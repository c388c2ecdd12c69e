"""The paper's own workload (Tab. I): LeNet-style MNIST CNN."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig

CONFIG = PaperCNNConfig()

ARCH = ArchSpec(
    arch_id="mnist_cnn", family="cnn",
    build=lambda: PaperCNN(CONFIG),
    source="paper Tab. I",
    notes="conv 3x3x15 -> pool -> conv 6x6x20 -> pool -> fc10; 14,180 params.",
)
