"""internvl2-26b [vlm] — InternLM2-20B backbone: 48L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=92553. InternViT frontend is a STUB per the
task spec: a prefill takes precomputed patch embeddings
(``batch["vision_embeds"]``, (B, VISION_PATCHES, D)) prepended to the
text tokens. [arXiv:2404.16821; hf]

Port of ``repro.configs.internvl2_26b``; ``ArchSpec.input_specs`` reads
``vision_patches`` for its train and prefill cells.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig, TransformerLM

VISION_PATCHES = 1024  # stub patch-embedding count per sample

CONFIG = LMConfig(
    name="internvl2-26b",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553,
    vision_prefix=True,
    act="silu", gated=True, rope_theta=1_000_000.0,
    tie_embeddings=False, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="internvl2-26b", family="vlm",
    build=lambda: TransformerLM(CONFIG),
    source="arXiv:2404.16821; hf",
    vision_patches=VISION_PATCHES,
    notes=("Backbone only; the ViT frontend is a stub: a prefill takes "
           "precomputed patch embeddings."),
)
