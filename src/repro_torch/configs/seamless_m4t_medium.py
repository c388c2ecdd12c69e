"""seamless-m4t-medium [audio] — enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206. The speech frontend is a
STUB: the encoder takes precomputed frame embeddings (B, T, D); decoder
text is T/4 tokens (speech frames outnumber text tokens).
[arXiv:2308.11596; hf]

Port of ``repro.configs.seamless_m4t_medium``. The serving ``Engine``
feeds no ``frames``, so ``launch.serve`` refuses it, as the reference's
launcher fails on it; ``launch.train`` trains it.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.encdec import EncDecConfig, EncDecLM

CONFIG = EncDecConfig(
    name="seamless-m4t-medium",
    n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    act="relu", gated=False, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="seamless-m4t-medium", family="audio",
    build=lambda: EncDecLM(CONFIG),
    source="arXiv:2308.11596; hf",
    frames=True, dec_frac=4,
    notes=("Enc-dec; decode cells: cross-KV cache = seq_len frames, "
           "self-KV cache = seq_len/4 tokens. The wav2vec-style conv "
           "subsampler (paper-C3 1-D window pipeline) is stubbed; its "
           "window math is exercised via core.conv in the smoke test."),
)
