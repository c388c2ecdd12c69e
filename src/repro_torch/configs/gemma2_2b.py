"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) head_dim=256
d_ff=9216 vocab=256000; alternating local(4096-window)/global layers,
attn softcap 50, final softcap 30, sandwich RMSNorm (1+w), embed scaling,
GeGLU. [arXiv:2408.00118; hf]

Port of ``repro.configs.gemma2_2b``; served at full size on one card by
``python -m repro_torch.launch.serve --arch gemma2-2b``.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig, TransformerLM

CONFIG = LMConfig(
    name="gemma2-2b",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global=True,
    sandwich_norm=True, norm_plus_one=True, embed_scale=True,
    act="gelu_tanh", gated=True, rope_theta=10_000.0,
    tie_embeddings=True, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="gemma2-2b", family="dense",
    build=lambda: TransformerLM(CONFIG),
    source="arXiv:2408.00118; hf",
    notes=("local/global alternation rides through the layer loop as a "
           "per-layer flag; logit softcaps on attention and final head. "
           "8 heads < model=16 ⇒ activations shard seq over 'model' "
           "(sequence parallelism) instead of heads."),
)
