"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16, MHA) d_ff=2816
vocab=151936, QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B; hf]

Port of ``repro.configs.qwen15_05b``; served by
``python -m repro_torch.launch.serve --arch qwen1.5-0.5b``.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig, TransformerLM

CONFIG = LMConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab=151936,
    qkv_bias=True, act="silu", gated=True, rope_theta=1_000_000.0,
    tie_embeddings=True, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="qwen1.5-0.5b", family="dense",
    build=lambda: TransformerLM(CONFIG),
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    notes="QKV bias; MHA (kv == heads); tied embeddings.",
)
