"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no-bias, parallel attention/FFN block, LayerNorm.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

Port of ``repro.configs.command_r_35b``.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig, TransformerLM

CONFIG = LMConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000,
    parallel_block=True, norm="layernorm",
    act="silu", gated=True, rope_theta=8_000_000.0,
    tie_embeddings=True, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="command-r-35b", family="dense",
    build=lambda: TransformerLM(CONFIG),
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    notes="Parallel attn∥FFN residual block; LayerNorm; tied embeddings.",
)
