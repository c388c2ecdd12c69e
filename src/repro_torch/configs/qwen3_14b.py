"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, per-head qk RMSNorm. [hf:Qwen/Qwen3-8B; hf]

Port of ``repro.configs.qwen3_14b``; 14.77 B parameters by
``param_count()``, served at full size on one card by
``python -m repro_torch.launch.serve --arch qwen3-14b``.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig, TransformerLM

CONFIG = LMConfig(
    name="qwen3-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    qk_norm=True, act="silu", gated=True, rope_theta=1_000_000.0,
    tie_embeddings=False, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="qwen3-14b", family="dense",
    build=lambda: TransformerLM(CONFIG),
    source="hf:Qwen/Qwen3-8B; hf",
    notes=("qk_norm per head; GQA kv=8; untied embeddings. 40 heads % "
           "model=16 != 0 ⇒ activations shard seq over 'model'."),
    rule_overrides={"act_seq": ["model"]},
)
