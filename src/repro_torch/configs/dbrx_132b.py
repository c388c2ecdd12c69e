"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]

Port of ``repro.configs.dbrx_132b``. About 132 B parameters (264 GB in
bf16): one card serves it at full width and reduced depth
(``dataclasses.replace(CONFIG, n_layers=L)``); full depth needs its
experts sharded over a mesh: ``Engine(..., ctx)`` and ``make_train_step``
on a mesh whose ``model`` axis divides its 16 experts run them
expert-parallel (``models/moe.py``, the reference's ``_moe_apply_ep``).
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig, TransformerLM

CONFIG = LMConfig(
    name="dbrx-132b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    moe=MoEConfig(d_model=6144, d_ff=10752, n_experts=16, top_k=4,
                  capacity_factor=1.25, act="silu", gated=True),
    act="silu", gated=True, rope_theta=500_000.0,
    tie_embeddings=False, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="dbrx-132b", family="moe",
    build=lambda: TransformerLM(CONFIG),
    source="hf:databricks/dbrx-base; unverified",
    notes="16 experts top-4 fine-grained; untied embeddings; GQA kv=8.",
)
