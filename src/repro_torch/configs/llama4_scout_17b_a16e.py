"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Port of ``repro.configs.llama4_scout_17b_a16e``. About 109 B parameters:
one card serves it at full width and reduced depth; full depth needs
its experts sharded over a mesh: on a mesh whose ``model`` axis divides
its 16 experts they run expert-parallel (``models/moe.py``), the
sequence gathered over ``model`` at the layer and split again after it.
``rule_overrides`` shards ``act_seq`` over ``model``, as the reference's.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig, TransformerLM

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    moe=MoEConfig(d_model=5120, d_ff=8192, n_experts=16, top_k=1,
                  n_shared=1, capacity_factor=1.25, act="silu", gated=True),
    act="silu", gated=True, rope_theta=500_000.0,
    tie_embeddings=False, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="moe",
    build=lambda: TransformerLM(CONFIG),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    notes=("MoE top-1 + shared expert. Early-fusion multimodality is a "
           "frontend concern; text backbone modeled (task-spec stub rule). "
           "40 heads % model=16 != 0 ⇒ activations shard seq over 'model' "
           "(sequence parallelism)."),
    rule_overrides={"act_seq": ["model"]},
)
