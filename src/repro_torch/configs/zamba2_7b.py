"""zamba2-7b [hybrid] — 81 Mamba2 layers d_model=3584, shared attention
block (32H MHA) + MLP d_ff=14336 every 6 layers, ssm_state=64, vocab=32000.
[arXiv:2411.15242; unverified]

Port of ``repro.configs.zamba2_7b``; served by
``python -m repro_torch.launch.serve --arch zamba2-7b --prompt-len 512``
(prompts must be whole SSD chunks of 256). 6,661,258,832 parameters
(26.6 GB in fp32): one card serves it at full width and depth.

Simplification vs release: ONE shared block instead of two alternating
(DESIGN.md §5).
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.hybrid import HybridConfig, HybridLM

CONFIG = HybridConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, d_state=64,
    shared_interval=6, mamba_chunk=256,
    dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="zamba2-7b", family="hybrid",
    build=lambda: HybridLM(CONFIG),
    source="arXiv:2411.15242; unverified",
    subquadratic=True,
    notes=("Mamba2 conv1d = paper-C3 1-D window pipeline (ring state at "
           "decode). Shared-attn KV cache is the only seq-proportional "
           "state; long_500k shards it over the data axis (SP)."),
)
