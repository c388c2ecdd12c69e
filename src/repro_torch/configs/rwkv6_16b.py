"""rwkv6-1.6b [ssm] — Finch: 24L d_model=2048 (attention-free)
d_ff=7168 vocab=65536, data-dependent decay. [arXiv:2404.05892; unverified]

Port of ``repro.configs.rwkv6_16b``; served by
``python -m repro_torch.launch.serve --arch rwkv6-1.6b --prompt-len 128``
(prompts must be whole WKV chunks of 64). 1,483,325,440 parameters by
the reference's count (5.9 GB in fp32). O(1)-state decode.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.rwkv_lm import RWKVLM, RWKVLMConfig

CONFIG = RWKVLMConfig(
    name="rwkv6-1.6b",
    n_layers=24, d_model=2048, d_ff=7168, vocab=65536,
    head_dim=64, chunk=64, dtype=torch.bfloat16, remat="full",
)

ARCH = ArchSpec(
    arch_id="rwkv6-1.6b", family="ssm",
    build=lambda: RWKVLM(CONFIG),
    source="arXiv:2404.05892; unverified",
    subquadratic=True,
    notes=("Token shift = K=2 causal window (paper C3 degenerate form); "
           "decode state is O(1) in sequence length."),
)
