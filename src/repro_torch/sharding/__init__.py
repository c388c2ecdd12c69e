"""Logical-axis annotations (port of ``repro.sharding``, the part the
models call). The mesh rules wait for the LM half of ROADMAP §A.10."""
from repro_torch.sharding.logical import A, ShardingCtx, shard

__all__ = ["A", "ShardingCtx", "shard"]
