"""Logical-axis rules and the layouts they resolve to (port of
``repro.sharding``): ``spec_for``, the rule tables, ``shard`` over a
DTensor mesh, and the host-staged gloo groups such meshes run on."""
from repro_torch.sharding.logical import (A, DEFAULT_RULES,
                                          INPUT_PARALLEL_RULES,
                                          SP_DECODE_RULES, MeshShape,
                                          NamedSharding, ShardingCtx,
                                          ShardingRules, param_shardings,
                                          param_specs, shard, spec_for)

__all__ = ["A", "ShardingCtx", "ShardingRules", "MeshShape", "NamedSharding",
           "DEFAULT_RULES", "SP_DECODE_RULES", "INPUT_PARALLEL_RULES",
           "spec_for", "shard", "param_specs", "param_shardings"]
