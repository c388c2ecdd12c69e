"""The op registry, ExecPolicy, the public op entry points (DESIGN.md §7)
and the tuning cache with its measured autotuner (§10), ported from
``repro.ops``."""
from repro_torch.ops.policy import (BACKENDS, QUANT_MODES, ExecPolicy,
                                    current_policy, use_policy)
from repro_torch.ops.registry import (REGISTRY, BackendUnavailableError,
                                      dispatch, list_backends, list_ops,
                                      register)
from repro_torch.ops.impls import (causal_conv1d, conv2d, dense,
                                   fused_conv_block, qdense, qmatmul,
                                   qmatmul_acc,
                                   quantize_conv_int8, split_requant,
                                   tree_reduce_sum)
from repro_torch.ops.tiling import TUNING_CACHE, TuningCache, tile_params
from repro_torch.ops.autotune import ensure_tuned, resolved_backend

__all__ = ["ExecPolicy", "use_policy", "current_policy", "BACKENDS",
           "QUANT_MODES", "REGISTRY", "BackendUnavailableError", "dispatch",
           "register", "list_ops", "list_backends", "conv2d",
           "fused_conv_block", "tree_reduce_sum", "qmatmul", "qmatmul_acc",
           "qdense",
           "dense", "causal_conv1d", "quantize_conv_int8", "split_requant",
           "TUNING_CACHE", "TuningCache", "tile_params", "ensure_tuned",
           "resolved_backend"]
