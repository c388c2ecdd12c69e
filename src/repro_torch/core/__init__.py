"""Numerics of the paper's accelerator, ported from ``repro.core``:
fixed-point/int8 quantization (C4), the odd-even addition tree and its
resource models (C2), the convolution-window laws, window-buffer model and
formulations (C3), the channel-parallel schedules (C1) and the conv layer
(``repro_torch.core.conv``).

The conv layer's names resolve lazily (PEP 562): ``core.conv`` imports
``repro_torch.ops.policy``, whose package imports ``core`` back, so an
eager import here would make that a cycle.
"""
from repro_torch.core.addtree import (TreeResources, classic_padded_sum,
                                      classic_tree_resources, level_widths,
                                      pairwise_sum, tree_resources)
from repro_torch.core.parallelism import (ChannelParallelism,
                                          conv2d_channel_parallel)
from repro_torch.core.quantize import (QFormat, QTensor, dequantize_int8,
                                       fake_quant_int8, quantize_int8,
                                       quantize_tree)
from repro_torch.core.window import (LineBufferSim, conv2d_im2col,
                                     conv2d_ref, conv_output_size,
                                     extract_windows, fill_latency,
                                     reuse_ratio, window_products)

_EXPORTS = {"Conv2DConfig": "conv", "causal_conv1d": "conv",
            "causal_conv1d_step": "conv", "conv2d_apply": "conv",
            "conv2d_init": "conv"}

__all__ = [
    "TreeResources", "classic_padded_sum", "classic_tree_resources",
    "level_widths", "pairwise_sum", "tree_resources",
    *_EXPORTS,
    "ChannelParallelism", "conv2d_channel_parallel",
    "QFormat", "QTensor", "dequantize_int8", "fake_quant_int8",
    "quantize_int8", "quantize_tree",
    "LineBufferSim", "conv2d_im2col", "conv2d_ref", "conv_output_size",
    "extract_windows", "fill_latency", "reuse_ratio", "window_products",
]


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.core' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.core.{mod}"), name)
