"""Numerics of the paper's accelerator, ported from ``repro.core``:
fixed-point/int8 quantization (C4), the odd-even addition tree and its
resource models (C2), the convolution-window laws, window-buffer model and
formulations (C3) and the conv layer (``repro_torch.core.conv``)."""
from repro_torch.core.addtree import (TreeResources, classic_padded_sum,
                                      classic_tree_resources, level_widths,
                                      pairwise_sum, tree_resources)
from repro_torch.core.quantize import (QFormat, QTensor, dequantize_int8,
                                       quantize_int8)
from repro_torch.core.window import (LineBufferSim, conv2d_im2col,
                                     conv2d_ref, conv_output_size,
                                     extract_windows, fill_latency,
                                     reuse_ratio, window_products)

__all__ = [
    "TreeResources", "classic_padded_sum", "classic_tree_resources",
    "level_widths", "pairwise_sum", "tree_resources",
    "QFormat", "QTensor", "dequantize_int8", "quantize_int8",
    "LineBufferSim", "conv2d_im2col", "conv2d_ref", "conv_output_size",
    "extract_windows", "fill_latency", "reuse_ratio", "window_products",
]
