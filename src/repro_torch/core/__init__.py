"""Numerics of the paper's accelerator, ported from ``repro.core``:
fixed-point/int8 quantization (C4), the odd-even addition tree (C2), the
convolution-window laws and formulations (C3) and the conv layer."""
