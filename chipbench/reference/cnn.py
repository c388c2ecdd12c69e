"""A plain PyTorch int8 CNN: the reference the benchmark holds the
program's logits to.

It states the int8 datapath of the paper's accelerator as the configuration
files describe it, from the raw float weights and images alone:

* before every conv block, the activations are quantized symmetrically
  with one scale over the whole batch: scale = max(absmax, 1e-8) x
  fp32(1 / qmax), codes = clamp(round(x / scale), -qmax, qmax);
* each conv weight with one scale per output channel, the same way;
* a block sums code x code products exactly (in float64, rounded back to
  the integers they are), and applies (sum x (sx . sw)) + b in fp32 with
  two roundings, then ReLU and a 2x2/2 max pool;
* the classifier quantizes each row of the flattened activations with its
  own scale, and each output column of its weight with its own scale,
  sums the codes exactly, and applies ((sum x sx) x sw) + b in fp32.

``bits`` sets qmax = 2^(bits - 1) - 1: 8 is the configuration's own
format; 4 is the nearest format below, the control that the comparison
must refuse. Nothing here reads a weight, scale or code that the program
made.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize", "conv_block", "classifier", "forward"]


def _inv(qmax: int) -> torch.Tensor:
    """fp32(1 / qmax), the constant a scale is multiplied by."""
    return torch.tensor(1.0, dtype=torch.float32) / float(qmax)


def quantize(x: torch.Tensor, qmax: int, dim: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes as integer-valued fp32, fp32 scale): one scale over all of
    ``x`` (``dim`` None) or one per slice with ``dim`` reduced away (kept
    as size 1)."""
    xf = x.to(torch.float32)
    amax = (xf.abs().amax() if dim is None
            else xf.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp(amax, min=1e-8) * _inv(qmax)
    codes = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return codes, scale


def _exact(t: torch.Tensor) -> torch.Tensor:
    """An integer-valued float64 sum, rounded to the integer it is and
    returned as fp32 (round to nearest even, as an int32 converts)."""
    return torch.round(t).to(torch.float32)


def conv_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               qmax: int) -> torch.Tensor:
    """(B, N, H, W) fp32 -> (B, M, (H-K+1)/2, (W-K+1)/2) fp32."""
    xc, xs = quantize(x, qmax)
    m = w.shape[0]
    wc, ws = quantize(w.reshape(m, -1), qmax, dim=-1)
    scale = (xs * ws.reshape(-1)).to(torch.float32)
    acc = _exact(F.conv2d(xc.to(torch.float64),
                          wc.reshape(w.shape).to(torch.float64)))
    y = acc * scale[None, :, None, None]
    y = y + b.to(torch.float32)[None, :, None, None]
    return F.max_pool2d(torch.relu(y), kernel_size=2, stride=2)


def classifier(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               qmax: int) -> torch.Tensor:
    """(B, K) fp32 . (K, N) -> (B, N) fp32 logits."""
    xc, xs = quantize(x, qmax, dim=-1)
    wc, ws = quantize(w, qmax, dim=0)
    acc = _exact(xc.to(torch.float64) @ wc.to(torch.float64))
    return acc * xs * ws + b.to(torch.float32)


def forward(params: dict, images: torch.Tensor, config: dict,
            bits: int = 8) -> torch.Tensor:
    """Logits of one batch, as one batch: the activation scales are the
    batch's own, so pass exactly the batch the program ran."""
    qmax = 2 ** (bits - 1) - 1
    x = images
    for layer in config["layers"]:
        p = params[layer["param"]]
        x = conv_block(x, p["w"], p["b"], qmax)
    fc = config["fc"]
    return classifier(x.reshape(x.shape[0], -1), params[fc["w"]],
                      params[fc["b"]], qmax)
