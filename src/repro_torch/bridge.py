"""JAX-to-PyTorch parameter bridge.

``params_from_numpy(tree, device)`` turns a params tree whose leaves are
numpy arrays — the JAX ``PaperCNN.init`` output, converted to numpy by
the caller — into the port's params in the same layout: conv weights
(M, N, Kh, Kw), conv biases (M,), ``fc_w`` (K, N), ``fc_b`` (N,). Both
packages then compute the same function, which is how the tests hold
one against the other. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, device: str | torch.device) -> dict | torch.Tensor:
    """Nested dicts of float arrays -> the same dicts of float32 tensors
    on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    if not np.issubdtype(arr.dtype, np.floating):
        raise TypeError(f"params leaf of dtype {arr.dtype}; expected float")
    return torch.from_numpy(np.array(arr, np.float32)).to(dev)
