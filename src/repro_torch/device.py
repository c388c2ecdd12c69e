"""Device resolution for the port's entry points.

Entry points (``PaperCNN.init``, ``VisionEngine``, the launcher) default
to ``"cuda"``. Asking for that default on a machine without a GPU raises:
the port never quietly runs on the CPU. The CPU is used only when the
caller names it, as the CPU tests do.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev
