"""Argument checks and launch helpers shared by the kernel wrappers.

A wrapper checks device, dtype, shape and contiguity before it hands raw
pointers to a kernel, and raises on anything the kernel does not take.
The same checks run for CPU tensors, whose wrapper call goes to the
kernel's plain version, so the CPU tests exercise them too.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["check_tensor", "refuse_grad", "ptr", "launch_args", "launch"]


def check_tensor(t: torch.Tensor, name: str, *, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank
    ``ndim`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, kernel takes {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, kernel takes "
                         f"rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous; pass .contiguous()")


def refuse_grad(name: str, *ts: torch.Tensor | None) -> None:
    """Raise when grad mode is on and an input requires grad: a kernel's
    output is a fresh tensor filled through a raw pointer, which autograd
    cannot see, so the caller would get no gradient and no error. Only
    ``conv_window`` has a backward (an ``autograd.Function``); the other
    kernels serve inference, under ``torch.no_grad``. Checked on every
    device, so a call the card would refuse fails on the CPU too."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: an input requires grad, but the {name} kernel has no "
            f"backward and its output would be detached from the graph; "
            f"call it under torch.no_grad() or detach the inputs")


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of ``t`` (None → a null pointer)."""
    return None if t is None else t.data_ptr()


def launch_args(n_ptrs: int, n_ints: int) -> list:
    """ctypes argtypes for ``(ptr × n_ptrs, int × n_ints, stream)``."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_void_p])


def launch(fn, name: str, device: torch.device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    PyTorch stream and raise if it reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
