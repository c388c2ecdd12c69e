"""Argument checks and launch helpers shared by the kernel wrappers.

A wrapper checks device, dtype, shape and contiguity before it hands raw
pointers to a kernel, and raises on anything the kernel does not take.
The same checks run for CPU tensors, whose wrapper call goes to the
kernel's plain version, so the CPU tests exercise them too, and for meta
tensors (the dry run's shapes), whose call returns an empty output of
the kernel's shape and dtype and charges the kernel's own work
(``charge_meta``): a meta call neither launches nor runs the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["check_tensor", "check_conv_operands", "refuse_grad", "ptr", "launch_args", "launch",
           "charge_meta"]


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


def check_conv_operands(name: str, x, w, scale=None, *,
                        needs_scale: bool) -> None:
    """Raise unless ``x`` and ``w`` are both fp32 or both int8 codes (a
    kernel route each) and, where ``needs_scale``, int8 codes come with
    their requant scale."""
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)):
        return                      # check_tensor names the bad argument
    if x.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"{name}: x has dtype {x.dtype}; the kernel takes "
                        f"torch.float32 or torch.int8 codes")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: mixed operands x {x.dtype} and w "
                        f"{w.dtype}; pass both as int8 codes or both as "
                        f"float32")
    if needs_scale and x.dtype == torch.int8 and scale is None:
        raise ValueError(f"{name}: int8 codes need their requant scale "
                         f"(scale=, shape (M,)): the epilogue applies it "
                         f"before the bias, relu and pool")


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


def charge_meta(name: str, *, ops: float, dtype: torch.dtype,
                nbytes: float, dot: bool = True) -> None:
    """On a meta call: charge kernel ``name``'s own work (``ops``
    operations in ``dtype``, ``nbytes`` read and written, each input once
    and each output once) to every op counter active around the call
    (``launch/op_stats.py``'s ``OpCounter``, a dispatch mode); nothing
    happens outside one."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        charge = getattr(mode, "charge_kernel", None)
        if charge is not None:
            charge(name, ops=ops, dtype=dtype, nbytes=nbytes, dot=dot)
