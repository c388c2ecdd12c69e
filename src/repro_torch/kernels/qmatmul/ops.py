"""Wrapper of the int8 GEMM CUDA kernel.

Registered as the ``cuda`` backend of the ``qmatmul`` op family
(repro_torch.ops). On a CUDA tensor ``qmatmul`` checks its arguments and
launches ``csrc/qmatmul.cu`` on the current stream, or raises; on a CPU
tensor it runs the plain version (``ref.py``); on a meta tensor it
returns an empty output and charges the kernel's work (``charge_meta``:
2·M·K·N int8 operations; M·K + K·N + 4·(M + N) + 4·M·N bytes).
The kernel has two bodies, tensor-core tiles and split-K weight
streaming, chosen by shape (``repro_torch.ops.tiling.qmatmul_tiles``); a
call whose K is split across blocks zeroes a buffer for their sums
first (``torch.zeros`` on the current stream: a graph captures it).
``qmatmul_acc`` is the same kernel without its epilogue: the int32
accumulator itself, which a row-parallel shard's partial product is
until the ranks' partials are summed (exactly, in int32) and the scales
applied once. ``launches`` counts kernel launches of either (one a
call, however many blocks share its K), and nothing else; inside
``record_shapes()`` each launch also adds its (mode, M, K, N) to the
yielded set ("epilogue" for ``qmatmul``, "acc" for ``qmatmul_acc``).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import (charge_meta, check_tensor, launch,
                                       launch_args, ptr, refuse_grad)
from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref, qmatmul_ref
from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.tiling import platform_key, qmatmul_tiles

__all__ = ["qmatmul", "qmatmul_acc", "launches", "record_shapes"]

launches = 0
_SHAPES: contextvars.ContextVar = contextvars.ContextVar(
    "qmatmul_launch_shapes", default=None)


@contextlib.contextmanager
def record_shapes():
    """Yield a set that collects each kernel launch's (mode, M, K, N)
    while the context is open."""
    seen: set = set()
    token = _SHAPES.set(seen)
    try:
        yield seen
    finally:
        _SHAPES.reset(token)


def _launched(mode: str, m: int, k: int, n: int) -> None:
    global launches
    launches += 1
    seen = _SHAPES.get()
    if seen is not None:
        seen.add((mode, m, k, n))


@functools.cache
def _launcher():
    fn = load("qmatmul").qmatmul_launch
    fn.argtypes = launch_args(6, 9)
    fn.restype = ctypes.c_int
    return fn


def _launch(t: dict, x_codes, w_codes, xs, ws, out, m: int, n: int,
            k: int, *, raw: bool) -> None:
    """One launch of the body ``t`` names. A split K with the epilogue
    takes a buffer of ``t["scratch"]`` bytes, zeroed on the current
    stream."""
    scratch = None
    if t["scratch"] and not raw:
        scratch = torch.zeros(t["scratch"] // 4, dtype=torch.int32,
                              device=out.device)
    launch(_launcher(), "qmatmul", out.device, ptr(x_codes), ptr(w_codes),
           ptr(xs), ptr(ws), ptr(out), ptr(scratch), m, n, k, t["body"],
           t["tile_m"], t.get("tile_n", 0), t["ksplit"], t["smem"], int(raw))


def _scale(s, shape: tuple[int, int], dev: torch.device) -> torch.Tensor:
    """A scalar or ``shape``-shaped f32 scale as a contiguous ``shape``."""
    s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    if s.ndim < 2:
        s = s.reshape(-1)
        if s.numel() != 1:
            raise ValueError(f"scale of {s.numel()} entries; expected a "
                             f"scalar or shape {shape}")
        return s.expand(shape).contiguous()
    if tuple(s.shape) != shape:
        raise ValueError(f"scale shape {tuple(s.shape)}, expected {shape}")
    return s.contiguous()


def qmatmul(x_codes: torch.Tensor, w_codes: torch.Tensor, x_scale,
            w_scale, *, out_dtype: torch.dtype = torch.float32,
            policy: ExecPolicy | None = None) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> (M,N) ``out_dtype`` = (acc · x_scale) ·
    w_scale with an int32 accumulator; x_scale (M,1)|scalar, w_scale
    (1,N)|scalar. The kernel writes f32; another dtype is a cast after
    it, as the reference's ``.astype`` after its epilogue."""
    dev = x_codes.device
    check_tensor(x_codes, "x_codes", dtype=torch.int8, ndim=2, device=dev)
    check_tensor(w_codes, "w_codes", dtype=torch.int8, ndim=2, device=dev)
    m, k = x_codes.shape
    k2, n = w_codes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x_codes {tuple(x_codes.shape)}"
                         f" · w_codes {tuple(w_codes.shape)}")
    xs = _scale(x_scale, (m, 1), dev)
    ws = _scale(w_scale, (1, n), dev)
    refuse_grad("qmatmul", xs, ws)
    if dev.type == "cpu":
        return qmatmul_ref(x_codes, w_codes, xs, ws, out_dtype)
    if dev.type == "meta":
        charge_meta("qmatmul", ops=2 * m * k * n, dtype=torch.int8,
                    nbytes=m * k + k * n + 4 * (m + n) + 4 * m * n)
        return torch.empty((m, n), dtype=torch.float32,
                           device=dev).to(out_dtype)
    pol = policy if policy is not None else current_policy()
    if pol.autotune:
        from repro_torch.ops.autotune import ensure_tuned
        ensure_tuned("qmatmul", x_codes, w_codes, xs, ws, policy=pol)
    t = qmatmul_tiles(m, k, n, pol.tile_overrides,
                      platform=platform_key(dev))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out.to(out_dtype)
    _launch(t, x_codes, w_codes, xs, ws, out, m, n, k, raw=False)
    _launched("epilogue", m, k, n)
    return out.to(out_dtype)


def qmatmul_acc(x_codes: torch.Tensor, w_codes: torch.Tensor, *,
                policy: ExecPolicy | None = None) -> torch.Tensor:
    """(M,K) int8 · (K,N) int8 -> the (M,N) int32 accumulator, no
    scales: one launch of the qmatmul kernel in its raw mode."""
    dev = x_codes.device
    check_tensor(x_codes, "x_codes", dtype=torch.int8, ndim=2, device=dev)
    check_tensor(w_codes, "w_codes", dtype=torch.int8, ndim=2, device=dev)
    m, k = x_codes.shape
    k2, n = w_codes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x_codes {tuple(x_codes.shape)}"
                         f" · w_codes {tuple(w_codes.shape)}")
    if dev.type == "cpu":
        return qmatmul_acc_ref(x_codes, w_codes)
    if dev.type == "meta":
        charge_meta("qmatmul", ops=2 * m * k * n, dtype=torch.int8,
                    nbytes=m * k + k * n + 4 * m * n)
        return torch.empty((m, n), dtype=torch.int32, device=dev)
    pol = policy if policy is not None else current_policy()
    t = qmatmul_tiles(m, k, n, pol.tile_overrides,
                      platform=platform_key(dev))
    # a split K adds every block's sums into the output itself: zeroed
    alloc = torch.zeros if t["splits"] > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _launch(t, x_codes, w_codes, None, None, out, m, n, k, raw=True)
    _launched("acc", m, k, n)
    return out
