"""Measured autotuning: coordinate descent over the kernels' launch shapes.

Port of ``repro.ops.autotune`` (DESIGN.md §10). The paper's accelerator
wins by sizing its parallel hardware to the layer at hand; this module is
that step for the hand-written CUDA kernels. For one concrete (op, shape,
dtype, platform) call on the card it times real launches over a small
candidate grid and writes the winner into the shared ``TUNING_CACHE``
(``repro_torch.ops.tiling``), where every later call of the same
signature picks it up ahead of the heuristic.

The search is the reference's: coordinate descent, one axis at a time,
starting from the heuristic, which is always measured; a candidate must
beat the incumbent by ``MIN_GAIN`` (5%) to displace it, so the search does
not chase noise. The axes are the port's own launch keys
(``repro_torch.ops.tiling``):

  * the conv template (``conv2d`` and ``fused_conv_block``, one search):
    on f32 operands (the fp32 route) ``ipb`` (images a block), ``band``
    (tile rows a block), ``cpb`` (output channels a block), ``split``
    (lanes sharing a tile's contraction) and ``threads``; on int8 codes
    (the int8 route, cached under dtype int8) ``items`` (items a block),
    ``band`` and ``cpb``; a point the tiler refuses is skipped;
  * ``qmatmul``: ``body`` (the heuristic of each body is measured, the
    faster by ``MIN_GAIN`` starts the descent), then within that body
    ``tile_m`` (tensor-core tiles) or ``tile_m`` and ``tile_n`` (weight
    streaming), and ``ksplit``; a candidate the tiler refuses is skipped;
  * a streamed stage (``stream_conv2d``, ``stream_fused_conv_block``):
    its band height ``th``.

A candidate is timed with CUDA events on the current stream, its launches
queued behind a short spin kernel so the host's dispatch does not show as
device time: the least of ``TUNE_ITERS`` calls after ``TUNE_WARMUP``.
``measurements`` counts the candidates timed, and nothing else.

Entry points:

  * ``ensure_tuned(op, *args, **kwargs)`` — cache hit, or run the search.
    Called by the kernel wrappers under ``ExecPolicy(autotune=True)`` and
    by ``ExecutionPlan.bind`` on a plan compiled with ``autotune=True``
    (the winners are baked into the BoundPlan, so serving never re-tunes).
  * ``resolved_backend(op, *args, policy=..., **kwargs)`` — the backend
    dispatch would pick. Tiles bind only on the ``cuda`` backend with a
    CUDA tensor (the reference tunes only on ``pallas``): anything else
    tunes nothing, so CPU dispatch never measures.

The addition tree is not tuned, as in the reference. Tiles only change
the order of fp32 sums (``split`` lanes share a contraction): int8 codes
and Q8.8 values sum exactly, so tuned and heuristic results are bitwise
equal there, and within the port's 1e-5 relative tolerance in fp32.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch

from repro_torch.ops.policy import ExecPolicy, current_policy
from repro_torch.ops.tiling import (CONV_CHANNELS, CONV_S8_CHANNELS,
                                    CONV_S8_MAX_CPB, TUNING_CACHE,
                                    choose_conv_s8_blocks,
                                    choose_fused_blocks,
                                    choose_qmatmul_blocks, conv_s8_tiles,
                                    conv_signature, fits_keys, platform_key,
                                    qmatmul_tiles)

__all__ = ["ensure_tuned", "tune_conv2d", "tune_fused_conv_block",
           "tune_qmatmul", "tune_stream_conv2d",
           "tune_stream_fused_conv_block", "resolved_backend",
           "heuristic_tiles", "TUNE_WARMUP", "TUNE_ITERS", "MIN_GAIN",
           "measurements"]

measurements = 0

# least device time over ITERS calls after WARMUP. Module-level so tests
# and smoke runs can shrink them.
TUNE_WARMUP = 1
TUNE_ITERS = 3
# a candidate must be at least this much faster than the incumbent to win
MIN_GAIN = 0.05
# spin ahead of each candidate's timed calls, in GPU clock cycles a call
# (~0.5 ms on an H100): longer than the host takes to queue one call
SPIN_CYCLES = 1_000_000

# candidate values per axis (clamped to the call's dims, deduped, the
# heuristic's value always among them)
IMAGE_BLOCKS = (1, 2, 4, 8)
BAND_ROWS = (1, 2, 4, 8)
CHANNEL_BLOCKS = (4, 8, 16, 32)
SPLITS = (1, 2, 4, 8, 16, 32)
THREADS = (64, 128, 256, 512)
# the conv template's int8 route: items a block
S8_ITEMS = (1, 2, 4, 8)
QMM_TC_ROWS = (64, 128)
QMM_STREAM_ROWS = (4, 8, 16)
QMM_STREAM_COLS = (16, 32, 64, 128)
# streamed-stage band heights; the budget-derived one, half and the whole
# map join the set
STREAM_TILE_ROWS = (4, 8, 16, 32, 64)

_CONV_KEYS = ("threads", "cpb", "band", "split", "ipb")
_CONV_S8_KEYS = ("cpb", "band", "items")
_QMM_KEYS = ("body", "tile_m", "tile_n", "ksplit")   # both bodies' keys


def _measure(fn: Callable[[], object], *, warmup: int | None = None,
             iters: int | None = None) -> float:
    """Least device time of one ``fn()`` in microseconds: ``iters`` calls,
    each between two CUDA events on the current stream, queued behind a
    spin kernel (the floor is the right estimate for µs launches)."""
    global measurements
    measurements += 1
    warmup = TUNE_WARMUP if warmup is None else warmup
    iters = max(TUNE_ITERS if iters is None else iters, 1)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES * iters)
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return min(e0.elapsed_time(e1) for e0, e1 in events) * 1e3


def _descend(axes: dict[str, list[int]], start: dict[str, int],
             launch: Callable[..., Callable | None], *,
             on_point: Callable[[dict, float], None] | None = None
             ) -> dict[str, int]:
    """Coordinate descent: sweep each axis in insertion order holding the
    others at the current best. A candidate displaces the incumbent only
    when it measures at least ``MIN_GAIN`` faster. ``launch(**tiles)``
    returns a zero-arg timed callable, or None for a point the kernel
    does not take (never measured, never chosen)."""
    measured: dict[tuple, float] = {}

    def probe(cand: dict[str, int]) -> float:
        key = tuple(sorted(cand.items()))
        if key not in measured:
            fn = launch(**cand)
            us = float("inf") if fn is None else _measure(fn)
            measured[key] = us
            if on_point is not None and fn is not None:
                on_point(dict(cand), us)
        return measured[key]

    best = dict(start)
    best_us = probe(best)
    for axis, values in axes.items():
        for v in values:
            cand = {**best, axis: v}
            us = probe(cand)
            if us < best_us * (1.0 - MIN_GAIN):
                best, best_us = cand, us
    return best


def _no_autotune(policy: ExecPolicy | None) -> ExecPolicy:
    pol = policy if policy is not None else current_policy()
    # the search must not recurse into ensure_tuned, and the candidate
    # tiles must win over any policy or cache tiling
    return pol.with_options(autotune=False, tiling=())


def _with_tiles(pol: ExecPolicy, op: str, tiles: Mapping[str, int]
                ) -> ExecPolicy:
    return pol.with_options(tiling={f"{op}.{k}": int(v)
                                    for k, v in tiles.items()})


def resolved_backend(op: str, *args, policy: ExecPolicy | None = None,
                     **kwargs) -> str | None:
    """The backend the registry would dispatch this call to (None when no
    backend accepts it)."""
    from repro_torch.ops.registry import REGISTRY, BackendUnavailableError
    pol = policy if policy is not None else current_policy()
    if pol.backend is not None:
        # a named backend the family registers runs or raises; one it
        # never registered falls to auto-selection (the registry's rules)
        try:
            impl = REGISTRY.lookup(op, pol.backend)
        except BackendUnavailableError:
            impl = None
        if impl is not None:
            return pol.backend if impl.accepts(*args, **kwargs) else None
    capable = REGISTRY.supported_backends(op, *args, **kwargs)
    return capable[0] if capable else None


def _values(cands, cap: int, heur: int) -> list[int]:
    return sorted({v for v in cands if v <= cap} | {heur})


# ------------------------------------------------------------- tuners

def _conv_heuristic(x, w, stride, pool: bool, odd: str) -> dict[str, int]:
    bsz, n, h, wd = x.shape
    m, _, kh, kw = w.shape
    if x.dtype == torch.int8:
        heur = choose_conv_s8_blocks(bsz, n, h, wd, m, kh, kw, *stride,
                                     pool=pool, odd=odd)
        return {k: heur[k] for k in _CONV_S8_KEYS}
    heur = choose_fused_blocks(bsz, n, h, wd, m, kh, kw, *stride, pool=pool,
                               odd=odd)
    return {k: heur[k] for k in _CONV_KEYS}


def _conv_axes(x, w, stride, heur: Mapping[str, int]) -> dict[str, list]:
    """The conv template's axes in impact order. fp32 route: weight reuse
    across images, the rows a block stages, its channel group, the lanes
    sharing a contraction, the block's threads. int8 route: the items a
    block, the rows an item, the channel group."""
    bsz, n, h, _ = x.shape
    m, _, kh, _ = w.shape
    ho = (h - kh) // stride[0] + 1
    po = max(-(-ho // 2), 1)
    if x.dtype == torch.int8:
        cpb_cap = min(-(-m // CONV_S8_CHANNELS) * CONV_S8_CHANNELS,
                      CONV_S8_MAX_CPB)
        return {
            "items": _values(S8_ITEMS, bsz * po, heur["items"]),
            "band": _values((*BAND_ROWS, po), po, heur["band"]),
            "cpb": _values(range(CONV_S8_CHANNELS, CONV_S8_MAX_CPB + 1,
                                 CONV_S8_CHANNELS), cpb_cap, heur["cpb"]),
        }
    cpb_cap = -(-m // CONV_CHANNELS) * CONV_CHANNELS
    return {
        "ipb": _values(IMAGE_BLOCKS, bsz, heur["ipb"]),
        "band": _values((*BAND_ROWS, po), po, heur["band"]),
        "cpb": _values(CHANNEL_BLOCKS, cpb_cap, heur["cpb"]),
        "split": _values(SPLITS, max(n * kh, 1), heur["split"]),
        "threads": _values(THREADS, 1024, heur["threads"]),
    }


def _tune_conv(op: str, call, x, w, stride, pool: bool, odd: str,
               on_point) -> dict[str, int]:
    heur = _conv_heuristic(x, w, stride, pool, odd)

    def launch(**tiles):
        if x.dtype == torch.int8:
            bsz, n, h, wd = x.shape
            m, _, kh, kw = w.shape
            try:
                t = conv_s8_tiles(bsz, n, h, wd, m, kh, kw, *stride,
                                  {f"{op}.{a}": v for a, v in tiles.items()},
                                  pool=pool, odd=odd,
                                  platform=platform_key(x.device))
            except ValueError:
                return None
        return lambda: call(tiles)

    best = _descend(_conv_axes(x, w, stride, heur), heur, launch,
                    on_point=on_point)
    TUNING_CACHE.put(op, conv_signature(x.shape, w.shape, stride), x.dtype,
                     best, platform=platform_key(x.device))
    return best


def tune_conv2d(x, w, b=None, *, stride=(1, 1),
                policy: ExecPolicy | None = None,
                on_point=None) -> dict[str, int]:
    """Search the conv template's keys for ``conv_window`` on this
    concrete call; cache and return the winner."""
    from repro_torch.kernels.conv_window.ops import conv_window
    pol = _no_autotune(policy)
    stride = tuple(stride)
    return _tune_conv(
        "conv2d", lambda t: conv_window(
            x, w, b, stride=stride, policy=_with_tiles(pol, "conv2d", t)),
        x, w, stride, False, "raise", on_point)


def tune_fused_conv_block(x, w, b=None, *, stride=(1, 1), odd="raise",
                          scale=None, policy: ExecPolicy | None = None,
                          on_point=None) -> dict[str, int]:
    """Search the conv template's keys for ``fused_cwp`` on this concrete
    call; cache and return the winner. ``scale`` exercises the int8
    requant epilogue when the caller runs quantized."""
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    pol = _no_autotune(policy)
    stride = tuple(stride)
    return _tune_conv(
        "fused_conv_block", lambda t: fused_cwp(
            x, w, b, stride=stride, scale=scale, odd=odd,
            policy=_with_tiles(pol, "fused_conv_block", t)),
        x, w, stride, True, odd, on_point)


def _qmatmul_axes(k: int, heur: Mapping[str, int]) -> dict[str, list]:
    """One body's axes: tensor-core tiles' rows a block, or the
    streaming body's rows and columns a block; then the K slice a
    block (the heuristic's, half and twice it, and all of K)."""
    step = 64 if heur["body"] == 1 else 4
    whole = max(-(-k // step), 1) * step
    ks = heur["ksplit"]
    ksplits = {ks, whole, min(whole, 2 * ks),
               max(step, ks // 2 // step * step)}
    if heur["body"] == 1:
        axes = {"tile_m": _values(QMM_TC_ROWS, 128, heur["tile_m"])}
    else:
        axes = {"tile_m": _values(QMM_STREAM_ROWS, 16, heur["tile_m"]),
                "tile_n": _values(QMM_STREAM_COLS, 128, heur["tile_n"])}
    return {**axes, "ksplit": sorted(ksplits)}


def tune_qmatmul(x_codes, w_codes, x_scale, w_scale, *,
                 policy: ExecPolicy | None = None,
                 on_point=None) -> dict[str, int]:
    """Search ``qmatmul``'s keys: the body (each body's heuristic is
    measured; the other body's displaces the shape's own only when
    ``MIN_GAIN`` faster), then that body's axes; cache and return the
    winner."""
    from repro_torch.kernels.qmatmul.ops import qmatmul
    pol = _no_autotune(policy)
    m, k = x_codes.shape
    n = w_codes.shape[1]

    def launch(**tiles):
        try:
            qmatmul_tiles(m, k, n, {f"qmatmul.{a}": v
                                    for a, v in tiles.items()})
        except ValueError:
            return None
        pol_t = _with_tiles(pol, "qmatmul", tiles)
        return lambda: qmatmul(x_codes, w_codes, x_scale, w_scale,
                               policy=pol_t)

    heur = choose_qmatmul_blocks(m, k, n)
    other = choose_qmatmul_blocks(m, k, n, 1 - heur["body"])
    timed = []
    for point in (heur, other):
        fn = launch(**point)
        timed.append(float("inf") if fn is None else _measure(fn))
        if on_point is not None and fn is not None:
            on_point(dict(point), timed[-1])
    start = other if timed[1] < timed[0] * (1.0 - MIN_GAIN) else heur
    best = _descend(_qmatmul_axes(k, start), start, launch,
                    on_point=on_point)
    TUNING_CACHE.put("qmatmul", (m, k, n), x_codes.dtype, best,
                     platform=platform_key(x_codes.device))
    return best


def _stream_axis(full: int, heur_th: int) -> list[int]:
    vals = {v for v in STREAM_TILE_ROWS if v <= full}
    vals |= {heur_th, max(full // 2, 1), full}
    return sorted(v for v in vals if 1 <= v <= full)


def tune_stream_conv2d(x, w, b=None, *, stride=(1, 1), scale=None,
                       tiling=None, policy: ExecPolicy | None = None,
                       on_point=None) -> dict[str, int]:
    """Search the band height (``th``) of a streamed conv stage: each
    candidate re-bands the same stage, trading halo re-reads against
    launches. Caches and returns the winner."""
    from repro_torch.stream.executor import stream_conv2d
    pol = _no_autotune(policy)
    kh, sh = w.shape[2], stride[0]
    ho = (x.shape[2] - kh) // sh + 1
    heur = {"th": min(tiling.tile_rows, ho)}

    def launch(**tiles):
        pol_t = _with_tiles(pol, "stream_conv2d", tiles)
        return lambda: stream_conv2d(x, w, b, stride=tuple(stride),
                                     scale=scale, tiling=tiling,
                                     policy=pol_t)

    best = _descend({"th": _stream_axis(ho, heur["th"])}, heur, launch,
                    on_point=on_point)
    TUNING_CACHE.put("stream_conv2d", conv_signature(x.shape, w.shape,
                                                     stride),
                     x.dtype, best, platform=platform_key(x.device))
    return best


def tune_stream_fused_conv_block(x, w, b=None, *, stride=(1, 1),
                                 odd="raise", scale=None, tiling=None,
                                 policy: ExecPolicy | None = None,
                                 on_point=None) -> dict[str, int]:
    """Search the band height (``th``, in POOLED rows) of a streamed
    fused stage; caches and returns the winner."""
    from repro_torch.core.window import pool_output_size
    from repro_torch.stream.executor import stream_fused_conv_block
    pol = _no_autotune(policy)
    kh, sh = w.shape[2], stride[0]
    po = pool_output_size((x.shape[2] - kh) // sh + 1, odd)
    heur = {"th": min(tiling.tile_rows, po)}

    def launch(**tiles):
        pol_t = _with_tiles(pol, "stream_fused_conv_block", tiles)
        return lambda: stream_fused_conv_block(
            x, w, b, stride=tuple(stride), odd=odd, scale=scale,
            tiling=tiling, policy=pol_t)

    best = _descend({"th": _stream_axis(po, heur["th"])}, heur, launch,
                    on_point=on_point)
    TUNING_CACHE.put("stream_fused_conv_block",
                     conv_signature(x.shape, w.shape, stride), x.dtype,
                     best, platform=platform_key(x.device))
    return best


_TUNERS = {"conv2d": tune_conv2d, "fused_conv_block": tune_fused_conv_block,
           "qmatmul": tune_qmatmul,
           "stream_conv2d": tune_stream_conv2d,
           "stream_fused_conv_block": tune_stream_fused_conv_block}

# streamed stages dispatch band by band through the inner op family; the
# cuda-only tuning gate checks capability on the inner op with the
# stream-only kwargs stripped
_STREAM_INNER = {"stream_conv2d": "conv2d",
                 "stream_fused_conv_block": "fused_conv_block"}
_STREAM_KWARGS = ("tiling",)


def heuristic_tiles(op: str, *args, **kwargs) -> dict[str, int] | None:
    """The tiles a heuristic-only call of this signature resolves to;
    callers compare a tuned winner against it to tell a real move from
    "the heuristic won" (then nothing needs baking)."""
    if op == "qmatmul":
        m, k = args[0].shape
        return choose_qmatmul_blocks(m, k, args[1].shape[1])
    if op in _STREAM_INNER:
        tiling = kwargs.get("tiling")
        return None if tiling is None else {"th": int(tiling.tile_rows)}
    if op not in ("conv2d", "fused_conv_block"):
        return None
    return _conv_heuristic(args[0], args[1],
                           tuple(kwargs.get("stride", (1, 1))),
                           op == "fused_conv_block",
                           kwargs.get("odd", "raise"))


def _known_keys(op: str, dtype=torch.float32) -> tuple[str, ...]:
    """The launch keys a tuned entry of ``op`` on ``dtype`` operands may
    hold."""
    if op == "qmatmul":
        return _QMM_KEYS
    if op in _STREAM_INNER:
        return ("th",)
    return _CONV_S8_KEYS if dtype == torch.int8 else _CONV_KEYS


def signature_of(op: str, args, kwargs) -> tuple:
    """The tuning-cache shape signature of a tunable call."""
    if op == "qmatmul":
        m, k = args[0].shape
        return (m, k, args[1].shape[1])
    return conv_signature(args[0].shape, args[1].shape,
                          tuple(kwargs.get("stride", (1, 1))))


def ensure_tuned(op: str, *args, policy: ExecPolicy | None = None,
                 **kwargs) -> dict[str, int] | None:
    """The tuned tiles for this concrete call, measured on a cache miss.
    Returns None (and measures nothing) when the op family is not tuned
    or the call would not run the ``cuda`` kernel on a CUDA tensor."""
    tuner = _TUNERS.get(op)
    if tuner is None:
        return None
    x = args[0]
    hit = TUNING_CACHE.get(op, signature_of(op, args, kwargs), x.dtype,
                           platform_key(x.device))
    if fits_keys(hit, _known_keys(op, x.dtype)):
        return hit
    inner = _STREAM_INNER.get(op, op)
    ikw = {k: v for k, v in kwargs.items() if k not in _STREAM_KWARGS}
    if (x.device.type != "cuda"
            or resolved_backend(inner, *args, policy=policy,
                                **ikw) != "cuda"):
        return None
    return tuner(*args, policy=policy, **kwargs)
