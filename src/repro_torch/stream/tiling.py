"""Halo-aware spatial row-band tiling — the line buffer, lifted to tiles.

Port of ``repro.stream.tiling``, line for line: pure integer math, so a
port plan's band cuts equal the reference's node for node.

The paper's window buffer (§III.B.2, core.window.LineBufferSim) streams an
image through K·W registers: at any instant only ``K`` input rows are
resident, and adjacent windows share ``(K-1)/K`` of their data (Fig. 6).
This module is the same idea one level up (DESIGN.md §13): instead of one
row at a time, stream a *band* of output rows through the existing conv
kernels, so an arbitrarily large image runs in a fixed working set. A
band of ``rb`` output rows needs

    rows_in(rb) = (rb - 1)·sh + kh          input rows,

and adjacent bands overlap on

    halo = kh - sh                           input rows

— exactly the rows the line buffer keeps resident between windows
(``halo == kh - 1`` at stride 1, the "K-1 overlap" of the shift buffer;
``halo_rows(k, 1) / k == reuse_ratio(k)``). Because convolution is
windowed with VALID padding, every output element of a band is the same
dot product over the same η = N·Kh·Kw inputs as in the untiled call —
banding changes *which* elements a kernel launch computes, never the
terms of any sum. On the card the conv template's launch shape follows
H (``ops/tiling.py``), so a band may add a fp32 sum in another order than
the untiled launch; integer-valued sums (int8, qformat) stay exact.

Pool alignment (the fused family): ``fused_conv_block`` pools conv rows
in 2×2/2 pairs, so a tile cut at an odd conv row would make a pool window
straddle two bands. Fused tiling therefore counts ``tile_rows`` in
*pooled* rows — a band of ``pb`` pooled rows covers conv rows
[2·p0, 2·(p0+pb)), always an even-row cut — and only the image's own last
band can be ragged/odd (handled by the stage's ``odd`` mode, same as
untiled).

``tile_rows`` is the stream's band height, resolved under the op names
``stream_conv2d.th`` / ``stream_fused_conv_block.th``. It is not the conv
kernels' own ``conv2d.band`` / ``fused_conv_block.band``, which counts
the tile rows one CUDA block stages in shared memory within a launch.

This module is deliberately free of any ``repro_torch.graph`` import: the
IR references ``SpatialTiling`` by annotation only, the placement pass
lives in ``repro_torch.stream.passes``, and the executors in
``repro_torch.stream.executor``.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SpatialTiling", "STREAM_VMEM_BUDGET_BYTES", "halo_rows",
           "band_input_rows", "streamed_input_rows", "conv_bands",
           "pooled_bands", "choose_tile_rows", "image_working_set",
           "band_working_set", "check_tiling", "tiling_to_doc",
           "tiling_from_doc"]

# Per-image activation budget (bytes) above which a conv/fused stage is
# spatially tiled: input slab + full output for one image. The reference's
# value and name, kept so the band plans match it; it is the streaming
# threshold, not a kernel's shared-memory limit (ops.tiling.SMEM_MAX): a
# stage under 1 MiB (MNIST PaperCNN stages are ~50 KiB) runs untiled
# exactly as before, while a 224×224 multi-block stage streams through
# row bands.
STREAM_VMEM_BUDGET_BYTES = 1 * 1024 * 1024


def halo_rows(kh: int, sh: int = 1) -> int:
    """Input rows shared between vertically adjacent bands: kh - sh
    (clamped at 0 — stride ≥ kernel means no reuse). At stride 1 this is
    the paper's K-1 resident shift-buffer rows, and
    ``halo_rows(k, 1) / k == reuse_ratio(k)``."""
    return max(kh - sh, 0)


def band_input_rows(rb: int, kh: int, sh: int = 1) -> int:
    """Input rows a band of ``rb`` conv-output rows reads:
    (rb-1)·sh + kh — the vertical form of the line buffer's fill+stream
    span (``band_input_rows(1, k, 1) == k``; growing the band by one
    output row adds ``sh`` rows, the same marginal cost as one more
    line-buffer step down)."""
    if rb < 1:
        raise ValueError(f"band needs >= 1 output rows, got {rb}")
    return (rb - 1) * sh + kh


def streamed_input_rows(out_rows: int, tile_rows: int, kh: int,
                        sh: int = 1) -> int:
    """Total input rows DMA'd across all bands = untiled rows_in +
    (n_bands - 1)·halo — the halo re-read is the whole streaming
    overhead, and it vanishes as tile_rows grows (the tiler's analogue
    of the line buffer amortizing its fill latency)."""
    total = 0
    for _, _, lo, hi in _bands(out_rows, tile_rows, kh, sh):
        total += hi - lo
    return total


def _bands(out_rows: int, tile_rows: int, kh: int, sh: int
           ) -> list[tuple[int, int, int, int]]:
    """(out_lo, out_hi, in_lo, in_hi) per band over conv-output rows."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    bands = []
    for lo in range(0, out_rows, tile_rows):
        hi = min(lo + tile_rows, out_rows)
        bands.append((lo, hi, lo * sh, (hi - 1) * sh + kh))
    return bands


def conv_bands(ho: int, tile_rows: int, kh: int, sh: int = 1
               ) -> list[tuple[int, int, int, int]]:
    """Band plan for a plain conv stage: ``tile_rows`` counts conv-output
    rows. Bands partition [0, ho); input ranges overlap by ``halo_rows``."""
    return _bands(ho, tile_rows, kh, sh)


def pooled_bands(po: int, tile_rows: int, kh: int, sh: int, h: int
                 ) -> list[tuple[int, int, int, int]]:
    """Band plan for a fused conv+relu+pool stage: ``tile_rows`` counts
    *pooled* output rows, so every interior cut lands on an even conv row
    and no 2×2 pool window ever straddles bands. The input range of the
    last band is clamped to the image (an odd-``ho`` image under
    odd='drop'/'pad' leaves its ragged conv row to the per-band op, which
    applies the exact same odd handling the untiled op would)."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    bands = []
    for p0 in range(0, po, tile_rows):
        p1 = min(p0 + tile_rows, po)
        in_lo = 2 * p0 * sh
        in_hi = min((2 * p1 - 1) * sh + kh, h)
        bands.append((p0, p1, in_lo, in_hi))
    return bands


def image_working_set(n: int, h: int, w: int, m: int, oh: int, ow: int,
                      itemsize: int) -> int:
    """Per-image stage footprint (bytes): full input + full output. The
    placement pass compares this against the budget — when it does not
    fit, the stage streams."""
    return (n * h * w + m * oh * ow) * itemsize


def band_working_set(n: int, w: int, m: int, wo: int, tile_rows: int,
                     kh: int, sh: int, itemsize: int, *,
                     pooled: bool) -> int:
    """Per-image footprint (bytes) of ONE band: input slab + conv-row
    output (+ the pooled output for the fused family). This is the fixed
    working set the stream executor cycles through — it depends on
    ``tile_rows`` and W, never on H."""
    rb = 2 * tile_rows if pooled else tile_rows
    rows_in = band_input_rows(rb, kh, sh)
    size = n * rows_in * w + m * rb * wo
    if pooled:
        size += m * tile_rows * (wo // 2)
    return size * itemsize


def choose_tile_rows(n: int, h: int, w: int, m: int, kh: int, kw: int,
                     stride: tuple[int, int], itemsize: int, *,
                     pooled: bool,
                     budget: int = STREAM_VMEM_BUDGET_BYTES) -> int:
    """Largest band (conv rows, or pooled rows when ``pooled``) whose
    per-image working set fits ``budget``; at least 1 — streaming is
    best-effort, a single-row band is the floor the line buffer itself
    guarantees."""
    sh, sw = stride
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    full = max(ho // 2, 1) if pooled else ho
    best = 1
    for tr in range(1, full + 1):
        if band_working_set(n, w, m, wo, tr, kh, sh, itemsize,
                            pooled=pooled) <= budget:
            best = tr
        else:
            break
    return best


def check_tiling(tiling: "SpatialTiling", *, fused: bool,
                 in_shape: tuple[int, int, int, int],
                 w_shape: tuple[int, int, int, int],
                 stride: tuple[int, int], itemsize: int
                 ) -> list[tuple[str, str]]:
    """Streaming-legality checks for one tiled stage, as (code, message)
    pairs — the plan verifier's ``stream-*`` family lives here so the
    band math and its invariants stay in one module; its caller is
    ``repro_torch.analysis.verifier._check_streaming``.

    Checks: halo accounting matches K/stride (``stream-halo``); the
    pooled flag matches the stage family, so no 2×2 pool window can
    straddle a band cut (``stream-pool-straddle``); a multi-row band's
    working set fits the stamped budget — a single-row band is the
    best-effort floor and is always legal (``stream-budget``); and the
    re-derived band plan partitions the output rows exactly
    (``stream-coverage``).
    """
    out: list[tuple[str, str]] = []
    _, n, h, w = in_shape
    m, _, kh, kw = w_shape
    sh, sw = stride
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1

    want_halo = halo_rows(kh, sh)
    if tiling.halo != want_halo:
        out.append(("stream-halo",
                    f"tiling {tiling} records halo={tiling.halo} but "
                    f"kh={kh}, sh={sh} gives halo={want_halo} — bands "
                    f"would drop or double-read input rows"))
    if tiling.pooled != fused:
        kind = "fused conv+pool" if fused else "plain conv"
        why = ("odd conv rows, so 2x2 pool windows straddle bands"
               if fused else "pooled rows the stage never produces")
        out.append(("stream-pool-straddle",
                    f"tiling {tiling} has pooled={tiling.pooled} on a "
                    f"{kind} stage — band cuts land on {why}"))
        return out  # band math below assumes the right row unit

    try:
        if fused:
            po = max(ho // 2, 1)
            bands = pooled_bands(po, tiling.tile_rows, kh, sh, h)
            total = po
        else:
            bands = conv_bands(ho, tiling.tile_rows, kh, sh)
            total = ho
    except ValueError as e:
        out.append(("stream-coverage", f"band plan invalid: {e}"))
        return out
    covered = 0
    for lo, hi, _, _ in bands:
        if lo != covered or hi <= lo:
            out.append(("stream-coverage",
                        f"band [{lo}, {hi}) does not continue the "
                        f"partition at row {covered}"))
            return out
        covered = hi
    if covered != total:
        out.append(("stream-coverage",
                    f"bands cover {covered} of {total} output rows"))

    if tiling.tile_rows > 1:
        ws = band_working_set(n, w, m, wo, tiling.tile_rows, kh, sh,
                              itemsize, pooled=fused)
        if ws > tiling.budget_bytes:
            out.append(("stream-budget",
                        f"band working set {ws} B exceeds the stamped "
                        f"budget {tiling.budget_bytes} B "
                        f"(tile_rows={tiling.tile_rows}; shrink the band)"))
    return out


@dataclass(frozen=True)
class SpatialTiling:
    """The streaming spec stamped on a conv/fused IR node (DESIGN.md §13).

    ``tile_rows`` counts conv-output rows for a plain conv stage and
    *pooled* output rows for a fused stage (``pooled=True``) — the pool
    alignment rule above. ``halo`` records kh - sh for introspection and
    the halo-accounting tests; ``budget_bytes`` is the per-image budget
    the placement pass applied, which the artifact fingerprint covers
    (``repro_torch.artifact.fingerprint``), as the reference's does."""

    tile_rows: int
    halo: int
    pooled: bool = False
    budget_bytes: int = STREAM_VMEM_BUDGET_BYTES

    def __post_init__(self):
        if self.tile_rows < 1:
            raise ValueError(f"tile_rows must be >= 1, got {self.tile_rows}")
        if self.halo < 0:
            raise ValueError(f"halo must be >= 0, got {self.halo}")

    def __str__(self) -> str:
        kind = "pooled" if self.pooled else "rows"
        return f"{self.tile_rows}{kind[0]} halo={self.halo}"


def tiling_to_doc(spec: SpatialTiling | None) -> dict | None:
    if spec is None:
        return None
    return {"tile_rows": int(spec.tile_rows), "halo": int(spec.halo),
            "pooled": bool(spec.pooled),
            "budget_bytes": int(spec.budget_bytes)}


def tiling_from_doc(doc: dict | None) -> SpatialTiling | None:
    if doc is None:
        return None
    return SpatialTiling(tile_rows=int(doc["tile_rows"]),
                         halo=int(doc["halo"]),
                         pooled=bool(doc["pooled"]),
                         budget_bytes=int(doc["budget_bytes"]))
