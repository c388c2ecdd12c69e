"""Launch-shape heuristics for the hand-written CUDA kernels.

The JAX package sizes Pallas blocks against a TPU VMEM budget. Here the
constraint is filling an H100's 132 streaming multiprocessors with whole
32-thread warps, inside a block's shared memory.

  * ``conv_window`` and ``qmatmul`` compute one output element per
    thread and mask their own ragged edge, so their one launch parameter
    is the block size: 256 threads (8 warps) once the grid has at least
    one such block per SM, below that the smallest warp multiple that
    spreads the outputs over as many SMs as they fill.
  * ``fused_cwp`` (``choose_fused_blocks``): a block owns ``ipb``
    images, a group of ``cpb`` output channels and a band of ``band``
    pooled rows, staged in shared memory; a thread holds one pooled
    output × 4 channels, and ``split`` adjacent lanes share it along
    the contraction where the outputs alone cannot fill the card.
  * the addition tree (``choose_tree_blocks``): ``rows`` rows a block;
    rows up to ``short_eta`` wide take one thread each, wider rows half
    a warp or a warp each (``row_lanes``).

Resolution order: ``ExecPolicy.tiling`` overrides (bare ``<key>`` or
namespaced ``<op>.<key>``) > these heuristics; ``fused_tiles`` and
``tree_tiles`` resolve and check what a launch takes. The JAX
``TuningCache`` waits for the measured autotuner (ROADMAP §A.7).
"""
from __future__ import annotations

from typing import Mapping

__all__ = ["H100_SMS", "WARP", "MAX_THREADS", "SMEM_MAX", "TREE_MAX_ETA",
           "TREE_SHORT_ETA", "CONV_CHANNELS", "launch_threads",
           "choose_conv_blocks", "choose_fused_blocks", "fused_ld",
           "fused_smem_bytes", "fused_tiles", "choose_qmatmul_blocks",
           "choose_tree_blocks", "tree_smem_bytes", "tree_tiles",
           "tile_params", "block_threads"]

H100_SMS = 132
WARP = 32
MAX_THREADS = 256
SMEM_MAX = 232_448              # dynamic shared memory a block may opt in to
# the widest row the addition tree takes: the op's contract, held on the
# card at the cap itself. The kernel's shared memory would allow more
# (a row's slice is ⌈η/16⌉ floats); the cap stays where the tests pin it.
TREE_MAX_ETA = 6144
TREE_SHORT_ETA = 32             # rows up to this wide: one thread a row
CONV_CHANNELS = 4               # output channels in a fused_cwp thread
# fused_cwp's heuristic keeps a block's staged band and weights under this
# (two blocks an SM); anything up to SMEM_MAX is staged when asked for
FUSED_SMEM_TARGET = SMEM_MAX // 2
FUSED_MAX_THREADS = 320         # a block of several images: 10 warps


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_threads(outputs: int, sms: int = H100_SMS) -> int:
    """Threads per block for a one-thread-per-output kernel."""
    per_sm = _cdiv(max(outputs, 1), sms)
    return min(MAX_THREADS, max(WARP, _cdiv(per_sm, WARP) * WARP))


def choose_conv_blocks(bsz: int, m: int, ho: int, wo: int) -> dict[str, int]:
    """conv_window: one thread per (b, m, oh, ow) conv output."""
    return {"threads": launch_threads(bsz * m * ho * wo)}


def fused_ld(h: int, w: int, kh: int, kw: int, sh: int, sw: int) -> int:
    """Row stride of a staged input band, in floats: W, padded (by < 16)
    so that one pooled row of 2×2 windows ends where the next begins in
    the 32 banks, (2·sh·ld − 2·sw·Qo) ≡ 0 (mod 32), when a row of them
    spans fewer than 32 words; else W."""
    qo = ((w - kw) // sw + 1) // 2
    if 2 * sw * qo < 32:
        for ld in range(w, w + 16):
            if (2 * sh * ld - 2 * sw * qo) % 32 == 0:
                return ld
    return w


def fused_smem_bytes(n: int, h: int, w: int, kh: int, kw: int, sh: int,
                     sw: int, cpb: int, band: int, ipb: int) -> int:
    """Shared memory of one staged fused_cwp block: the group's weights
    (cpb × η) and the input bands (ipb × N × the band's rows × ld), fp32."""
    rows = min((2 * band - 1) * sh + kh, h)
    return 4 * (n * kh * kw * cpb
                + ipb * n * rows * fused_ld(h, w, kh, kw, sh, sw))


def choose_fused_blocks(bsz: int, n: int, h: int, w: int, m: int, kh: int,
                        kw: int, sh: int, sw: int) -> dict[str, int]:
    """fused_cwp: ``split`` is the least power of two (≤ 32 and ≤ the
    N·Kh kernel rows it divides among lanes) that gives 132 SMs 256
    threads each. The block starts at one whole image and every channel
    group and halves its band, then its channel groups, until it holds
    at most 256 threads, the grid at least one block an SM, and the
    staged slab ``FUSED_SMEM_TARGET``. Then it takes more images
    (``ipb``), so the weights are staged once for several, while the grid
    keeps a block an SM, the slab ``FUSED_SMEM_TARGET``, and the block at
    most two rounds of ``FUSED_MAX_THREADS``."""
    po = max((h - kh) // sh + 1, 0) // 2
    qo = max((w - kw) // sw + 1, 0) // 2
    po, qo = max(po, 1), max(qo, 1)
    groups = _cdiv(m, CONV_CHANNELS)
    tiles = bsz * groups * po * qo
    split = 1
    while (split < WARP and 2 * split <= n * kh
           and tiles * split < H100_SMS * MAX_THREADS):
        split *= 2

    def smem(cg, band, ipb):
        return fused_smem_bytes(n, h, w, kh, kw, sh, sw, CONV_CHANNELS * cg,
                                band, ipb)

    cg, band = groups, po
    while band > 1 or cg > 1:
        blocks = bsz * _cdiv(groups, cg) * _cdiv(po, band)
        if (cg * band * qo * split <= MAX_THREADS and blocks >= H100_SMS
                and smem(cg, band, 1) <= FUSED_SMEM_TARGET):
            break
        if band > 1:
            band = _cdiv(band, 2)
        else:
            cg = _cdiv(cg, 2)
    per_img = cg * band * qo * split
    ipb = 1
    while ((ipb + 1) * per_img <= 2 * FUSED_MAX_THREADS
           and _cdiv(bsz, ipb + 1) * _cdiv(groups, cg) * _cdiv(po, band)
           >= H100_SMS
           and smem(cg, band, ipb + 1) <= FUSED_SMEM_TARGET):
        ipb += 1
    threads = min(MAX_THREADS if ipb == 1 else FUSED_MAX_THREADS,
                  _cdiv(ipb * per_img, WARP) * WARP)
    return {"threads": threads, "cpb": CONV_CHANNELS * cg, "band": band,
            "split": split, "ipb": ipb}


def fused_tiles(bsz: int, n: int, h: int, w: int, m: int, kh: int, kw: int,
                sh: int, sw: int,
                overrides: Mapping[str, int] | None = None
                ) -> dict[str, int]:
    """``choose_fused_blocks`` with ``fused_conv_block`` overrides
    applied and checked, plus the staged row stride ``ld`` and ``smem``,
    the staged slab's bytes: 0 where it would exceed ``SMEM_MAX``, and
    the kernel then reads device memory instead."""
    defaults = choose_fused_blocks(bsz, n, h, w, m, kh, kw, sh, sw)
    t = tile_params("fused_conv_block", defaults, overrides)
    t["threads"] = block_threads("fused_conv_block", defaults, overrides)
    if t["cpb"] < CONV_CHANNELS or t["cpb"] % CONV_CHANNELS:
        raise ValueError(f"fused_conv_block: cpb {t['cpb']} must be a "
                         f"positive multiple of {CONV_CHANNELS}")
    for key in ("band", "ipb"):
        if t[key] < 1:
            raise ValueError(f"fused_conv_block: {key} {t[key]} must be "
                             f">= 1")
    if t["split"] not in (1, 2, 4, 8, 16, WARP):
        raise ValueError(f"fused_conv_block: split {t['split']} must be a "
                         f"power of two up to {WARP}")
    po = ((h - kh) // sh + 1) // 2
    grid = (_cdiv(bsz, t["ipb"]) * _cdiv(m, t["cpb"])
            * _cdiv(po, t["band"]))
    if grid > 2 ** 31 - 1:
        raise ValueError(f"fused_conv_block: {grid} blocks; CUDA's grid "
                         f"holds at most 2**31 - 1")
    t["ld"] = fused_ld(h, w, kh, kw, sh, sw)
    smem = fused_smem_bytes(n, h, w, kh, kw, sh, sw, t["cpb"], t["band"],
                            t["ipb"])
    t["smem"] = smem if smem <= SMEM_MAX else 0
    return t


def choose_qmatmul_blocks(m: int, n: int) -> dict[str, int]:
    """qmatmul: one thread per (row, column) of the (M, N) output."""
    return {"threads": launch_threads(m * n)}


def choose_tree_blocks(r: int, eta: int) -> dict[str, int]:
    """addtree: rows up to ``short_eta`` wide take a thread each, 128
    rows a block of 128 threads (measured 9% ahead of 256 at the paper's
    conv1, B = 1024). Wider rows take 256 threads and ``row_lanes`` lanes
    a row: a half-warp (16 rows a block) while one row a half-warp of
    every SM's 2,048 threads covers them, so the whole matrix is in
    flight at once; a whole warp (8 rows) on matrices many times that."""
    if max(eta, 1) <= TREE_SHORT_ETA:
        return {"threads": 128, "rows": 128, "short_eta": TREE_SHORT_ETA,
                "row_lanes": WARP}
    lanes = 16 if r <= H100_SMS * 2048 // 16 else WARP
    return {"threads": MAX_THREADS, "rows": MAX_THREADS // lanes,
            "short_eta": TREE_SHORT_ETA, "row_lanes": lanes}


def tree_smem_bytes(eta: int, threads: int, rows: int, short_eta: int,
                    row_lanes: int) -> int:
    """Shared memory of one addtree block: a tile of rows at an odd word
    stride (short rows), or a ⌈η/16⌉-float slice a row in flight (long)."""
    if eta <= short_eta:
        return 4 * rows * (eta | 1)
    return 4 * (threads // row_lanes) * _cdiv(eta, 16)


def tree_tiles(r: int, eta: int,
               overrides: Mapping[str, int] | None = None
               ) -> dict[str, int]:
    """``choose_tree_blocks`` with ``tree_reduce_sum`` overrides applied
    and checked, plus ``smem``."""
    defaults = choose_tree_blocks(r, eta)
    t = tile_params("tree_reduce_sum", defaults, overrides)
    t["threads"] = block_threads("tree_reduce_sum", defaults, overrides)
    if t["rows"] < 1:
        raise ValueError(f"tree_reduce_sum: rows {t['rows']} must be >= 1")
    if t["row_lanes"] not in (16, WARP):
        raise ValueError(f"tree_reduce_sum: row_lanes {t['row_lanes']} "
                         f"must be 16 or {WARP}")
    t["smem"] = tree_smem_bytes(eta, t["threads"], t["rows"],
                                t["short_eta"], t["row_lanes"])
    if t["smem"] > SMEM_MAX:
        raise ValueError(f"tree_reduce_sum: {t['smem']} bytes of shared "
                         f"memory a block; at most {SMEM_MAX}")
    return t


def tile_params(op: str, defaults: Mapping[str, int],
                overrides: Mapping[str, int] | None = None
                ) -> dict[str, int]:
    """Heuristic ``defaults`` with ``overrides`` applied: bare keys apply
    to any op that knows them, ``"<op>.<key>"`` keys to one op and win."""
    merged = dict(defaults)
    ov = dict(overrides or {})
    for k, v in ov.items():
        if "." not in k and k in defaults:
            merged[k] = int(v)
    for k, v in ov.items():
        name = k.split(".", 1)
        if len(name) == 2 and name[0] == op and name[1] in defaults:
            merged[name[1]] = int(v)
    return merged


def block_threads(op: str, defaults: Mapping[str, int],
                  overrides: Mapping[str, int] | None = None) -> int:
    """The resolved ``threads`` of ``tile_params``, checked against what
    a launch takes: whole warps, at most 1024 threads."""
    t = tile_params(op, defaults, overrides)["threads"]
    if t < WARP or t > 1024 or t % WARP:
        raise ValueError(f"{op}: threads per block {t} must be a multiple "
                         f"of {WARP} in [{WARP}, 1024]")
    return t
