"""Launch-shape heuristics for the hand-written CUDA kernels.

The JAX package sizes Pallas blocks against a TPU VMEM budget. Here the
constraint is filling an H100's 132 streaming multiprocessors with whole
32-thread warps, inside a block's shared memory.

  * ``conv_window`` and ``fused_cwp`` (one template, ``pool`` tells them
    apart), two routes. fp32 operands (``choose_fused_blocks``): a block
    owns ``ipb`` images, a group of ``cpb`` output channels and a band of
    ``band`` tile rows, staged in shared memory; a thread holds a tile of
    2×2 conv points × 4 channels (one pooled output under ``pool``), and
    ``split`` adjacent lanes share it along the contraction where the
    tiles alone cannot fill the card. int8 codes
    (``choose_conv_s8_blocks``): a block of 8 warps owns ``cpb`` output
    channels (8 an MMA column tile) and ``items`` items (an image's band
    of ``band`` tile rows), each warp taking 8 tiles; the overrides share
    the two namespaces below, and the cache keys the route by its
    dtype.
  * ``qmatmul`` (``choose_qmatmul_blocks``): ``body`` 1, tensor-core
    tiles of ``tile_m`` × 128 outputs over ``ksplit`` bytes of K, from 8
    rows and 64 columns; else ``body`` 0, split-K weight streaming:
    ``tile_m`` rows, ``tile_n`` columns and a ``ksplit``-row slice of K a
    block, K split until the grid fills the card twice over. Each body
    has only the keys it varies.
  * the addition tree (``choose_tree_blocks``): ``rows`` rows a block;
    rows up to ``short_eta`` wide take one thread each, wider rows half
    a warp or a warp each (``row_lanes``).

Resolution order, as in the reference: ``ExecPolicy.tiling`` overrides
(bare ``<key>`` or namespaced ``<op>.<key>``: ``conv2d.``,
``fused_conv_block.``, ``qmatmul.``, ``tree_reduce_sum.``) > a
``TUNING_CACHE`` entry for (op, shape signature, dtype, platform) > these
heuristics; ``fused_tiles``, ``qmatmul_tiles`` and ``tree_tiles`` resolve
and check what a launch takes. The measured autotuner
(``repro_torch.ops.autotune``) writes the cache; the addition tree is not
tuned, as in the reference, so its tiles skip the cache.

The cache persists as versioned JSON (``SCHEMA_VERSION``):
``TUNING_CACHE.save``/``.load``, or ``--tuning-cache`` on the launcher.
A corrupt or unknown-version file warns and loads nothing, so the
heuristics stay in charge. Entries are keyed by platform: the card's name and compute
capability (``platform_key``), ``"cpu"`` on the CPU, so tiles measured on
one card never steer another.
"""
from __future__ import annotations

import functools
import json
import pathlib
import warnings
from typing import Mapping

__all__ = ["H100_SMS", "WARP", "MAX_THREADS", "SMEM_MAX", "TREE_MAX_ETA",
           "TREE_SHORT_ETA", "CONV_CHANNELS", "CONV_S8_CHANNELS",
           "CONV_S8_MAX_CPB", "QMATMUL_TC_MIN_M",
           "QMATMUL_TC_MIN_N", "choose_fused_blocks", "fused_ld",
           "fused_smem_bytes", "fused_tiles", "conv_s8_smem_bytes",
           "choose_conv_s8_blocks", "conv_s8_tiles", "qmatmul_body",
           "choose_qmatmul_blocks", "qmatmul_smem_bytes",
           "qmatmul_scratch_bytes", "qmatmul_tiles", "choose_tree_blocks",
           "tree_smem_bytes", "tree_tiles", "tile_params", "fits_keys",
           "block_threads", "conv_signature", "platform_key", "TuningCache",
           "TUNING_CACHE", "SCHEMA_VERSION"]

H100_SMS = 132
WARP = 32
MAX_THREADS = 256
SMEM_MAX = 232_448              # dynamic shared memory a block may opt in to
# the widest row the addition tree takes: the op's contract, held on the
# card at the cap itself. The kernel's shared memory would allow more
# (a row's slice is ⌈η/16⌉ floats); the cap stays where the tests pin it.
TREE_MAX_ETA = 6144
TREE_SHORT_ETA = 32             # rows up to this wide: one thread a row
CONV_CHANNELS = 4               # output channels in a conv thread's tile
# the conv heuristic keeps a block's staged band and weights under this
# (two blocks an SM); anything up to SMEM_MAX is staged when asked for
FUSED_SMEM_TARGET = SMEM_MAX // 2
FUSED_MAX_THREADS = 320         # a block of several images: 10 warps
# where lanes split a tile's contraction, they aim at this many threads an
# SM, and a block may hold this many (the fp32 route's long, latency-bound
# FMA chains at highres_cnn's blocks 2 and 3, B = 8, ran fastest there)
FUSED_SPLIT_THREADS = 512
# a block takes more images only while the grid keeps this many blocks
FUSED_IPB_BLOCKS = 3 * H100_SMS // 2
# the conv template's int8 route: output channels an MMA column tile, and
# at most 4 of them a block (cpb 32); a block is 8 warps (S8_WARPS in
# csrc/conv_tile.cuh)
CONV_S8_CHANNELS = 8
CONV_S8_MAX_CPB = 32
# qmatmul: the tensor-core body (1) takes M >= 8 and N >= 64; below
# either, the split-K weight-streaming body (0). Measured on an H100 at
# two LM weights (scripts/torch_kernel_probe.py --sweep): streaming ahead
# at M = 4, even at M = 8, the tiles ahead from M = 12
QMATMUL_TC_MIN_M = 8
QMATMUL_TC_MIN_N = 64
QMATMUL_TC_BN = 128             # body 1: output columns a block
QMATMUL_TC_BK = 64              # body 1: K bytes a cp.async stage
QMATMUL_TC_LD = QMATMUL_TC_BK + 16  # body 1: staged row stride (bytes)
QMATMUL_TC_STAGES = 4           # body 1: cp.async stages in the ring
QMATMUL_STREAM_MIN_N = 16       # body 0: the narrowest column slice
QMATMUL_XSLICE = 48 * 1024      # body 0: bytes of x a block stages
QMATMUL_SPLIT_BYTES = 32 * 1024     # body 0: weights this large split K
# version of the persisted tuning-cache JSON schema; other versions fall
# back to the heuristics on load
SCHEMA_VERSION = 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _conv_grid(h: int, w: int, kh: int, kw: int, sh: int, sw: int,
               pool: bool, odd: str = "raise") -> tuple[int, int]:
    """(Po, Qo): the tile rows and columns of a conv's output, one tile
    being 2×2 conv points; pooled, only whole tiles (an odd last row or
    column dropped), else, or pooled under ``odd='pad'``, a ragged last
    row or column too."""
    ho = max((h - kh) // sh + 1, 0)
    wo = max((w - kw) // sw + 1, 0)
    if pool and odd != "pad":
        return ho // 2, wo // 2
    return _cdiv(ho, 2), _cdiv(wo, 2)


def fused_ld(h: int, w: int, kh: int, kw: int, sh: int, sw: int,
             pool: bool = True, odd: str = "raise") -> int:
    """Row stride of a staged input band, in floats: W, padded (by < 16)
    so that one row of 2×2 tiles ends where the next begins in the 32
    banks, (2·sh·ld − 2·sw·Qo) ≡ 0 (mod 32), when a row of them spans
    fewer than 32 words; else W."""
    qo = _conv_grid(h, w, kh, kw, sh, sw, pool, odd)[1]
    if 2 * sw * qo < 32:
        for ld in range(w, w + 16):
            if (2 * sh * ld - 2 * sw * qo) % 32 == 0:
                return ld
    return w


def fused_smem_bytes(n: int, h: int, w: int, kh: int, kw: int, sh: int,
                     sw: int, cpb: int, band: int, ipb: int,
                     pool: bool = True, odd: str = "raise") -> int:
    """Shared memory of one staged conv block: the group's weights
    (η rows of cpb + 4 floats: the 4 past cpb keep the transposing copy
    free of bank conflicts) and the input bands (ipb × N × the band's
    rows × ld), fp32.
    A band's rows are its tiles' windows, at most the input's H: a
    ragged last tile row reads its first row's windows again, so the
    kernel clamps the band there too and reads nothing past H."""
    rows = min((2 * band - 1) * sh + kh, h)
    return 4 * (n * kh * kw * (cpb + CONV_CHANNELS)
                + ipb * n * rows * fused_ld(h, w, kh, kw, sh, sw, pool, odd))


def choose_fused_blocks(bsz: int, n: int, h: int, w: int, m: int, kh: int,
                        kw: int, sh: int, sw: int, pool: bool = True,
                        odd: str = "raise") -> dict[str, int]:
    """The conv tile template: ``fused_cwp`` with ``pool``, else
    ``conv_window``, whose tiles cover a ragged last row and column of
    an odd output (as pooled ones do under ``odd='pad'``). ``split`` is
    the least power of two (≤ 32 and ≤ the N·Kh kernel rows it divides
    among lanes) that gives 132 SMs ``FUSED_SPLIT_THREADS`` threads
    each. The block starts at one whole image and every channel group and
    halves its band, then its channel groups, until it holds at most 256
    threads (``FUSED_SPLIT_THREADS`` where lanes split), the grid at
    least one block an SM, and the staged slab ``FUSED_SMEM_TARGET``.
    Then it takes more images (``ipb``), so the weights are staged once
    for several, while the grid keeps ``FUSED_IPB_BLOCKS`` blocks (1.5 an
    SM: at highres_cnn's 224-wide bands, B = 8, two images a block ran
    18% behind one on an H100), the slab ``FUSED_SMEM_TARGET``, and the
    block at most two rounds of ``FUSED_MAX_THREADS``."""
    po, qo = _conv_grid(h, w, kh, kw, sh, sw, pool, odd)
    po, qo = max(po, 1), max(qo, 1)
    groups = _cdiv(m, CONV_CHANNELS)
    tiles = bsz * groups * po * qo
    split = 1
    while (split < WARP and 2 * split <= n * kh
           and tiles * split < H100_SMS * FUSED_SPLIT_THREADS):
        split *= 2
    cap = FUSED_SPLIT_THREADS if split > 1 else MAX_THREADS

    def smem(cg, band, ipb):
        return fused_smem_bytes(n, h, w, kh, kw, sh, sw, CONV_CHANNELS * cg,
                                band, ipb, pool, odd)

    cg, band = groups, po
    while band > 1 or cg > 1:
        blocks = bsz * _cdiv(groups, cg) * _cdiv(po, band)
        if (cg * band * qo * split <= cap and blocks >= H100_SMS
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
           >= FUSED_IPB_BLOCKS
           and smem(cg, band, ipb + 1) <= FUSED_SMEM_TARGET):
        ipb += 1
    threads = min(cap if ipb == 1 else FUSED_MAX_THREADS,
                  _cdiv(ipb * per_img, WARP) * WARP)
    return {"threads": threads, "cpb": CONV_CHANNELS * cg, "band": band,
            "split": split, "ipb": ipb}


def fused_tiles(bsz: int, n: int, h: int, w: int, m: int, kh: int, kw: int,
                sh: int, sw: int,
                overrides: Mapping[str, int] | None = None,
                pool: bool = True, odd: str = "raise",
                platform: str | None = None) -> dict[str, int]:
    """``choose_fused_blocks`` with the op's overrides applied and
    checked (``fused_conv_block.<key>`` with ``pool``, ``conv2d.<key>``
    without), plus the staged row stride ``ld`` and ``smem``, the staged
    slab's bytes: 0 where it would exceed ``SMEM_MAX``, and the kernel
    then reads device memory instead. ``odd`` is the pool's odd mode
    (``core.window.pool_output_size``): ``'pad'`` adds a ragged last tile
    row or column where the conv map is odd. A ``TUNING_CACHE`` entry
    of this (op, shape, float32, ``platform``) sits between the
    overrides and the heuristic."""
    op = "fused_conv_block" if pool else "conv2d"
    defaults = choose_fused_blocks(bsz, n, h, w, m, kh, kw, sh, sw, pool,
                                   odd)
    key = {"signature": (bsz, n, h, w, m, kh, kw, sh, sw),
           "platform": platform}
    t = tile_params(op, defaults, overrides, **key)
    t["threads"] = block_threads(op, defaults, overrides, **key)
    if t["cpb"] < CONV_CHANNELS or t["cpb"] % CONV_CHANNELS:
        raise ValueError(f"{op}: cpb {t['cpb']} must be a positive "
                         f"multiple of {CONV_CHANNELS}")
    for key in ("band", "ipb"):
        if t[key] < 1:
            raise ValueError(f"{op}: {key} {t[key]} must be >= 1")
    if t["split"] not in (1, 2, 4, 8, 16, WARP):
        raise ValueError(f"{op}: split {t['split']} must be a power of "
                         f"two up to {WARP}")
    po = _conv_grid(h, w, kh, kw, sh, sw, pool, odd)[0]
    grid = (_cdiv(bsz, t["ipb"]) * _cdiv(m, t["cpb"])
            * _cdiv(po, t["band"]))
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{op}: {grid} blocks; CUDA's grid holds at most "
                         f"2**31 - 1")
    t["ld"] = fused_ld(h, w, kh, kw, sh, sw, pool, odd)
    smem = fused_smem_bytes(n, h, w, kh, kw, sh, sw, t["cpb"], t["band"],
                            t["ipb"], pool, odd)
    t["smem"] = smem if smem <= SMEM_MAX else 0
    return t


def conv_s8_smem_bytes(n: int, h: int, w: int, kh: int, kw: int, sh: int,
                       cpb: int, band: int, items: int) -> int:
    """Shared memory of one int8-route conv block (``s8_smem`` in
    ``csrc/conv_tile.cuh``): the expanded weights (cpb rows of the padded
    depth η' + 16 bytes; η' = 32·⌈N·Kh·Kw'/32⌉, Kw' = 4·⌈Kw/4⌉), the run
    table (8 bytes a 4-byte run of η'), the raw weights (cpb·η + 4), the
    slab offsets (4 bytes a channel of each item) and ``items`` slabs of N
    channel bands (each the band's rows × W + 19 bytes: a shift of up to
    3 and the reads past a run's last real k), every part rounded to 16.
    The raw weights' bytes, dead once expanded, then hold the int32
    partial sums of warps that share a unit's depth: at least 512 × cpb."""
    kwp = _cdiv(kw, 4) * 4
    etap = _cdiv(n * kh * kwp, 32) * 32
    rows = min((2 * band - 1) * sh + kh, h)
    cst = _cdiv(rows * w + 19, 16) * 16
    raw = max(_cdiv(cpb * n * kh * kw + 4, 16) * 16, 512 * cpb)
    return (cpb * (etap + 16) + 2 * etap + raw + _cdiv(4 * items * n, 16) * 16
            + items * n * cst)


def choose_conv_s8_blocks(bsz: int, n: int, h: int, w: int, m: int,
                          kh: int, kw: int, sh: int, sw: int,
                          pool: bool = True, odd: str = "raise"
                          ) -> dict[str, int]:
    """The int8 route of the conv template (both kernels; ``pool`` as in
    ``choose_fused_blocks``). A block owns ``cpb`` output channels (8 an
    MMA column tile, up to 32) and ``items`` items, an item being one
    image's band of ``band`` tile rows; its 8 warps (which also stage the
    slabs and expand the weights) take 8 tiles (a unit) × all the block's
    channels each, and share a unit's depth where a block has fewer units
    than warps.

    From whole images and ⌈M/8⌉ column tiles (at most 4), the band halves
    while the blocks number under 132 or the slab exceeds
    ``FUSED_SMEM_TARGET``, then the column tiles halve while the blocks
    number under 132. Where the blocks are under 4 × 132, the band halves
    on while an item has over 8 units (more, smaller blocks), and then
    doubles while an item has under 8 units, the doubled one at most 8,
    and the blocks stay at least 66 (fewer blocks, each warp a unit). A
    block takes items while they keep its units at most 8 and either the
    blocks stay at least 132 or the depth (η'/32 k-steps) is too shallow
    for the warps to share it; a pooled block of one item takes 2 where
    one-item blocks number at least 4 × 132 (an unpooled one is bound by
    its fp32 output's bytes). Each rule follows ``scripts/torch_kernel_probe.py --conv-sweep`` on an
    H100 at the main path's shapes."""
    po, qo = _conv_grid(h, w, kh, kw, sh, sw, pool, odd)
    po, qo = max(po, 1), max(qo, 1)
    nt = min(CONV_S8_MAX_CPB // CONV_S8_CHANNELS, _cdiv(m, CONV_S8_CHANNELS))
    ksteps = _cdiv(n * kh * _cdiv(kw, 4) * 4, 32)

    def smem(nt, band, items):
        return conv_s8_smem_bytes(n, h, w, kh, kw, sh,
                                  CONV_S8_CHANNELS * nt, band, items)

    def blocks(nt, band, items):
        return (_cdiv(bsz * _cdiv(po, band), items)
                * _cdiv(m, CONV_S8_CHANNELS * nt))

    def upi(band):
        return _cdiv(min(band, po) * qo, 8)

    band = po
    while band > 1 and (blocks(nt, band, 1) < H100_SMS
                        or smem(nt, band, 1) > FUSED_SMEM_TARGET):
        band = _cdiv(band, 2)
    while nt > 1 and blocks(nt, band, 1) < H100_SMS:
        nt = _cdiv(nt, 2)
    if blocks(nt, band, 1) < 4 * H100_SMS:
        while band > 1 and upi(band) > 8:
            band = _cdiv(band, 2)
        while (band < po and upi(band) < 8 and upi(2 * band) <= 8
               and blocks(nt, 2 * band, 1) >= H100_SMS // 2
               and smem(nt, 2 * band, 1) <= FUSED_SMEM_TARGET):
            band *= 2
    units = upi(band)
    items = 1
    while ((items + 1) * units <= 8
           and (blocks(nt, band, items + 1) >= H100_SMS
                or ksteps * items * units < 8)
           and smem(nt, band, items + 1) <= FUSED_SMEM_TARGET):
        items += 1
    if (pool and items == 1 and blocks(nt, band, 1) >= 4 * H100_SMS
            and smem(nt, band, 2) <= FUSED_SMEM_TARGET):
        # the pooled output is small: where one-item blocks are plenty,
        # two items a block stage the weights once for both
        items = 2
    return {"cpb": CONV_S8_CHANNELS * nt, "band": band, "items": items}


def conv_s8_tiles(bsz: int, n: int, h: int, w: int, m: int, kh: int,
                  kw: int, sh: int, sw: int,
                  overrides: Mapping[str, int] | None = None,
                  pool: bool = True, odd: str = "raise",
                  platform: str | None = None) -> dict[str, int]:
    """``choose_conv_s8_blocks`` with the op's overrides
    (``fused_conv_block.<key>`` with ``pool``, ``conv2d.<key>`` without)
    and a ``TUNING_CACHE`` entry of this (op, shape, int8, ``platform``)
    applied and checked, plus ``smem``, the block's shared memory. A
    block that would exceed ``SMEM_MAX`` raises, the heuristic's own too
    (a one-row band of a huge N·W: no model of the repo comes near)."""
    op = "fused_conv_block" if pool else "conv2d"
    defaults = choose_conv_s8_blocks(bsz, n, h, w, m, kh, kw, sh, sw, pool,
                                     odd)
    key = {"signature": (bsz, n, h, w, m, kh, kw, sh, sw), "dtype": "int8",
           "platform": platform}
    t = tile_params(op, defaults, overrides, **key)
    if t["cpb"] not in (8, 16, 24, 32):
        raise ValueError(f"{op}: int8 cpb {t['cpb']} must be 8, 16, 24 or "
                         f"32")
    for name in ("band", "items"):
        if t[name] < 1:
            raise ValueError(f"{op}: {name} {t[name]} must be >= 1")
    po = _conv_grid(h, w, kh, kw, sh, sw, pool, odd)[0]
    grid = (_cdiv(bsz * _cdiv(po, t["band"]), t["items"])
            * _cdiv(m, t["cpb"]))
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{op}: {grid} blocks; CUDA's grid holds at most "
                         f"2**31 - 1")
    t["smem"] = conv_s8_smem_bytes(n, h, w, kh, kw, sh, t["cpb"], t["band"],
                                   t["items"])
    if t["smem"] > SMEM_MAX:
        raise ValueError(f"{op}: the int8 route's {t['smem']} bytes of "
                         f"shared memory a block; at most {SMEM_MAX}")
    return t


def _pow2_at_least(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def qmatmul_body(m: int, k: int, n: int) -> int:
    """The qmatmul body a shape takes: 1 (tensor-core tiles) from
    ``QMATMUL_TC_MIN_M`` rows and ``QMATMUL_TC_MIN_N`` columns, else 0
    (split-K weight streaming: decode's few rows, the CNN's narrow fc)."""
    return int(m >= QMATMUL_TC_MIN_M and n >= QMATMUL_TC_MIN_N)


def qmatmul_smem_bytes(body: int, tile_m: int, tile_n: int,
                       ksplit: int) -> int:
    """Shared memory of one qmatmul block. Body 1: 4 stages × (x's
    ``tile_m`` rows of 64 bytes at the 80-byte stride + a 64 × 128 stage
    of w as it lies) + w's 128 × 64 K-major tile at the 80-byte stride.
    Body 0: the x slice (``tile_m`` × ``ksplit`` bytes) + the block's int32
    sums (``tile_m`` × ``tile_n``)."""
    if body == 1:
        return (QMATMUL_TC_STAGES * (tile_m * QMATMUL_TC_LD + QMATMUL_TC_BK
                                     * QMATMUL_TC_BN)
                + QMATMUL_TC_BN * QMATMUL_TC_LD)
    return tile_m * _cdiv(ksplit, 4) * 4 + 4 * tile_m * tile_n


def qmatmul_scratch_bytes(body: int, m: int, n: int,
                          grid: tuple[int, int, int]) -> int:
    """The zeroed buffer a split-K call with the epilogue takes: body 1,
    M × N int32 sums and an arrival counter an output tile; body 0, a
    64-bit slot an output entry (its blocks' count beside their exact
    sum). 0 when K is not split."""
    gx, gy, gz = grid
    if gz == 1:
        return 0
    return 4 * (m * n + gx * gy) if body == 1 else 8 * m * n


def _qmatmul_stream_blocks(m: int, k: int, n: int) -> dict[str, int]:
    mr = 4 if m <= 4 else 8 if m <= 8 else 16
    cw = 64 // mr
    tile_n = max(QMATMUL_STREAM_MIN_N,
                 min(QMATMUL_TC_BN, cw * _pow2_at_least(_cdiv(max(n, 1),
                                                              cw))))
    ksplit = min(_cdiv(max(k, 1), 4) * 4, QMATMUL_XSLICE // mr)
    if k * n >= QMATMUL_SPLIT_BYTES:
        blocks = _cdiv(max(n, 1), tile_n) * _cdiv(max(m, 1), mr)
        want = _cdiv(2 * H100_SMS, blocks)
        ksplit = min(ksplit, max(16, k // want // 16 * 16))
    return {"body": 0, "tile_m": mr, "tile_n": tile_n, "ksplit": ksplit}


def _qmatmul_tc_blocks(m: int, k: int, n: int) -> dict[str, int]:
    tile_m = 64 if m <= 64 else 128
    tiles = _cdiv(max(m, 1), tile_m) * _cdiv(max(n, 1), QMATMUL_TC_BN)
    ktiles = max(_cdiv(k, QMATMUL_TC_BK), 1)
    kps = ktiles
    if tiles < H100_SMS:
        splits = min(_cdiv(2 * H100_SMS, tiles), max(1, ktiles // 4))
        kps = _cdiv(ktiles, splits)
    return {"body": 1, "tile_m": tile_m, "ksplit": QMATMUL_TC_BK * kps}


def choose_qmatmul_blocks(m: int, k: int, n: int,
                          body: int | None = None) -> dict[str, int]:
    """qmatmul's launch keys for ``body`` (default ``qmatmul_body``).

    Body 1 (tensor-core tiles): a block owns ``tile_m`` (64 up to M = 64,
    else 128) × 128 outputs and walks ``ksplit`` bytes of K in 64-byte
    steps through 4 cp.async stages; where the tiles
    number fewer than the card's SMs, K is split (``ksplit`` < K) until
    there are about 2 × 132 blocks, keeping at least 4 steps a block.

    Body 0 (split-K weight streaming): a block takes ``tile_m`` rows (4,
    8 or 16: the least that holds M, so 64 / tile_m columns a thread) and
    ``tile_n`` columns (16 to 128: 128 bytes of a w row, or the least
    power-of-two count of thread words that covers a narrow N) over a
    ``ksplit``-row slice of K (a multiple of 4; the x slice at most
    ``QMATMUL_XSLICE`` bytes). Where the weight holds at least
    ``QMATMUL_SPLIT_BYTES``, ``ksplit`` is cut (to a multiple of 16, so
    that x's slices stay 16-byte aligned) until the grid holds at least
    2 × 132 blocks; a smaller weight takes one block a column slice and
    writes its epilogue without the zeroed buffer."""
    if body is None:
        body = qmatmul_body(m, k, n)
    return (_qmatmul_tc_blocks(m, k, n) if body == 1
            else _qmatmul_stream_blocks(m, k, n))


def qmatmul_tiles(m: int, k: int, n: int,
                  overrides: Mapping[str, int] | None = None,
                  platform: str | None = None) -> dict[str, int]:
    """``choose_qmatmul_blocks`` with ``qmatmul`` overrides (and a
    ``TUNING_CACHE`` entry of (M, K, N), int8, ``platform``) applied and
    checked, ``ksplit`` clipped to K, plus the launch's ``grid``,
    ``splits`` (blocks a tile shares K among), shared memory ``smem`` and
    the zeroed buffer's ``scratch`` bytes. An overridden or cached
    ``body`` takes that body's heuristic for the keys not given; a key
    the body does not take (body 1's ``tile_n``) is ignored, as any key
    the op does not know, and a cached entry of the other body is a
    miss."""
    key = {"signature": (m, k, n), "dtype": "int8", "platform": platform}
    both = {**choose_qmatmul_blocks(m, k, n, 0),
            **choose_qmatmul_blocks(m, k, n)}   # every key, this body's
    body = tile_params("qmatmul", both, overrides, **key)["body"]
    if body not in (0, 1):
        raise ValueError(f"qmatmul: body {body} must be 0 (weight "
                         f"streaming) or 1 (tensor-core tiles)")
    hit = TUNING_CACHE.get("qmatmul", (m, k, n), "int8", platform) or {}
    t = tile_params("qmatmul", choose_qmatmul_blocks(m, k, n, body),
                    overrides, **(key if hit.get("body", body) == body
                                  else {}))
    t["body"] = body
    if body == 1:
        ok = {"tile_m": (64, 128)}
        step = QMATMUL_TC_BK
    else:
        ok = {"tile_m": (4, 8, 16), "tile_n": (16, 32, 64, 128)}
        step = 4
    for name, values in ok.items():
        if t[name] not in values:
            raise ValueError(f"qmatmul: {name} {t[name]} must be one of "
                             f"{values} for body {body}")
    if t["ksplit"] < step or t["ksplit"] % step:
        raise ValueError(f"qmatmul: ksplit {t['ksplit']} must be a "
                         f"positive multiple of {step} for body {body}")
    t["ksplit"] = min(t["ksplit"], max(_cdiv(k, step), 1) * step)
    t["splits"] = max(1, _cdiv(k, t["ksplit"]))   # blocks sharing a K
    cols = QMATMUL_TC_BN if body == 1 else t["tile_n"]
    grid = (_cdiv(n, cols), _cdiv(m, t["tile_m"]), t["splits"])
    if grid[0] > 2 ** 31 - 1 or max(grid[1:]) > 65535:
        raise ValueError(f"qmatmul: grid {grid}; CUDA's grid holds at most "
                         f"(2**31 - 1, 65535, 65535)")
    t["grid"] = grid
    t["smem"] = qmatmul_smem_bytes(body, t["tile_m"], cols, t["ksplit"])
    if t["smem"] > SMEM_MAX:
        raise ValueError(f"qmatmul: {t['smem']} bytes of shared memory a "
                         f"block; at most {SMEM_MAX}")
    t["scratch"] = qmatmul_scratch_bytes(body, m, n, grid)
    return t


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
                overrides: Mapping[str, int] | None = None, *,
                signature: tuple | None = None, dtype="float32",
                platform: str | None = None) -> dict[str, int]:
    """Heuristic ``defaults``, refined by the ``TUNING_CACHE`` entry of
    (``op``, ``signature``, ``dtype``, ``platform``) when a signature is
    given (and only if every key of the entry is one of ``defaults``':
    ``fits_keys``), with ``overrides`` applied last: bare keys apply to any
    op that knows them, ``"<op>.<key>"`` keys to one op and win. Unknown
    override keys are ignored, so one policy can carry tiles for several
    ops."""
    merged = dict(defaults)
    if signature is not None:
        hit = TUNING_CACHE.get(op, signature, dtype, platform)
        if fits_keys(hit, defaults):
            merged.update(hit)
    ov = dict(overrides or {})
    for k, v in ov.items():
        if "." not in k and k in defaults:
            merged[k] = int(v)
    for k, v in ov.items():
        name = k.split(".", 1)
        if len(name) == 2 and name[0] == op and name[1] in defaults:
            merged[name[1]] = int(v)
    return merged


def fits_keys(hit: Mapping[str, int] | None,
              known: Mapping[str, int] | set) -> bool:
    """Whether a cached entry speaks this build's launch keys: a
    non-empty entry none of whose keys is unknown to the op. An entry
    measured under keys the op no longer has (an older kernel's) is a
    miss, never an error."""
    return bool(hit) and set(hit) <= set(known)


def block_threads(op: str, defaults: Mapping[str, int],
                  overrides: Mapping[str, int] | None = None,
                  **cache_key) -> int:
    """The resolved ``threads`` of ``tile_params`` (``cache_key`` as
    there), checked against what a launch takes: whole warps, at most
    1024 threads."""
    t = tile_params(op, defaults, overrides, **cache_key)["threads"]
    if t < WARP or t > 1024 or t % WARP:
        raise ValueError(f"{op}: threads per block {t} must be a multiple "
                         f"of {WARP} in [{WARP}, 1024]")
    return t


# ------------------------------------------------------- the tuning cache

def conv_signature(x_shape, w_shape, stride) -> tuple[int, ...]:
    """The tuning-cache shape signature of a conv call, shared by the
    ``conv2d`` and ``fused_conv_block`` wrappers, the stream executors and
    the autotuner: (B, N, H, W, M, Kh, Kw, sh, sw)."""
    bsz, n, h, w = x_shape
    m, _, kh, kw = w_shape
    return tuple(int(v) for v in (bsz, n, h, w, m, kh, kw, *stride))


def platform_key(device=None) -> str:
    """The tuning cache's platform: ``"<card name> sm_<cc>"`` for a CUDA
    device (the current one when ``device`` is None and a card exists),
    ``"cpu"`` otherwise."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        return _card_key(torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return _card_key(device.index if device.index is not None
                     else torch.cuda.current_device())


@functools.cache
def _card_key(index: int) -> str:
    import torch
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class TuningCache:
    """Measured launch shapes keyed by (op, shape signature, dtype,
    platform). The platform key keeps tiles measured on one card (or
    none) from steering another: entries apply only where they were
    measured."""

    def __init__(self):
        self._entries: dict[tuple[str, tuple[int, ...], str, str],
                            dict[str, int]] = {}

    @staticmethod
    def key(op: str, shape, dtype, platform: str | None = None
            ) -> tuple[str, tuple[int, ...], str, str]:
        return (op, tuple(int(s) for s in shape), _dtype_name(dtype),
                platform or platform_key())

    def get(self, op: str, shape, dtype,
            platform: str | None = None) -> dict[str, int] | None:
        return self._entries.get(self.key(op, shape, dtype, platform))

    def put(self, op: str, shape, dtype, params: Mapping[str, int],
            platform: str | None = None) -> None:
        self._entries[self.key(op, shape, dtype, platform)] = {
            k: int(v) for k, v in dict(params).items()}

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> dict:
        """Copy of the entry table (tests save/restore around tuning)."""
        return dict(self._entries)

    def restore(self, entries: dict) -> None:
        self._entries = dict(entries)

    def export_rows(self) -> list[dict]:
        """Every entry as a JSON-able row (the persisted ``entries``
        shape); the plan artifact store embeds the rows of a plan's
        stages in its manifest."""
        return [{"op": op, "shape": list(shape), "dtype": dt,
                 "platform": plat, "params": dict(p)}
                for (op, shape, dt, plat), p in sorted(self._entries.items())]

    def merge_rows(self, rows, *, keep_existing: bool = False,
                   source: str = "tuning rows") -> int:
        """Merge rows in ``export_rows`` form; returns how many landed.
        ``keep_existing=True`` never overwrites an entry already here
        (an artifact's rows must not clobber fresher local measurements).
        Malformed rows warn and are skipped."""
        loaded = 0
        for row in rows:
            try:
                key = self.key(row["op"], row["shape"], row["dtype"],
                               row.get("platform"))
                if keep_existing and key in self._entries:
                    continue
                self._entries[key] = {k: int(v)
                                      for k, v in dict(row["params"]).items()}
                loaded += 1
            except (KeyError, TypeError, ValueError, AttributeError):
                warnings.warn(f"{source}: skipping malformed row {row!r}",
                              stacklevel=2)
        return loaded

    def save(self, path) -> None:
        """Write the versioned JSON cache (schema ``SCHEMA_VERSION``)."""
        doc = {"version": SCHEMA_VERSION, "entries": self.export_rows()}
        pathlib.Path(path).write_text(json.dumps(doc, indent=1) + "\n")

    def load(self, path) -> int:
        """Merge entries from ``path``; returns how many were loaded. A
        corrupt file, an unknown schema version or malformed rows warn and
        load nothing (the heuristics stay in charge) rather than raising
        mid-startup; only a missing file raises, as the caller chose the
        path."""
        text = pathlib.Path(path).read_text()
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            warnings.warn(f"tuning cache {path}: corrupt JSON; falling back "
                          f"to heuristic tiles", stacklevel=2)
            return 0
        if not isinstance(doc, dict):
            warnings.warn(f"tuning cache {path}: expected a JSON object, got "
                          f"{type(doc).__name__}; falling back to heuristic "
                          f"tiles", stacklevel=2)
            return 0
        if doc.get("version") != SCHEMA_VERSION:
            warnings.warn(
                f"tuning cache {path}: unknown schema version "
                f"{doc.get('version')!r} (this build reads "
                f"{SCHEMA_VERSION}); falling back to heuristic tiles",
                stacklevel=2)
            return 0
        return self.merge_rows(doc.get("entries", []),
                               source=f"tuning cache {path}")


TUNING_CACHE = TuningCache()
