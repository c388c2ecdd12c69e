#!/usr/bin/env python3
"""Build the port's four kernels on one NVIDIA GPU, print what ptxas says
of them, launch each at the paper CNN's widths (and conv_window at odd
outputs, qmatmul at other GEMM shapes) and hold it against its plain
PyTorch version; with ``--sweep``, also time launch-shape overrides of
each against the heuristic's (qmatmul's also at LM shapes on both sides
of its body boundary, each variant bitwise to the plain version).

    python3 scripts/torch_kernel_probe.py [--sweep]
    python3 scripts/torch_kernel_probe.py --ablate [--only conv,qmatmul]
    python3 scripts/torch_kernel_probe.py --conv-sweep

``--conv-sweep`` instead times both routes of the conv kernels at the
main path's shapes (the paper CNN's convs at B = 8 and 1024, every launch
shape of highres_cnn's 224² plan at B = 8): from each route's heuristic,
one axis of the autotuner's at a time (``repro_torch.ops.autotune``), each
point first held against the plain version (int8 bitwise, fp32 within
1e-5), and cuDNN's fp32 conv (+ relu + pool, TF32 off) beside them.

Prints one JSON line per check, then ``{"ok": true}`` when every check
passed; exits non-zero on the first failure. ``--ablate`` instead times
what a part of a kernel costs: for each entry of ``ABLATIONS`` it copies
the package into ``build/ablate/``, changes that part of a source, builds
the copy and times conv_window and qmatmul at the paper's shapes beside
the unchanged build, in one process each (``--time --src DIR``). The
changed kernels compute wrong values by design and are not checked. It
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (CONV1, CONV2, CONV_SHAPES, FC,  # noqa: E402
                        QMATMUL_SHAPES, TOL_FP32, conv_inputs, device_ms,
                        qmatmul_inputs)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# what a part of a kernel costs: (source in csrc/, its text, the change)
_STORES = """          o0[0] = a[0];
          if (right) o0[1] = a[1];
          if (down_rows) {
            o0[s.Wo] = a[2];
            if (right) o0[s.Wo + 1] = a[3];
          }"""
ABLATIONS = {
    # a row's two points as one float2 where Wo is even
    "conv_window float2 stores": ("conv_tile.cuh", _STORES, """
          if (!(s.Wo & 1)) {
            *reinterpret_cast<float2*>(o0) = make_float2(a[0], a[1]);
            if (down_rows)
              *reinterpret_cast<float2*>(o0 + s.Wo) = make_float2(a[2], a[3]);
          } else {""" + _STORES + "}"),
    # fused_cwp's bytes: one value a channel and tile
    "conv_window one store a tile": ("conv_tile.cuh", _STORES,
                                     "o0[0] = a[0] + a[1] + a[2] + a[3];"),
    # the tensor-core body without its transposition pass of w's stage
    "qmatmul without the transposition": (
        "qmatmul.cu", "    tc_transpose(sw + slot * TC_RAW, st);\n", ""),
    # the streaming body without its byte transposes (dp4a on the rows)
    "qmatmul stream without transpose4": (
        "qmatmul.cu",
        """      transpose4(rw[0][q], rw[1][q], rw[2][q], rw[3][q], t[4 * q],
                 t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]);""",
        """      t[4 * q] = rw[0][q], t[4 * q + 1] = rw[1][q],
      t[4 * q + 2] = rw[2][q], t[4 * q + 3] = rw[3][q];"""),
    # what a launch of each body costs before any work: return at once
    "qmatmul stream returns at once": (
        "qmatmul.cu",
        "  constexpr int CW = 64 / MR;  // columns a thread: MR x CW = 64 sums\n",
        "  constexpr int CW = 64 / MR;\n  if (M > 0) return;\n"),
    "qmatmul tc returns at once": (
        "qmatmul.cu",
        "  constexpr int MT = BM / 32;  // m16 tiles a warp: its BM / 2 rows\n",
        "  constexpr int MT = BM / 32;\n  if (M > 0) return;\n"),
    # the conv template's fp32 route at highres_cnn's blocks 2 and 3:
    # without its FMA loop (staging, waits and epilogue left), and without
    # the input slab's copies (the FMAs on whatever shared memory holds)
    "conv fp32 without the FMA loop": (
        "conv_tile.cuh",
        "    for (int kr = part; live && kr < s.N * s.Kh; kr += split) {\n",
        "    for (int kr = s.N * s.Kh; live && kr < s.N * s.Kh; "
        "kr += split) {\n"),
    "conv fp32 without the slab copies": (
        "conv_tile.cuh", "          cp_async4(dst + col, src + col);\n",
        "          ;\n"),
    # the int8 route without its MMA k-loop (staging, expansion, epilogue)
    "conv int8 without the k-loop": (
        "conv_tile.cuh",
        "    for (int ks = part; on && ks < ksteps; ks += kparts) {\n",
        "    for (int ks = ksteps; on && ks < ksteps; ks += kparts) {\n"),
    # the streaming body's fold of its threads' sums
    "qmatmul stream without the fold": (
        "qmatmul.cu", """        a[m][j] += __shfl_xor_sync(FULL, a[m][j], o);""",
        """        a[m][j] += o;"""),
}
# qmatmul at LM shapes on both sides of the body boundary (M = 8): each
# timed under the heuristic, under either body, and under other keys
QMM_SWEEP_SHAPES = ([(m, k, n) for m in (4, 8, 12, 16, 24, 32, 64)
                     for k, n in ((1024, 2816), (14336, 3584))]
                    + [(256, 14336, 3584), (512, 3584, 14336),
                       (512, 14336, 3584), (8, 4608, 10)])
# qmatmul_acc (the raw int32 sum) at the LM mesh's row-parallel shard
# shapes, under the same variants
QMM_ACC_SWEEP_SHAPES = [(4, 704, 1024), (4, 1408, 1024), (2, 2816, 1024),
                        (32, 1408, 1024), (4, 7168, 3584)]
# conv_window and qmatmul shapes the ablations time (qmatmul's LM ones)
QMM_TIME_SHAPES = [(4, 1024, 2816), (4, 1024, 704), (8, 4608, 10),
                   (64, 1024, 2816), (512, 14336, 3584)]


def time_rows(dev) -> dict[str, float]:
    """conv_window and qmatmul at the paper's shapes, B = 8 and 1024: the
    median device ms of 100 launches."""
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.qmatmul.ops import qmatmul
    gen = torch.Generator().manual_seed(4)
    rows = {}
    for bsz in (8, 1024):
        for name, stage in (("conv1", CONV1), ("conv2", CONV2)):
            x, w, b, _ = conv_inputs(gen, bsz, stage, "none", dev)
            rows[f"conv_window {name} B={bsz}"] = device_ms(
                lambda: conv_window(x, w, b))[0]
        args = qmatmul_inputs(gen, bsz, *FC, dev)
        rows[f"qmatmul fc B={bsz}"] = device_ms(lambda: qmatmul(*args))[0]
    for m, k, n in QMM_TIME_SHAPES:
        args = qmatmul_inputs(gen, m, k, n, dev)
        rows[f"qmatmul {m}x{k}x{n}"] = device_ms(lambda: qmatmul(*args))[0]
    # fused_cwp at highres_cnn's blocks 2 and 3, B = 8, both routes
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    for name, stage in (("block2", (16, 54, 54, 32, 3)),
                        ("block3", (32, 26, 26, 32, 3))):
        for mode in ("none", "int8"):
            x, w, b, s = conv_inputs(gen, 8, stage, mode, dev,
                                     codes=mode == "int8")
            rows[f"fused_cwp {name} {mode} B=8"] = device_ms(
                lambda: fused_cwp(x, w, b, scale=s))[0]
    rows["empty kernel"] = device_ms(lambda: torch.cuda._sleep(0))[0]
    return rows


def ablate(only: list[str]) -> None:
    def timed(src: Path) -> dict[str, float]:
        r = subprocess.run([sys.executable, __file__, "--time", "--src",
                            str(src)], capture_output=True, text=True,
                           check=True)
        return json.loads(r.stdout.strip().splitlines()[-1])

    out = {"unchanged": timed(ROOT / "src")}
    for name, (source, old, new) in ABLATIONS.items():
        if only and not any(w in name for w in only):
            continue
        pkg = ROOT / "build" / "ablate" / name.replace(" ", "_") / "src"
        shutil.rmtree(pkg.parent, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch", pkg / "repro_torch")
        path = pkg / "repro_torch" / "csrc" / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"ablation {name!r}: its text is not in "
                             f"{source} exactly once")
        path.write_text(text.replace(old, new))
        out[name] = timed(pkg)
        emit({"ablation": name, "ms": out[name]})
    emit({"ablate": out})


# SASS opcodes that show qmatmul's design: int8 tensor-core products,
# cp.async copies into shared memory, ldmatrix fragment loads, byte
# permutations, dp4a, atomics, and any use of local memory
SASS_OPS = ("IMMA", "LDGSTS", "LDSM", "PRMT", "IDP", "RED", "ATOM", "LDL",
            "STL")


def sass_counts() -> dict:
    """Build the qmatmul library and count SASS_OPS in each of its
    kernels (``cuobjdump -sass``, from the CUDA toolkit beside nvcc)."""
    import re
    from repro_torch.kernels.build import build, library_path, nvcc
    build(["qmatmul"])
    tool = Path(nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library_path("qmatmul"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {op: 0 for op in SASS_OPS}
            out[name]["instructions"] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if name and m:
            out[name]["instructions"] += 1
            if m.group(1) in SASS_OPS:
                out[name][m.group(1)] += 1
    return {"sass": out}


def tree_shape(stage, bsz):
    n, h, w, m, k = stage
    return bsz * (h - k + 1) * (w - k + 1) * m, n * k * k


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--only", default="",
                    help="with --ablate (--conv-sweep): only the ablations "
                         "(shapes) whose names hold one of these "
                         "comma-separated words")
    ap.add_argument("--sass", action="store_true",
                    help="only build and count, in each kernel of the "
                         "qmatmul library, the instructions that show its "
                         "design (cuobjdump -sass)")
    ap.add_argument("--conv-sweep", action="store_true",
                    help="only time both conv routes' launch keys, one "
                         "axis at a time, at the main path's shapes")
    ap.add_argument("--time", action="store_true",
                    help="only print time_rows() as one JSON line")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory holding the repro_torch to load")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src))
    if not torch.cuda.is_available():
        print("torch_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    if args.time:
        emit(time_rows(torch.device("cuda", 0)))
        return 0
    if args.conv_sweep:
        return conv_sweep(torch.device("cuda", 0),
                          [w for w in args.only.split(",") if w])
    if args.ablate:
        ablate([w for w in args.only.split(",") if w])
        return 0
    if args.sass:
        emit(sass_counts())
        return 0
    from repro_torch.kernels.addtree.ops import tree_reduce_sum
    from repro_torch.kernels.addtree.ref import tree_reduce_sum_ref
    from repro_torch.kernels.build import build
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    from repro_torch.kernels.qmatmul.ops import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    from repro_torch.ops import ExecPolicy

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rep = build()
    emit({"device": smi, "torch": torch.__version__,
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln]
                    for k, v in rep.items()}})
    gen = torch.Generator().manual_seed(0)
    ok = True

    def agree(kernel, mode, got, want, **where):
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        good = (err <= TOL_FP32 * (1 + float(want.abs().max()))
                if mode == "none" else torch.equal(got, want))
        emit({"kernel": kernel, **where, "mode": mode, "max_abs": err,
              "ok": good})
        return good

    for bsz in (8, 1024):
        for name, stage in (("conv1", CONV1), ("conv2", CONV2)):
            for mode in ("none", "qformat", "int8"):
                x, w, b, s = conv_inputs(gen, bsz, stage, mode, dev)
                ok &= agree("fused_cwp", mode, fused_cwp(x, w, b, scale=s),
                            fused_cwp_ref(x, w, b, scale=s), stage=name,
                            B=bsz)
                cb = None if mode == "int8" else b
                ok &= agree("conv_window", mode, conv_window(x, w, cb),
                            conv2d_window_ref(x, w, cb), stage=name, B=bsz)
            r, eta = tree_shape(stage, bsz)
            xt = torch.randn((r, eta), generator=gen).to(dev)
            good = torch.equal(tree_reduce_sum(xt), tree_reduce_sum_ref(xt))
            ok &= good
            emit({"kernel": "addtree", "stage": name, "B": bsz,
                  "shape": [r, eta], "bitwise": good})
            if args.sweep and good:
                sweep_tree(tree_reduce_sum, xt, name, bsz, ExecPolicy)
            del xt
            if args.sweep:
                x, w, b, _ = conv_inputs(gen, bsz, stage, "none", dev)
                sweep_fused(fused_cwp, x, w, b, name, bsz, ExecPolicy)
                sweep_conv(conv_window, x, w, b, name, bsz, ExecPolicy)
        xc, wc, xs, ws = qmatmul_inputs(gen, bsz, *FC, dev)
        ok &= agree("qmatmul", "int8", qmatmul(xc, wc, xs, ws),
                    qmatmul_ref(xc, wc, xs, ws), shape=[bsz, *FC])
        if args.sweep:
            ok &= sweep_qmatmul(qmatmul, (xc, wc, xs, ws), bsz, ExecPolicy)
    for case, (stage, stride, tiling) in CONV_SHAPES.items():
        for mode in ("none", "qformat", "int8"):
            x, w, b, _ = conv_inputs(gen, 2, stage, mode, dev)
            cb = None if mode == "int8" else b
            ok &= agree("conv_window", mode,
                        conv_window(x, w, cb, stride=stride,
                                    policy=ExecPolicy(tiling=tiling)),
                        conv2d_window_ref(x, w, cb, stride=stride),
                        stage=case, B=2)
    for (m, k, n), tiling in QMATMUL_SHAPES:
        xc, wc, xs, ws = qmatmul_inputs(gen, m, k, n, dev)
        ok &= agree("qmatmul", "int8",
                    qmatmul(xc, wc, xs, ws, policy=ExecPolicy(tiling=tiling)),
                    qmatmul_ref(xc, wc, xs, ws), shape=[m, k, n],
                    tiling=tiling)
    if args.sweep:
        from repro_torch.kernels.qmatmul.ops import qmatmul_acc
        for m, k, n in QMM_SWEEP_SHAPES:
            ok &= sweep_qmatmul(qmatmul, qmatmul_inputs(gen, m, k, n, dev),
                                m, ExecPolicy)
        for m, k, n in QMM_ACC_SWEEP_SHAPES:
            ok &= sweep_qmatmul(qmatmul_acc,
                                qmatmul_inputs(gen, m, k, n, dev)[:2], m,
                                ExecPolicy)
    emit({"ok": bool(ok)})
    return 0 if ok else 1


def conv_sweep(dev, only: list[str]) -> int:
    """Both conv routes' launch keys at the main path's shapes and the
    mesh's per-shard shapes (MESH_TIMED_SHAPES, B = 8): one JSON line a
    (kernel, route, shape, B) with every point's ms beside the
    heuristic's and cuDNN's; ``only`` keeps the shapes whose labels hold
    one of its words."""
    import torch.nn.functional as F
    from chip_smoke import MESH_TIMED_SHAPES, highres_shapes, smi_line
    from repro_torch.kernels.conv_window.ops import conv_window
    from repro_torch.kernels.conv_window.ref import conv2d_window_ref
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    from repro_torch.ops import ExecPolicy
    from repro_torch.ops.autotune import _conv_axes, heuristic_tiles
    gen = torch.Generator().manual_seed(21)
    cases = [(kern, f"mnist {stage}", shape, bsz)
             for bsz in (8, 1024)
             for stage, shape in (("conv1", CONV1), ("conv2", CONV2))
             for kern in ("fused_cwp", "conv_window")]
    cases += [(kern, f"highres {stage} {shape[1]}x{shape[2]}", shape, 8)
              for kern, stage, shape in highres_shapes()]
    cases += [(kern, f"mesh {label}", shape, 8)
              for label, kern, shape in MESH_TIMED_SHAPES]
    if only:
        cases = [c for c in cases if any(w in c[1] for w in only)]
    ok = True
    for kern, label, shape, bsz in cases:
        for mode in ("none", "int8"):
            x, w, b, s = conv_inputs(gen, bsz, shape, mode, dev,
                                     codes=mode == "int8")
            pooled = kern == "fused_cwp"
            ns = "fused_conv_block" if pooled else "conv2d"
            if pooled:
                def call(pol):
                    return fused_cwp(x, w, b, scale=s, policy=pol)
                want = fused_cwp_ref(x, w, b, scale=s)
            else:
                cb = None if mode == "int8" else b

                def call(pol):
                    return conv_window(x, w, cb, policy=pol)
                want = conv2d_window_ref(x, w, cb)
            xf, wf = x.float(), w.float()
            if pooled:
                def lib():
                    return F.max_pool2d(F.relu(F.conv2d(xf, wf, b)), 2)
            else:
                def lib():
                    return F.conv2d(xf, wf, b)
            heur = heuristic_tiles(ns, x, w, b, stride=(1, 1))
            points = [dict(heur)]
            for axis, values in _conv_axes(x, w, (1, 1), heur).items():
                points += [{**heur, axis: v} for v in values
                           if v != heur[axis]]
            if mode == "none":
                # fp32: lanes sharing a tile with the threads to hold them
                # (one round), at the heuristic's channel group and at
                # half and a quarter of it
                n_, h_, w_, m_, k_ = shape
                qo = (w_ - k_ + 1) // 2
                for cpb in sorted({heur["cpb"], max(4, heur["cpb"] // 2),
                                   max(4, heur["cpb"] // 4)}):
                    for split in (1, 2, 4, 8):
                        tiles = (heur["ipb"] * cpb // 4 * heur["band"]
                                 * qo)
                        threads = -(-tiles * split // 32) * 32
                        if threads <= 1024:
                            points.append({**heur, "cpb": cpb,
                                           "split": split,
                                           "threads": threads})
            rows = []
            for t in points:
                pol = ExecPolicy(tiling={f"{ns}.{k}": v
                                         for k, v in t.items()})
                try:
                    got = call(pol)
                except (ValueError, RuntimeError) as e:
                    rows.append({"tiles": t, "refused": str(e)[:80]})
                    continue
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                good = (torch.equal(got, want) if mode == "int8" else
                        err <= TOL_FP32 * (1 + float(want.abs().max())))
                ok &= good
                ms, _ = device_ms(lambda: call(pol), reps=50)
                rows.append({"tiles": t, "ms": ms, "ok": good})
            timed = [r for r in rows if "ms" in r]
            best = min(timed, key=lambda r: r["ms"])
            emit({"sweep": kern, "route": "int8" if mode == "int8"
                  else "fp32", "shape": label, "B": bsz,
                  "heuristic_ms": timed[0]["ms"], "best": best,
                  "library_ms": device_ms(lib, reps=50)[0], "rows": rows,
                  "device": smi_line()})
            del x, w, want
    emit({"ok": bool(ok)})
    return 0 if ok else 1


def _time(fn, pol_cls, tiling):
    pol = pol_cls(tiling=tiling)
    ms, dry = device_ms(lambda: fn(pol), reps=50)
    return {"tiling": tiling, "ms": ms, "dry": dry}


def sweep_tree(kern, x, name, bsz, pol_cls):
    variants = [{}]
    if x.shape[1] <= 32:
        variants += [{"rows": 128, "threads": 128}, {"rows": 512}]
    else:
        variants += [{"row_lanes": 16, "rows": 16},
                     {"row_lanes": 32, "rows": 8},
                     {"row_lanes": 16, "rows": 8, "threads": 128},
                     {"row_lanes": 32, "rows": 4, "threads": 128}]
    rows = [_time(lambda p: kern(x, policy=p), pol_cls,
                  {f"tree_reduce_sum.{k}": v for k, v in t.items()})
            for t in variants]
    emit({"sweep": "addtree", "stage": name, "B": bsz, "rows": rows})


def sweep_fused(kern, x, w, b, name, bsz, pol_cls):
    variants = [{}]
    if bsz >= 1024:
        variants += [{"ipb": 1, "threads": 256}, {"ipb": 2, "threads": 160},
                     {"ipb": 4, "threads": 256}, {"ipb": 6, "threads": 480},
                     {"ipb": 2, "split": 2, "threads": 320}]
    else:
        variants += [{"split": 16}, {"band": 2}, {"threads": 256},
                     {"cpb": 8, "threads": 256}]
    rows = [_time(lambda p: kern(x, w, b, policy=p), pol_cls,
                  {f"fused_conv_block.{k}": v for k, v in t.items()})
            for t in variants]
    emit({"sweep": "fused_cwp", "stage": name, "B": bsz, "rows": rows})


def sweep_conv(kern, x, w, b, name, bsz, pol_cls):
    variants = [{}]
    if bsz >= 1024:
        variants += [{"ipb": 1, "threads": 256}, {"ipb": 2, "threads": 160},
                     {"ipb": 4, "threads": 256}, {"ipb": 6, "threads": 480},
                     {"band": 2}, {"ipb": 2, "split": 2, "threads": 320}]
    else:
        variants += [{"split": 16}, {"split": 8}, {"threads": 256},
                     {"cpb": 8, "threads": 256}]
    rows = [_time(lambda p: kern(x, w, b, policy=p), pol_cls,
                  {f"conv2d.{k}": v for k, v in t.items()})
            for t in variants]
    emit({"sweep": "conv_window", "stage": name, "B": bsz, "rows": rows})


def sweep_qmatmul(kern, args, bsz, pol_cls):
    """The heuristic beside either body and each body's other keys, every
    variant first held bitwise against the plain version (``kern`` is
    qmatmul on four arguments, or qmatmul_acc on two)."""
    from repro_torch.kernels.qmatmul.ref import qmatmul_acc_ref, qmatmul_ref
    from repro_torch.ops.tiling import qmatmul_tiles
    m, k = args[0].shape
    n = args[1].shape[1]
    heur = qmatmul_tiles(m, k, n)
    variants = [{}, {"body": 0}, {"body": 1}, {"body": 0, "tile_n": 64},
                {"body": 0, "ksplit": 4 * -(-k // 4)},
                {"body": 1, "tile_m": 64},
                {"body": 1, "tile_m": 128},
                {"body": 1, "ksplit": 64 * -(-k // 64)}]
    if heur["splits"] > 1:
        step = 64 if heur["body"] == 1 else 4
        variants.append({"ksplit": max(step, heur["ksplit"] // 2 // step
                                       * step)})
    want = qmatmul_ref(*args) if len(args) == 4 else qmatmul_acc_ref(*args)
    rows = []
    for t in variants:
        tiling = {f"qmatmul.{key}": v for key, v in t.items()}
        try:
            tiles = qmatmul_tiles(m, k, n, tiling)
        except ValueError as e:
            rows.append({"tiling": tiling, "refused": str(e)})
            continue
        got = kern(*args, policy=pol_cls(tiling=tiling))
        torch.cuda.synchronize()
        row = _time(lambda p: kern(*args, policy=p), pol_cls, tiling)
        row["tiles"] = {key: tiles[key] for key in
                        ("body", "tile_m", "tile_n", "ksplit", "splits")
                        if key in tiles}
        row["bitwise"] = bool(torch.equal(got, want))
        rows.append(row)
    emit({"sweep": "qmatmul" if len(args) == 4 else "qmatmul_acc",
          "shape": [m, k, n], "B": bsz, "rows": rows})
    return all(r.get("bitwise", True) for r in rows)


if __name__ == "__main__":
    sys.exit(main())
