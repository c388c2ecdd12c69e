#!/usr/bin/env python3
"""Build the port's four kernels on one NVIDIA GPU, print what ptxas says
of them, launch each at the paper CNN's widths (and conv_window at odd
outputs, qmatmul at other GEMM shapes) and hold it against its plain
PyTorch version; with ``--sweep``, also time launch-shape overrides of
each against the heuristic's.

    python3 scripts/torch_kernel_probe.py [--sweep]
    python3 scripts/torch_kernel_probe.py --ablate

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
    # w's staging without its loads from memory
    "qmatmul without w's loads": ("qmatmul.cu",
                                  "(unsigned)(uint8_t)wc[(size_t)k * N]",
                                  "(unsigned)(k + c)"),
}


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
    rows["empty kernel"] = device_ms(lambda: torch.cuda._sleep(0))[0]
    return rows


def ablate() -> None:
    def timed(src: Path) -> dict[str, float]:
        r = subprocess.run([sys.executable, __file__, "--time", "--src",
                            str(src)], capture_output=True, text=True,
                           check=True)
        return json.loads(r.stdout.strip().splitlines()[-1])

    out = {"unchanged": timed(ROOT / "src")}
    for name, (source, old, new) in ABLATIONS.items():
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


def tree_shape(stage, bsz):
    n, h, w, m, k = stage
    return bsz * (h - k + 1) * (w - k + 1) * m, n * k * k


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
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
    if args.ablate:
        ablate()
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
            sweep_qmatmul(qmatmul, (xc, wc, xs, ws), bsz, ExecPolicy)
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
    variants = [{}, {"threads": 128, "rows": 4}, {"threads": 64, "rows": 2},
                {"rows": 16}, {"threads": 512, "rows": 16}]
    rows = [_time(lambda p: kern(*args, policy=p), pol_cls,
                  {f"qmatmul.{k}": v for k, v in t.items()})
            for t in variants]
    emit({"sweep": "qmatmul", "B": bsz, "rows": rows})


if __name__ == "__main__":
    sys.exit(main())
