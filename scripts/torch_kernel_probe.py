#!/usr/bin/env python3
"""Build the port's addtree and fused_cwp kernels on one NVIDIA GPU, print
what ptxas says of them, launch each once at the paper CNN's widths and
hold it against its plain PyTorch version; with ``--sweep``, also time
launch-shape overrides of both against the heuristic's.

    python3 scripts/torch_kernel_probe.py [--sweep]

Prints one JSON line per check, then ``{"ok": true}`` when every check
passed; exits non-zero on the first failure. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (CONV1, CONV2, TOL_FP32, conv_inputs,  # noqa: E402
                        device_ms)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def tree_shape(stage, bsz):
    n, h, w, m, k = stage
    return bsz * (h - k + 1) * (w - k + 1) * m, n * k * k


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.addtree.ops import tree_reduce_sum
    from repro_torch.kernels.addtree.ref import tree_reduce_sum_ref
    from repro_torch.kernels.build import build
    from repro_torch.kernels.fused_cwp.ops import fused_cwp
    from repro_torch.kernels.fused_cwp.ref import fused_cwp_ref
    from repro_torch.ops import ExecPolicy

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rep = build(["addtree", "fused_cwp"])
    emit({"device": smi, "torch": torch.__version__,
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln]
                    for k, v in rep.items()}})
    gen = torch.Generator().manual_seed(0)
    ok = True
    for bsz in (8, 1024):
        for name, stage in (("conv1", CONV1), ("conv2", CONV2)):
            for mode in ("none", "qformat", "int8"):
                x, w, b, s = conv_inputs(gen, bsz, stage, mode, dev)
                got = fused_cwp(x, w, b, scale=s)
                want = fused_cwp_ref(x, w, b, scale=s)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                good = (err <= TOL_FP32 * (1 + float(want.abs().max()))
                        if mode == "none" else torch.equal(got, want))
                ok &= good
                emit({"kernel": "fused_cwp", "stage": name, "B": bsz,
                      "mode": mode, "max_abs": err, "ok": good})
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


if __name__ == "__main__":
    sys.exit(main())
