#!/usr/bin/env python3
"""Read the check's numbers of a cell for the program and for its control,
seed by seed, in one process on the card.

    python3 chipbench/control.py --workload <name> --seeds 1 2 3 [--seconds 2]

The control is the reference put in the program's place in the nearest
format below the configuration's: 4-bit codes where the configuration
states int8. For each seed it runs the cell as ``run.py`` does (a short
window at the cell's own sizes, without the wait for the steady rate,
which the readings do not depend on), then again with the control, and prints
one JSON line per run with the compared numbers and ``correct``. The
limits of the check are set between the program's largest reading and
the control's smallest; the benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1,
                    help="also read the program's own numbers (default 1)")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    from chipbench import harness
    if not torch.cuda.is_available():
        print("chipbench: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(harness.load_manifest(root), args.workload,
                             root)
    sides = (False, True) if args.program else (True,)
    for seed in args.seeds:
        for control in sides:
            out = harness.run_cell(cell, seed=seed, seconds=args.seconds,
                                   trace=False, device="cuda",
                                   t_process=time.perf_counter(),
                                   control=control, root=root)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": "control" if control else "program",
                              "correct": out["correct"],
                              "check": out["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
