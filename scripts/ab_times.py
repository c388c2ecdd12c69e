#!/usr/bin/env python3
"""Time two trees of the repository on one card, in turns.

    python3 scripts/ab_times.py PARENT_DIR CHANGE_DIR [--out FILE]

Runs ``python3 chip_smoke.py --phases times`` in PARENT_DIR, CHANGE_DIR,
CHANGE_DIR, PARENT_DIR (each a checkout of the repository, such as a
``git archive`` unpacked under ``build/``), one process at a time, so both
trees are timed on the same card under the same power limit with any
drift spread over both. Each run's ``times`` line is kept whole in
``--out`` (default ``build/ab_times.json``); one JSON line a row of the
qmatmul kernel is printed with each run's device ms, the mean of each
tree, the change's speedup, and the change's bound, ``_int_mm`` time and
cold reading where it has them. The last line is the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ORDER = ("parent", "change", "change", "parent")


def run_times(tree: Path) -> tuple[dict, float]:
    """The ``times`` phase line of one ``--phases times`` run in ``tree``
    (exit 4: a ``--phases`` run prints no result), and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                           "times"], cwd=tree, capture_output=True,
                          text=True, timeout=1200)
    seconds = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    times = [ln for ln in lines if ln.get("phase") == "times"]
    if proc.returncode != 4 or not times:
        raise SystemExit(f"{tree}: chip_smoke.py --phases times exited "
                         f"{proc.returncode}\n{proc.stderr[-4000:]}")
    return times[0], seconds


def row_key(row: dict) -> tuple:
    return (row["name"], row["model"], row["stage"], row["B"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build/ab_times.json"))
    args = ap.parse_args()
    runs = []
    for which in ORDER:
        times, seconds = run_times(getattr(args, which))
        runs.append({"tree": which, "seconds": seconds, "times": times})
        print(json.dumps({"run": len(runs), "tree": which,
                          "seconds": round(seconds, 1),
                          "launch_floor_ms": times["launch_floor_ms"]}),
              flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(runs, indent=1) + "\n")
    by_run = [{row_key(r): r for r in run["times"]["rows"]} for run in runs]
    for key, row in by_run[1].items():
        if key[0] != "qmatmul":
            continue
        ms = [b.get(key, {}).get("ms") for b in by_run]
        parent = [m for m, w in zip(ms, ORDER) if w == "parent" and m]
        change = [m for m, w in zip(ms, ORDER) if w == "change" and m]
        out = {"model": key[1], "stage": key[2], "B": key[3], "ms": ms,
               "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
               "library_ms": [b.get(key, {}).get("library_ms")
                              for b in by_run],
               "cold_ms": [b.get(key, {}).get("cold_ms") for b in by_run]}
        if parent and change:
            out["parent_mean"] = statistics.mean(parent)
            out["change_mean"] = statistics.mean(change)
            out["speedup"] = out["parent_mean"] / out["change_mean"]
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
