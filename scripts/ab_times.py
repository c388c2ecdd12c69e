#!/usr/bin/env python3
"""Time two trees of the repository on one card, in turns.

    python3 scripts/ab_times.py PARENT_DIR CHANGE_DIR [--out FILE]
        [--kernels fused_cwp,conv_window]

Runs ``python3 chip_smoke.py --phases times,plans`` in PARENT_DIR,
CHANGE_DIR, CHANGE_DIR, PARENT_DIR (each a checkout of the repository,
such as a ``git archive`` unpacked under ``build/``), one process at a
time, so both trees are timed on the same card under the same power limit
with any drift spread over both. Each run's ``times`` and ``plans`` lines
are kept whole in ``--out`` (default ``build/ab_times.json``). Printed,
one JSON line each: every ``times`` row of the ``--kernels`` (both routes
of the conv kernels: a row's ``route`` is ``int8`` on the int8 route) with
each run's device ms, the mean of each tree, the change's speedup, and
the change's bound, library time and cold reading where it has them (an
int8 row also each run's fp32-route time at its shape, ``fp32_route_ms``:
the ``ms`` of the fp32 row beside it); then every ``plans`` row (highres_cnn's whole plan a batch:
B, mode, stream budget) with each run's device and wall ms, the means and
the speedup. The last line is the card's ``nvidia-smi`` name and power
limit.
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


def run_times(tree: Path) -> tuple[dict, dict, float]:
    """The ``times`` and ``plans`` phase lines of one ``--phases
    times,plans`` run in ``tree`` (exit 4: a ``--phases`` run prints no
    result), and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                           "times,plans"], cwd=tree, capture_output=True,
                          text=True, timeout=1200)
    seconds = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    times = [ln for ln in lines if ln.get("phase") == "times"]
    plans = [ln for ln in lines if ln.get("phase") == "plans"]
    if proc.returncode != 4 or not times or not plans:
        raise SystemExit(f"{tree}: chip_smoke.py --phases times,plans "
                         f"exited {proc.returncode}\n{proc.stderr[-4000:]}")
    return times[0], plans[0], seconds


def row_key(row: dict) -> tuple:
    return (row["name"], row["model"], row["stage"], row["B"])


def plan_key(row: dict) -> tuple:
    return (row["B"], row["mode"], row["budget"])


def means(values: list, out: dict) -> dict:
    """Each tree's mean of ``values`` (one a run, in ORDER) and the
    change's speedup, into ``out``."""
    parent = [v for v, w in zip(values, ORDER) if w == "parent" and v]
    change = [v for v, w in zip(values, ORDER) if w == "change" and v]
    if parent and change:
        out["parent_mean"] = statistics.mean(parent)
        out["change_mean"] = statistics.mean(change)
        out["speedup"] = out["parent_mean"] / out["change_mean"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build/ab_times.json"))
    ap.add_argument("--kernels", default="fused_cwp,conv_window",
                    help="comma-separated kernels whose times rows print")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    runs = []
    for which in ORDER:
        times, plans, seconds = run_times(getattr(args, which))
        runs.append({"tree": which, "seconds": seconds, "times": times,
                     "plans": plans})
        print(json.dumps({"run": len(runs), "tree": which,
                          "seconds": round(seconds, 1),
                          "launch_floor_ms": times["launch_floor_ms"]}),
              flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(runs, indent=1) + "\n")
    by_run = [{row_key(r): r for r in run["times"]["rows"]} for run in runs]
    for key, row in by_run[1].items():
        if key[0] not in kernels:
            continue
        ms = [b.get(key, {}).get("ms") for b in by_run]
        out = {"name": key[0], "route": row.get("route", "fp32"),
               "model": key[1], "stage": key[2], "B": key[3], "ms": ms,
               "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
               "plain_ms": row["plain_ms"],
               "library_ms": [b.get(key, {}).get("library_ms")
                              for b in by_run]}
        if "cold_ms" in row:
            out["cold_ms"] = [b.get(key, {}).get("cold_ms") for b in by_run]
        if out["route"] == "int8":
            fkey = (key[0], key[1], key[2].removesuffix(" int8"), key[3])
            out["fp32_route_ms"] = [b.get(fkey, {}).get("ms")
                                    for b in by_run]
        print(json.dumps(means(ms, out)), flush=True)
    plans = [{plan_key(r): r for r in run["plans"]["rows"]} for run in runs]
    for key, row in plans[1].items():
        ms = [p.get(key, {}).get("ms") for p in plans]
        out = {"plan": "highres_cnn", "B": key[0], "mode": key[1],
               "budget": key[2], "ms": ms,
               "wall_ms": [p.get(key, {}).get("wall_ms") for p in plans],
               "launches": row["launches"]}
        print(json.dumps(means(ms, out)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
