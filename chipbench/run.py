#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA GPUs as the
cell asks for. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a profiled stretch after
the window. The last line of standard output is one JSON object (keys
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``check``: each compared number
beside its limit); the compared numbers are also the last lines of
standard error.

Exits 2 on a bad argument or an unknown cell, 3 where there is no card or
too few, 4 where JAX or the JAX package was loaded; none of these print a
result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# modules the process that prints a result may not hold, by top-level name
BANNED = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock, from its
    start time in /proc (clock ticks since boot); now where that is not
    readable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        since_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        age = since_boot - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, age)


T_PROCESS = process_start()


def banned_modules(names=None) -> list[str]:
    """The banned top-level names among ``names`` (default: the modules
    this process has loaded), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(BANNED))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")

    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    # the context first: its age decides when the window may open
    t_context = None
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        t_context = time.perf_counter()

    from chipbench import harness

    try:
        cell = harness.find_cell(harness.load_manifest(root), args.workload,
                                 root)
    except (KeyError, OSError, ValueError) as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chipbench: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"chipbench: the cell needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda",
                              t_process=T_PROCESS, t_context=t_context,
                              root=root)
    print(f"chipbench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr, flush=True)
    found = banned_modules()
    if found:
        print(f"chipbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
