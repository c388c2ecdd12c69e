#!/usr/bin/env python3
"""A/B, on one NVIDIA GPU, of how a layer-stacked model takes its
layers' parameters: ``select`` (one ``t[i]`` view a layer and leaf, the
port's way before its training stack) against ``unbind``
(``repro_torch.models.common.layer_views``: one ``torch.unbind`` a
stacked leaf). Under autograd a ``select`` view's backward zero-fills and
adds a whole stack for each layer; ``unbind``'s is one ``stack``.

    python3 scripts/ab_layer_views.py [--archs qwen1.5-0.5b,rwkv6-1.6b,zamba2-7b]

Each arch is drawn once at full size from seed 0 and timed in one
process in the order select, unbind, unbind, select:
- ``train``: qwen1.5-0.5b's train step (``make_train_step``, AdamW, fp32
  weights) at B = 8 × 128 tokens, the step ``chip_smoke.py``'s train
  phase times; both variants must give the same loss and new parameters
  bitwise;
- ``decode``: one decode step of each arch at capacity 4 with every
  slot live, in bf16, as the serving engine runs it (the lm and ssm
  phases' step).
For each: the wall time of one call to its synchronize (20 calls), the
CUDA-event time of one call queued behind a spin (10 calls; the host's
dispatch does not show), each as median and quartiles, and the device
busy time of one call (torch.profiler's kernel sum). Prints the card's
name and power limit, one JSON line a measurement, then one summary line
with each variant's medians. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# before the first CUDA call: the bitwise check runs deterministically
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import (encdec, hybrid, rwkv_lm,  # noqa: E402
                                transformer)
from repro_torch.models.common import layer_views  # noqa: E402

ORDER = ("select", "unbind", "unbind", "select")
MODULES = (transformer, hybrid, rwkv_lm, encdec)


def layer_views_select(tree: dict) -> list[dict]:
    """The port's views before ``layer_views``: ``t[i]`` a layer."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda t: t[i], tree) for i in range(n)]


VARIANTS = {"select": layer_views_select, "unbind": layer_views}


def use_variant(name: str) -> None:
    for mod in MODULES:
        mod.layer_views = VARIANTS[name]


def quartiles(xs: list[float]) -> dict:
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q1, "q3": q3}


def measure(fn) -> dict:
    """Wall (20 calls), spin-queued event time (10 calls), busy (one)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    events, dry = [], False
    for _ in range(10):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        spin_done = torch.cuda.Event()
        torch.cuda._sleep(int(5e8))
        spin_done.record()
        e0.record()
        fn()
        e1.record()
        dry |= spin_done.query()
        torch.cuda.synchronize()
        events.append(e0.elapsed_time(e1))
    prof = cs.lm_profile(fn)
    return {"wall_ms": quartiles(walls), "event_ms": quartiles(events),
            "queue_ran_dry": dry,
            "device_busy_ms": prof.get("kernel_us", 0.0) / 1e3,
            "kernel_launches": prof.get("kernel_launches")}


def train_rows(device) -> list[dict]:
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           SyntheticTextIterator,
                                           shard_batch)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    model = get_arch(cs.TRAIN_ARCH).model()
    params = model.init(0, device=device)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(total_steps=20))
    batch = shard_batch(SyntheticTextIterator(SyntheticTextConfig(
        model.cfg.vocab, 128, 8)).next_batch(), device=device)
    rows, ref = [], None
    for name in ORDER:
        use_variant(name)
        if len(rows) < 2:       # each variant's first: the same step?
            torch.use_deterministic_algorithms(True)
            new, _, metrics = step(params, opt, batch)
            torch.use_deterministic_algorithms(False)
            got = [metrics["loss"], *tree_leaves(new)]
            if ref is None:
                ref = got
            else:
                cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                         "select and unbind give different train steps")
                ref = None
            del new, got
        rows.append({"arch": cs.TRAIN_ARCH, "step": "train",
                     "variant": name, **measure(
                         lambda: step(params, opt, batch))})
        emit(rows[-1])
    return rows


def decode_rows(arch: str, device) -> list[dict]:
    from repro_torch.configs import get_arch
    model = get_arch(arch).model()
    params = model.init(0, device=device)
    plen = cs.SSM_PROMPT.get(arch)
    prompts = cs.lm_prompts(model.cfg.vocab, plen) if plen else None
    eng, tokens, pos = cs.filled_engine(
        model, params, device, prompts=prompts,
        max_seq=(plen or 64) + 16)
    state = eng.kv.device_state()
    rows = []
    for name in ORDER:
        use_variant(name)
        rows.append({"arch": arch, "step": "decode", "variant": name,
                     **measure(lambda: eng._decode(eng.params, tokens, pos,
                                                   *state))})
        emit(rows[-1])
    return rows


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen1.5-0.5b,rwkv6-1.6b,zamba2-7b",
                    help="archs whose decode step is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_layer_views: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    rows = train_rows(device)
    cs.free_card()
    for arch in args.archs.split(","):
        rows += decode_rows(arch, device)
        cs.free_card()
    summary = {}
    for r in rows:
        key = f"{r['arch']} {r['step']}"
        for k in ("wall_ms", "event_ms"):
            summary.setdefault(key, {}).setdefault(r["variant"], {}) \
                .setdefault(k, []).append(r[k]["median"])
        summary[key][r["variant"]].setdefault("busy_ms", []).append(
            r["device_busy_ms"])
    emit({"summary": summary, "card": smi, "order": ORDER})
    return 0


if __name__ == "__main__":
    sys.exit(main())
