"""Serving launcher: ``--arch <id>`` behind the serving front-end
(DESIGN.md §11), on the card unless ``--device cpu``.

Port of ``repro.launch.serve``'s CNN branch: the bucketed vision engine
over compiled plans, a synthetic workload of ``--requests`` seeded
images submitted through the front-end with an optional ``--slo-ms``
deadline budget, and a report of throughput, lane occupancy and the SLO
view. The LM branch and the ``--mesh``, ``--autotune``,
``--tuning-cache``, ``--plan-artifact``, ``--save-plan`` and
``--warmup-report`` flags wait for later slices.

    python -m repro_torch.launch.serve --arch mnist_cnn --capacity 8 \
        --requests 32
    python -m repro_torch.launch.serve --arch highres_cnn --capacity 8 \
        --requests 16

Any ``cnn`` arch serves through the same path: ``serve_vision`` needs
only the model's ``init(seed, device=...)``, ``input_shape()`` and
``compile(...)``; ``highres_cnn``'s plans stream its first two blocks.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.device import DEFAULT_DEVICE


def _frontend(adapter, args, clock):
    from repro_torch.serve import Frontend, FrontendConfig
    max_queue = args.max_queue or max(args.requests, 64)
    slo_s = args.slo_ms / 1e3 if args.slo_ms else None
    return Frontend(adapter, FrontendConfig(max_queue=max_queue,
                                            slo_s=slo_s), clock)


def _submit_all(frontend, payloads) -> int:
    """Submit everything; a full queue sheds (typed, counted) instead of
    hanging — the launcher's workload is open-loop."""
    from repro_torch.serve import QueueFullError
    shed = 0
    for p in payloads:
        try:
            frontend.submit(p)
        except QueueFullError:
            shed += 1
    return shed


def _print_slo(stats, args) -> None:
    slo = f"{args.slo_ms:.0f}ms" if args.slo_ms else "none"
    print(f"SLO (budget {slo}): p50={stats.p50_s * 1e3:.1f}ms "
          f"p95={stats.p95_s * 1e3:.1f}ms p99={stats.p99_s * 1e3:.1f}ms | "
          f"goodput {stats.goodput_rps:.2f} req/s | "
          f"deadline misses {stats.deadline_misses}/{stats.completed} "
          f"({stats.miss_rate:.0%}) | rejected at intake {stats.rejected}")


def serve_vision(model, args):
    """Micro-batched image serving through bucketed bound plans behind
    the front-end. Returns (engine, {rid: {"label", "logits"}})."""
    from repro_torch.serve import (MonotonicClock, VisionAdapter,
                                   VisionEngine, VisionEngineConfig)
    clock = MonotonicClock()
    params = model.init(0, device=args.device)
    engine = VisionEngine(
        model, params,
        VisionEngineConfig(batch=args.capacity,
                           buckets=None if args.fixed_batch else "auto",
                           device=args.device),
        clock=clock)
    plan = engine.plan
    print(f"arch={args.arch} vision path on {engine.device}: compiled plan "
          f"with {plan.num_fused()} fused conv blocks, quant={plan.quant}, "
          f"batch buckets {list(engine.buckets)}")

    frontend = _frontend(VisionAdapter(engine), args, clock)
    rng = np.random.RandomState(1)
    shape = model.input_shape()[1:]
    shed = _submit_all(frontend, (rng.randn(*shape).astype(np.float32)
                                  for _ in range(args.requests)))
    t0 = clock.now()
    results = frontend.run_until_drained()
    wall = clock.now() - t0

    s = engine.stats
    print(f"served {len(results)} images in {wall:.2f}s "
          f"({s.images_per_s:.1f} img/s) over {s.steps} bucket-shaped "
          f"batches (max {args.capacity})")
    print(f"lane utilization {s.lane_utilization:.0%} "
          f"({s.lane_steps} real + {s.pad_lanes} pad lanes), "
          f"pad_fraction={s.pad_fraction:.2f}")
    _print_slo(s, args)
    if shed:
        print(f"shed {shed} submissions at intake (queue full)")
    if results:
        sample = results[min(results)]
        print(f"sample prediction (request {min(results)}): "
              f"label={sample['label']}")
    return engine, results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--capacity", type=int, default=4,
                    help="largest served batch (the bucket ladder's top)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency budget; completions past it "
                         "count as deadline misses in the SLO report")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="front-end intake bound (0 = fit the workload); "
                         "submits beyond it are refused, not queued")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="serve every micro-batch at the full --capacity "
                         "shape (disable bucketed batch plans)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    spec = get_arch(args.arch)
    if spec.family != "cnn":
        raise NotImplementedError(
            f"--arch {args.arch}: the LM serving stack is not ported yet "
            f"(ROADMAP §A.11)")
    return serve_vision(spec.model(), args)


if __name__ == "__main__":
    main()
