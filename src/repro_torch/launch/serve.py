"""Serving launcher: ``--arch <id>`` behind the serving front-end
(DESIGN.md §11), on the card unless ``--device cpu``.

Port of ``repro.launch.serve``. An LM arch serves through the
continuous-batching ``Engine`` (DESIGN.md §6) behind ``LMAdapter``: a
seeded synthetic workload of ``--requests`` prompts (half of them
``--prompt-len`` tokens, half ``--prompt-len // 2``) with a budget of
``--decode-steps`` tokens each, over ``--capacity`` KV slots of
``--max-seq`` positions (default prompt + decode), in the model's dtype
(bf16 for qwen1.5-0.5b), with an int8 KV cache under ``--kv-quant int8``.
A sub-quadratic arch takes prompts that are whole scan chunks (a
ragged one raises): zamba2-7b ``--prompt-len 512`` (chunk 256),
rwkv6-1.6b ``--prompt-len 128`` (chunk 64); neither has a
``--reduced``, as in the reference. ``--reduced`` serves a 2-layer,
d_model 64 model of a transformer arch's family. The weights are random
from seed 0, drawn by a generator on the serving device, so ``--device
cpu`` and the card serve different weights and their tokens cannot be
compared (the CNNs draw on the CPU for any
device). The int8 compute path has no flag, as in the reference: it is
``EngineConfig(policy=ExecPolicy(quant="int8"))``. The report is the
reference's: occupancy, tokens/s and the SLO view. The engine takes the
weights over (cast once to the compute dtype) and, before the first
request, compiles its steps for the workload's two prompt lengths and
its decode shape (on the card a CUDA graph each, ``serve/graphs.py``);
on the card the report ends with that time to ready and the graphs'
pool bytes, and ``--warmup-report`` prints the phase table.

A CNN arch serves through the bucketed vision engine over compiled plans:
a synthetic workload of ``--requests`` seeded images submitted through
the front-end with an optional ``--slo-ms`` deadline budget, and a report
of throughput, lane occupancy and the SLO view. Its boot flags are the
reference's:

  * ``--tuning-cache PATH`` loads a persisted tuned-tile table before any
    plan compiles and saves it (merged) after serving;
  * ``--autotune`` measures launch shapes at each bucket's bind (on the
    card; the CPU tunes nothing) and bakes the winners in;
  * ``--plan-artifact DIR`` boots the bucket ladder from a plan artifact
    store (no trace/fuse/place/tune work when every bucket hits; a bad
    artifact warns and compiles fresh);
  * ``--save-plan DIR`` writes the ladder out after boot;
  * ``--warmup-report`` prints the time-to-ready breakdown (trace, fuse,
    place, tune, compile — the nvcc build and the CUDA graph captures on
    the card —, artifact, first_dispatch).

``--mesh DxM`` (data × model) compiles a CNN arch's plans
channel-parallel (DESIGN.md §9/§15) over a ``DeviceMesh`` built by
``repro_torch.launch.mesh.build_mesh``: every rank of the process group
(``torchrun``, or one rank alone) serves the same requests, each running
its shards. ``--dist-backend`` names the process-group backend: NCCL
when every rank has a card of its own (the default resolves to it and
raises otherwise), ``gloo`` for several ranks on one card or on the CPU.
``auto`` keeps the vision path on one device, as in the reference. An LM
arch on ``--mesh DxM`` or ``PxDxM`` (pod × data × model, the
multi-pod mesh: the slots split over pod and data) serves through the
``Engine`` on every rank
(SPMD, rank 0 prints), its weights and KV cache laid out by the model's
logical axes under the arch's rules (``repro_torch.sharding``); over
gloo its steps run eagerly (``graphs: off (gloo)``), over NCCL they are
captured as on one device. Every LM family has a mesh path: the MoE
archs run expert-parallel where ``model`` divides their experts, the
hybrid and RWKV-6 split their heads over ``model`` (the encoder-decoder
has no ``Engine``, as in the reference).

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --capacity 4 \
        --requests 8 --prompt-len 64 --decode-steps 16 [--kv-quant int8]
    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \
        --capacity 2 --requests 4 --prompt-len 16 --decode-steps 8 \
        --device cpu
    python -m repro_torch.launch.serve --arch mnist_cnn --capacity 8 \
        --requests 32
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch mnist_cnn --mesh 1x4 --dist-backend gloo
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen1.5-0.5b --mesh 1x2 --dist-backend gloo
    python -m repro_torch.launch.serve --arch highres_cnn --capacity 8 \
        --requests 16 --autotune --tuning-cache tuned.tuning.json \
        --save-plan plans/ --warmup-report

Any ``cnn`` arch serves through the same path: ``serve_vision`` needs
only the model's ``init(seed, device=...)``, ``input_shape()`` and
``compile(...)``; ``highres_cnn``'s plans stream its first two blocks.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.device import DEFAULT_DEVICE


def _load_tuning_cache(path) -> None:
    """``--tuning-cache`` load half: merge a persisted tuned-tile table
    into the process cache before any plan compiles. A missing file is
    fine (first runs start empty); corrupt or unknown-version files warn
    and fall back to the heuristics inside ``TuningCache.load``."""
    import os

    from repro_torch.ops.tiling import TUNING_CACHE
    if not path:
        return
    if not os.path.exists(path):
        print(f"tuning cache: {path} not found (starting empty)")
        return
    n = TUNING_CACHE.load(path)
    print(f"tuning cache: loaded {n} entries from {path}")


def _save_tuning_cache(path) -> None:
    """``--tuning-cache`` save half: persist everything measured in this
    process (bind-time autotuning included) for the next one."""
    from repro_torch.ops.tiling import TUNING_CACHE
    if not path:
        return
    TUNING_CACHE.save(path)
    print(f"tuning cache: saved {len(TUNING_CACHE)} entries to {path}")


def _frontend(adapter, args, clock):
    from repro_torch.serve import Frontend, FrontendConfig
    max_queue = args.max_queue or max(args.requests, 64)
    slo_s = args.slo_ms / 1e3 if args.slo_ms else None
    return Frontend(adapter, FrontendConfig(max_queue=max_queue,
                                            slo_s=slo_s), clock)


def _submit_all(frontend, payloads, **options) -> int:
    """Submit everything; a full queue sheds (typed, counted) instead of
    hanging — the launcher's workload is open-loop."""
    from repro_torch.serve import QueueFullError
    shed = 0
    for p in payloads:
        try:
            frontend.submit(p, **options)
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


def serve_vision(model, args, mesh=None):
    """Micro-batched image serving through bucketed bound plans behind
    the front-end (on the card, a CUDA graph a bucket; on a ``mesh``,
    channel-parallel plans on every rank). Returns (engine, {rid:
    {"label", "logits"}})."""
    from repro_torch.artifact.warmup import collect_warmup
    from repro_torch.serve import (MonotonicClock, VisionAdapter,
                                   VisionEngine, VisionEngineConfig)
    clock = MonotonicClock()
    params = model.init(0, device=args.device)
    with collect_warmup() as boot:
        # prewarm (on by default) compiles or loads EVERY bucket here
        engine = VisionEngine(
            model, params,
            VisionEngineConfig(batch=args.capacity, mesh=mesh,
                               buckets=None if args.fixed_batch else "auto",
                               device=args.device, autotune=args.autotune,
                               artifact_dir=args.plan_artifact),
            clock=clock)
    plan = engine.plan
    sharded = ""
    if mesh is not None:
        from repro_torch.artifact.fingerprint import mesh_shape_doc
        sharded = (f", {plan.num_sharded()} sharded stages over "
                   f"mesh={dict(mesh_shape_doc(mesh))} (graphs: "
                   f"{engine.graphs})")
    tuned = ""
    if args.autotune:
        baked = engine._bounds[args.capacity].tuned
        tuned = f", {len(baked)} autotuned stages"
    print(f"arch={args.arch} vision path on {engine.device}: compiled plan "
          f"with {plan.num_fused()} fused conv blocks, quant={plan.quant}"
          f"{sharded}{tuned}, batch buckets {list(engine.buckets)}")
    if args.warmup_report:
        print(boot.pretty())
    if args.plan_artifact:
        srcs = ", ".join(f"{b}:{s}"
                         for b, s in sorted(engine.plan_source.items()))
        print(f"plan artifacts: {srcs}")
        status = ("OK (trace/fuse/place/tune phases all 0)"
                  if boot.zero_compile() else
                  "DEGRADED (fresh pipeline ran for some buckets)")
        print(f"zero-derivation boot: {status}")
    if args.save_plan:
        fps = engine.save_artifacts(args.save_plan)
        for name, fp in sorted(fps.items()):
            print(f"saved plan artifact {args.save_plan}/{name} "
                  f"fingerprint={fp[:16]}")

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


def serve_lm(model, args, ctx=None):
    """Continuous-batching LM serving behind the front-end; on a mesh
    (``ctx``) every rank serves the same workload. Returns (engine,
    {rid: Request})."""
    from repro_torch.serve import (Engine, EngineConfig, LMAdapter,
                                   MonotonicClock)
    from repro_torch.artifact.warmup import collect_warmup
    clock = MonotonicClock()
    max_seq = args.max_seq or (args.prompt_len + args.decode_steps)
    # mixed-length synthetic workload: jittered prompts, fixed budget
    rng = np.random.RandomState(1)
    lens = rng.choice([args.prompt_len // 2, args.prompt_len],
                      size=args.requests)
    with collect_warmup() as boot:
        # the weights are handed over: cast once, never held twice
        engine = Engine(model, model.init(0, device=args.device),
                        EngineConfig(capacity=args.capacity,
                                     max_seq=max_seq,
                                     kv_quant=args.kv_quant,
                                     device=args.device),
                        ctx=ctx, clock=clock, donate=True)
        # the step graphs of the workload's shapes, captured on the card
        for plen in sorted({int(p) for p in lens if p <= max_seq}):
            engine.warm_prefill(plen)
        engine.warm_decode()
    frontend = _frontend(LMAdapter(engine), args, clock)

    shed = _submit_all(frontend,
                       (rng.randint(0, model.cfg.vocab, size=int(plen))
                        for plen in lens),
                       max_new_tokens=args.decode_steps)

    t0 = clock.now()
    results = frontend.run_until_drained()
    wall = clock.now() - t0
    finished = list(results.values())

    s = engine.stats
    total_tokens = s.prefill_tokens + s.decode_tokens
    print(f"arch={args.arch} capacity={args.capacity} "
          f"kv_quant={args.kv_quant} kv_bytes={engine.kv.nbytes():,}")
    if ctx is not None:
        from repro_torch.sharding.logical import mesh_sizes
        print(f"mesh={mesh_sizes(ctx.mesh)} graphs: {engine.graph_mode}")
    print(f"served {len(finished)} requests in {wall:.2f}s "
          f"({len(finished) / wall:.2f} req/s)")
    print(f"engine steps {s.steps} | mean occupancy "
          f"{engine.scheduler.stats.mean_occupancy():.2f}/{args.capacity} "
          f"| decode lane utilization {s.decode_utilization:.0%}")
    print(f"tokens: {s.prefill_tokens} prefill + {s.decode_tokens} decode "
          f"= {total_tokens} ({total_tokens / wall:.1f} tok/s)")
    _print_slo(s, args)
    if shed:
        print(f"shed {shed} submissions at intake (queue full)")
    served = [r for r in finished if r.generated]
    if served:
        r0 = served[0]
        print(f"sample continuation (request {r0.uid}):", r0.generated[:10])
    rejected = len(finished) - len(served)
    if rejected:
        print(f"rejected {rejected} requests (prompt > max_seq {max_seq})")
    if engine.device.type == "cuda":
        graphs = engine.graphs()
        print(f"time to ready {boot.total_s * 1e3:.1f} ms: "
              f"{boot.phase_s('compile') * 1e3:.1f} ms capturing "
              f"{sum(g.captured for g in graphs)} step graphs "
              f"({sum(g.pool_bytes for g in graphs):,} pool bytes)")
    if args.warmup_report:
        print(boot.pretty())
    return engine, results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--capacity", type=int, default=4,
                    help="KV slots (max in-flight sequences) of an LM; the "
                         "largest served batch (the bucket ladder's top) "
                         "of a CNN")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="per-slot budget (default prompt+decode)")
    ap.add_argument("--kv-quant", choices=("none", "int8"), default="none")
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (one device) or DxM (data x model): a "
                         "channel-parallel CNN, or an LM laid out by its "
                         "logical axes; PxDxM (pod x data x model) for an "
                         "LM")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="process-group backend of --mesh (default: NCCL "
                         "when every rank has a card of its own)")
    ap.add_argument("--reduced", action="store_true",
                    help="a small same-family LM (2 layers, d_model 64)")
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
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="persisted tuned-tile table: load before "
                         "compiling, save (merged) after serving")
    ap.add_argument("--autotune", action="store_true",
                    help="measure launch shapes at plan bind time on the "
                         "card and bake them into the served plans")
    ap.add_argument("--plan-artifact", default=None, metavar="DIR",
                    help="boot bucket plans from a plan artifact store "
                         "(zero trace/fuse/place/tune on a full hit; "
                         "misses fall back to the fresh pipeline)")
    ap.add_argument("--save-plan", default=None, metavar="DIR",
                    help="after boot, save every bucket plan into DIR for "
                         "the next replica")
    ap.add_argument("--warmup-report", action="store_true",
                    help="print the time-to-ready phase breakdown "
                         "(trace/fuse/place/tune/compile/artifact/"
                         "first_dispatch)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_config
    spec = get_arch(args.arch)
    _load_tuning_cache(args.tuning_cache)
    if spec.frames:
        # the reference's launcher fails here too: EncDecLM.prefill reads
        # batch["frames"], and the Engine's prefill batch has only tokens
        raise KeyError(f"frames: {args.arch} is an encoder-decoder, and the "
                       f"serving Engine feeds its prefill no 'frames' "
                       f"(only tokens); call its prefill/decode_step "
                       f"directly")
    model = spec.model()
    if spec.family == "cnn" and args.mesh != "auto":
        out = _serve_vision_on_mesh(model, args)
    elif spec.family == "cnn":
        out = serve_vision(model, args)
    else:
        model = reduced_config(model) if args.reduced else model
        out = (_serve_lm_on_mesh(model, args, spec) if args.mesh != "auto"
               else serve_lm(model, args))
    _save_tuning_cache(args.tuning_cache)
    return out


def _serve_lm_on_mesh(model, args, spec):
    """``serve_lm`` on every rank of a ``--mesh``, over a DTensor mesh
    (``build_mesh``) under the arch's rules; rank 0 prints
    the report. A process group this call joined is left before
    returning."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.launch.mesh import build_mesh
    from repro_torch.sharding import ShardingCtx
    joined = not dist.is_initialized()
    try:
        mesh = build_mesh(args.mesh, args.dist_backend, args.device)
        quiet = (contextlib.redirect_stdout(io.StringIO())
                 if dist.get_rank() else contextlib.nullcontext())
        with quiet:
            return serve_lm(model, args, ShardingCtx(mesh, spec.rules()))
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _serve_vision_on_mesh(model, args):
    """``serve_vision`` on every rank of a ``--mesh``; rank 0 prints the
    report. A process group this call joined is left before returning."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.launch.mesh import build_mesh
    joined = not dist.is_initialized()
    try:
        mesh = build_mesh(args.mesh, args.dist_backend, args.device)
        quiet = (contextlib.redirect_stdout(io.StringIO())
                 if dist.get_rank() else contextlib.nullcontext())
        with quiet:
            return serve_vision(model, args, mesh=mesh)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
