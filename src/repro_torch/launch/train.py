"""Training launcher: ``--arch <id>`` + checkpoints + auto-resume (port
of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 20 \
        --global-batch 8 --seq 128 --ckpt DIR --ckpt-every 10

trains the arch at full size on the card (``--device cpu --reduced`` runs
a small same-family model on the CPU). It draws the reference's weights'
shapes from seed 0, feeds the synthetic Markov token stream and takes
AdamW steps (``train.steps``); every ``--ckpt-every`` steps and at the
end it saves params, optimizer state and the data iterator's state
atomically (keep 3). On start it resumes from the newest checkpoint in
``--ckpt``, so a run killed and invoked again with the same arguments
continues where its last checkpoint left it, bit for bit: the launcher
turns on ``torch.use_deterministic_algorithms`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the first CUDA call), so
the embedding's backward (an index accumulate) and cuBLAS reduce in a
fixed order. Each step prints its loss at full precision (``repr``),
so that two runs' losses can be compared bitwise from their output.

The step is compiled as the reference's ``jax.jit`` compiles it: one
``serve.graphs.train_graph`` for the run's (batch, seq, microbatches),
whose static buffers are the params and optimizer state the run starts
from (a fresh init, or the restored checkpoint's trees). On the card
each step is a replay of its CUDA graph, captured at the first step
(``--eager`` runs the same steps on the same buffers without one); the
checkpoints read the static trees, which each step writes in place.

Training over a mesh waits for the LM half of ROADMAP §A.10: ``--mesh``
takes ``auto`` or ``1`` (one device). Encoder-decoder archs, whose batch
needs frames, are trained through ``train.steps`` directly, as the
reference's launcher, whose stream has only tokens, cannot feed them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

__all__ = ["reduced_config", "main"]


def reduced_config(model):
    """A small same-family model: 2 layers, d_model 64, 4 heads, d_ff 128,
    vocab 2,048, and an MoE config cut to 4 experts of d_ff 128 with
    top-k at most 2 — what ``--reduced`` trains and serves, so the whole
    loop runs on the CPU."""
    from repro_torch.models.transformer import LMConfig
    cfg = model.cfg
    if isinstance(cfg, LMConfig):
        moe = cfg.moe
        if moe is not None:
            moe = dataclasses.replace(moe, d_model=64, d_ff=128, n_experts=4,
                                      top_k=min(moe.top_k, 2))
        small = dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=None, d_ff=128, vocab=2048, moe=moe,
            sliding_window=64 if cfg.sliding_window else None, remat="none")
        return type(model)(small)
    raise SystemExit(f"--reduced supports LM archs; got {type(cfg)}")


def _parser() -> argparse.ArgumentParser:
    from repro_torch.device import DEFAULT_DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="auto",
                    help="'auto' or '1' (one device) until the mesh is "
                         "ported")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="small same-family config (CPU debugging)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--eager", action="store_true",
                    help="run each step eagerly on the same static "
                         "buffers, no CUDA graph (to compare against)")
    return ap


def main(argv=None) -> dict:
    """Train; returns {"start": the step resumed from, "losses": {step:
    loss}} of this invocation."""
    args = _parser().parse_args(argv)
    # before the first CUDA call: cuBLAS reads it when it makes a handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _train(args) -> dict:
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (SyntheticTextConfig,
                                           SyntheticTextIterator)
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.serve.graphs import train_graph
    from repro_torch.train.steps import make_train_step

    if args.mesh not in ("auto", "1"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: training over a mesh is not ported yet "
            f"(ROADMAP §A.10, the LM half); 'auto' and '1' train on one "
            f"device")
    spec = get_arch(args.arch)
    if spec.frames:
        raise NotImplementedError(
            f"{args.arch}: the encoder's frames are not in the token "
            f"stream; train it through repro_torch.train.make_train_step "
            f"with a batch that holds them")
    dev = resolve_device(args.device)
    model = spec.model()
    if args.reduced:
        model = reduced_config(model)
    print(f"arch={args.arch} params={model.cfg.param_count() / 1e6:.1f}M "
          f"device={dev}", flush=True)

    opt_cfg = AdamWConfig(total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg,
                              microbatches=args.microbatches)
    dcfg = SyntheticTextConfig(vocab=model.cfg.vocab, seq_len=args.seq,
                               global_batch=args.global_batch)
    mgr = CheckpointManager(args.ckpt, keep=3)
    start = 0
    if mgr.latest_step() is not None:
        # shapes and dtypes only (the reference's eval_shape): nothing drawn
        meta = model.init(torch.Generator(), device="meta")
        start, params, opt, extra = mgr.restore(
            params_template=meta, opt_template=adamw_init(meta, opt_cfg),
            device=dev)
        data = SyntheticTextIterator.from_state(dcfg, extra["data"])
        print(f"auto-resumed from step {start}", flush=True)
    else:
        params = model.init(0, device=dev)
        opt = adamw_init(params)
        data = SyntheticTextIterator(dcfg)

    # the compiled step (serve/graphs.py): params and opt are its static
    # buffers from here on, each step writes them in place
    first = data.next_batch()
    graph = train_graph(step_fn, params, opt, first, device=dev,
                        compiled=not args.eager)
    losses = {}
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = first if i == start else data.next_batch()
        metrics = graph(batch=batch)
        losses[i + 1] = loss = float(metrics["loss"])
        print(f"step {i + 1:5d}  loss={loss!r}  "
              f"{(time.perf_counter() - t0) / (i + 1 - start):.2f}s/step",
              flush=True)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            mgr.save(i + 1, params=params, opt_state=opt,
                     extra={"data": data.state_dict()})
            print(f"saved step {i + 1}", flush=True)
    if dev.type == "cuda" and graph.captured:
        print(f"captured the train step in {graph.capture_s * 1e3:.1f} ms "
              f"({graph.pool_bytes:,} pool bytes)", flush=True)
    if dev.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
              f" GB", flush=True)
    print("training complete", flush=True)
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
