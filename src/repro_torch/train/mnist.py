"""The paper's own experiment (§IV): train the Tab.-I CNN on MNIST-like
data, then evaluate the trained weights in float32, in the paper's
16-bit fixed point (Q8.8) and in int8 — the claim that fixed point keeps
the accuracy. Port of ``examples/train_mnist_cnn.py``, with its defaults
(300 steps, batch 128, AdamW lr 2e-3, warmup 20, weight decay 1e-4).

    python -m repro_torch.train.mnist [--steps 300] [--device cpu]

The train step is compiled as the reference's ``jax.jit`` compiles it:
one ``serve.graphs.train_graph`` over static params, optimizer state and
batch buffers. On the card each step is a replay of its CUDA graph, in
which each conv of the training forward is a ``conv_window`` launch and
its gradient comes from ``ConvWindowFn`` (cuDNN); the int8
evaluation runs ``conv_window`` on int8 codes and the fc through
``qmatmul``. Fails (SystemExit) if float32 accuracy is not above 0.9,
as the reference asserts.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticMNIST, shard_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.ops.policy import ExecPolicy
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serve.graphs import train_graph
from repro_torch.train.steps import make_train_step

__all__ = ["train", "evaluate", "evaluate_formats", "main"]

FORMATS = ("float32", "qformat", "int8")


def train(steps: int = 300, batch: int = 128, *,
          device: str | torch.device = DEFAULT_DEVICE,
          ckpt: str | None = None) -> tuple[dict, dict]:
    """Train ``PaperCNN`` from seed 0 on ``SyntheticMNIST(seed=0)``;
    every 50 steps print the loss and accuracy and, with ``ckpt``, save
    a checkpoint (keep 2). Returns (params, {"losses", "step_ms",
    "graph"}): the per-step losses, the mean wall ms a step (each step
    ends in the host reading its loss), and the step's ``StepGraph``
    (on the card its capture and its 2 ``conv_window`` launches a
    replay)."""
    dev = resolve_device(device)
    model = PaperCNN(PaperCNNConfig())
    params = model.init(0, device=dev)
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=steps,
                          weight_decay=1e-4)
    opt = adamw_init(params)
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticMNIST(seed=0)
    graph = train_graph(step_fn, params, opt, data.batch(batch, step=0),
                        device=dev)
    mgr = CheckpointManager(ckpt, keep=2) if ckpt else None
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = graph(batch=data.batch(batch, step=i))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 50 == 0:
            print(f"step {i + 1:4d}  loss={losses[-1]:.4f}  "
                  f"acc={float(metrics['accuracy']):.3f}  "
                  f"({(time.perf_counter() - t0) / (i + 1) * 1e3:.0f} "
                  f"ms/step)", flush=True)
            if mgr is not None:
                mgr.save(i + 1, params=params, opt_state=opt)
    step_ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
    return params, {"losses": losses, "step_ms": step_ms,
                    "graph": graph}


def evaluate(model, params, data, steps: int = 10, batch: int = 256,
             seed: int = 999, *,
             device: str | torch.device = DEFAULT_DEVICE) -> float:
    """Mean accuracy over ``steps`` held-out batches (their own seed)."""
    dev = resolve_device(device)
    accs = []
    with torch.no_grad():
        for i in range(steps):
            b = shard_batch(data.batch(batch, step=10_000 + i, seed=seed),
                            device=dev)
            _, m = model.loss(params, b)
            accs.append(float(m["accuracy"]))
    return float(np.mean(accs))


def evaluate_formats(params, *, device: str | torch.device = DEFAULT_DEVICE
                     ) -> dict[str, float]:
    """The trained weights' accuracy in float32, Q8.8 and int8."""
    data = SyntheticMNIST(seed=0)
    return {fmt: evaluate(PaperCNN(PaperCNNConfig(
        policy=None if fmt == "float32" else ExecPolicy(quant=fmt))),
        params, data, device=device) for fmt in FORMATS}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_mnist_ckpt"))
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)
    params, hist = train(args.steps, args.batch, device=args.device,
                         ckpt=args.ckpt)
    acc = evaluate_formats(params, device=args.device)
    print("\n== §IV accuracy under quantization (the paper's claim) ==")
    print(f"float32        : {acc['float32']:.4f}")
    for fmt in FORMATS[1:]:
        print(f"{fmt:15s}: {acc[fmt]:.4f}  "
              f"(Δ {acc[fmt] - acc['float32']:+.4f})")
    if not acc["float32"] > 0.9:
        raise SystemExit(f"CNN failed to train: float32 accuracy "
                         f"{acc['float32']:.4f}")
    return {"accuracy": acc, **hist}


if __name__ == "__main__":
    main()
