#!/usr/bin/env python3
"""qwen1.5-0.5b over an NCCL mesh of several NVIDIA GPUs, one rank a
card: its serving and training steps captured as CUDA graphs, held
against the same steps run eagerly.

    python3 scripts/nccl_mesh_graphs.py [--meshes 1x2,2x2]

Needs as many cards as the largest mesh has ranks (4 for 2x2); it
exits 1 with fewer. The ``qmatmul`` library is built first, in this
process. Then for each mesh a world of ``run_spmd`` ranks over NCCL,
each on ``cuda:<rank>`` and a ``DeviceMesh`` of ``("data", "model")``:

- ``Engine`` at full size (24 layers) in bf16 and under int8 (every MLP
  matmul a ``qmatmul`` on the rank's shard, an int8 KV cache), serving
  4 requests of 16-40 tokens, 8 new tokens each at capacity 4, once
  with its step graphs (``graphs: on``) and once eagerly
  (``EngineConfig(graphs=False)``): the same tokens; the step wall of
  each, the graphs' launches of ``qmatmul`` (captured x replays);
- ``launch/train.py --mesh DxM --dist-backend nccl`` at full width cut to
  4 layers, 3 steps at 8 x 128, with its train graph and with
  ``--eager``: the same losses, bitwise.

Prints the cards' names and power limits, one JSON line a rank and
mesh, and a last line ``{"ok": true|false, ...}``; the whole report goes
to ``build/nccl_mesh_graphs.json``. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen1.5-0.5b"
PROMPT_LENS = (16, 24, 32, 40)
NEW_TOKENS = 8
TRAIN_LAYERS = 4
TRAIN_STEPS = 3
WORLD_TIMEOUT_S = 180


def _serve(model, params, ctx, quant, graphs, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.ops import ExecPolicy
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(model, params, EngineConfig(
        capacity=4, max_seq=80, device=str(device), graphs=graphs,
        policy=ExecPolicy(quant=quant)), ctx)
    rng = np.random.RandomState(1)
    for n in PROMPT_LENS:
        eng.add_request(rng.randint(0, model.cfg.vocab, size=n), NEW_TOKENS)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    out = {"quant": quant, "graphs": eng.graph_mode,
           "tokens": {r.uid: [int(t) for t in r.generated] for r in done},
           "steps": eng.stats.steps,
           "step_wall_ms": 1e3 * wall / max(eng.stats.steps, 1)}
    if graphs:
        out["graph_launches"] = dict(eng.graph_launches())
    return out


def _train(shape, eager: bool, ckpt: str) -> dict:
    import contextlib
    import io

    from repro_torch.launch import train as launcher
    argv = ["--arch", ARCH, "--layers", str(TRAIN_LAYERS),
            "--steps", str(TRAIN_STEPS), "--global-batch", "8",
            "--seq", "128", "--mesh", "x".join(map(str, shape)),
            "--dist-backend", "nccl", "--device", "cuda", "--ckpt", ckpt]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = launcher.main(argv + (["--eager"] if eager else []))
    return {"losses": {int(k): v for k, v in res["losses"].items()},
            "seconds": time.perf_counter() - t0,
            "lines": buf.getvalue().strip().splitlines()[:2]}


def _rank(rank, world, shape, work) -> dict:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx
    device = torch.device("cuda", rank)
    spec = get_arch(ARCH)
    ctx = ShardingCtx(mesh_groups(shape, ("data", "model"), "cuda"),
                      spec.rules())
    model = spec.model()
    params = model.init(0, device=device)
    out = {"rank": rank, "mesh": list(shape), "serve": [], "fails": []}
    for quant in ("none", "int8"):
        graph = _serve(model, params, ctx, quant, True, device)
        eager = _serve(model, params, ctx, quant, False, device)
        if graph["graphs"] != "on":
            out["fails"].append(f"{quant}: graphs {graph['graphs']}")
        if graph["tokens"] != eager["tokens"]:
            out["fails"].append(f"{quant}: graph tokens {graph['tokens']} "
                                f"vs eager {eager['tokens']}")
        out["serve"].append({
            "quant": quant, "graphs": graph["graphs"],
            "tokens_equal": graph["tokens"] == eager["tokens"],
            "steps": graph["steps"],
            "graph_step_wall_ms": graph["step_wall_ms"],
            "eager_step_wall_ms": eager["step_wall_ms"],
            "graph_launches": graph["graph_launches"]})
    del params
    torch.cuda.empty_cache()
    tag = "x".join(map(str, shape))
    g = _train(shape, False, str(Path(work) / f"graph_{tag}"))
    e = _train(shape, True, str(Path(work) / f"eager_{tag}"))
    if g["losses"] != e["losses"]:
        out["fails"].append(f"train: graph losses {g['losses']} vs eager "
                            f"{e['losses']}")
    out["train"] = {"graph": g, "eager": e,
                    "bitwise": g["losses"] == e["losses"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1x2,2x2")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.kernels.build import build
    from repro_torch.launch.mesh import run_spmd
    shapes = [tuple(int(n) for n in m.split("x"))
              for m in args.meshes.split(",")]
    need = max(int(np.prod(s)) for s in shapes)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA cards", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"cards": smi, "torch": torch.__version__}), flush=True)
    build(["qmatmul"])
    worlds = []
    with tempfile.TemporaryDirectory(prefix="nccl_mesh_") as work:
        for shape in shapes:
            t0 = time.perf_counter()
            ranks = run_spmd(_rank, int(np.prod(shape)), "nccl", "cuda",
                             shape, work, timeout=WORLD_TIMEOUT_S)
            for r in ranks:
                print(json.dumps(r), flush=True)
            worlds.append({"mesh": list(shape),
                           "seconds": time.perf_counter() - t0,
                           "ranks": ranks})
    fails = [f"{w['mesh']} rank {r['rank']}: {f}" for w in worlds
             for r in w["ranks"] for f in r["fails"]]
    result = {"ok": not fails, "fails": fails, "cards": smi,
              "worlds": worlds}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "nccl_mesh_graphs.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": not fails, "fails": fails}), flush=True)
    return 0 if not fails else 1


if __name__ == "__main__":
    sys.exit(main())
