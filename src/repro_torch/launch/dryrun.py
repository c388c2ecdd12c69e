"""Dry run: every (arch × shape) run on the meta device and counted, with
memory, cost, collectives and an H100 roofline (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on its production TPU meshes
(512 placeholder host devices) and reads the compiled program's memory
and cost analyses. The port runs the cell's own step (the train step,
the prefill or the decode serve step) on tensors of PyTorch's ``meta``
device, which have shapes and dtypes and no storage, under
``launch/op_stats.py``'s counter:

  reference                         port
  jax.eval_shape                    tensors on the meta device
  512 placeholder host devices      a ``fake`` process group (``fake_world``)
  compiled.as_text() + analyze_hlo  OpCounter over the step on meta
  memory_analysis()                 argument bytes + the step's peak live
                                    bytes on meta
  v5e peaks                         the H100's (launch/roofline.py)

The mesh dry run counts a cell as rank 0 of the reference's production
mesh, ``pod16x16`` (256 ranks, ``multi_pod=False``) or ``pod2x16x16``
(512, ``multi_pod=True``): this one process joins a ``fake`` process
group of that world (collectives that move nothing) for the one cell,
builds the mesh over it (``launch/mesh.py``), lays the params, the
optimizer state and the serve cache out as meta DTensors of rank 0's
local shards (``param_shardings`` and ``cache_axes()`` under the arch's
rules) and runs the step: FLOPs, bytes and the peak are rank 0's, and
every collective the mesh paths issue is counted by kind, with the bytes
``sharding/groups.py``'s ``StagedGroup`` counts into ``COMM_STATS``
when the same step runs on real ranks. The inputs stay plain global
tensors, as the port's steps take them (every rank draws the same
global batch and the model keeps its rows). Where a shard is uneven the
record says rank 0's program is not every rank's. ``multi_pod=None``
(``--one-device``) is the one-device count (``h100x1``).

A train cell counts one microbatch and multiplies it by their number
(``count_train_step``), as the reference's HLO walk multiplies a
``while`` body by its trip count; on a mesh the microbatches follow the
reference's data-parallel default, ``min(16, batch // (data · pod))``.
Nothing runs on a card: meta needs neither the card nor memory, so the
dry run runs on the CPU as well as beside the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --one-device
Writes one JSON per cell under reports/dryrun_torch/,
``{mesh}__{arch}__{shape}{__tag}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch.op_stats import OpStats, count
from repro_torch.launch.roofline import RooflineReport
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.sharding.logical import (DEFAULT_RULES, SP_DECODE_RULES,
                                          ShardingCtx, mesh_sizes,
                                          on_mesh, param_shardings)
from repro_torch.train.steps import TrainStep, make_train_step

__all__ = ["model_flops_for", "SkipCell", "train_opt_config",
           "count_train_step", "count_step", "build_cell", "run_cell",
           "cell_line", "main", "fake_world", "lay_out", "cell_rules",
           "uneven_shards", "MESH", "POD_MESHES", "REPORTS",
           "TRAIN_MICROBATCHES"]

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
TRAIN_MICROBATCHES = 16
MESH = "h100x1"                     # the one-device count
POD_MESHES = {False: "pod16x16", True: "pod2x16x16"}


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks, for the block: collectives over it return at once and move
    nothing. The group is destroyed on leaving, so nothing of it outlives
    the cell. A process that has joined a group already is refused (the
    dry run would count on it, or leave it behind)."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError(
            "the mesh dry run joins a fake process group of its own, and "
            "this process has joined one already: run it in a process "
            "without a group")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def model_flops_for(arch_spec, kind: str, seq: int, batch: int) -> float:
    """Useful FLOPs per step: 6·N_active·tokens (train), 2·N_active·tokens
    (inference fwd)."""
    m = arch_spec.model()
    n_active = m.cfg.active_param_count() if hasattr(m.cfg, "active_param_count") \
        else m.cfg.param_count()
    if kind == "train":
        tokens = batch * seq
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = batch * seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * batch  # decode: one token per sequence


class SkipCell(Exception):
    pass


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _bytes(tree) -> int:
    """Bytes this rank holds of ``tree``: a DTensor's local shard."""
    from torch.utils._pytree import tree_leaves
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def train_opt_config(model) -> AdamWConfig:
    """The train cells' AdamW: bf16 moments above 1e11 parameters (the
    reference's low-memory stand-in for 8-bit moments), fp32 below."""
    if model.cfg.param_count() > 100e9:
        return AdamWConfig(m_dtype=torch.bfloat16, v_dtype=torch.bfloat16)
    return AdamWConfig()


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def lay_out(tree, axes, ctx: ShardingCtx):
    """A tree of meta tensors as meta DTensors on ``ctx.mesh``, each
    rank 0's local shard of the layout ``axes`` resolves to under
    ``ctx.rules`` (``DTensor.from_local`` at the local shape: nothing is
    scattered, nothing allocated)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    sh = param_shardings(tree, axes, ctx.mesh, ctx.rules)

    def one(t, s):
        pl = s.placements
        shape, _ = compute_local_shape_and_global_offset(t.shape, ctx.mesh,
                                                         pl)
        local = torch.empty(tuple(shape), dtype=t.dtype, device="meta")
        return DTensor.from_local(local, ctx.mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return _tree_map(one, tree, sh)


def uneven_shards(trees) -> list[str]:
    """Paths of the DTensors in ``trees`` whose shards are not all of one
    shape (a dim that its mesh axes do not divide): there rank 0's
    program is not every rank's."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten_with_path, keystr
    out = []
    sizes = None
    for path, t in tree_flatten_with_path(trees)[0]:
        if not isinstance(t, DTensor):
            continue
        mesh = t.device_mesh
        sizes = sizes or [int(n) for n in mesh.mesh.shape]
        split = [1] * t.ndim
        for n, p in zip(sizes, t.placements):
            if p.is_shard():
                split[p.dim] *= n
        if any(d % k for d, k in zip(t.shape, split)):
            out.append(keystr(path))
    return out


def count_train_step(step: TrainStep, params, opt_state, batch) -> OpStats:
    """``step(params, opt_state, batch)`` counted part by part, its
    microbatch loop as one microbatch × their number; the peak is the
    largest of the parts', each with what the step holds meanwhile
    (params, optimizer state, batch, cast params, accumulator) live."""
    live = (params, opt_state, batch)
    cast, total = count(step.cast, params, live=live)
    live += (cast,)
    if step.microbatches == 1:
        (loss, metrics, grads), part = count(step.grads, cast, batch,
                                             live=live)
        total.add(part)
    else:
        acc, part = count(step.accumulator, params, live=live)
        total.add(part)
        live += (acc,)
        mbs, part = count(step.split, batch, live=live)    # views
        total.add(part)
        metrics, part = count(step.accumulate, cast, acc, mbs[0],
                              repeat=step.microbatches, live=live)
        total.add(part)
        (loss, metrics, grads), part = count(
            step.mean, acc, [metrics] * step.microbatches, live=live)
        total.add(part)
    _, part = count(step.update, params, opt_state, grads, loss, metrics,
                    live=live)
    return total.add(part)


def count_step(model, kind: str, inputs: dict, ctx: ShardingCtx | None =
               None, *, cache=None, opt_cfg: AdamWConfig | None = None,
               microbatches: int = 1, cast_params_once: bool = False
               ) -> tuple[OpStats, dict]:
    """(OpStats, argument bytes by kind) of one step of ``model``
    (``kind``: train, prefill or decode) on the meta device: its params
    (and a train step's AdamW state, a serve step's ``cache``, given as
    global meta tensors) laid out on ``ctx``'s mesh as rank 0's shards
    (``lay_out``; whole without a mesh); ``inputs`` (the batch, or a
    decode step's ``tokens`` and ``pos``) global, as every rank takes
    them. The memory dict's ``uneven`` lists the arguments whose shards
    differ in shape between ranks."""
    params = model.init(torch.Generator(), device="meta")
    mesh = on_mesh(ctx)
    if mesh:
        params = lay_out(params, model.axes(), ctx)
    memory = {"params": _bytes(params), "optimizer": 0,
              "inputs": _bytes(inputs), "cache": 0}
    args = [params]
    if kind == "train":
        opt_cfg = opt_cfg or train_opt_config(model)
        opt = adamw_init(params, opt_cfg)
        memory["optimizer"] = _bytes(opt)
        step = make_train_step(model, opt_cfg, ctx,
                               microbatches=microbatches,
                               cast_params_once=cast_params_once)
        stats = count_train_step(step, params, opt, inputs)
        args.append(opt)
    else:
        if mesh:
            cache = lay_out(cache, model.cache_axes(), ctx)
        memory["cache"] = _bytes(cache)
        if kind == "prefill":
            _, stats = count(make_prefill_step(model, ctx), params, inputs,
                             cache)
        else:
            _, stats = count(make_decode_step(model, ctx), params,
                             inputs["tokens"], inputs["pos"], cache)
        args.append(cache)
    memory["argument_bytes"] = sum(memory.values())
    memory["peak_bytes"] = stats.peak_bytes
    if mesh:
        memory["uneven"] = uneven_shards(args)
    return stats, memory


def cell_rules(spec, shape_id: str, rules=None, rule_patch=None):
    """A cell's sharding rules, as the reference's ``lower_cell`` picks
    them: ``SP_DECODE_RULES`` for ``long_500k`` else the defaults, the
    arch's overrides on top (or ``rules`` when given), then
    ``rule_patch``."""
    if rules is None:
        base = SP_DECODE_RULES if shape_id == "long_500k" else DEFAULT_RULES
        rules = spec.rules(base)
    if rule_patch:
        rules = rules.with_overrides(**rule_patch)
    return rules


def build_cell(arch_id: str, shape_id: str, mesh=None, *, rules=None,
               config_patch: dict | None = None,
               microbatches: int | None = None,
               rule_patch: dict | None = None,
               cast_params_once: bool = False) -> dict:
    """Build one (arch, shape) cell on the meta device and count its
    step on ``mesh`` (one device when None): {"kind", "seq", "batch",
    "stats" (OpStats), "memory" (argument bytes by kind), "microbatches"}.
    A train cell takes ``microbatches``, by default min(16, batch // dp)
    with dp the mesh's data × pod extent (1 on one device), as the
    reference's dp-aware default. ``config_patch`` replaces fields of the
    model's config; ``rules``/``rule_patch`` as ``cell_rules``."""
    spec = get_arch(arch_id)
    reason = spec.skip_reason(shape_id)
    if reason:
        raise SkipCell(reason)
    kind, in_specs, _, seq, batch = spec.input_specs(shape_id)
    model = spec.model()
    if config_patch:
        model = type(model)(dataclasses.replace(model.cfg, **config_patch))
    ctx = None
    if mesh is not None:
        ctx = ShardingCtx(mesh, cell_rules(spec, shape_id, rules,
                                           rule_patch))
    if kind == "train":
        if microbatches is None:
            sizes = mesh_sizes(mesh) if mesh is not None else {}
            dp = sizes.get("data", 1) * sizes.get("pod", 1)
            microbatches = max(1, min(TRAIN_MICROBATCHES, batch // dp))
        stats, memory = count_step(model, kind, in_specs, ctx,
                                   microbatches=microbatches,
                                   cast_params_once=cast_params_once)
    else:
        microbatches = None
        cache, _ = spec.cache_specs(shape_id)
        stats, memory = count_step(model, kind, in_specs, ctx, cache=cache)
    return {"kind": kind, "seq": seq, "batch": batch, "stats": stats,
            "memory": memory, "microbatches": microbatches}


def _mesh_cell(arch_id, shape_id, multi_pod, **kw) -> dict:
    """``build_cell`` as rank 0 of the production mesh, in a fake world
    that lives for this cell only."""
    from repro_torch.launch.mesh import make_mesh_shape, make_production_mesh
    shape, _ = make_mesh_shape(multi_pod=multi_pod)
    world = 1
    for n in shape:
        world *= n
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        return build_cell(arch_id, shape_id, mesh, **kw)


def run_cell(arch_id: str, shape_id: str, *, multi_pod: bool | None = None,
             out_dir: Path = REPORTS, rules=None, tag: str = "",
             config_patch: dict | None = None,
             microbatches: int | None = None,
             rule_patch: dict | None = None,
             cast_params_once: bool = False) -> dict:
    """Build, count and report one cell on ``pod16x16``
    (``multi_pod=False``), ``pod2x16x16`` (True) or one device (None);
    writes ``{out_dir}/{mesh}__{arch}__{shape}{__tag}.json`` and returns
    its record (``status`` ok, skipped or error: an error is reported,
    not raised, so a sweep runs on). The other arguments are the
    reference's knobs (``build_cell``)."""
    name = MESH if multi_pod is None else POD_MESHES[bool(multi_pod)]
    chips = 1 if multi_pod is None else (512 if multi_pod else 256)
    rec = {"arch": arch_id, "shape": shape_id, "mesh": name,
           "chips": chips, "status": "ok", "tag": tag,
           "variant": {"config_patch": config_patch,
                       "microbatches": microbatches,
                       "rule_patch": bool(rule_patch)}}
    kw = dict(rules=rules, config_patch=config_patch,
              microbatches=microbatches, rule_patch=rule_patch,
              cast_params_once=cast_params_once)
    t0 = time.perf_counter()
    try:
        if multi_pod is None:
            cell = build_cell(arch_id, shape_id, **kw)
        else:
            cell = _mesh_cell(arch_id, shape_id, multi_pod, **kw)
        rec["count_s"] = round(time.perf_counter() - t0, 2)
        stats = cell["stats"]
        rec["microbatches"] = cell["microbatches"]
        rec["memory"] = cell["memory"]
        if cell["memory"].get("uneven"):
            rec["rank0_is_every_rank"] = False
            rec["note"] = ("uneven shards: rank 0's program is not every "
                           "rank's (memory.uneven lists them)")
        elif multi_pod is not None:
            rec["rank0_is_every_rank"] = True
        rec["op_stats"] = stats.to_dict()
        rec["collectives"] = {
            "bytes_by_op": dict(stats.collective_bytes_by_op),
            "count_by_op": dict(stats.collective_count_by_op)}
        report = RooflineReport(
            arch=arch_id, shape=shape_id, mesh=name, chips=chips,
            flops_per_device=stats.flops,
            bytes_per_device=stats.bytes_accessed,
            collective_bytes_per_device=stats.collective_bytes,
            model_flops=model_flops_for(get_arch(arch_id), cell["kind"],
                                        cell["seq"], cell["batch"]),
            peak_memory_per_device=stats.peak_bytes,
            flops_by_dtype=stats.flops_by_dtype,
            collective_bytes_by_op=dict(stats.collective_bytes_by_op),
            collective_count_by_op=dict(stats.collective_count_by_op))
        rec["roofline"] = report.to_dict()
    except SkipCell as e:
        rec["status"] = "skipped"
        rec["reason"] = str(e)
    except Exception as e:  # report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{name}__{arch_id}__{shape_id}{suffix}.json"
    path.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def cell_line(rec: dict) -> str:
    """The one line ``main`` prints a cell."""
    extra = ""
    if rec["status"] == "ok":
        r = rec["roofline"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" compute={r['compute_s']:.3e}s"
                 f" memory={r['memory_s']:.3e}s"
                 f" coll={r['collective_s']:.3e}s"
                 f" mfu={r['mfu']:.3f}"
                 f" peak={rec['memory']['peak_bytes'] / 1e9:.1f}GB")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:200]
    return f"[{rec['mesh']}] {rec['arch']} × {rec['shape']}: " \
           f"{rec['status']}{extra}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="off",
                    help="off: pod16x16; on: pod2x16x16; both: the two")
    ap.add_argument("--one-device", action="store_true",
                    help="count one device (h100x1) instead of a mesh")
    ap.add_argument("--out", default=str(REPORTS))
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = [None] if args.one_device else \
        {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    for mp in pods:
        for a in archs:
            for s in shapes:
                print(cell_line(run_cell(a, s, multi_pod=mp,
                                         out_dir=Path(args.out))),
                      flush=True)


if __name__ == "__main__":
    main()
