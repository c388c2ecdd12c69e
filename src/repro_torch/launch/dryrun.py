"""One-device dry run: every (arch × shape) run on the meta device and
counted, with memory, cost and an H100 roofline (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on its production TPU meshes
(512 placeholder host devices) and reads the compiled program's memory
and cost analyses. The port runs the cell's own step (the train step,
the prefill or the decode serve step) on tensors of PyTorch's ``meta``
device, which have shapes and dtypes and no storage, under
``launch/op_stats.py``'s counter:

  reference                         port
  jax.eval_shape                    tensors on the meta device
  compiled.as_text() + analyze_hlo  OpCounter over the step on meta
  memory_analysis()                 argument bytes + the step's peak live
                                    bytes on meta
  v5e peaks                         the H100's (launch/roofline.py)

A train cell counts one microbatch and multiplies it by their number
(``count_train_step``), as the reference's HLO walk multiplies a
``while`` body by its trip count. Nothing runs on a card: meta needs
neither the card nor memory, so the dry run runs on the CPU as well as
beside the card. The multi-pod dry run waits for the LM half of ROADMAP
§A.10: ``--multi-pod on`` and ``both`` raise.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
Writes one JSON per cell under reports/dryrun_torch/.
"""
from __future__ import annotations

import argparse
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
from repro_torch.train.steps import TrainStep, make_train_step

__all__ = ["model_flops_for", "SkipCell", "train_opt_config",
           "count_train_step", "build_cell", "run_cell", "cell_line", "main",
           "MESH", "REPORTS", "TRAIN_MICROBATCHES"]

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
TRAIN_MICROBATCHES = 16
MESH = "h100x1"                     # one card; LM meshes: ROADMAP §A.10


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


def _bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def train_opt_config(model) -> AdamWConfig:
    """The train cells' AdamW: bf16 moments above 1e11 parameters (the
    reference's low-memory stand-in for 8-bit moments), fp32 below."""
    if model.cfg.param_count() > 100e9:
        return AdamWConfig(m_dtype=torch.bfloat16, v_dtype=torch.bfloat16)
    return AdamWConfig()


def count_train_step(step: TrainStep, params, opt_state, batch
                     ) -> OpStats:
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


def build_cell(arch_id: str, shape_id: str) -> dict:
    """Build one (arch, shape) cell on the meta device and count its
    step: {"kind", "seq", "batch", "stats" (OpStats), "memory" (argument
    bytes by kind), "microbatches"}. A train cell takes min(16, batch)
    microbatches (the reference's, at one data-parallel replica)."""
    spec = get_arch(arch_id)
    reason = spec.skip_reason(shape_id)
    if reason:
        raise SkipCell(reason)
    kind, in_specs, _, seq, batch = spec.input_specs(shape_id)
    model = spec.model()
    params = model.init(torch.Generator(), device="meta")
    memory = {"params": _bytes(params), "optimizer": 0,
              "inputs": _bytes(in_specs), "cache": 0}
    microbatches = None

    if kind == "train":
        opt_cfg = train_opt_config(model)
        opt = adamw_init(params, opt_cfg)
        memory["optimizer"] = _bytes(opt)
        microbatches = max(1, min(TRAIN_MICROBATCHES, batch))
        step = make_train_step(model, opt_cfg, microbatches=microbatches)
        stats = count_train_step(step, params, opt, in_specs)
    else:
        cache, _ = spec.cache_specs(shape_id)
        memory["cache"] = _bytes(cache)
        if kind == "prefill":
            _, stats = count(make_prefill_step(model), params, in_specs,
                             cache)
        else:
            _, stats = count(make_decode_step(model), params,
                             in_specs["tokens"], in_specs["pos"], cache)
    memory["argument_bytes"] = sum(memory.values())
    memory["peak_bytes"] = stats.peak_bytes
    return {"kind": kind, "seq": seq, "batch": batch, "stats": stats,
            "memory": memory, "microbatches": microbatches}


def run_cell(arch_id: str, shape_id: str, *, multi_pod: bool = False,
             out_dir: Path = REPORTS) -> dict:
    """Build, count and report one cell; writes
    ``{out_dir}/h100x1__{arch}__{shape}.json`` and returns its record
    (``status`` ok, skipped or error: an error is reported, not raised,
    so a sweep runs on)."""
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod dry run is not ported yet (ROADMAP §A.10, "
            "the LM half)")
    rec = {"arch": arch_id, "shape": shape_id, "mesh": MESH, "chips": 1,
           "status": "ok"}
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch_id, shape_id)
        rec["count_s"] = round(time.perf_counter() - t0, 2)
        stats = cell["stats"]
        rec["microbatches"] = cell["microbatches"]
        rec["memory"] = cell["memory"]
        rec["op_stats"] = stats.to_dict()
        rec["collectives"] = {"bytes_by_op": {}, "count_by_op": {}}
        report = RooflineReport(
            arch=arch_id, shape=shape_id, mesh=MESH, chips=1,
            flops_per_device=stats.flops,
            bytes_per_device=stats.bytes_accessed,
            collective_bytes_per_device=stats.collective_bytes,
            model_flops=model_flops_for(get_arch(arch_id), cell["kind"],
                                        cell["seq"], cell["batch"]),
            peak_memory_per_device=stats.peak_bytes,
            flops_by_dtype=stats.flops_by_dtype)
        rec["roofline"] = report.to_dict()
    except SkipCell as e:
        rec["status"] = "skipped"
        rec["reason"] = str(e)
    except Exception as e:  # report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{MESH}__{arch_id}__{shape_id}.json"
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
                    default="off")
    ap.add_argument("--out", default=str(REPORTS))
    args = ap.parse_args(argv)
    if args.multi_pod != "off":
        raise NotImplementedError(
            f"--multi-pod {args.multi_pod}: the multi-pod dry run is not "
            f"ported yet (ROADMAP §A.10, the LM half); the port's dry "
            f"run is one device (--multi-pod off)")

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    for a in archs:
        for s in shapes:
            print(cell_line(run_cell(a, s, out_dir=Path(args.out))),
                  flush=True)


if __name__ == "__main__":
    main()
