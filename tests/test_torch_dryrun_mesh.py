"""The mesh dry run (``repro_torch.launch.dryrun``): collectives counted on
a fake process group against the ones the same steps really issue.

The dry run counts a cell as rank 0 of a mesh built over a ``fake``
process group, with the params and the serve cache laid out as meta
DTensors of the rank's shards; ``launch/op_stats.py``'s counter files
every collective under the kind ``sharding/groups.py``'s ``StagedGroup``
counts it under in ``core.parallelism.COMM_STATS``, with the same bytes.
So here:

* gloo worlds 1x2 and 2x2 (``run_spmd``) run the reduced dense LM's
  prefill, decode and train steps on real tensors, fp32 and int8, and
  record each step's ``COMM_STATS``; the same steps counted on meta over
  a fake world of the same size must give every rank's calls and bytes
  of each kind, exactly;
* on a 1x1 mesh the count is the one-device count: the same FLOPs, peak
  and argument bytes, no collective; the mesh path's own index
  arithmetic (the vocab lookup's hit mask, the cache write's offsets)
  is the only difference in bytes;
* a full-size cell (qwen1.5-0.5b ``decode_32k`` on ``pod16x16``) writes
  the reference's keys, its roofline pricing the counted collectives;
* a train cell takes the reference's data-parallel microbatch default;
* a planted fault: a counter whose table lacks the all-gather raises
  rather than count a step short.

Every fake world lives inside ``dryrun.fake_world``, which destroys it on
leaving; the rank bodies import no JAX.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import run_spmd
from repro_torch.launch.op_stats import COLLECTIVES
from repro_torch.launch.roofline import ALL_REDUCE_WEIGHT, HW

KW = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab=96, qkv_bias=True)
B, S, T = 4, 8, 12
ADAM = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
AXES = ("data", "model")
STEPS = ("prefill", "decode", "train")
QUANTS = ("none", "int8")
# (quant, step): the train step is fp32 (qmatmul has no backward)
CASES = [(q, s) for q in QUANTS for s in STEPS
         if not (q == "int8" and s == "train")]
# the mesh path's index arithmetic (the vocab lookup's hit mask, the
# cache write's positions and offsets): the only ops whose bytes differ
# between a 1x1 mesh and one device
INDEX_OPS = {"aten.add", "aten.arange", "aten.bitwise_and", "aten.clamp",
             "aten.ge", "aten.index", "aten.lt", "aten.sub", "aten.where",
             "aten.zeros"}


def _model():
    from repro_torch.models.transformer import LMConfig, TransformerLM
    return TransformerLM(LMConfig(**KW, dtype=torch.float32))


def _inputs(device: str) -> dict:
    rng = np.random.RandomState(7)
    tok = rng.randint(0, KW["vocab"], size=(B, S)).astype(np.int32)
    lab = rng.randint(0, KW["vocab"], size=(B, S)).astype(np.int32)
    nxt = rng.randint(0, KW["vocab"], size=(B,)).astype(np.int32)
    pos = np.array([S, S - 1, S, S - 2], np.int32)

    def t(a):
        return torch.from_numpy(a).to(device)
    return {"prefill": {"tokens": t(tok)},
            "decode": {"tokens": t(nxt), "pos": t(pos)},
            "train": {"tokens": t(tok), "labels": t(lab)}}


def _policy(quant):
    from repro_torch.ops import ExecPolicy, use_policy
    return use_policy(ExecPolicy(quant=quant))


# ------------------------------------------------------------ rank side

def _measured(rank, world, shape):
    """Each step's COMM_STATS (calls, bytes by kind) on this rank."""
    from repro_torch.core.parallelism import COMM_STATS
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx, distribute_tree
    from repro_torch.train.steps import make_train_step
    ctx = ShardingCtx(mesh_groups(shape, AXES, "cpu"))
    model = _model()
    params = distribute_tree(model.init(torch.Generator().manual_seed(0),
                                        device="cpu"), model.axes(), ctx)
    inp = _inputs("cpu")

    def read():
        return ({k: float(v) for k, v in COMM_STATS.calls.items()},
                {k: float(v) for k, v in COMM_STATS.bytes.items()})
    out = {}
    opt_cfg = AdamWConfig(**ADAM)
    opt = adamw_init(params, opt_cfg)
    COMM_STATS.reset()
    make_train_step(model, opt_cfg, ctx)(params, opt, inp["train"])
    out["none", "train"] = read()
    for quant in QUANTS:
        with _policy(quant), torch.no_grad():
            cache = distribute_tree(model.init_cache(B, T, device="cpu"),
                                    model.cache_axes(), ctx)
            COMM_STATS.reset()
            _, cache = make_prefill_step(model, ctx)(params, inp["prefill"],
                                                     cache)
            out[quant, "prefill"] = read()
            COMM_STATS.reset()
            make_decode_step(model, ctx)(params, inp["decode"]["tokens"],
                                         inp["decode"]["pos"], cache)
            out[quant, "decode"] = read()
    return out


# ------------------------------------------------------------ meta side

def _count(ctx, quant, step):
    from repro_torch.optim.adamw import AdamWConfig
    model = _model()
    inp = _inputs("meta")[step]
    with _policy(quant):
        if step == "train":
            return dryrun.count_step(model, step, inp, ctx,
                                     opt_cfg=AdamWConfig(**ADAM))
        with torch.no_grad():
            return dryrun.count_step(
                model, step, inp, ctx,
                cache=model.init_cache(B, T, device="meta"))


@functools.cache
def _counted() -> dict:
    """Every (mesh, quant, step)'s counted (calls, bytes) by kind."""
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx
    out = {}
    for name, shape in MESHES.items():
        with dryrun.fake_world(int(np.prod(shape))):
            ctx = ShardingCtx(mesh_groups(shape, AXES, "cpu"))
            for quant, step in CASES:
                st, _ = _count(ctx, quant, step)
                out[name, quant, step] = (st.collective_count_by_op,
                                          st.collective_bytes_by_op)
    return out


@functools.cache
def _worlds() -> dict:
    return {name: run_spmd(_measured, int(np.prod(shape)), "gloo", "cpu",
                           shape, timeout=300)
            for name, shape in MESHES.items()}


# ------------------------------------------------------------ the checks

@pytest.mark.parametrize("quant,step", CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_counted_collectives_equal_the_measured(mesh, quant, step):
    """Calls and bytes of each kind, counted on meta as rank 0, equal
    what every rank's ``COMM_STATS`` recorded running the step."""
    calls, nbytes = _counted()[mesh, quant, step]
    assert calls, f"{mesh} {quant} {step}: no collective counted"
    for rank, r in enumerate(_worlds()[mesh]):
        got_calls, got_bytes = r[quant, step]
        assert got_calls == calls, (mesh, quant, step, rank)
        assert got_bytes == nbytes, (mesh, quant, step, rank)


@pytest.mark.parametrize("step", STEPS)
def test_one_by_one_is_the_one_device_count(step):
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx
    one, one_mem = _count(None, "none", step)
    with dryrun.fake_world(1):
        ctx = ShardingCtx(mesh_groups((1, 1), AXES, "cpu"))
        got, mem = _count(ctx, "none", step)
    assert got.collective_count_by_op == {} and got.collective_bytes == 0
    assert (got.flops, got.dot_flops, got.flops_by_dtype) == \
        (one.flops, one.dot_flops, one.flops_by_dtype)
    assert got.peak_bytes == one.peak_bytes
    assert mem["argument_bytes"] == one_mem["argument_bytes"]
    assert mem["uneven"] == []
    for name in set(got.ops) | set(one.ops):
        a, b = got.ops.get(name), one.ops.get(name)
        if (a.bytes if a else 0.0) != (b.bytes if b else 0.0):
            assert name in INDEX_OPS, (step, name, a, b)
    assert abs(got.bytes_accessed - one.bytes_accessed) <= \
        0.02 * one.bytes_accessed


def test_full_size_cell_writes_the_reference_keys(tmp_path):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", multi_pod=False,
                          out_dir=tmp_path, tag="t")
    assert rec["status"] == "ok", rec.get("traceback")
    path = tmp_path / "pod16x16__qwen1.5-0.5b__decode_32k__t.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    for k in ("arch", "shape", "mesh", "chips", "status", "tag", "variant",
              "memory", "collectives", "roofline"):
        assert k in rec, k
    assert (rec["mesh"], rec["chips"]) == ("pod16x16", 256)
    assert set(rec["variant"]) >= {"config_patch", "microbatches",
                                   "rule_patch"}
    coll = rec["collectives"]
    assert set(coll) == {"bytes_by_op", "count_by_op"}
    assert coll["count_by_op"]["all_gather"] > 0
    assert set(coll["bytes_by_op"]) == set(coll["count_by_op"])
    r = rec["roofline"]
    want = sum(b * (ALL_REDUCE_WEIGHT if k == "all_reduce" else 1.0)
               for k, b in coll["bytes_by_op"].items())
    assert r["collective_bytes_per_device"] == want
    assert r["collective_s"] == want / HW.NVLINK_BW > 0
    assert r["collective_bytes_by_op"] == coll["bytes_by_op"]
    mem = rec["memory"]
    # rank 0's shards: the 24-layer bf16 cache split over 16 × 16
    model = dryrun.get_arch("qwen1.5-0.5b").model()
    whole = 2 * 24 * 128 * 32_768 * model.cfg.n_kv_heads * model.cfg.hd * 2
    assert mem["cache"] == whole // 256
    assert rec["rank0_is_every_rank"] is True and mem["uneven"] == []
    assert not torch.distributed.is_initialized()


def test_train_cell_takes_the_dp_aware_microbatches(tmp_path):
    """min(16, batch // (data · pod)): 256 // 32 = 8 on pod2x16x16."""
    rec = dryrun.run_cell("qwen1.5-0.5b", "train_4k", multi_pod=True,
                          out_dir=tmp_path,
                          config_patch={"n_layers": 1})
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["microbatches"] == 8 and rec["chips"] == 512
    assert rec["variant"]["config_patch"] == {"n_layers": 1}
    assert rec["collectives"]["count_by_op"]["reduce_scatter"] > 0


def test_uneven_shards_are_named():
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.sharding.groups import mesh_groups
    with dryrun.fake_world(2):
        mesh = mesh_groups((1, 2), AXES, "cpu")
        even = DTensor.from_local(torch.empty(3, 4, device="meta"), mesh,
                                  [Shard(0), Shard(0)], run_check=False,
                                  shape=torch.Size([6, 4]), stride=(4, 1))
        odd = DTensor.from_local(torch.empty(3, 4, device="meta"), mesh,
                                 [Shard(0), Shard(0)], run_check=False,
                                 shape=torch.Size([5, 4]), stride=(4, 1))
        assert dryrun.uneven_shards({"a": even, "b": odd}) == ["['b']"]


def test_planted_uncounted_collective_fails(monkeypatch):
    """A counter that does not know the all-gather DTensor runs raises
    where the step gathers, rather than count it short."""
    from repro_torch.sharding.groups import mesh_groups
    from repro_torch.sharding.logical import ShardingCtx
    monkeypatch.delitem(COLLECTIVES,
                        "_c10d_functional.all_gather_into_tensor")
    with dryrun.fake_world(2):
        ctx = ShardingCtx(mesh_groups((1, 2), AXES, "cpu"))
        with pytest.raises(KeyError, match="all_gather_into_tensor is not "
                                           "counted"):
            _count(ctx, "none", "decode")
    assert not torch.distributed.is_initialized()
