"""The port's channel parallelism (``repro_torch.core.parallelism``, the
mesh-placed plans of ``repro_torch.graph``) against the JAX package's,
on the CPU.

In process: the placement pass and ``stage_arith_intensity`` give the
reference's specs and records for the lattice CNN (``conv1_c=16,
conv2_c=8``), ``mnist_cnn`` and ``highres_cnn`` at 48² and 64², at model
sizes 1, 2, 3, 4 and 8 and under every override (the impossible
override's error included); the ``shard-*`` verifier codes on the same
tampered placed plans; the schedules' validation messages; the policy's
``channel_parallel`` aliases; the mesh constructors and the launcher.

Across processes: three gloo worlds spawned through ``run_spmd``,
meshes (1, 2), (1, 4) and (2, 2), each rank running the placed plans of
the lattice CNN (fused and unfused), ``mnist_cnn`` and ``highres_cnn``
at 48² and 64² (whose model-4 plan feeds one BOTH stage into another,
where half the ranks already hold their input block and the others must
gather: every rank has to choose alike), under auto placement and the forced ``input`` and ``output``
schedules, in all three number formats. Each rank's output must equal:

  * under int8, JAX's unsharded plan (run op by op) and the port's
    unsharded plan bitwise, on lattice and random data alike: the codes
    are ≤ 127 integers, so every reduction is exact;
  * on the reference's lattice data (multiples of 2⁻⁶, absmax pinned to
    127/64), the port's unsharded plan bitwise in every format: the
    lattice keeps every sum the sharding reassociates exact. It does not
    under ``none`` on highres_cnn once an ICP stage sits past its first
    blocks (the activations reach ~168 in steps of 2⁻¹⁸ and finer, past
    fp32's 24 bits), so those cases take the fp32 bar alone;
  * JAX's unsharded plan within rtol 1e-5, atol 1e-6·max|y| under
    ``none`` (reassociation only, the reference's own bar in
    ``test_unfused_sharded_plan_and_float_closeness``; the dense layer's
    fp32 sum is not exact even on the lattice, so the two packages'
    unsharded plans differ there already), and within one Q8.8 step
    under ``qformat`` (the bar ``tests/test_torch_serve.py`` holds the
    unsharded plans to).

The (1, 4) world also holds the ring's order against the reference's
(own shard, then r − 1, r − 2, …) computed in numpy on random fp32
data, each rank's weight bytes against 1/(icp·ocp) of each placed
stage's, and a BOTH-placed plan saved and loaded bitwise; the (2, 2)
world serves ``VisionEngine`` on the mesh against JAX's forward. Two
planted faults must fail their checks: bias and requant scale applied
per shard before the ring, and a ring adding in the other order.

Each world is spawned once (module fixtures) and feeds many
parametrised cases. The ranks import this file to find their bodies, so
the JAX package is imported inside ``_jax()``, by the parent alone: a
rank imports no JAX. The kernels' per-shard shapes are held on the card
(``tests/test_torch_cuda.py``).
"""
import dataclasses
import functools
import os
import tempfile
import types

import numpy as np
import pytest
import torch

import repro_torch.core.parallelism as t_par
import repro_torch.graph.passes as t_passes
from repro_torch.analysis import verify_plan
from repro_torch.bridge import params_from_numpy
from repro_torch.graph.ir import ShardingSpec
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import serve as launcher
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
from repro_torch.ops import ExecPolicy

QUANTS = ("none", "qformat", "int8")
OVERRIDES = (None, "input", "output")
MESHES = ((1, 2), (1, 4), (2, 2))
BATCH = 8
# fp32: reassociation only; atol is 1e-6 of the largest |logit| (the
# lattice's logits reach ~200, where cancellation leaves small entries
# with a few ulps of the large ones)
RTOL, ATOL = 1e-5, 1e-6
Q_STEP = 2.0 ** -8                  # one Q8.8 lattice step



@functools.cache
def _jax():
    """The JAX package's side of the comparisons (parent process only)."""
    import jax
    import jax.numpy as jnp

    import repro.core.parallelism as par
    import repro.graph.passes as passes
    from repro.analysis import verify_plan
    from repro.graph.ir import ShardingSpec
    from repro.launch.mesh import make_mesh_shape
    from repro.models.cnn import PaperCNN, PaperCNNConfig
    from repro.models.vgg import VGGStyleCNN, VGGStyleCNNConfig
    from repro.ops import ExecPolicy
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, par=par, passes=passes, verify=verify_plan,
        Spec=ShardingSpec, CNN=PaperCNN, CNNConfig=PaperCNNConfig,
        VGG=VGGStyleCNN, VGGConfig=VGGStyleCNNConfig, Policy=ExecPolicy,
        make_mesh_shape=make_mesh_shape)


# name -> (JAX model, port model, fuse)
MODELS = {
    "lattice": (lambda: _jax().CNN(_jax().CNNConfig(conv1_c=16, conv2_c=8)),
                lambda: PaperCNN(PaperCNNConfig(conv1_c=16, conv2_c=8)),
                True),
    "lattice_unfused": (
        lambda: _jax().CNN(_jax().CNNConfig(conv1_c=16, conv2_c=8)),
        lambda: PaperCNN(PaperCNNConfig(conv1_c=16, conv2_c=8)), False),
    "mnist": (lambda: _jax().CNN(_jax().CNNConfig()),
              lambda: PaperCNN(PaperCNNConfig()), True),
    "vgg48": (lambda: _jax().VGG(_jax().VGGConfig(img_size=48)),
              lambda: VGGStyleCNN(VGGStyleCNNConfig(img_size=48)), True),
    # at model 4: ocp, icp2xocp2, icp2xocp2, ocp — a BOTH stage feeding
    # another, where half the ranks already hold their input block
    "vgg64": (lambda: _jax().VGG(_jax().VGGConfig(img_size=64)),
              lambda: VGGStyleCNN(VGGStyleCNNConfig(img_size=64)), True),
}


def _lattice(rng, shape, frac=6, maxcode=31):
    """The reference's lattice: integer multiples of 2^-frac, the first
    element pinned to 127·2^-frac (an exact int8 scale)."""
    v = rng.randint(-maxcode, maxcode + 1, size=shape).astype(np.float32)
    v = v * np.float32(2.0 ** -frac)
    v.reshape(-1)[0] = 127 * 2.0 ** -frac
    return v


def _tree_like(tree, make):
    if isinstance(tree, dict):
        return {k: _tree_like(v, make) for k, v in tree.items()}
    return make(tuple(tree.shape))


def _random(rng, shape):
    """He-scaled normal weights (fan-in: every dim but the first of a
    conv weight, the first of a dense one)."""
    fan_in = (shape[0] if len(shape) == 2 else
              int(np.prod(shape[1:])) if len(shape) == 4 else 1)
    return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
        np.float32)


def _data(name: str, kind: str):
    """(numpy params, numpy images) of ``name``: lattice or random, made
    with numpy from a seed."""
    tmodel = MODELS[name][1]()
    shapes = tmodel.init(0, device="cpu")
    rng = np.random.RandomState(7)
    make = _lattice if kind == "lattice" else _random
    params = _tree_like(shapes, lambda s: make(rng, s))
    shape = tmodel.input_shape(BATCH)
    if kind == "lattice":
        return params, _lattice(rng, shape)
    return params, rng.standard_normal(shape).astype(np.float32)


def _jax_forward(name, params, x, quant):
    J = _jax()
    jmodel, _, fuse = MODELS[name]
    jp = J.jax.tree_util.tree_map(J.jnp.asarray, params)
    plan = jmodel().compile(J.Policy(quant=quant), batch=BATCH, fuse=fuse)
    return np.asarray(plan.bind(jp)(J.jnp.asarray(x)))


def _exact(name, quant, data, placements) -> bool:
    """Is bitwise parity with the unsharded plan owed? Lattice data keeps
    every reassociated sum exact but on highres_cnn under ``none`` once
    an ICP stage reassociates past its first blocks."""
    if data != "lattice":
        return False
    return not (name.startswith("vgg") and quant == "none"
                and any(p != "ocp" and p != "none" for p in placements))


# ----------------------------------------------------------- rank bodies

def _plan_cases(mesh_shape, cases):
    """Run every (name, data, quant, override) case's placed plan on this
    rank: {case: {"out" | "error", "placement", "plain"}}."""
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)            # the ranks share the host's cores
    mesh = make_test_mesh(mesh_shape)
    out = {}
    for (name, data), (params, x) in cases.items():
        _, tmodel, fuse = MODELS[name]
        tparams = params_from_numpy(params, "cpu")
        tx = torch.from_numpy(x)
        for quant in QUANTS:
            plain = tmodel().compile(ExecPolicy(quant=quant), batch=BATCH,
                                     fuse=fuse).bind(tparams)(tx).numpy()
            for ov in OVERRIDES:
                key = (name, data, quant, ov)
                pol = ExecPolicy(quant=quant, channel_parallel=ov)
                try:
                    plan = tmodel().compile(pol, batch=BATCH, fuse=fuse,
                                            mesh=mesh)
                except ValueError as e:
                    out[key] = {"error": str(e)}
                    continue
                placements = [str(n.sharding) for n in plan.graph
                              if getattr(n, "sharding", None) is not None]
                out[key] = {"out": plan.bind(tparams)(tx).numpy(),
                            "placement": placements, "plain": plain}
    return out


def _faulty_fused_shard(xl, wl, bl, sl, *, grid, stride=(1, 1),
                        odd="raise", policy=None):
    """Planted fault: bias and requant scale applied per shard, before
    the ring (they then join ki times)."""
    from repro_torch.core.quantize import conv_epilogue
    from repro_torch.core.window import maxpool2
    if grid.ki == 1:
        return t_par.fused_conv_block_shard(xl, wl, bl, sl, grid=grid,
                                            stride=stride, odd=odd,
                                            policy=policy)
    part = conv_epilogue(t_par._conv(xl, wl, None, tuple(stride), policy),
                         sl, bl)
    full = t_par.ring_all_reduce(part, grid.ring, grid.group)
    return maxpool2(torch.relu(full), odd=odd)


def _reversed_ring(part, ring, group=None):
    """Planted fault: a ring that adds in the other order (receives from
    r + 1)."""
    return t_par.ring_all_reduce(part, tuple(reversed(ring)), group)


def _world_1x4(rank, world, cases, parts, art_dir, operands):
    from repro_torch.launch.mesh import make_test_mesh
    res = {"plans": _plan_cases((1, 4), cases),
           "schedules": _run_schedules((1, 4), operands)}
    ring = tuple(range(world))
    res["ring"] = t_par.ring_all_reduce(torch.from_numpy(parts[rank]),
                                        ring).numpy()
    res["ring_reversed"] = _reversed_ring(torch.from_numpy(parts[rank]),
                                          ring).numpy()
    mesh = make_test_mesh((1, 4))
    params, x = cases[("lattice", "lattice")]
    tparams, tx = params_from_numpy(params, "cpu"), torch.from_numpy(x)
    # the planted per-shard epilogue, through the plan's ICP stage
    real = t_par.fused_conv_block_shard
    t_par.fused_conv_block_shard = _faulty_fused_shard
    try:
        res["fault_epilogue"] = {
            q: PaperCNN(PaperCNNConfig(conv1_c=16, conv2_c=8)).compile(
                ExecPolicy(quant=q, channel_parallel="input"), batch=BATCH,
                mesh=mesh).bind(tparams)(tx).numpy() for q in QUANTS}
    finally:
        t_par.fused_conv_block_shard = real
    # per-rank weight bytes, a BOTH plan saved and loaded, fingerprints
    res["bytes"], res["artifact"], res["fingerprints"] = {}, {}, {}
    from repro_torch.graph.plan import BoundPlan
    for q in QUANTS:
        model = PaperCNN(PaperCNNConfig(conv1_c=16, conv2_c=8))
        plan = model.compile(ExecPolicy(quant=q), batch=BATCH, mesh=mesh)
        bound = plan.bind(tparams)
        whole = model.compile(ExecPolicy(quant=q), batch=BATCH).bind(tparams)
        full = whole.stage_weight_bytes()
        res["bytes"][q] = [
            (str(node.sharding), *node.sharding.split(4),
             _split_bytes(bound.operand(node, 1, "w"),
                          bound.operand(node, 2, "b")),
             _split_bytes(whole.operand(node, 1, "w"),
                          whole.operand(node, 2, "b")),
             bound.stage_weight_bytes()[node.id], full[node.id])
            for node in plan.graph if node.id in plan.grids]
        path = os.path.join(art_dir, f"both_{q}")
        fp = bound.save(path)
        loaded = BoundPlan.load(path, device="cpu")
        res["artifact"][q] = {
            "both": [str(n.sharding) for n in plan.graph
                     if n.id in plan.grids],
            "fp": fp, "fp_loaded": loaded.fingerprint(),
            "out": bound(tx).numpy(), "loaded": loaded(tx).numpy()}
        res["fingerprints"][q] = {
            "1x4": bound.fingerprint(), "none": whole.fingerprint(),
            "2x2": model.compile(ExecPolicy(quant=q), batch=BATCH,
                                 mesh=make_test_mesh((2, 2))).bind(
                tparams).fingerprint()}
    return res


def _nbytes(v):
    return 0 if v is None else v.numel() * v.element_size()


def _split_bytes(w, b):
    """(weight bytes, per-output-channel vector bytes: bias and int8
    requant scale) of one stage's operands."""
    from repro_torch.core.quantize import QTensor
    if isinstance(w, QTensor):
        return _nbytes(w.codes), _nbytes(w.scale) + _nbytes(b)
    return _nbytes(w), _nbytes(b)


SCHEDULES = {
    # mesh -> [(mode, icp, ocp)]: the global schedules each world runs
    (1, 4): [("output", 0, 0), ("input", 0, 0), ("both", 2, 2)],
    (2, 2): [("output", 0, 0), ("input", 0, 0), ("both", 1, 2)],
}


def _schedule_operands():
    """Lattice x (8, 8, 10, 10), w (8, 8, 3, 3), b (8,) and a power-of-two
    requant scale (8,): every schedule's sums are exact."""
    rng = np.random.RandomState(21)
    return (_lattice(rng, (BATCH, 8, 10, 10)), _lattice(rng, (8, 8, 3, 3)),
            _lattice(rng, (8,)),
            (2.0 ** -rng.randint(0, 4, size=8)).astype(np.float32))


def _run_schedules(mesh_shape, operands):
    """Both global schedules on this rank, each with and without the
    requant scale: {(fn, mode, scaled): the global result}."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(mesh_shape)
    x, w, b, s = (torch.from_numpy(v) for v in operands)
    out = {}
    for mode, icp, ocp in SCHEDULES[mesh_shape]:
        m = t_par.ChannelParallelism(mode)
        for scaled in (False, True):
            kw = dict(mesh=mesh, mode=m, icp=icp, ocp=ocp,
                      scale=s if scaled else None)
            out[("conv2d", mode, scaled)] = t_par.conv2d_channel_parallel(
                x, w, b, **kw).numpy()
            out[("fused", mode, scaled)] = \
                t_par.fused_conv_block_channel_parallel(x, w, b,
                                                        **kw).numpy()
    return out


def _world_1x2(rank, world, cases):
    return {"plans": _plan_cases((1, 2), cases)}


def _world_2x2(rank, world, cases, engine_params, images, operands):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve import VisionEngine, VisionEngineConfig
    res = {"plans": _plan_cases((2, 2), cases),
           "schedules": _run_schedules((2, 2), operands)}
    mesh = make_test_mesh((2, 2))
    tparams = params_from_numpy(engine_params, "cpu")
    eng = VisionEngine(PaperCNN(), tparams, VisionEngineConfig(
        batch=8, buckets="auto", device="cpu", mesh=mesh))
    uids = [eng.submit(img) for img in images]
    got = eng.run()
    res["engine"] = {"labels": [got[u]["label"] for u in uids],
                     "logits": np.stack([got[u]["logits"] for u in uids]),
                     "buckets": list(eng.buckets), "pretty": eng.pretty(),
                     "stats": (eng.stats.items, eng.stats.pad_lanes,
                               eng.stats.graphs)}
    try:
        VisionEngine(PaperCNN(), tparams, VisionEngineConfig(
            batch=3, device="cpu", mesh=mesh))
        res["engine"]["divisibility"] = None
    except ValueError as e:
        res["engine"]["divisibility"] = str(e)
    # a placed plan called on a batch the data axis cannot split
    bound = PaperCNN().compile(batch=4, mesh=mesh).bind(tparams)
    try:
        bound(torch.from_numpy(images[:3]))
        res["plan_divisibility"] = None
    except ValueError as e:
        res["plan_divisibility"] = str(e)
    return res


# -------------------------------------------------------------- fixtures

CASE_KEYS = [(name, data) for name in MODELS
             for data in ("lattice", "random")]


@pytest.fixture(scope="module")
def cases():
    return {key: _data(*key) for key in CASE_KEYS}


@pytest.fixture(scope="module")
def jax_refs(cases):
    return {(name, data, q): _jax_forward(name, *cases[(name, data)], q)
            for (name, data) in CASE_KEYS for q in QUANTS}


@pytest.fixture(scope="module")
def ring_parts():
    rng = np.random.RandomState(11)
    return [rng.standard_normal((3, 5, 7)).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def engine_inputs():
    params = _data("mnist", "random")[0]
    images = np.random.RandomState(2).standard_normal(
        (11, 1, 28, 28)).astype(np.float32)
    return params, images


@pytest.fixture(scope="module")
def worlds(cases, ring_parts, engine_inputs):
    operands = _schedule_operands()
    with tempfile.TemporaryDirectory() as art_dir:
        return {
            (1, 2): t_mesh.run_spmd(_world_1x2, 2, "gloo", "cpu", cases),
            (1, 4): t_mesh.run_spmd(_world_1x4, 4, "gloo", "cpu", cases,
                                    ring_parts, art_dir, operands),
            (2, 2): t_mesh.run_spmd(_world_2x2, 4, "gloo", "cpu", cases,
                                    *engine_inputs, operands),
        }


# ------------------------------------------------- placed plans, per rank

PLAN_CASES = [(m, name, data, q, ov) for m in MESHES
              for (name, data) in CASE_KEYS for q in QUANTS
              for ov in OVERRIDES]


@pytest.mark.parametrize("mesh,name,data,quant,override", PLAN_CASES)
def test_placed_plan_matches_the_reference(worlds, jax_refs, cases, mesh,
                                           name, data, quant, override):
    ranks = [r["plans"][(name, data, quant, override)] for r in worlds[mesh]]
    if "error" in ranks[0]:
        # an override no stage can take raises alike in both packages
        J = _jax()
        graph = MODELS[name][0]().compile(J.Policy(quant=quant), batch=BATCH,
                                          fuse=MODELS[name][2]).graph
        with pytest.raises(ValueError) as e:
            J.passes.place_channel_parallel(graph, mesh[1],
                                            override=override)
        assert all(r["error"] == str(e.value) for r in ranks)
        return
    want = jax_refs[(name, data, quant)]
    for r in ranks:
        assert r["out"].shape == want.shape
        if quant == "int8" or _exact(name, quant, data, r["placement"]):
            np.testing.assert_array_equal(r["out"], r["plain"])
        if quant == "int8":
            np.testing.assert_array_equal(r["out"], want)
        elif quant == "qformat":
            np.testing.assert_allclose(r["out"], want, rtol=0, atol=Q_STEP)
        else:
            np.testing.assert_allclose(r["out"], want, rtol=RTOL,
                                       atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("mesh", MESHES)
def test_every_world_runs_a_sharded_stage(worlds, mesh):
    """Auto placement shards the lattice CNN's conv2 (ICP at model 2, the
    composed icp2xocp2 at model 4) and highres_cnn's block 0 (OCP)."""
    r = worlds[mesh][0]["plans"]
    lat = r[("lattice", "lattice", "none", None)]["placement"]
    assert lat == ["ocp", "icp" if mesh[1] == 2 else "icp2xocp2"]
    assert r[("vgg48", "random", "int8", None)]["placement"][0] == "ocp"
    if mesh == (1, 4):
        assert r[("vgg64", "random", "int8", None)]["placement"] == [
            "ocp", "icp2xocp2", "icp2xocp2", "ocp"]


# ------------------------------------------------- the global schedules

@pytest.mark.parametrize("scaled", (False, True))
@pytest.mark.parametrize("fn", ("conv2d", "fused"))
@pytest.mark.parametrize("mesh,mode", [(m, mode) for m in SCHEDULES
                                       for mode, _, _ in SCHEDULES[m]])
def test_global_schedules_match_the_reference(worlds, mesh, mode, fn,
                                              scaled):
    """``conv2d_channel_parallel`` and ``fused_conv_block_channel_parallel``
    return the global result on every rank, bitwise to the reference's
    single-device schedule (``mode=NONE``) on lattice operands."""
    J = _jax()
    x, w, b, s = (J.jnp.asarray(v) for v in _schedule_operands())
    call = (J.par.conv2d_channel_parallel if fn == "conv2d"
            else J.par.fused_conv_block_channel_parallel)
    want = np.asarray(call(x, w, b, mesh=None,
                           mode=J.par.ChannelParallelism.NONE,
                           scale=s if scaled else None))
    for r in worlds[mesh]:
        np.testing.assert_array_equal(r["schedules"][(fn, mode, scaled)],
                                      want)


# ----------------------------------------------------- the ring and faults

def _reference_ring(parts, i):
    """The reference ring's sum on rank i: own shard, then i−1, i−2, …"""
    acc = parts[i].copy()
    for k in range(1, len(parts)):
        acc = acc + parts[(i - k) % len(parts)]
    return acc


@pytest.mark.parametrize("rank", range(4))
def test_ring_adds_in_the_reference_order(worlds, ring_parts, rank):
    got = worlds[(1, 4)][rank]["ring"]
    np.testing.assert_array_equal(got, _reference_ring(ring_parts, rank))


def test_planted_fault_ring_order_is_caught(worlds, ring_parts):
    """Random fp32 parts: the other order rounds differently somewhere."""
    assert any(not np.array_equal(worlds[(1, 4)][i]["ring_reversed"],
                                  _reference_ring(ring_parts, i))
               for i in range(4))


@pytest.mark.parametrize("quant", QUANTS)
def test_planted_fault_epilogue_before_the_ring_is_caught(worlds, jax_refs,
                                                          quant):
    want = jax_refs[("lattice", "lattice", quant)]
    for r in worlds[(1, 4)]:
        assert not np.array_equal(r["fault_epilogue"][quant], want)


# ------------------------------------------- bind, artifacts, fingerprints

@pytest.mark.parametrize("quant", QUANTS)
def test_ranks_keep_only_their_weight_blocks(worlds, quant):
    for r in worlds[(1, 4)]:
        rows = r["bytes"][quant]
        assert [row[0] for row in rows] == ["ocp", "icp2xocp2"]
        for _, ki, ko, (w, v), (w_full, v_full), stage, stage_full in rows:
            assert w * ki * ko == w_full        # the (M/ocp, N/icp) block
            assert v * ko == v_full             # bias, scale: M/ocp
            assert stage == w + v and stage_full == w_full + v_full


@pytest.mark.parametrize("quant", QUANTS)
def test_both_placed_artifact_roundtrips_bitwise(worlds, quant):
    fps = set()
    for r in worlds[(1, 4)]:
        a = r["artifact"][quant]
        assert "icp2xocp2" in a["both"]
        assert a["fp"] == a["fp_loaded"]
        np.testing.assert_array_equal(a["loaded"], a["out"])
        fps.add(a["fp"])
    assert len(fps) == 1                # the identity has no rank in it


@pytest.mark.parametrize("quant", QUANTS)
def test_fingerprint_separates_mesh_shapes(worlds, quant):
    f = worlds[(1, 4)][0]["fingerprints"][quant]
    assert len({f["1x4"], f["2x2"], f["none"]}) == 3


# ------------------------------------------------------ serving on a mesh

def test_vision_engine_on_a_2x2_mesh_matches_the_reference(worlds,
                                                           engine_inputs):
    J = _jax()
    params, images = engine_inputs
    want = np.asarray(J.CNN(J.CNNConfig()).forward(
        J.jax.tree_util.tree_map(J.jnp.asarray, params),
        J.jnp.asarray(images)))
    for r in worlds[(2, 2)]:
        e = r["engine"]
        assert e["labels"] == [int(v) for v in want.argmax(-1)]
        np.testing.assert_allclose(e["logits"], want, rtol=RTOL, atol=1e-5)
        assert e["buckets"] == [2, 4, 8]       # buckets divide data=2
        assert e["stats"] == (11, 1, "off (cpu)")
        assert "mesh={'data': 2, 'model': 2}" in e["pretty"]


def test_vision_engine_refuses_a_batch_the_data_axis_cannot_split(worlds):
    for r in worlds[(2, 2)]:
        assert "does not divide" in r["engine"]["divisibility"]
        assert r["plan_divisibility"].startswith(
            "batch 3 does not divide the 'data' axis (2 devices)")


# ----------------------------------------------------- the placement pass

def _graph_pair(name, quant="none"):
    J = _jax()
    jmodel, tmodel, fuse = MODELS[name]
    return (jmodel().compile(J.Policy(quant=quant), batch=BATCH, fuse=fuse,
                             verify=False).graph,
            tmodel().compile(ExecPolicy(quant=quant), batch=BATCH, fuse=fuse,
                             verify=False).graph)


def _specs(graph):
    return [(n.id, n.sharding.mode, n.sharding.data, n.sharding.icp,
             n.sharding.ocp) for n in graph
            if getattr(n, "sharding", None) is not None]


@pytest.mark.parametrize("override", (None, "input", "output", "none"))
@pytest.mark.parametrize("size", (1, 2, 3, 4, 8))
@pytest.mark.parametrize("name", ("lattice", "mnist", "vgg48", "vgg64"))
def test_placement_and_intensity_match_the_reference(name, size, override):
    j_passes = _jax().passes
    jg, tg = _graph_pair(name, "int8")
    for data in (True, False):
        try:
            jp = j_passes.place_channel_parallel(jg, size, override=override,
                                                 data=data)
        except ValueError as e:
            with pytest.raises(ValueError) as te:
                t_passes.place_channel_parallel(tg, size, override=override,
                                                data=data)
            assert str(te.value) == str(e)
            continue
        tp = t_passes.place_channel_parallel(tg, size, override=override,
                                             data=data)
        assert _specs(tp) == _specs(jp)
        assert t_passes.stage_arith_intensity(tp) == \
            j_passes.stage_arith_intensity(jp)
        assert [n.pretty() for n in tp] == [n.pretty() for n in jp]


@pytest.mark.parametrize("name", ("lattice", "mnist", "vgg48", "vgg64"))
def test_tunable_stages_skip_the_sharded_ones(name):
    j_passes = _jax().passes
    jg, tg = _graph_pair(name)
    jp = j_passes.place_channel_parallel(jg, 4)
    tp = t_passes.place_channel_parallel(tg, 4)
    assert [n.id for n in t_passes.tunable_stages(tp)] == \
        [n.id for n in j_passes.tunable_stages(jp)]


def test_split_cost_and_pick_split_match_the_reference():
    j_passes = _jax().passes
    for m, n, k, hw in ((8, 3, 5, 220), (16, 8, 3, 108), (32, 16, 3, 52),
                        (20, 15, 6, 8), (8, 16, 6, 8)):
        for size in (1, 2, 4, 8, 16):
            assert t_passes._pick_split(m, n, k, k, hw, hw, size) == \
                j_passes._pick_split(m, n, k, k, hw, hw, size)
            for ki, ko in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2)):
                assert t_passes._split_cost(m, n, k, k, hw, hw, ki, ko) == \
                    j_passes._split_cost(m, n, k, k, hw, hw, ki, ko)
    assert t_passes._HOP_OVERHEAD == j_passes._HOP_OVERHEAD == 4096.0


@pytest.mark.parametrize("spec", [dict(), dict(mode="input"),
                                  dict(mode="output", data=False),
                                  dict(mode="both", icp=2, ocp=4),
                                  dict(mode="input", icp=4, ocp=1)])
def test_sharding_spec_split_and_str_match(spec):
    j, t = _jax().Spec(**spec), ShardingSpec(**spec)
    assert str(t) == str(j)
    for size in (1, 2, 4, 8):
        assert t.split(size) == j.split(size)


@pytest.mark.parametrize("bad", [dict(mode="diagonal"), dict(icp=-1)])
def test_sharding_spec_validation_matches(bad):
    with pytest.raises(ValueError) as je:
        _jax().Spec(**bad)
    with pytest.raises(ValueError) as te:
        ShardingSpec(**bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("value", ["icp", "ocp", "input", "output", "none",
                                   None, "diagonal"])
def test_policy_channel_parallel_aliases_match(value):
    try:
        j = _jax().Policy(channel_parallel=value).channel_parallel
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            ExecPolicy(channel_parallel=value)
        assert str(te.value) == str(e)
        return
    assert ExecPolicy(channel_parallel=value).channel_parallel == j


# ------------------------------------------------ the schedules' messages

def _jmesh(**axes):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


def _tmesh(**axes):
    return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 mesh=np.zeros(tuple(axes.values())))


VALIDATE = [
    # (x shape, w shape, axes, mode, data axis, icp, ocp)
    ((4, 3, 8, 8), (4, 2, 3, 3), dict(model=2), "output", "data", 0, 0),
    ((4, 3, 8, 8), (3, 3, 3, 3), dict(model=2), "output", "data", 0, 0),
    ((4, 3, 8, 8), (4, 3, 3, 3), dict(model=2), "input", "data", 0, 0),
    ((4, 4, 8, 8), (4, 4, 3, 3), dict(model=4), "both", "data", 2, 1),
    ((4, 3, 8, 8), (4, 3, 3, 3), dict(model=4), "both", "data", 2, 2),
    ((4, 4, 8, 8), (6, 4, 3, 3), dict(model=4), "both", "data", 1, 4),
    ((3, 4, 8, 8), (4, 4, 3, 3), dict(data=2, model=2), "output", "data",
     0, 0),
    ((4, 4, 8, 8), (4, 4, 3, 3), dict(data=2), "output", "data", 0, 0),
    ((4, 4, 8), (4, 4, 3, 3), dict(model=2), "output", "data", 0, 0),
]


@pytest.mark.parametrize("x,w,axes,mode,data,icp,ocp", VALIDATE)
def test_schedule_validation_messages_match(x, w, axes, mode, data, icp,
                                            ocp):
    J = _jax()
    jmode = J.par.ChannelParallelism(mode)
    tmode = t_par.ChannelParallelism(mode)
    with pytest.raises(ValueError) as je:
        J.par._validate(J.jnp.zeros(x), J.jnp.zeros(w), _jmesh(**axes),
                        jmode, "model", data, icp, ocp)
    with pytest.raises(ValueError) as te:
        t_par._validate(x, w, _tmesh(**axes), tmode, "model", data, icp,
                        ocp)
    assert str(te.value) == str(je.value)


# -------------------------------------------- the shard-* verifier codes

def _replace_node(plan, nid, **changes):
    nodes = tuple(dataclasses.replace(n, **changes) if n.id == nid else n
                  for n in plan.graph)
    return dataclasses.replace(
        plan, graph=dataclasses.replace(plan.graph, nodes=nodes))


def _codes(vs):
    return sorted((v.code, v.node) for v in vs)


def _jstub(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)),
                                 devices=np.zeros(shape))


def _tstub(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, mesh=np.zeros(shape))


TAMPER = {
    # name: (stage index, sharding, mesh shape or None, axis names)
    "icp-divisibility": (0, dict(mode="input", data=False), (2,),
                         ("model",)),
    "factorization": (0, dict(mode="both", data=False, icp=2, ocp=2), (2,),
                      ("model",)),
    "both-divisibility": (0, dict(mode="both", data=False, icp=2, ocp=2),
                          (4,), ("model",)),
    "pure-data-collective": (0, dict(mode="none", icp=2, ocp=1), None, ()),
    "gather-axis": (-1, dict(mode="output", data=False), (2, 5),
                    ("data", "model")),
    "no-mesh": (0, dict(mode="output"), None, ()),
    "no-data-axis": (-1, dict(mode="output", data=True), (5,), ("model",)),
    "no-model-axis": (-1, dict(mode="output", data=True), (2,), ("data",)),
}


@pytest.mark.parametrize("case", sorted(TAMPER))
def test_shard_codes_match_the_reference(case):
    J = _jax()
    idx, spec, shape, names = TAMPER[case]
    jplan = J.CNN(J.CNNConfig()).compile(batch=2, verify=False)
    tplan = PaperCNN(PaperCNNConfig()).compile(batch=2, verify=False)
    jstage = [n for n in jplan.graph if hasattr(n, "sharding")][idx]
    tstage = [n for n in tplan.graph if hasattr(n, "sharding")][idx]
    jbad = _replace_node(jplan, jstage.id, sharding=J.Spec(**spec))
    tbad = _replace_node(tplan, tstage.id, sharding=ShardingSpec(**spec))
    if shape is not None:
        jbad = dataclasses.replace(jbad, mesh=_jstub(shape, names))
        tbad = dataclasses.replace(tbad, mesh=_tstub(shape, names))
    want = _codes(J.verify(jbad, raise_on_violation=False))
    assert want and any(c.startswith("shard-") for c, _ in want)
    assert _codes(verify_plan(tbad, raise_on_violation=False)) == want


def test_banding_on_a_sharded_stage_is_named():
    plan = PaperCNN(PaperCNNConfig()).compile(batch=2, stream_budget=10_000,
                                              verify=False)
    stage = next(n for n in plan.graph if getattr(n, "tiling", None))
    bad = _replace_node(plan, stage.id,
                        sharding=ShardingSpec(mode="output", data=False))
    bad = dataclasses.replace(bad, mesh=_tstub((5,), ("model",)))
    codes = [v.code for v in verify_plan(bad, raise_on_violation=False)]
    assert "stream-sharded-stage" in codes


# ------------------------------------ mesh constructors and the launcher

def test_backend_is_explicit():
    with pytest.raises(ValueError, match="name backend='gloo'"):
        t_mesh.resolve_backend(None, 2, "cpu")
    with pytest.raises(ValueError, match="needs a card per rank"):
        t_mesh.resolve_backend("nccl", 1, "cpu")
    assert t_mesh.resolve_backend("gloo", 4, "cpu") == "gloo"


_FAKE_WORLDS = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import build_mesh, make_production_mesh
out = {}
for world in (8, 256, 512):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    m = build_mesh("auto", device="cpu")
    out[str(world)] = [list(m.mesh.shape), list(m.mesh_dim_names)]
    if world == 512:
        p = make_production_mesh(multi_pod=True, device="cpu")
        out["multi_pod"] = [list(p.mesh.shape), list(p.mesh_dim_names)]
    dist.destroy_process_group()
print(json.dumps(out))
"""


@functools.cache
def _fake_worlds() -> dict:
    """``build_mesh("auto")`` on fake process groups of 8, 256 and 512
    ranks, and ``make_production_mesh(multi_pod=True)`` on the 512, in a
    child interpreter (a process group never outlives it)."""
    import json
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _FAKE_WORLDS],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_mesh_shapes_and_the_production_mesh():
    """Both production meshes have the reference's shapes and axes; the
    multi-pod one builds on a (fake) world of 512 ranks, and either
    refuses a world too small for it."""
    j = _jax()
    assert t_mesh.make_mesh_shape() == j.make_mesh_shape()
    assert t_mesh.make_mesh_shape(multi_pod=True) == \
        j.make_mesh_shape(multi_pod=True)
    with pytest.raises(RuntimeError, match=r"needs 256 devices"):
        t_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match=r"needs 512 devices"):
        t_mesh.make_production_mesh(multi_pod=True)
    shape, axes = j.make_mesh_shape(multi_pod=True)
    assert _fake_worlds()["multi_pod"] == [list(shape), list(axes)]


@pytest.mark.parametrize("world,want", [
    (8, [[1, 8], ["data", "model"]]),
    (256, [[16, 16], ["data", "model"]]),
    (512, [[2, 16, 16], ["pod", "data", "model"]])])
def test_auto_mesh_is_the_references(world, want):
    """``build_mesh("auto")`` as the reference's ``build_mesh``: the
    multi-pod mesh from 512 ranks, the pod mesh from 256, else 1 × N."""
    assert _fake_worlds()[str(world)] == want


def test_launcher_serves_a_cnn_on_a_mesh_of_one(capsys):
    _, results = launcher.main(["--arch", "mnist_cnn", "--capacity", "4",
                                "--requests", "6", "--device", "cpu",
                                "--mesh", "1x1", "--dist-backend", "gloo"])
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out and len(results) == 6
    assert not torch.distributed.is_initialized()   # the group it joined


def test_launcher_refuses_a_mesh_larger_than_the_world():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        launcher.main(["--arch", "mnist_cnn", "--device", "cpu",
                       "--mesh", "1x2", "--dist-backend", "gloo"])
    assert not torch.distributed.is_initialized()


def test_launcher_lm_on_a_mesh_cites_the_lm_half():
    """Every LM family serves on a mesh: an MoE arch (expert-parallel,
    tests/test_torch_moe_mesh.py) serves here on a world of one over
    gloo, on the (data, model) mesh and on the multi-pod (pod, data,
    model) one, the LM half of ROADMAP §A.10 (tests/test_torch_pod_mesh.py
    runs it on worlds of four); a spec of more axes than the reference's
    three is refused."""
    argv = ["--arch", "dbrx-132b", "--reduced", "--device", "cpu",
            "--dist-backend", "gloo", "--capacity", "2", "--requests", "2",
            "--prompt-len", "8", "--decode-steps", "2"]
    for spec in ("1x1", "1x1x1"):
        _, results = launcher.main(argv + ["--mesh", spec])
        assert len(results) == 2 and all(len(r.generated) == 2
                                         for r in results.values())
        assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="at most 3 axes"):
        launcher.main(argv + ["--mesh", "1x1x1x1"])
    assert not torch.distributed.is_initialized()


def test_compile_on_a_mesh_places_and_refuses_autotune():
    """A mesh's shape is enough for the placement pass and the printout
    (no process group: nothing is set up to run); autotuning, which the
    ranks would do apart, is refused."""
    plan = PaperCNN().compile(batch=2, mesh=_tstub((1, 4), ("data", "model")))
    assert plan.num_sharded() == 1 and not plan.grids
    assert "mesh={'data': 1, 'model': 4}" in plan.pretty()
    assert "shard=ocp" in plan.pretty()
    with pytest.raises(ValueError, match="autotune"):
        PaperCNN().compile(batch=2, autotune=True,
                           mesh=_tstub((1, 4), ("data", "model")))
