"""The port's logical-axis rules against the reference's
(``repro_torch.sharding.logical`` vs ``repro.sharding.logical``).

``spec_for`` cases mirror ``tests/test_sharding.py``; then, for every arch
of the registry, the resolved spec of every param and every serve-cache
leaf equals the reference's, at the meshes (16, 16), (2, 2), (1, 2) and
(2, 16, 16) ``("pod", "data", "model")``, under ``DEFAULT_RULES``,
``SP_DECODE_RULES``, ``INPUT_PARALLEL_RULES`` and the arch's own
overrides. The reference resolves on ``jax.sharding.AbstractMesh`` (no
devices), the port on ``MeshShape``; shapes come from ``jax.eval_shape``
and from the port's meta tensors, so nothing is allocated.
"""
from __future__ import annotations

import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_arch as j_get_arch
from repro.sharding import logical as jl
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.core.tree import tree_items
from repro_torch.sharding import logical as tl

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = ("default", "sp_decode", "input_parallel", "arch")
CACHE_SHAPES = ("decode_32k", "long_500k")


def _meshes(key):
    shape, axes = MESHES[key]
    return jax.sharding.AbstractMesh(shape, axes), tl.MeshShape(axes, shape)


def _rules(arch: str, which: str):
    """(reference rules, port rules) of one of ``RULES``."""
    if which == "default":
        return jl.DEFAULT_RULES, tl.DEFAULT_RULES
    if which == "sp_decode":
        return jl.SP_DECODE_RULES, tl.SP_DECODE_RULES
    if which == "input_parallel":
        return jl.INPUT_PARALLEL_RULES, tl.INPUT_PARALLEL_RULES
    jr = jl.DEFAULT_RULES
    ov = j_get_arch(arch).rule_overrides
    if ov:
        jr = jr.with_overrides(**ov)
    return jr, get_arch(arch).rules()


def _j_items(tree, prefix=()):
    """[(key path, leaf)] of a reference tree (dicts of leaves)."""
    if isinstance(tree, dict):
        return [i for k in sorted(tree) for i in _j_items(tree[k],
                                                          prefix + (k,))]
    return [(prefix, tree)]


@functools.cache
def _trees(arch: str):
    """(reference params shapes, axes; port params meta, axes; and the
    two packages' cache shapes and axes at each of CACHE_SHAPES)."""
    jspec, tspec = j_get_arch(arch), get_arch(arch)
    jm, tm = jspec.model(), tspec.model()
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tp = tm.init(torch.Generator(), device="meta")
    caches = {s: (jspec.cache_specs(s), tspec.cache_specs(s))
              for s in CACHE_SHAPES}
    return (jp, jm.axes(), tp, tm.axes()), caches


def _specs_equal(j_tree, j_axes, t_tree, t_axes, jmesh, tmesh, jr, tr):
    want = {p: tuple(jl.spec_for(jmesh, tuple(s.shape), a.names, jr))
            for (p, s), (_, a) in zip(_j_items(j_tree), _j_items(j_axes))}
    got = {p: tl.spec_for(tmesh, tuple(t.shape), a.names, tr)
           for (p, t), (_, a) in zip(tree_items(t_tree), tree_items(t_axes))}
    assert [p for p, _ in tree_items(t_tree)] == \
        [p for p, _ in tree_items(t_axes)], "axes tree != params tree"
    assert set(got) == set(want)
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, bad
    return len(want)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_the_reference(arch, mesh, rules):
    (jp, jax_, tp, tax), caches = _trees(arch)
    jmesh, tmesh = _meshes(mesh)
    jr, tr = _rules(arch, rules)
    n = _specs_equal(jp, jax_, tp, tax, jmesh, tmesh, jr, tr)
    assert n > 0
    for (jshapes, jaxes), (tshapes, taxes) in caches.values():
        assert taxes is not None
        _specs_equal(jshapes, jaxes, tshapes, taxes, jmesh, tmesh, jr, tr)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cnn_axes_equal_the_reference(mesh):
    jm, tm = j_get_arch("mnist_cnn").model(), get_arch("mnist_cnn").model()
    jmesh, tmesh = _meshes(mesh)
    for jr, tr in ((jl.DEFAULT_RULES, tl.DEFAULT_RULES),
                   (jl.INPUT_PARALLEL_RULES, tl.INPUT_PARALLEL_RULES)):
        _specs_equal(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                     jm.axes(), tm.init(torch.Generator(), device="meta"),
                     tm.axes(), jmesh, tmesh, jr, tr)


def test_rule_overrides_are_the_reference_archs():
    for arch in ARCH_IDS + ["mnist_cnn", "highres_cnn"]:
        assert get_arch(arch).rule_overrides == \
            j_get_arch(arch).rule_overrides, arch


# ---- spec_for, as tests/test_sharding.py holds the reference's ----

def _m(shape=(2, 2), axes=("data", "model")):
    return tl.MeshShape(tuple(axes), tuple(shape))


@pytest.mark.parametrize("shape,names,mesh,want", [
    ((64, 128), ("embed", "mlp"), ((4, 2),), P("data", "model")),
    ((6, 128), ("embed", "mlp"), ((4, 2),), P(None, "model")),
    ((32, 32), ("heads", "mlp"), ((2, 2),), P("model")),
    ((16, 128), ("batch", "act_seq"),
     ((2, 4, 2), ("pod", "data", "model")), P(("pod", "data"))),
    ((6, 128), ("batch", "act_seq"),
     ((2, 4, 2), ("pod", "data", "model")), P()),
    ((8,), ("nonexistent",), ((2, 2),), P()),
    ((128, 8, 64), ("embed", "kv_heads", "head"), ((1, 16),), P()),
    ((0, 8), ("batch", "mlp"), ((2, 2),), P(None, "model")),
])
def test_spec_for_guards(shape, names, mesh, want):
    got = tl.spec_for(_m(*mesh), shape, names)
    assert got == tuple(want)
    assert got == tuple(jl.spec_for(jax.sharding.AbstractMesh(*(
        mesh if len(mesh) == 2 else (mesh[0], ("data", "model")))),
        shape, names))


def test_kv_seq_rules():
    m = _m((2, 4, 2), ("pod", "data", "model"))
    sp = tl.spec_for(m, (2, 64, 8, 16), ("batch", "kv_seq", "kv_heads",
                                         None))
    assert sp[1] == "model"
    sp = tl.spec_for(m, (1, 64, 8, 16), ("batch", "kv_seq", "kv_heads",
                                         None), tl.SP_DECODE_RULES)
    assert sp[1] == ("data", "model")


def test_param_specs_structure_and_overrides():
    shapes = {"w": torch.empty((64, 32), device="meta"),
              "nested": {"b": torch.empty((32,), device="meta")}}
    axes = {"w": tl.A("embed", "mlp"), "nested": {"b": tl.A(None)}}
    specs = tl.param_specs(shapes, axes, _m())
    assert specs["w"] == ("data", "model") and specs["nested"]["b"] == ()
    rules = tl.DEFAULT_RULES.with_overrides(act_seq=["model"])
    shp, names = (4, 64, 32), ("batch", "act_seq", "act_embed")
    assert tl.spec_for(_m(), shp, names, rules) == ("data", "model")
    assert tl.spec_for(_m(), shp, names) == ("data",)


def test_rule_tables_are_the_reference_tables():
    for j, t in ((jl.DEFAULT_RULES, tl.DEFAULT_RULES),
                 (jl.SP_DECODE_RULES, tl.SP_DECODE_RULES),
                 (jl.INPUT_PARALLEL_RULES, tl.INPUT_PARALLEL_RULES)):
        assert {k: list(v) for k, v in j.table.items()} == \
            {k: list(v) for k, v in t.table.items()}


def test_shard_without_a_mesh_is_the_identity():
    x = torch.randn(2, 3)
    assert tl.shard(x, None, "batch", None) is x
    assert tl.shard(x, tl.ShardingCtx(), "batch", None) is x


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:            # placements reads the axis names only
        mesh_dim_names = ("pod", "data", "model")

    assert tl.placements(_Mesh, ("model", None, ("pod", "data"))) == (
        Shard(2), Shard(2), Shard(0))
    assert tl.placements(_Mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's axis order"):
        tl.placements(_Mesh, (("data", "pod"),))
