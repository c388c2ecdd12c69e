"""The port's plan verifier (``repro_torch.analysis``) against the JAX
package's (``repro.analysis.verifier``), on the CPU.

Every case builds the same plan in both packages (``PaperCNN`` at batch
2, streamed with a 10 kB budget where the case needs bands), tampers
with it in the same way, and requires the same list of (violation code,
node id) pairs from both verifiers: the port's plans mirror the
reference's node for node. The cases are the reference's
``TestVerifyPlan`` and ``TestVerifierWiring`` whose codes apply to a
single-device plan, plus one per remaining ``shape-flow``,
``dtype-flow``, ``graph-structure`` and ``quant-*`` check. The
``shard-*`` family is held in ``tests/test_torch_mesh.py``.
"""
import dataclasses
import json
import shutil
import warnings

import jax
import numpy as np
import pytest

import repro.graph.ir as j_ir
from repro.analysis import verify_plan as j_verify
from repro.core.quantize import QFormat as JQFormat
from repro.core.quantize import QTensor as JQTensor
from repro.models.cnn import PaperCNN as JaxCNN
from repro.models.cnn import PaperCNNConfig as JaxCNNConfig
from repro.ops import ExecPolicy as JPolicy
import repro_torch.graph.ir as t_ir
from repro_torch.analysis import PlanVerificationError, verify_plan
from repro_torch.artifact.fingerprint import plan_fingerprint
from repro_torch.bridge import params_from_numpy
from repro_torch.core.quantize import QFormat, QTensor
from repro_torch.models.cnn import PaperCNN, PaperCNNConfig
from repro_torch.ops import ExecPolicy

QUANTS = ("none", "qformat", "int8")
BUDGET = 10_000            # streams both MNIST conv stages as bands


@pytest.fixture(scope="module")
def weights():
    params = JaxCNN(JaxCNNConfig()).init(jax.random.PRNGKey(0))
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu")


def _plans(quant="none", **kw):
    """(JAX plan, port plan), compiled alike and unverified."""
    jp = JaxCNN(JaxCNNConfig()).compile(JPolicy(quant=quant), batch=2,
                                        verify=False, **kw)
    tp = PaperCNN(PaperCNNConfig()).compile(ExecPolicy(quant=quant),
                                            batch=2, verify=False, **kw)
    assert [n.pretty() for n in jp.graph] == [n.pretty() for n in tp.graph]
    return jp, tp


def _replace_node(plan, nid, **changes):
    """A tampered copy of ``plan`` with node ``nid``'s fields replaced."""
    nodes = tuple(dataclasses.replace(n, **changes) if n.id == nid else n
                  for n in plan.graph)
    graph = dataclasses.replace(plan.graph, nodes=nodes)
    return dataclasses.replace(plan, graph=graph)


def _codes(violations):
    return [(v.code, v.node) for v in violations]


def _both(jp, tp):
    """The (code, node) lists of both verifiers, which must agree."""
    want = _codes(j_verify(jp, raise_on_violation=False))
    got = _codes(verify_plan(tp, raise_on_violation=False))
    assert got == want
    return got


def _first(plan, ir, cls_name, pred=lambda n: True):
    cls = getattr(ir, cls_name)
    return next(n for n in plan.graph if isinstance(n, cls) and pred(n))


# each case: (quant, compile kwargs, tamper(plan, ir) -> plan, code)
def _halo(p, ir):
    n = _first(p, ir, "FusedConvBlockNode", lambda n: n.tiling)
    return _replace_node(p, n.id, tiling=dataclasses.replace(
        n.tiling, halo=n.tiling.halo + 1))


def _straddle(p, ir):
    n = _first(p, ir, "FusedConvBlockNode", lambda n: n.tiling)
    return _replace_node(p, n.id, tiling=dataclasses.replace(
        n.tiling, pooled=False))


def _budget(p, ir):
    n = _first(p, ir, "FusedConvBlockNode", lambda n: n.tiling)
    return _replace_node(p, n.id, tiling=dataclasses.replace(
        n.tiling, tile_rows=4, budget_bytes=64))


def _stride(p, ir):
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, stride=(2, 2))


def _out_spec(p, ir):
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, out=ir.TensorSpec((2, 15, 12, 13)))


def _dtype(p, ir):
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, out=ir.TensorSpec(n.out.shape,
                                                    "float16"))


def _channels(p, ir):
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, w=dataclasses.replace(
        n.w, shape=(15, 2, 3, 3)))


def _odd_raise(p, ir):
    # a 4x4 kernel leaves a 25x25 conv map that odd='raise' refuses
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, w=dataclasses.replace(
        n.w, shape=(15, 1, 4, 4)))


def _bias(p, ir):
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, b=dataclasses.replace(n.b, shape=(14,)))


def _dense(p, ir):
    n = _first(p, ir, "DenseNode")
    return _replace_node(p, n.id, w=dataclasses.replace(
        n.w, shape=(321, 10)))


def _wiring(p, ir):
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, inputs=(999,))


def _unlowered_weight(p, ir):
    # rewire the weight edge past its quantize node: an fp ParamRef would
    # reach the int8 kernel
    n = _first(p, ir, "FusedConvBlockNode")
    return _replace_node(p, n.id, inputs=(n.inputs[0], n.inputs[0]))


def _no_act_quant(p, ir):
    n = _first(p, ir, "FusedConvBlockNode")
    aq = p.graph.node(n.inputs[0])
    return _replace_node(p, n.id, inputs=(aq.inputs[0], *n.inputs[1:]))


def _quant_none(p, ir):
    return dataclasses.replace(p, quant="none")


def _qformat_bits(p, ir):
    q = QFormat(6, 10) if ir is t_ir else JQFormat(6, 10)
    return dataclasses.replace(p, qformat=q)


CASES = {
    "stream-halo": ("none", {"stream_budget": BUDGET}, _halo),
    "stream-pool-straddle": ("none", {"stream_budget": BUDGET}, _straddle),
    "stream-budget": ("int8", {"stream_budget": BUDGET}, _budget),
    "shape-flow stride": ("none", {}, _stride),
    "shape-flow out spec": ("qformat", {}, _out_spec),
    "dtype-flow": ("none", {}, _dtype),
    "shape-flow channels": ("none", {}, _channels),
    "shape-flow odd pool": ("none", {}, _odd_raise),
    "shape-flow bias": ("none", {}, _bias),
    "shape-flow dense": ("int8", {}, _dense),
    "graph-structure": ("none", {}, _wiring),
    "quant-weight-unlowered weight": ("int8", {}, _unlowered_weight),
    "quant-weight-unlowered act": ("int8", {}, _no_act_quant),
    "quant-kind mode": ("int8", {}, _quant_none),
    "quant-kind bits": ("qformat", {}, _qformat_bits),
}


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("kw", [{}, {"stream_budget": BUDGET}])
def test_clean_plans_verify_for_every_quant(weights, quant, kw):
    jparams, tparams = weights
    jp, tp = _plans(quant, **kw)
    assert _both(jp, tp) == []
    assert verify_plan(tp.bind(tparams, verify=False)) == []
    assert j_verify(jp.bind(jparams, verify=False)) == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_malformed_plan_named_like_the_reference(case):
    quant, kw, tamper = CASES[case]
    jp, tp = _plans(quant, **kw)
    codes = _both(tamper(jp, j_ir), tamper(tp, t_ir))
    assert case.split()[0] in [c for c, _ in codes], codes


def test_verification_is_read_only():
    for kw in ({}, {"stream_budget": BUDGET}):
        a = PaperCNN().compile(batch=2, verify=False, **kw)
        b = PaperCNN().compile(batch=2, verify=True, **kw)
        assert a == b
        assert plan_fingerprint(a) == plan_fingerprint(b)


@pytest.mark.parametrize("kind", ["conv weight scale", "dense fold"])
def test_folded_payload_mismatch_named(weights, kind):
    """Bound-level checks: a folded QTensor whose scale does not hold one
    value per out-channel (``quant-scale-shape``), in both packages."""
    jparams, tparams = weights
    jp, tp = _plans("int8")
    out = []
    for plan, params, qt in ((jp, jparams, JQTensor), (tp, tparams,
                                                       QTensor)):
        bound = plan.bind(params, verify=False)
        if kind == "conv weight scale":
            nid = next(n.id for n in plan.graph
                       if getattr(n, "kind", "") == "int8_conv_weight")
        else:
            nid = next(n.id for n in plan.graph if n.op == "dense")
        val = bound.folded[nid]
        bound.folded[nid] = qt(codes=val.codes,
                               scale=val.scale.reshape(-1)[:1])
        out.append(_codes((j_verify if qt is JQTensor else verify_plan)(
            bound, raise_on_violation=False)))
    assert out[0] == out[1] and out[1][0][0] == "quant-scale-shape"
    with pytest.raises(PlanVerificationError):
        verify_plan(bound)


def test_violations_render_named_not_stack_traces():
    _, tp = _plans("none", stream_budget=BUDGET)
    bad = _halo(tp, t_ir)
    node = next(n for n in bad.graph if getattr(n, "tiling", None))
    with pytest.raises(PlanVerificationError) as e:
        verify_plan(bad)
    msg = str(e.value)
    assert "stream-halo" in msg and f"%{node.id}" in msg
    assert "violation" in msg
    assert [v.code for v in e.value.violations] == ["stream-halo"]


def test_params_must_be_a_dict_of_tensors(weights):
    _, tparams = weights
    bound = PaperCNN().compile(batch=2).bind(tparams)
    bad = dataclasses.replace(bound, params={**tparams, 3: tparams["fc_b"]})
    assert [v.code for v in verify_plan(bad, raise_on_violation=False)] \
        == ["artifact-coherence"]


# ---------------------------------------------------------------- wiring

def test_compile_and_bind_verify_by_default(weights, monkeypatch):
    """``compile_model``, ``bind`` and both models' ``compile`` default to
    ``verify=True``, as the reference's do."""
    import repro_torch.analysis.verifier as V
    from repro_torch.models.vgg import VGGStyleCNN
    _, tparams = weights
    calls = []
    real = V.verify_plan
    monkeypatch.setattr(V, "verify_plan",
                        lambda p, **kw: calls.append(p) or real(p, **kw))
    plan = PaperCNN().compile(batch=2)
    assert len(calls) == 1
    plan.bind(tparams)
    assert len(calls) == 2 and hasattr(calls[-1], "plan")
    PaperCNN().compile(batch=2, verify=False).bind(tparams, verify=False)
    VGGStyleCNN().compile(verify=False)
    assert len(calls) == 2
    VGGStyleCNN().compile()
    assert len(calls) == 3


def test_tampered_artifact_rejected_with_named_violation(weights, tmp_path):
    """A manifest whose fingerprint was recomputed after the tamper passes
    the integrity check; only the verifier catches it."""
    from repro_torch.artifact import PlanStore
    from repro_torch.artifact.fingerprint import policy_from_doc
    from repro_torch.artifact.ir_codec import graph_from_doc
    from repro_torch.artifact.store import ArtifactError, load_plan
    from repro_torch.graph.plan import ExecutionPlan

    _, tparams = weights
    bound = PaperCNN().compile(batch=2).bind(tparams)
    bound.save(tmp_path / "good")
    shutil.copytree(tmp_path / "good", tmp_path / "evil")
    mf = tmp_path / "evil" / "manifest.json"
    manifest = json.loads(mf.read_text())
    node_doc = next(n for n in manifest["graph"]["nodes"]
                    if n["op"] == "fused_conv_block")
    node_doc["stride"] = [2, 2]              # shapes no longer flow
    plan = ExecutionPlan(
        graph=graph_from_doc(manifest["graph"]), quant=manifest["quant"],
        qformat=QFormat(*manifest["qformat"]),
        compile_policy=policy_from_doc(manifest["compile_policy"]))
    manifest["fingerprint"] = plan_fingerprint(
        plan, params=tparams, tuned={},
        bind_policy=policy_from_doc(manifest["bind_policy"]))
    mf.write_text(json.dumps(manifest))

    with pytest.raises(ArtifactError, match="static verification"):
        load_plan(tmp_path / "evil", device="cpu")
    with pytest.raises(ArtifactError, match="shape-flow"):
        load_plan(tmp_path / "evil", device="cpu")
    store = PlanStore(tmp_path)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert store.load("evil", device="cpu") is None
    assert any("falling back" in str(x.message) for x in w)
    assert store.load("good", device="cpu") is not None
