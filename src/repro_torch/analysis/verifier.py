"""The compile-time plan verifier (DESIGN.md §14).

Port of ``repro.analysis.verifier``. ``verify_plan(plan_or_bound)`` statically re-derives and checks every
stage of a compiled ``ExecutionPlan`` (or ``BoundPlan``) **before any
dispatch**: a malformed plan is rejected with a *named violation* (code +
stage + fix hint), never a stack trace from the middle of a kernel
launch.

Invariant families (each a stable ``Violation.code`` prefix, the same
codes as the reference):

  * ``shape-flow`` / ``dtype-flow`` / ``graph-structure`` — every node's
    output spec re-derived from its inputs (paper Eq. 1–2 sizing);
  * ``quant-*`` — the lowered graph matches the plan's baked quant mode:
    no fp weight reaches an int8 stage, QTensor scale shapes match
    out-channels, QFormat bits agree (paper C4);
  * ``shard-*`` — ICP/OCP/2-D divisibility against the mesh (Eq. 6/7,
    icp × ocp factorization of the model axis, gather-axis purity), data
    axis presence, flatten-gather placement at the conv→fc boundary;
  * ``stream-*`` — band cuts never straddle a 2×2 pool window, per-band
    working set fits the budget, halo accounting matches K/stride
    (``repro_torch.stream.tiling.check_tiling``), banding not stamped on
    a sharded stage;
  * ``artifact-coherence`` — every fingerprint input serializes (graph
    doc roundtrip, policies, tuned tiles, params dict keys), so the plan
    can become an artifact (DESIGN.md §12).

Verification is read-only: it never mutates the plan, so verified and
unverified compiles are identical. It runs in ``compile_model`` and
``ExecutionPlan.bind`` under ``verify=True`` (the default) and in
``repro_torch.artifact.store.load_plan``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from repro_torch.core.window import conv_output_size, pool_output_size
from repro_torch.graph.ir import (Conv2DNode, DenseNode, FlattenNode,
                                  FusedConvBlockNode, Graph, InputNode,
                                  MaxPool2Node, Node, QuantizeNode,
                                  ReluNode, TensorSpec)
from repro_torch.graph.passes import stage_input_spec
from repro_torch.stream.tiling import check_tiling

__all__ = ["Violation", "PlanVerificationError", "verify_plan"]


@dataclass(frozen=True)
class Violation:
    """One named invariant violation in a compiled plan."""

    code: str                 # stable id, e.g. "stream-halo"
    message: str
    node: int | None = None   # graph node id the violation anchors to
    hint: str = ""

    def render(self) -> str:
        where = "plan" if self.node is None else f"%{self.node}"
        out = f"[{self.code}] {where}: {self.message}"
        if self.hint:
            out += f" (hint: {self.hint})"
        return out


class PlanVerificationError(ValueError):
    """A plan failed static verification. ``violations`` carries every
    named violation; the message lists them all."""

    def __init__(self, violations: list[Violation]):
        self.violations = tuple(violations)
        super().__init__(
            "plan failed static verification with "
            f"{len(violations)} violation(s):\n"
            + "\n".join("  " + v.render() for v in violations))


# ---------------------------------------------------------------------------
# shape / dtype flow

def _conv_like_specs(graph: Graph, node) -> tuple[TensorSpec, tuple]:
    """(activation spec feeding the stage, weight shape). Quantize nodes
    are transparent (codes keep the float-level shape)."""
    return stage_input_spec(graph, node), tuple(node.w.shape)


def _derive(graph: Graph, node: Node, out: list[Violation]) -> None:
    """Re-derive ``node.out`` from its inputs; append violations."""

    def bad(code, msg, hint=""):
        out.append(Violation(code=code, message=msg, node=node.id,
                             hint=hint))

    def expect(shape, dtype=None):
        if tuple(node.out.shape) != tuple(shape):
            bad("shape-flow",
                f"{node.op} output spec {node.out} does not match the "
                f"re-derived shape {tuple(shape)}")
        elif dtype is not None and node.out.dtype != dtype:
            bad("dtype-flow",
                f"{node.op} output dtype {node.out.dtype} does not match "
                f"the re-derived dtype {dtype}")

    if isinstance(node, InputNode):
        return
    src = graph.node(node.inputs[0]).out if node.inputs else None

    if isinstance(node, (Conv2DNode, FusedConvBlockNode)):
        act, wshape = _conv_like_specs(graph, node)
        if len(act.shape) != 4 or len(wshape) != 4:
            bad("shape-flow", f"conv stage expects 4-D activation/weight, "
                f"got {act} and w{wshape}")
            return
        bsz, n, h, w = act.shape
        m, n2, kh, kw = wshape
        if n != n2:
            bad("shape-flow",
                f"input has {n} channels but weight {node.w} expects {n2}")
            return
        if h < kh or w < kw:
            bad("shape-flow", f"kernel {kh}x{kw} larger than input "
                f"{h}x{w} (VALID padding, paper Eq. 1)")
            return
        sh, sw = node.stride
        ho = conv_output_size(h, kh, sh)
        wo = conv_output_size(w, kw, sw)
        if node.b is not None and tuple(node.b.shape) != (m,):
            bad("shape-flow", f"bias {node.b} shape {tuple(node.b.shape)} "
                f"!= ({m},) out channels")
        if isinstance(node, FusedConvBlockNode):
            try:
                po = pool_output_size(ho, node.odd)
                pw = pool_output_size(wo, node.odd)
            except ValueError as e:
                bad("shape-flow", f"fused pool sizing invalid: {e}",
                    hint="compile with odd='drop'|'pad' or fix the sizing")
                return
            expect((bsz, m, po, pw), act.dtype)
        else:
            expect((bsz, m, ho, wo), act.dtype)
    elif isinstance(node, ReluNode):
        expect(src.shape, src.dtype)
    elif isinstance(node, MaxPool2Node):
        bsz, c, h, w = src.shape
        try:
            expect((bsz, c, pool_output_size(h, node.odd),
                    pool_output_size(w, node.odd)), src.dtype)
        except ValueError as e:
            bad("shape-flow", f"pool sizing invalid: {e}")
    elif isinstance(node, FlattenNode):
        expect((src.shape[0], int(np.prod(src.shape[1:]))), src.dtype)
    elif isinstance(node, DenseNode):
        k, n = node.w.shape
        if src.shape[-1] != k:
            bad("shape-flow", f"dense input dim {src.shape[-1]} != weight "
                f"{node.w} dim {k}")
            return
        expect((*src.shape[:-1], n), src.dtype)
        if node.b is not None and tuple(node.b.shape) != (n,):
            bad("shape-flow", f"dense bias {node.b} shape "
                f"{tuple(node.b.shape)} != ({n},)")
    elif isinstance(node, QuantizeNode):
        if node.constant:
            if node.ref is None:
                bad("quant-kind", "constant quantize node has no ParamRef")
            elif tuple(node.out.shape) != tuple(node.ref.shape):
                bad("shape-flow",
                    f"constant quantize out {node.out} != ref "
                    f"{node.ref} shape {tuple(node.ref.shape)}")
        else:
            expect(src.shape)


# ---------------------------------------------------------------------------
# quantization invariants (paper C4; DESIGN.md §8)

_HINT_QUANT = "recompile the model under the intended quant policy"


def _check_quant(plan, out: list[Violation]) -> None:
    graph, quant = plan.graph, plan.quant
    q_nodes = [n for n in graph if isinstance(n, QuantizeNode)]
    if quant == "none":
        for n in q_nodes:
            out.append(Violation(
                code="quant-kind", node=n.id,
                message=f"quantize node (kind={n.kind!r}) in a quant='none' "
                        f"plan", hint=_HINT_QUANT))
        return
    if quant not in ("qformat", "int8"):
        out.append(Violation(code="quant-kind",
                             message=f"unknown plan quant mode {quant!r}"))
        return
    allowed = {"qformat"} if quant == "qformat" else {"int8_act",
                                                      "int8_conv_weight"}
    for n in q_nodes:
        if n.kind not in allowed:
            out.append(Violation(
                code="quant-kind", node=n.id,
                message=f"quantize kind {n.kind!r} illegal in a "
                        f"quant={quant!r} plan", hint=_HINT_QUANT))
        if n.kind == "qformat" and (n.int_bits != plan.qformat.int_bits or
                                    n.frac_bits != plan.qformat.frac_bits):
            out.append(Violation(
                code="quant-kind", node=n.id,
                message=f"Q{n.int_bits}.{n.frac_bits} node in a "
                        f"Q{plan.qformat.int_bits}.{plan.qformat.frac_bits} "
                        f"plan", hint=_HINT_QUANT))

    wkind = "qformat" if quant == "qformat" else "int8_conv_weight"
    for node in graph:
        if not isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            continue
        wq = graph.node(node.inputs[1]) if len(node.inputs) > 1 else None
        if not (isinstance(wq, QuantizeNode) and wq.constant
                and wq.kind == wkind):
            out.append(Violation(
                code="quant-weight-unlowered", node=node.id,
                message=f"conv stage in a quant={quant!r} plan reads an "
                        f"unlowered (fp) weight {node.w}",
                hint="quant lowering must insert a constant "
                     f"{wkind!r} quantize on the weight edge"))
            continue
        if quant == "int8":
            m = node.w.shape[0]
            if wq.ref is not None and tuple(wq.ref.shape) and \
                    wq.ref.shape[0] != m:
                out.append(Violation(
                    code="quant-scale-shape", node=node.id,
                    message=f"int8 weight quantize ref {wq.ref} has "
                            f"{wq.ref.shape[0]} out-channels, stage has "
                            f"{m}"))
            aq = graph.node(node.inputs[0])
            if not (isinstance(aq, QuantizeNode) and aq.kind == "int8_act"):
                out.append(Violation(
                    code="quant-weight-unlowered", node=node.id,
                    message="int8 conv stage input edge has no int8_act "
                            "quantize — an fp activation would reach the "
                            "int8 kernel", hint=_HINT_QUANT))


def _shard_blocks(bound) -> dict[int, tuple[int, int]]:
    """{constant quantize id: (ki, ko)} of the weight-side operands a mesh
    ``bind`` replaced by this rank's block (every bind of a plan with
    placed stages does)."""
    if not bound.plan.grids:
        return {}
    blocks = {}
    msize = _mesh_axes(bound.plan.mesh).get("model", 1)
    for node in bound.plan.graph:
        spec = getattr(node, "sharding", None)
        if spec is None or spec.mode == "none":
            continue
        for q in node.inputs[1:]:
            blocks[q] = spec.split(msize)
    return blocks


def _check_folded(bound, out: list[Violation]) -> None:
    """Bound-level quant invariants: the folded payloads really are what
    the int8/qformat kernels expect (scale shapes match out-channels). On
    a mesh a placed stage's payload is this rank's (M/ocp, N/icp) block."""
    from repro_torch.core.quantize import QTensor
    plan = bound.plan
    graph = plan.graph
    blocks = _shard_blocks(bound)
    for node in graph:
        if isinstance(node, QuantizeNode) and node.constant:
            val = bound.folded.get(node.id)
            if val is None:        # unfolded: executor refetches — legal
                continue
            want = tuple(node.ref.shape) if node.ref is not None else None
            if want and node.id in blocks:
                ki, ko = blocks[node.id]
                want = ((want[0] // ko,) if len(want) == 1 else
                        (want[0] // ko, want[1] // ki, *want[2:]))
            if node.kind == "int8_conv_weight":
                if not isinstance(val, QTensor):
                    out.append(Violation(
                        code="quant-scale-shape", node=node.id,
                        message=f"folded int8 weight is "
                                f"{type(val).__name__}, expected QTensor"))
                    continue
                m = want[0] if want else None
                if want and tuple(val.codes.shape) != want:
                    out.append(Violation(
                        code="quant-scale-shape", node=node.id,
                        message=f"folded codes shape "
                                f"{tuple(val.codes.shape)} != weight "
                                f"shape {want}"))
                if m is not None and int(np.prod(val.scale.shape)) != m:
                    out.append(Violation(
                        code="quant-scale-shape", node=node.id,
                        message=f"QTensor scale shape "
                                f"{tuple(val.scale.shape)} does not hold "
                                f"one scale per out-channel ({m})",
                        hint="per-channel requant needs scale.size == M"))
            elif want and hasattr(val, "shape") and \
                    tuple(val.shape) != want:
                out.append(Violation(
                    code="quant-scale-shape", node=node.id,
                    message=f"folded {node.kind} payload shape "
                            f"{tuple(val.shape)} != ref shape {want}"))
        elif isinstance(node, DenseNode) and plan.quant == "int8":
            val = bound.folded.get(node.id)
            if val is None:
                continue
            if not isinstance(val, QTensor):
                out.append(Violation(
                    code="quant-scale-shape", node=node.id,
                    message=f"folded int8 dense weight is "
                            f"{type(val).__name__}, expected QTensor"))
                continue
            k, n = node.w.shape
            if tuple(val.codes.shape) != (k, n) or \
                    int(np.prod(val.scale.shape)) != n:
                out.append(Violation(
                    code="quant-scale-shape", node=node.id,
                    message=f"int8 dense fold codes "
                            f"{tuple(val.codes.shape)} / scale "
                            f"{tuple(val.scale.shape)} inconsistent with "
                            f"weight ({k}, {n})"))


# ---------------------------------------------------------------------------
# sharding legality (paper Eq. 6/7; DESIGN.md §9)

def _mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything shaped like
    one: ``mesh_dim_names`` and a ``mesh`` array of ranks)."""
    if mesh is None:
        return {}
    return {name: int(size) for name, size in
            zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def _check_sharding(plan, out: list[Violation]) -> None:
    graph = plan.graph
    axes = _mesh_axes(plan.mesh)
    sharded: set[int] = set()
    for node in graph:
        spec = getattr(node, "sharding", None)
        if spec is None:
            continue
        if spec.mode == "none":
            # a pure-data stage must not carry model-axis factors: the
            # executor would run it replicated while the spec claims a
            # collective
            if spec.icp > 1 or spec.ocp > 1:
                out.append(Violation(
                    code="shard-pure-data-collective", node=node.id,
                    message=f"pure data-parallel stage (mode=none) carries "
                            f"model-axis factors icp={spec.icp} "
                            f"ocp={spec.ocp} — no collective runs on this "
                            f"stage",
                    hint="clear the factors or set mode to the split "
                         "they describe"))
            continue
        sharded.add(node.id)
        if plan.mesh is None:
            out.append(Violation(
                code="shard-mesh", node=node.id,
                message=f"stage placed ({spec}) but the plan has no mesh",
                hint="compile with mesh= or strip the placement"))
            continue
        if "model" not in axes:
            out.append(Violation(
                code="shard-mesh", node=node.id,
                message=f"mesh {axes} has no 'model' axis for the {spec} "
                        f"schedule"))
            continue
        msize = axes["model"]
        m, n = node.w.shape[0], node.w.shape[1]
        ki, ko = spec.split(msize)
        if (spec.icp or spec.ocp) and ki * ko != msize:
            out.append(Violation(
                code="shard-factorization", node=node.id,
                message=f"{spec} factors do not cover the model axis: "
                        f"icp={ki} x ocp={ko} = {ki * ko} != {msize} "
                        f"devices",
                hint="icp * ocp must equal the model-axis extent"))
        if spec.mode == "both":
            if n % ki != 0:
                out.append(Violation(
                    code="shard-divisibility", node=node.id,
                    message=f"Eq. 7/ICP side of {spec}: N (in channels)="
                            f"{n} does not divide the icp factor "
                            f"({ki} groups)",
                    hint="use divisible channel counts or let "
                         "auto-placement pick the split"))
            if m % ko != 0:
                out.append(Violation(
                    code="shard-divisibility", node=node.id,
                    message=f"Eq. 6/OCP side of {spec}: M (out channels)="
                            f"{m} does not divide the ocp factor "
                            f"({ko} groups)",
                    hint="use divisible channel counts or let "
                         "auto-placement pick the split"))
        else:
            dim, name, eq = (m, "M (out channels)", "Eq. 6/OCP") \
                if spec.mode == "output" \
                else (n, "N (in channels)", "Eq. 7/ICP")
            if dim % msize != 0:
                out.append(Violation(
                    code="shard-divisibility", node=node.id,
                    message=f"{eq}: {name}={dim} does not divide the model "
                            f"axis ({msize} devices)",
                    hint="use divisible channel counts or let "
                         "auto-placement pick the schedule"))
        if spec.data and "data" not in axes:
            out.append(Violation(
                code="shard-mesh", node=node.id,
                message=f"stage opts into data-axis sharding but mesh "
                        f"{axes} has no 'data' axis"))
        if getattr(node, "tiling", None) is not None:
            out.append(Violation(
                code="stream-sharded-stage", node=node.id,
                message="spatial banding stamped on a channel-sharded "
                        "stage — the executor cannot compose them",
                hint="the placement pass skips sharded stages; re-place"))

    if not sharded:
        return
    # flatten-gather placement: a sharded activation is gathered (at a
    # FlattenNode) before it reaches the dense tail
    for node in graph:
        if not isinstance(node, DenseNode):
            continue
        if _reaches(graph, node, lambda nid, src: nid in sharded):
            out.append(Violation(
                code="shard-gather", node=node.id,
                message="dense stage reads a channel-sharded stage with "
                        "no flatten gather between them",
                hint="the conv->fc boundary gathers at FlattenNode"))

    # gather-axis purity: the flatten gather moves ONLY the model axis;
    # a model-sharded stage that opted out of data sharding feeding a
    # flatten on a mesh with a data axis would move the batch too
    if "data" not in axes:
        return
    for node in graph:
        if not isinstance(node, FlattenNode):
            continue
        if _reaches(graph, node, lambda nid, src: nid in sharded
                    and not src.sharding.data):
            out.append(Violation(
                code="shard-gather-axis", node=node.id,
                message="flatten gathers a model-sharded stage placed "
                        "with data=False on a mesh with a 'data' axis — "
                        "the gather would move the batch axis, not just "
                        "the model axis",
                hint="place the stage with data=True or drop the "
                     "mesh's data axis"))


def _reaches(graph: Graph, node: Node, hit) -> bool:
    """True when a producer path of ``node`` that crosses no FlattenNode
    holds a node ``hit(id, node)`` accepts."""
    frontier, seen = list(node.inputs), set()
    while frontier:
        nid = frontier.pop()
        if nid in seen:
            continue
        seen.add(nid)
        src = graph.node(nid)
        if isinstance(src, FlattenNode):
            continue                # gather point — stop this path
        if hit(nid, src):
            return True
        frontier.extend(src.inputs)
    return False


# ---------------------------------------------------------------------------
# streaming legality (§III.B; DESIGN.md §13)

def _check_streaming(plan, out: list[Violation]) -> None:
    graph = plan.graph
    for node in graph:
        tiling = getattr(node, "tiling", None)
        if tiling is None:
            continue
        fused = isinstance(node, FusedConvBlockNode)
        act, wshape = _conv_like_specs(graph, node)
        if len(act.shape) != 4 or len(wshape) != 4:
            continue                # shape-flow already flagged this stage
        for code, msg in check_tiling(
                tiling, fused=fused, in_shape=tuple(act.shape),
                w_shape=wshape, stride=tuple(node.stride),
                itemsize=np.dtype(act.dtype).itemsize):
            out.append(Violation(code=code, message=msg, node=node.id))


# ---------------------------------------------------------------------------
# artifact-schema coherence (DESIGN.md §12)

def _check_artifact_coherence(plan, bound, out: list[Violation]) -> None:
    from repro_torch.artifact.fingerprint import (flatten_params,
                                                  policy_to_doc)
    from repro_torch.artifact.ir_codec import graph_from_doc, graph_to_doc
    try:
        doc = graph_to_doc(plan.graph)
        json.dumps(doc)
        if graph_from_doc(doc) != plan.graph:
            out.append(Violation(
                code="artifact-coherence",
                message="graph IR does not roundtrip through the artifact "
                        "codec — the fingerprint would not cover this "
                        "plan's real structure"))
    except Exception as e:
        out.append(Violation(
            code="artifact-coherence",
            message=f"graph IR not serializable: "
                    f"{type(e).__name__}: {e}"))
    try:
        json.dumps([policy_to_doc(plan.compile_policy),
                    [int(plan.qformat.int_bits),
                     int(plan.qformat.frac_bits)]])
        if bound is not None:
            json.dumps(policy_to_doc(bound.policy))
            json.dumps({str(int(k)): {str(kk): int(vv)
                                      for kk, vv in v.items()}
                        for k, v in bound.tuned.items()})
    except Exception as e:
        out.append(Violation(
            code="artifact-coherence",
            message=f"fingerprint input not serializable: "
                    f"{type(e).__name__}: {e}"))
    if bound is not None:
        try:
            flatten_params(bound.params)
        except TypeError as e:
            out.append(Violation(
                code="artifact-coherence",
                message=f"params are not a dict of tensors keyed by "
                        f"strings — the artifact store cannot flatten "
                        f"them ({e})"))


# ---------------------------------------------------------------------------
# entry point

def verify_plan(plan_or_bound, *, raise_on_violation: bool = True
                ) -> list[Violation]:
    """Statically verify a compiled plan (read-only; no dispatch).

    Accepts an ``ExecutionPlan`` or a ``BoundPlan`` (duck-typed on the
    ``plan`` attribute — bound plans additionally get their folded quant
    payloads checked). Returns the violation list; with
    ``raise_on_violation`` (default) a non-empty list raises
    ``PlanVerificationError`` naming every violation.
    """
    bound = None
    plan = plan_or_bound
    if hasattr(plan_or_bound, "plan"):
        bound = plan_or_bound
        plan = bound.plan

    out: list[Violation] = []
    try:
        plan.graph.validate()
    except (ValueError, KeyError) as e:
        out.append(Violation(code="graph-structure",
                             message=f"graph invalid: {e}"))
        if raise_on_violation:
            raise PlanVerificationError(out)
        return out

    for node in plan.graph:
        try:
            _derive(plan.graph, node, out)
        except (KeyError, IndexError, ValueError, TypeError) as e:
            out.append(Violation(
                code="shape-flow", node=node.id,
                message=f"could not re-derive {node.op} output: "
                        f"{type(e).__name__}: {e}"))
    _check_quant(plan, out)
    _check_sharding(plan, out)
    _check_streaming(plan, out)
    _check_artifact_coherence(plan, bound, out)
    if bound is not None:
        _check_folded(bound, out)

    if out and raise_on_violation:
        raise PlanVerificationError(out)
    return out
