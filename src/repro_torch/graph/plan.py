"""ExecutionPlan: the static, deep-pipelined execution of a compiled graph.

Port of ``repro.graph.plan`` on a single device (DESIGN.md §8).
``compile_model`` runs trace → passes → plan; the plan is

  * **static** — node list, shapes, fusion and quantization points are
    fixed at compile time;
  * **registry-dispatched** — every compute stage goes through the
    ``repro_torch.ops`` registry, so on the card the conv stages run the
    ``fused_cwp`` (or ``conv_window``) kernel and the int8 fc the
    ``qmatmul`` kernel;
  * **quant-baked** — the lowered graph carries explicit QuantizeNodes
    and the stages run with ``quant="none"``; running under a different
    ambient quant raises.

``plan.bind(params)`` folds the constant (weight) quantize nodes once and
returns a ``BoundPlan``. Every compile runs the streaming placement pass
(``repro_torch.stream``, DESIGN.md §13): a conv stage whose per-image
footprint exceeds ``stream_budget`` carries a ``SpatialTiling`` and runs
as halo-overlapped row bands through the same registry ops, one kernel
launch a band on the card. Mesh placement, bind-time autotuning,
artifacts and the plan verifier are later slices and raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.quantize import QFormat, QTensor, quantize_int8
from repro_torch.core.window import maxpool2
from repro_torch.graph.ir import (Conv2DNode, DenseNode, FlattenNode,
                                  FusedConvBlockNode, Graph, InputNode,
                                  MaxPool2Node, QuantizeNode, ReluNode)
from repro_torch.graph.passes import default_passes
from repro_torch.graph.trace import trace
from repro_torch.ops.policy import ExecPolicy, current_policy

__all__ = ["ExecutionPlan", "BoundPlan", "compile_model"]


def _apply_quantize(node: QuantizeNode, val, q: QFormat):
    """int8 kinds produce QTensors (codes + scale), not fake-quant floats:
    the conv entry points contract the codes and apply sx·sw as the
    requant epilogue."""
    if node.kind == "qformat":
        return q.quantize(val)
    if node.kind == "int8_act":
        return quantize_int8(val, axis=None)
    if node.kind == "int8_conv_weight":
        m = val.shape[0]
        t = quantize_int8(val.reshape(m, -1), axis=-1)
        return QTensor(t.codes.reshape(val.shape), t.scale.reshape(-1))
    raise ValueError(f"unknown quantize kind {node.kind!r}")


@dataclass(frozen=True)
class ExecutionPlan:
    """A compiled graph + its baked quantization, executable as
    ``plan(params, images)``."""

    graph: Graph
    quant: str = "none"
    qformat: QFormat = field(default_factory=QFormat)
    compile_policy: ExecPolicy | None = None

    def _base_policy(self, policy: ExecPolicy | None) -> ExecPolicy:
        pol = policy
        if pol is None:
            pol = self.compile_policy
        if pol is None:
            pol = current_policy()
        if pol.quant not in ("none", self.quant):
            raise ValueError(
                f"plan was compiled for quant={self.quant!r} but is being "
                f"run under quant={pol.quant!r}; recompile with "
                f".compile(policy=...) for a different number format")
        return pol.with_options(quant="none")

    def __call__(self, params, x, *, policy: ExecPolicy | None = None,
                 _folded: dict | None = None):
        from repro_torch.ops import conv2d, dense, fused_conv_block, qdense
        from repro_torch.stream.executor import (stream_conv2d,
                                                 stream_fused_conv_block)
        base = self._base_policy(policy)
        dense_pol = base.with_options(quant=self.quant, qformat=self.qformat)
        env: dict[int, object] = {}
        folded = _folded or {}

        def _weight(node, idx, attr):
            """Weight operand: through the lowered graph's quantize node
            (possibly pre-folded), else read from the ParamRef."""
            if len(node.inputs) > idx:
                return env[node.inputs[idx]]
            ref = getattr(node, attr)
            return None if ref is None else ref.fetch(params)

        for node in self.graph:
            if isinstance(node, InputNode):
                env[node.id] = x
            elif isinstance(node, QuantizeNode):
                if node.id in folded:
                    env[node.id] = folded[node.id]
                    continue
                val = (node.ref.fetch(params) if node.constant
                       else env[node.inputs[0]])
                env[node.id] = _apply_quantize(node, val, self.qformat)
            elif isinstance(node, FusedConvBlockNode):
                args = (env[node.inputs[0]], _weight(node, 1, "w"),
                        _weight(node, 2, "b"))
                if node.tiling is not None:
                    # over-budget stage: halo-overlapped row bands
                    env[node.id] = stream_fused_conv_block(
                        *args, stride=node.stride, odd=node.odd,
                        tiling=node.tiling, policy=base)
                else:
                    env[node.id] = fused_conv_block(
                        *args, stride=node.stride, odd=node.odd,
                        policy=base)
            elif isinstance(node, Conv2DNode):
                args = (env[node.inputs[0]], _weight(node, 1, "w"),
                        _weight(node, 2, "b"))
                if node.tiling is not None:
                    env[node.id] = stream_conv2d(
                        *args, stride=node.stride, tiling=node.tiling,
                        policy=base)
                else:
                    env[node.id] = conv2d(*args, stride=node.stride,
                                          policy=base)
            elif isinstance(node, ReluNode):
                env[node.id] = torch.relu(env[node.inputs[0]])
            elif isinstance(node, MaxPool2Node):
                env[node.id] = maxpool2(env[node.inputs[0]], odd=node.odd)
            elif isinstance(node, FlattenNode):
                v = env[node.inputs[0]]
                env[node.id] = v.reshape(v.shape[0], -1)
            elif isinstance(node, DenseNode):
                wq = folded.get(node.id)
                if wq is not None:
                    # bind pre-quantized this dense weight: the int8
                    # datapath directly (== ops.dense under int8)
                    out = qdense(env[node.inputs[0]], wq, policy=base)
                    b = _weight(node, 2, "b")
                    env[node.id] = out if b is None else out + b
                else:
                    env[node.id] = dense(
                        env[node.inputs[0]], _weight(node, 1, "w"),
                        _weight(node, 2, "b"), policy=dense_pol)
            else:
                raise TypeError(f"no executor for node {node.pretty()}")
        return env[self.graph.output_id]

    def _fold_constants(self, params) -> dict:
        """Every constant QuantizeNode, plus each dense layer's QTensor
        under int8."""
        folded = {
            node.id: _apply_quantize(node, node.ref.fetch(params),
                                     self.qformat)
            for node in self.graph
            if isinstance(node, QuantizeNode) and node.constant}
        if self.quant == "int8":
            for node in self.graph:
                if isinstance(node, DenseNode):
                    folded[node.id] = quantize_int8(node.w.fetch(params),
                                                    axis=0)
        return folded

    def bind(self, params, *, policy: ExecPolicy | None = None
             ) -> "BoundPlan":
        """Fold weight quantization against ``params`` now, so per-batch
        calls skip weight requantization."""
        return BoundPlan(plan=self, params=params,
                         folded=self._fold_constants(params), policy=policy)

    def stages(self) -> list[str]:
        return [n.pretty() for n in self.graph]

    def num_fused(self) -> int:
        return sum(isinstance(n, FusedConvBlockNode) for n in self.graph)

    def pretty(self) -> str:
        head = (f"ExecutionPlan(quant={self.quant}, "
                f"{len(self.graph)} nodes, {self.num_fused()} fused)")
        return head + "\n" + self.graph.pretty()


@dataclass(frozen=True)
class BoundPlan:
    """An ExecutionPlan closed over one params dict with weight
    quantization pre-folded — call as ``bound(images)``."""

    plan: ExecutionPlan
    params: object
    folded: dict
    policy: ExecPolicy | None = None

    def __call__(self, x, *, policy: ExecPolicy | None = None):
        return self.plan(self.params, x,
                         policy=policy if policy is not None else self.policy,
                         _folded=self.folded)


def compile_model(model, input_shape: tuple[int, ...] | None = None, *,
                  policy: ExecPolicy | None = None, fuse: bool = True,
                  mesh=None, autotune: bool = False,
                  stream_budget: int | None = None,
                  dtype: str = "float32",
                  verify: bool = False) -> ExecutionPlan:
    """trace → passes → spatial-tiling placement → plan for any model
    whose forward routes through the hooked functional layer. The
    quantization mode resolves now (explicit ``policy`` > model-config
    policy > ambient ``use_policy``); backend and launch shape stay
    dynamic through the registry.

    ``stream_budget`` (bytes, default
    ``repro_torch.stream.STREAM_VMEM_BUDGET_BYTES``) is the per-image
    stage footprint above which conv/fused stages get a ``SpatialTiling``
    and execute as halo-overlapped row bands (DESIGN.md §13)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-placed plans are not ported yet (ROADMAP §A.10, "
            "channel parallelism)")
    if autotune:
        raise NotImplementedError(
            "bind-time autotuning is not ported yet (ROADMAP §A.7)")
    if verify:
        raise NotImplementedError(
            "the plan verifier is not ported yet (ROADMAP §A.9)")
    if input_shape is None:
        input_shape = model.input_shape()
    pol = policy
    if pol is None:
        exec_pol = getattr(getattr(model, "cfg", None), "exec_policy", None)
        pol = exec_pol() if callable(exec_pol) else None
    quant_pol = pol if pol is not None else current_policy()
    graph = trace(model, tuple(input_shape), dtype)
    graph = default_passes(graph, quant=quant_pol.quant,
                           qformat=quant_pol.qformat, fuse=fuse)
    # runs on every compile: under-budget graphs (all MNIST-sized plans)
    # come back node for node identical. Imported here: repro_torch.stream
    # imports the graph IR, whose package imports this module.
    from repro_torch.stream.passes import place_spatial_tiling
    graph = place_spatial_tiling(graph, budget_bytes=stream_budget)
    return ExecutionPlan(graph=graph, quant=quant_pol.quant,
                         qformat=quant_pol.qformat, compile_policy=pol)
