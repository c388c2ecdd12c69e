"""Typed op-graph IR for the fusion graph compiler (DESIGN.md §8).

Port of ``repro.graph.ir`` on a single device: the same frozen node
dataclasses, ids, ``TensorSpec``s and ``ParamRef`` paths, and the conv
stages' streaming ``tiling`` (``repro_torch.stream``, DESIGN.md §13), so
a port plan prints (``Graph.pretty``) exactly like the reference plan it
mirrors, and the conv stages' ``ShardingSpec`` placement on a
(data × model) mesh (DESIGN.md §9/§15).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Iterator

if TYPE_CHECKING:
    from repro_torch.stream.tiling import SpatialTiling

__all__ = ["TensorSpec", "ParamRef", "ShardingSpec", "Node", "InputNode",
           "Conv2DNode", "ReluNode", "MaxPool2Node", "FlattenNode", "DenseNode",
           "QuantizeNode", "FusedConvBlockNode", "Graph"]


@dataclass(frozen=True)
class TensorSpec:
    """Static shape + dtype of one value in the graph."""

    shape: tuple[int, ...]
    dtype: str = "float32"

    def __str__(self) -> str:
        return f"{self.dtype}[{','.join(map(str, self.shape))}]"


@dataclass(frozen=True)
class ParamRef:
    """A path into the params dict, e.g. ``("conv1", "w")``."""

    path: tuple[str, ...]
    shape: tuple[int, ...]
    dtype: str = "float32"

    def fetch(self, params):
        leaf = params
        for key in self.path:
            leaf = leaf[key]
        return leaf

    def __str__(self) -> str:
        return "/".join(self.path)


@dataclass(frozen=True)
class ShardingSpec:
    """Placement of one conv stage on a 2-D (data × model) mesh.

    ``mode`` is the paper's §III.A channel-parallelism choice, in
    ``ChannelParallelism`` value spelling: ``"output"`` (Eq. 6 / OCP: M
    sharded over ``model``, no collective), ``"input"`` (Eq. 7 / ICP: N
    sharded, one ring reduce), ``"both"`` (the ``model`` axis factored
    into an ``icp × ocp`` sub-grid, each rank owning an (M/ocp, N/icp)
    weight block; the reduce runs over the icp groups only) or
    ``"none"`` (replicated compute, data parallelism only).

    ``icp``/``ocp`` are the model-axis factors (``0`` = derive from
    ``mode``: ``input`` is the whole axis ICP, ``output`` the whole axis
    OCP); ``split()`` resolves either form against a mesh. ``data`` opts
    the stage's batch into sharding over the ``data`` axis. ``None`` on
    a node means the graph was never placed.
    """

    mode: str = "none"
    data: bool = True
    icp: int = 0
    ocp: int = 0

    def __post_init__(self):
        if self.mode not in ("none", "input", "output", "both"):
            raise ValueError(f"unknown sharding mode {self.mode!r}; "
                             "expected none|input|output|both")
        if self.icp < 0 or self.ocp < 0:
            raise ValueError(f"negative sharding factors "
                             f"icp={self.icp} ocp={self.ocp}")

    def split(self, model_size: int) -> tuple[int, int]:
        """Resolve the (icp, ocp) group sizes against a mesh's model-axis
        extent. Explicit factors win; specs without factors derive the
        whole axis from ``mode``."""
        if self.icp or self.ocp:
            return (max(self.icp, 1), max(self.ocp, 1))
        if self.mode == "input":
            return (model_size, 1)
        if self.mode == "output":
            return (1, model_size)
        return (1, 1)

    def __str__(self) -> str:
        if self.mode == "none":
            return "none"
        if self.mode == "both":
            return f"icp{self.icp}xocp{self.ocp}"
        return {"input": "icp", "output": "ocp"}[self.mode]


@dataclass(frozen=True)
class Node:
    """Base node: subclasses add op-specific static attributes."""

    id: int
    inputs: tuple[int, ...]
    out: TensorSpec

    @property
    def op(self) -> str:
        name = type(self).__name__
        if name.endswith("Node"):
            name = name[:-4]
        return getattr(self, "_opname", name.lower())

    def describe(self) -> str:
        return ""

    def pretty(self) -> str:
        args = ", ".join(f"%{i}" for i in self.inputs)
        extra = self.describe()
        extra = f" {extra}" if extra else ""
        return f"%{self.id} = {self.op}({args}){extra} -> {self.out}"


@dataclass(frozen=True)
class InputNode(Node):
    pass


@dataclass(frozen=True)
class Conv2DNode(Node):
    """VALID-padding conv2d + bias (paper C1/C3), weights by reference."""

    w: ParamRef = None
    b: ParamRef | None = None
    stride: tuple[int, int] = (1, 1)
    sharding: ShardingSpec | None = None
    # streaming row-band spec (repro_torch.stream, DESIGN.md §13); None =
    # untiled
    tiling: "SpatialTiling | None" = None

    def describe(self) -> str:
        shard = "" if self.sharding is None else f" shard={self.sharding}"
        tile = "" if self.tiling is None else f" tile={self.tiling}"
        return (f"w={self.w} k={self.w.shape[2]}x{self.w.shape[3]} "
                f"s={self.stride[0]}x{self.stride[1]}"
                + ("" if self.b is None else f" b={self.b}") + shard + tile)


@dataclass(frozen=True)
class ReluNode(Node):
    pass


@dataclass(frozen=True)
class MaxPool2Node(Node):
    """2×2/stride-2 max pool; ``odd`` per core.window.pool_output_size."""

    odd: str = "raise"

    def describe(self) -> str:
        return f"odd={self.odd}"


@dataclass(frozen=True)
class FlattenNode(Node):
    """(B, …) -> (B, prod(…)) — the conv→fc boundary."""


@dataclass(frozen=True)
class DenseNode(Node):
    """x @ w + b through the policy-aware ``repro_torch.ops.dense``."""

    w: ParamRef = None
    b: ParamRef | None = None

    def describe(self) -> str:
        return f"w={self.w}" + ("" if self.b is None else f" b={self.b}")


@dataclass(frozen=True)
class QuantizeNode(Node):
    """An explicit quantization point, inserted by the lowering pass.

    ``kind``: ``qformat`` (snap to the Qm.n lattice), ``int8_conv_weight``
    (per-output-channel int8 of a conv weight) or ``int8_act`` (per-tensor
    int8 of an activation). ``constant`` marks weight quantizations, which
    ``ExecutionPlan.bind`` folds once.
    """

    kind: str = "qformat"
    int_bits: int = 8
    frac_bits: int = 8
    constant: bool = False
    ref: ParamRef | None = None       # set when quantizing a weight directly

    def describe(self) -> str:
        fmt = (f" Q{self.int_bits}.{self.frac_bits}"
               if self.kind == "qformat" else "")
        src = f" ref={self.ref}" if self.ref is not None else ""
        return f"kind={self.kind}{fmt}{src}" + \
            (" const" if self.constant else "")


@dataclass(frozen=True)
class FusedConvBlockNode(Node):
    """conv + bias + relu + 2×2/2 maxpool as ONE stage — the pre-pool
    activation never exists as a whole tensor."""

    _opname = "fused_conv_block"

    w: ParamRef = None
    b: ParamRef | None = None
    stride: tuple[int, int] = (1, 1)
    odd: str = "raise"
    sharding: ShardingSpec | None = None
    # streaming row-band spec in POOLED rows (DESIGN.md §13); None = untiled
    tiling: "SpatialTiling | None" = None

    def describe(self) -> str:
        shard = "" if self.sharding is None else f" shard={self.sharding}"
        tile = "" if self.tiling is None else f" tile={self.tiling}"
        return (f"w={self.w} k={self.w.shape[2]}x{self.w.shape[3]} "
                f"s={self.stride[0]}x{self.stride[1]} odd={self.odd}"
                + shard + tile)


@dataclass(frozen=True)
class Graph:
    """An ordered (topological) operator graph with one input and one
    output. Passes are Graph -> Graph; nodes are immutable."""

    nodes: tuple[Node, ...]
    input_id: int = 0
    output_id: int = 0

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def node(self, nid: int) -> Node:
        for n in self.nodes:
            if n.id == nid:
                return n
        raise KeyError(f"no node %{nid} in graph")

    def consumers(self, nid: int) -> list[Node]:
        return [n for n in self.nodes if nid in n.inputs]

    def ops(self) -> list[str]:
        return [n.op for n in self.nodes]

    def next_id(self) -> int:
        return max(n.id for n in self.nodes) + 1

    def validate(self) -> "Graph":
        """Check topological order, id uniqueness, input/output wiring."""
        seen: set[int] = set()
        for n in self.nodes:
            if n.id in seen:
                raise ValueError(f"duplicate node id %{n.id}")
            for i in n.inputs:
                if i not in seen:
                    raise ValueError(
                        f"%{n.id} ({n.op}) consumes %{i} before definition")
            seen.add(n.id)
        if self.input_id not in seen or self.output_id not in seen:
            raise ValueError("input/output id not in graph")
        return self

    def pretty(self) -> str:
        return "\n".join(n.pretty() for n in self.nodes)

    def replace_input(self, old: int, new: int) -> "Graph":
        """Rewire every consumer of %old to read %new."""
        nodes = tuple(
            replace(n, inputs=tuple(new if i == old else i
                                    for i in n.inputs))
            for n in self.nodes)
        out = new if self.output_id == old else self.output_id
        return replace(self, nodes=nodes, output_id=out)
