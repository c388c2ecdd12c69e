"""Tracer: lift a core.conv-based model into the repro_torch.graph IR.

Port of ``repro.graph.trace``. ``trace(model, input_shape)`` runs the
model's ``forward`` once with a ``TracedArray`` in place of the image
batch and a params dict of ``ParamRef`` leaves. The shapes come from the
model's own parameters, initialised on PyTorch's ``meta`` device, so no
weights are materialised. The functional layer is duck-type hooked:
``core.conv.conv2d_apply`` and ``core.window.maxpool2`` check for
``graph_*`` methods, and ``relu`` / ``flatten`` / ``dense`` below record
nodes for a ``TracedArray`` and compute for a real tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from repro_torch.core.window import conv_output_size, pool_output_size
from repro_torch.graph.ir import (Conv2DNode, DenseNode, FlattenNode, Graph,
                                  InputNode, MaxPool2Node, Node, ParamRef,
                                  ReluNode, TensorSpec)

__all__ = ["TracedArray", "GraphBuilder", "param_refs", "trace",
           "relu", "flatten", "dense"]


@dataclass
class GraphBuilder:
    """Accumulates nodes in creation (= topological) order."""

    nodes: list[Node] = field(default_factory=list)

    def add(self, cls, inputs: tuple[int, ...], out: TensorSpec,
            **attrs) -> "TracedArray":
        node = cls(id=len(self.nodes), inputs=inputs, out=out, **attrs)
        self.nodes.append(node)
        return TracedArray(self, node.id, out)

    def input(self, spec: TensorSpec) -> "TracedArray":
        return self.add(InputNode, (), spec)

    def finish(self, output: "TracedArray") -> Graph:
        return Graph(nodes=tuple(self.nodes), input_id=0,
                     output_id=output.node_id).validate()


@dataclass
class TracedArray:
    """The symbolic value flowing through ``forward`` during tracing."""

    builder: GraphBuilder
    node_id: int
    spec: TensorSpec

    @property
    def shape(self) -> tuple[int, ...]:
        return self.spec.shape

    @property
    def ndim(self) -> int:
        return len(self.spec.shape)

    @property
    def dtype(self) -> str:
        return self.spec.dtype

    def _emit(self, cls, out_shape: tuple[int, ...], **attrs):
        return self.builder.add(cls, (self.node_id,),
                                TensorSpec(tuple(out_shape), self.dtype),
                                **attrs)

    def graph_conv2d(self, params: dict, cfg) -> "TracedArray":
        w: ParamRef = params["w"]
        b: ParamRef | None = params.get("b")
        bsz, n, h, wd = self.shape
        m, n2, kh, kw = w.shape
        if n != n2:
            raise ValueError(f"conv2d: input has {n} channels, weight "
                             f"{w} expects {n2}")
        ho = conv_output_size(h, kh, cfg.stride[0])
        wo = conv_output_size(wd, kw, cfg.stride[1])
        return self._emit(Conv2DNode, (bsz, m, ho, wo), w=w, b=b,
                          stride=tuple(cfg.stride))

    def graph_maxpool2(self, *, odd: str = "raise") -> "TracedArray":
        bsz, c, h, w = self.shape
        out = (bsz, c, pool_output_size(h, odd), pool_output_size(w, odd))
        return self._emit(MaxPool2Node, out, odd=odd)

    def graph_relu(self) -> "TracedArray":
        return self._emit(ReluNode, self.shape)

    def graph_flatten(self) -> "TracedArray":
        return self._emit(FlattenNode,
                          (self.shape[0], math.prod(self.shape[1:])))

    def graph_dense(self, w: ParamRef,
                    b: ParamRef | None = None) -> "TracedArray":
        k, n = w.shape
        if self.shape[-1] != k:
            raise ValueError(f"dense: input dim {self.shape[-1]} vs "
                             f"weight {w} dim {k}")
        return self._emit(DenseNode, (*self.shape[:-1], n), w=w, b=b)


# ------------------------------------------------------ functional layer

def relu(x):
    """``torch.relu``, or a Relu node when tracing."""
    hook = getattr(x, "graph_relu", None)
    return hook() if hook is not None else torch.relu(x)


def flatten(x):
    """(B, …) -> (B, -1), or a Flatten node when tracing."""
    hook = getattr(x, "graph_flatten", None)
    return hook() if hook is not None else x.reshape(x.shape[0], -1)


def dense(x, w, b=None, *, policy=None):
    """Policy-aware dense (repro_torch.ops.dense), or a Dense node when
    tracing."""
    hook = getattr(x, "graph_dense", None)
    if hook is not None:
        return hook(w, b)
    from repro_torch.ops import dense as op
    return op(x, w, b, policy=policy)


# ---------------------------------------------------------------- trace

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def param_refs(model) -> dict:
    """The model's params dict with every leaf replaced by a ParamRef,
    from parameters initialised on the ``meta`` device (shapes only)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return ParamRef(path=path, shape=tuple(tree.shape),
                        dtype=_dtype_name(tree.dtype))
    return walk(model.init(device="meta"), ())


def trace(model, input_shape: tuple[int, ...],
          dtype: str = "float32") -> Graph:
    """Lift ``model.forward`` into a Graph; the traced batch dim is
    informational — execution is batch-polymorphic."""
    builder = GraphBuilder()
    x = builder.input(TensorSpec(tuple(input_shape), dtype))
    out = model.forward(param_refs(model), x)
    if not isinstance(out, TracedArray):
        raise TypeError(
            f"{type(model).__name__}.forward returned {type(out).__name__} "
            f"under tracing — its ops must route through the hooked "
            f"functional layer (conv2d_apply, maxpool2, relu, flatten, "
            f"dense)")
    return builder.finish(out)
