"""Graph IR ↔ JSON codec for plan artifacts (DESIGN.md §12).

Port of ``repro.artifact.ir_codec``. The artifact store persists a
*compiled* graph — fusion, quantization lowering, the channel-parallel
placement and the streaming tilings already applied — so a replica reconstructs its
``ExecutionPlan`` by decoding nodes, never by re-running trace or the
pass pipeline. The encoding is canonical (sorted keys, no float
formatting, ids kept verbatim), so the same document doubles as the
fingerprint payload: two plans hash equal iff their decoded graphs are
equal (``Graph`` is a frozen dataclass, so equality is structural).

Every node type carries exactly its dataclass fields; an unknown ``op``
on decode raises ``ValueError``, which the store maps to the
schema-mismatch arm of the fallback ladder. A conv stage's
``ShardingSpec`` encodes as its four fields, so a port document equals
the reference's node for node.
"""
from __future__ import annotations

from repro_torch.graph.ir import (Conv2DNode, DenseNode, FlattenNode,
                                  FusedConvBlockNode, Graph, InputNode,
                                  MaxPool2Node, ParamRef, QuantizeNode,
                                  ReluNode, ShardingSpec, TensorSpec)
from repro_torch.stream.tiling import tiling_from_doc, tiling_to_doc

__all__ = ["graph_to_doc", "graph_from_doc"]

_NODE_TYPES = {
    "input": InputNode,
    "conv2d": Conv2DNode,
    "relu": ReluNode,
    "maxpool2": MaxPool2Node,
    "flatten": FlattenNode,
    "dense": DenseNode,
    "quantize": QuantizeNode,
    "fused_conv_block": FusedConvBlockNode,
}


def _spec_doc(spec: TensorSpec) -> dict:
    return {"shape": list(spec.shape), "dtype": spec.dtype}


def _spec_from(doc: dict) -> TensorSpec:
    return TensorSpec(shape=tuple(doc["shape"]), dtype=doc["dtype"])


def _ref_doc(ref: ParamRef | None) -> dict | None:
    if ref is None:
        return None
    return {"path": list(ref.path), "shape": list(ref.shape),
            "dtype": ref.dtype}


def _ref_from(doc: dict | None) -> ParamRef | None:
    if doc is None:
        return None
    return ParamRef(path=tuple(doc["path"]), shape=tuple(doc["shape"]),
                    dtype=doc["dtype"])


def _shard_doc(spec: ShardingSpec | None) -> dict | None:
    if spec is None:
        return None
    return {"mode": spec.mode, "data": bool(spec.data),
            "icp": int(spec.icp), "ocp": int(spec.ocp)}


def _shard_from(doc: dict | None) -> ShardingSpec | None:
    if doc is None:
        return None
    # icp/ocp absent: 0 = derive the split from mode
    return ShardingSpec(mode=doc["mode"], data=bool(doc["data"]),
                        icp=int(doc.get("icp", 0)),
                        ocp=int(doc.get("ocp", 0)))


def _node_doc(node) -> dict:
    doc = {"op": node.op, "id": int(node.id),
           "inputs": [int(i) for i in node.inputs],
           "out": _spec_doc(node.out)}
    if isinstance(node, (Conv2DNode, FusedConvBlockNode)):
        doc.update(w=_ref_doc(node.w), b=_ref_doc(node.b),
                   stride=list(node.stride),
                   sharding=_shard_doc(node.sharding),
                   tiling=tiling_to_doc(node.tiling))
        if isinstance(node, FusedConvBlockNode):
            doc["odd"] = node.odd
    elif isinstance(node, MaxPool2Node):
        doc["odd"] = node.odd
    elif isinstance(node, DenseNode):
        doc.update(w=_ref_doc(node.w), b=_ref_doc(node.b))
    elif isinstance(node, QuantizeNode):
        doc.update(kind=node.kind, int_bits=int(node.int_bits),
                   frac_bits=int(node.frac_bits),
                   constant=bool(node.constant), ref=_ref_doc(node.ref))
    return doc


def _node_from(doc: dict):
    cls = _NODE_TYPES.get(doc.get("op"))
    if cls is None:
        raise ValueError(f"unknown graph node op {doc.get('op')!r} "
                         f"(artifact written by a newer build?)")
    kw = dict(id=int(doc["id"]), inputs=tuple(doc["inputs"]),
              out=_spec_from(doc["out"]))
    if cls in (Conv2DNode, FusedConvBlockNode):
        kw.update(w=_ref_from(doc["w"]), b=_ref_from(doc["b"]),
                  stride=tuple(doc["stride"]),
                  sharding=_shard_from(doc.get("sharding")),
                  tiling=tiling_from_doc(doc.get("tiling")))
        if cls is FusedConvBlockNode:
            kw["odd"] = doc["odd"]
    elif cls is MaxPool2Node:
        kw["odd"] = doc["odd"]
    elif cls is DenseNode:
        kw.update(w=_ref_from(doc["w"]), b=_ref_from(doc["b"]))
    elif cls is QuantizeNode:
        kw.update(kind=doc["kind"], int_bits=int(doc["int_bits"]),
                  frac_bits=int(doc["frac_bits"]),
                  constant=bool(doc["constant"]),
                  ref=_ref_from(doc.get("ref")))
    return cls(**kw)


def graph_to_doc(graph: Graph) -> dict:
    """Canonical JSON-able document for a (possibly lowered/streamed)
    graph."""
    return {"input_id": int(graph.input_id),
            "output_id": int(graph.output_id),
            "nodes": [_node_doc(n) for n in graph]}


def graph_from_doc(doc: dict) -> Graph:
    """Decode and re-validate; raises ``ValueError``/``KeyError`` on any
    structural problem (callers map that to the fallback ladder)."""
    return Graph(nodes=tuple(_node_from(n) for n in doc["nodes"]),
                 input_id=int(doc["input_id"]),
                 output_id=int(doc["output_id"])).validate()
