"""Graph passes: fusion, quantization lowering, dead-quantize elimination.

Port of ``repro.graph.passes`` (DESIGN.md §8), single device:

  1. ``fuse_conv_blocks`` — every single-consumer Conv2D → Relu → MaxPool2
     chain collapses into one ``FusedConvBlockNode``, run by the
     ``fused_conv_block`` op family (the ``fused_cwp`` kernel on the card).
  2. ``lower_quant`` — the plan's quantization as explicit QuantizeNodes:
     constant (foldable) weight quantizes, per-edge activation quantizes,
     and the post-accumulate lattice snap under ``qformat``.
  3. ``eliminate_dead_quantize`` — drops activation snaps whose producer
     chain is provably already on the lattice.

``stage_input_spec`` gives a stage's float-level input spec, which the
streaming placement pass (``repro_torch.stream.passes``) sizes bands by.
The channel-parallel placement pass waits for ROADMAP §A.10.
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.core.quantize import QFormat
from repro_torch.graph.ir import (Conv2DNode, FlattenNode,
                                  FusedConvBlockNode, Graph, MaxPool2Node,
                                  Node, QuantizeNode, ReluNode, TensorSpec)

__all__ = ["fuse_conv_blocks", "lower_quant", "eliminate_dead_quantize",
           "stage_input_spec", "default_passes"]


def _single_consumer(graph: Graph, nid: int) -> Node | None:
    cons = graph.consumers(nid)
    return cons[0] if len(cons) == 1 and graph.output_id != nid else None


def fuse_conv_blocks(graph: Graph) -> Graph:
    """Conv2D → Relu → MaxPool2 (linear, single-consumer) ⇒ one
    FusedConvBlockNode carrying the pool's id."""
    fused: list[Node] = []
    skip: set[int] = set()
    for node in graph:
        if node.id in skip:
            continue
        if isinstance(node, Conv2DNode):
            r = _single_consumer(graph, node.id)
            if isinstance(r, ReluNode):
                p = _single_consumer(graph, r.id)
                if isinstance(p, MaxPool2Node):
                    fused.append(FusedConvBlockNode(
                        id=p.id, inputs=node.inputs, out=p.out,
                        w=node.w, b=node.b, stride=node.stride, odd=p.odd))
                    skip.update({r.id, p.id})
                    continue
        fused.append(node)
    return replace(graph, nodes=tuple(fused)).validate()


def _quantize_node(nid: int, src: int, spec: TensorSpec, kind: str,
                   q: QFormat, constant: bool = False,
                   ref=None) -> QuantizeNode:
    return QuantizeNode(id=nid, inputs=(src,), out=spec, kind=kind,
                        int_bits=q.int_bits, frac_bits=q.frac_bits,
                        constant=constant, ref=ref)


def lower_quant(graph: Graph, quant: str,
                qformat: QFormat | None = None) -> Graph:
    """Insert explicit QuantizeNodes per ``quant`` mode — what
    ``ops.conv2d`` / ``fused_conv_block`` do internally, as graph
    structure."""
    if quant == "none":
        return graph
    if quant not in ("qformat", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    q = qformat or QFormat()
    nodes: list[Node] = []
    nid = graph.next_id()
    rewired: dict[int, int] = {}      # producer id -> quantized-value id

    def _wref(w, kind):
        nonlocal nid
        node = replace(_quantize_node(nid, -1, TensorSpec(w.shape, w.dtype),
                                      kind, q, constant=True, ref=w),
                       inputs=())
        nodes.append(node)
        nid += 1
        return node.id

    for node in graph:
        inputs = tuple(rewired.get(i, i) for i in node.inputs)
        if isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            act_kind = "qformat" if quant == "qformat" else "int8_act"
            aq = _quantize_node(nid, inputs[0],
                                graph.node(node.inputs[0]).out, act_kind, q)
            nodes.append(aq)
            nid += 1
            wkind = "qformat" if quant == "qformat" else "int8_conv_weight"
            wq = _wref(node.w, wkind)
            bq = None
            if node.b is not None and quant == "qformat":
                bq = _wref(node.b, "qformat")
            nodes.append(replace(node, inputs=(aq.id, wq) +
                                 (() if bq is None else (bq,))))
            if quant == "qformat":
                oq = _quantize_node(nid, node.id, node.out, "qformat", q)
                nodes.append(oq)
                nid += 1
                rewired[node.id] = oq.id
        else:
            nodes.append(replace(node, inputs=inputs))
    out = rewired.get(graph.output_id, graph.output_id)
    return replace(graph, nodes=tuple(nodes), output_id=out).validate()


def _lattice_valued(graph: Graph, nid: int, q: QuantizeNode) -> bool:
    """True if %nid provably lies on q's Qm.n lattice."""
    node = graph.node(nid)
    if isinstance(node, QuantizeNode):
        return (node.kind == "qformat" and node.int_bits == q.int_bits
                and node.frac_bits == q.frac_bits)
    if isinstance(node, (ReluNode, MaxPool2Node, FlattenNode)):
        return _lattice_valued(graph, node.inputs[0], q)
    return False


def eliminate_dead_quantize(graph: Graph) -> Graph:
    """Remove idempotent activation quantizes (qformat over lattice
    values). Weight and int8 activation quantizes are never dead."""
    changed = True
    while changed:
        changed = False
        for node in graph:
            if (isinstance(node, QuantizeNode) and not node.constant
                    and node.kind == "qformat" and node.inputs
                    and _lattice_valued(graph, node.inputs[0], node)):
                graph = replace(
                    graph, nodes=tuple(n for n in graph if n.id != node.id))
                graph = graph.replace_input(node.id, node.inputs[0])
                changed = True
                break
    return graph.validate()


def stage_input_spec(graph: Graph, node: Node) -> TensorSpec:
    """The *float-level* activation spec feeding ``node``: quantize nodes
    are transparent (an int8_act QuantizeNode re-emits its input's spec —
    the executed QTensor's codes keep that shape, and the kernels contract
    codes as float32)."""
    src = graph.node(node.inputs[0])
    while isinstance(src, QuantizeNode) and src.inputs:
        src = graph.node(src.inputs[0])
    return src.out


def default_passes(graph: Graph, quant: str = "none",
                   qformat: QFormat | None = None,
                   fuse: bool = True) -> Graph:
    """The standard pipeline: fuse → lower quant → DQE."""
    if fuse:
        graph = fuse_conv_blocks(graph)
    graph = lower_quant(graph, quant, qformat)
    return eliminate_dead_quantize(graph)
