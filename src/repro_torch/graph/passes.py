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

``place_channel_parallel`` is the mesh placement (DESIGN.md §9/§15): it
stamps a ``ShardingSpec`` on every conv stage, an icp × ocp split of the
mesh's ``model`` axis chosen per stage by the ``_split_cost``
arithmetic-intensity model, or the split an ``ExecPolicy.channel_parallel``
override forces. ``tunable_stages`` leaves the channel-sharded stages out
of bind-time autotuning.
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.core.quantize import QFormat
from repro_torch.graph.ir import (Conv2DNode, DenseNode, FlattenNode,
                                  FusedConvBlockNode, Graph, MaxPool2Node,
                                  Node, QuantizeNode, ReluNode, ShardingSpec,
                                  TensorSpec)

__all__ = ["fuse_conv_blocks", "lower_quant", "eliminate_dead_quantize",
           "place_channel_parallel", "stage_arith_intensity",
           "tunable_stages", "stage_input_spec", "default_passes"]


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


# Modeled fixed cost of one ring hop (collective launch + sync), in
# element-traffic units so it adds directly to the byte terms of
# ``_split_cost``: it makes the model prefer a short ring over a long one
# when the per-hop payload is small. The reference's constant, kept as it
# is so both packages place every stage alike.
_HOP_OVERHEAD = 4096.0


def _split_cost(m: int, n: int, kh: int, kw: int, ho: int, wo: int,
                ki: int, ko: int) -> float:
    """Per-rank cost model of an (icp=ki, ocp=ko) channel split, in
    element units: compute (M/ko)·(N/ki)·Kh·Kw·Ho·Wo MACs, the window
    stream (N/ki)·Kh·Kw·Ho·Wo each rank reads (only ICP shrinks it: OCP
    replicates x), and the ICP ring, ki−1 hops of the (M/ko)·Ho·Wo
    partial plus a fixed per-hop overhead."""
    spatial = ho * wo
    compute = (m / ko) * (n / ki) * kh * kw * spatial
    window = (n / ki) * kh * kw * spatial
    reduce_ = (ki - 1) * ((m / ko) * spatial + _HOP_OVERHEAD)
    return compute + window + reduce_


def _pick_split(m: int, n: int, kh: int, kw: int, ho: int, wo: int,
                model_size: int) -> tuple[int, int]:
    """The feasible (ki | N, ko | M, ki·ko = mesh) split of least modeled
    cost. ``(1, 1)``, pure data parallelism, is always feasible, so auto
    placement never produces an invalid plan."""
    best, best_cost = (1, 1), _split_cost(m, n, kh, kw, ho, wo, 1, 1)
    for ki in range(1, model_size + 1):
        if model_size % ki:
            continue
        ko = model_size // ki
        if n % ki or m % ko:
            continue
        cost = _split_cost(m, n, kh, kw, ho, wo, ki, ko)
        if cost < best_cost:
            best, best_cost = (ki, ko), cost
    return best


def _split_mode(ki: int, ko: int) -> str:
    if ki > 1 and ko > 1:
        return "both"
    if ki > 1:
        return "input"
    if ko > 1:
        return "output"
    return "none"


def _conv_hw(graph: Graph, node: Node) -> tuple[int, int]:
    """The stage's PRE-pool conv output extent (the reduce buffer size: a
    fused block's ``out`` is already pooled)."""
    h, w = stage_input_spec(graph, node).shape[2:]
    kh, kw = node.w.shape[2], node.w.shape[3]
    sh, sw = node.stride
    return (h - kh) // sh + 1, (w - kw) // sw + 1


def stage_arith_intensity(graph: Graph) -> list[dict]:
    """Per-conv-stage arithmetic intensity (MACs per element moved) and
    the placement the cost model derived from it."""
    out = []
    for node in graph:
        if not isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            continue
        m, n = node.w.shape[0], node.w.shape[1]
        kh, kw = node.w.shape[2], node.w.shape[3]
        ho, wo = _conv_hw(graph, node)
        macs = m * n * kh * kw * ho * wo
        moved = n * ho * wo * kh * kw + m * n * kh * kw + m * ho * wo
        spec = node.sharding
        out.append({
            "node": node.id, "op": node.op,
            "m": m, "n": n, "k": [kh, kw], "conv_hw": [ho, wo],
            "macs": macs, "elements_moved": moved,
            "intensity": round(macs / moved, 3),
            "placement": None if spec is None else str(spec),
        })
    return out


def place_channel_parallel(graph: Graph, model_size: int, *,
                           override: str | None = None,
                           data: bool = True) -> Graph:
    """Attach a ``ShardingSpec`` to every conv / fused-conv stage.

    ``model_size`` is the mesh's ``model``-axis extent. Auto placement
    factors it per stage into the icp × ocp split ``_pick_split`` finds
    cheapest: pure ICP, pure OCP, a 2-D split, or pure data parallelism
    when no channel dim divides. ``override`` ("input" | "output" |
    "none") forces the whole axis onto one 1-D schedule; a stage whose
    channels the forced schedule cannot shard stays replicated, never
    silently the other schedule. An override that applies to no stage
    raises. ``data`` opts the batch into ``data``-axis sharding.
    """
    placed: list[Node] = []
    forced_hits = 0
    conv_stages = 0
    for node in graph:
        if not isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            placed.append(node)
            continue
        conv_stages += 1
        m, n = node.w.shape[0], node.w.shape[1]
        if override is None:
            ho, wo = _conv_hw(graph, node)
            ki, ko = _pick_split(m, n, node.w.shape[2], node.w.shape[3],
                                 ho, wo, model_size)
            mode = _split_mode(ki, ko)
        else:
            dim = m if override == "output" else n
            mode = override if (override == "none"
                                or dim % model_size == 0) else "none"
            forced_hits += mode == override != "none"
            ki, ko = ((model_size, 1) if mode == "input" else
                      (1, model_size) if mode == "output" else (1, 1))
        placed.append(replace(node, sharding=ShardingSpec(
            mode=mode, data=data,
            icp=ki if mode != "none" else 0,
            ocp=ko if mode != "none" else 0)))
    if override not in (None, "none") and conv_stages and not forced_hits:
        raise ValueError(
            f"channel_parallel={override!r} applies to none of the "
            f"{conv_stages} conv stages: no layer's "
            f"{'M' if override == 'output' else 'N'} divides the model "
            f"axis ({model_size} devices); use divisible channel counts "
            f"or drop the override for per-layer auto-placement")
    return replace(graph, nodes=tuple(placed)).validate()


def tunable_stages(graph: Graph) -> list[Node]:
    """The stages bind-time autotuning sizes: conv, fused conv block and
    dense nodes, in execution order. Channel-sharded stages are left out,
    as in the reference: their per-rank shapes are the shard's."""
    out = []
    for node in graph:
        if isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            spec = node.sharding
            if spec is None or spec.mode == "none":
                out.append(node)
        elif isinstance(node, DenseNode):
            out.append(node)
    return out


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
