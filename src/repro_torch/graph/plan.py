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
launch a band on the card.

As in the reference:

  * ``verify=True`` (the default of ``compile_model`` and ``bind``) runs
    the static plan verifier (``repro_torch.analysis``, DESIGN.md §14);
  * ``autotune=True`` makes ``bind`` measure launch shapes per stage on
    the card (``repro_torch.ops.autotune``; tuning-cache hits skip the
    measurement) and bake the winners into the BoundPlan as per-stage
    tiling overrides, so serving never re-tunes (DESIGN.md §10);
  * ``BoundPlan.save`` / ``.load`` persist a bound plan as a versioned
    artifact (``repro_torch.artifact``, DESIGN.md §12).

Compiling with ``mesh=`` (a ``DeviceMesh`` with a ``model`` axis and
optionally a ``data`` axis, ``repro_torch.launch.mesh``) makes the plan
**sharded** (DESIGN.md §9/§15): the placement pass stamps a
``ShardingSpec`` on every conv stage, and every rank runs the plan
(SPMD). The rank takes its data-axis slice of the batch on entry
(``_scatter``), runs each placed stage's shard through the per-shard
schedules of ``repro_torch.core.parallelism`` (the conv kernels at the
shard's shapes, the icp ring between them), keeps channel-sharded
activations sharded until a stage needs other channels, all-gathers the
model axis at the conv→fc boundary (``_gather``) and the data axis at
the end, so the call returns the whole batch's output on every rank.
``bind`` keeps on each rank only its (M/ocp, N/icp) block of every
placed stage's weight, bias and requant scale.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.artifact.warmup import phase
from repro_torch.core.quantize import QFormat, QTensor, quantize_int8
from repro_torch.core.window import maxpool2
from repro_torch.graph.ir import (Conv2DNode, DenseNode, FlattenNode,
                                  FusedConvBlockNode, Graph, InputNode,
                                  MaxPool2Node, QuantizeNode, ReluNode)
from repro_torch.graph.passes import (default_passes,
                                      place_channel_parallel,
                                      stage_input_spec, tunable_stages)
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
    mesh: object | None = None
    # measured launch shapes at bind time (DESIGN.md §10)
    autotune: bool = False
    # {node id: StageGrid} of the placed stages, built with the plan on
    # every rank in graph order (building one may create process groups)
    grids: dict = field(default=None, init=False, compare=False,
                        repr=False)

    def __post_init__(self):
        from torch.distributed.device_mesh import DeviceMesh
        grids = {}
        # a mesh that is only a shape (the verifier's tests) places nothing
        if isinstance(self.mesh, DeviceMesh):
            from repro_torch.core.parallelism import (ChannelParallelism,
                                                      axis_size, stage_grid)
            msize = axis_size(self.mesh, "model")
            for node in self.graph:
                spec = getattr(node, "sharding", None)
                if spec is not None and spec.mode != "none":
                    ki, ko = spec.split(msize)
                    grids[node.id] = stage_grid(
                        self.mesh, ChannelParallelism(spec.mode), ki, ko)
        object.__setattr__(self, "grids", grids)

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
        # stages run quant-free (quantization is graph structure) and
        # never tune while they run: bind measured and baked the tiles
        return pol.with_options(quant="none", autotune=False)

    @staticmethod
    def _stage_policy(base: ExecPolicy, tiles: dict | None) -> ExecPolicy:
        """The per-stage policy: baked (bind-time autotuned) tiles ride as
        namespaced tiling overrides, which win over the tuning cache and
        the heuristics."""
        if not tiles:
            return base
        return base.with_options(tiling={**base.tile_overrides, **tiles})

    def __call__(self, params, x, *, policy: ExecPolicy | None = None,
                 _folded: dict | None = None, _placed: dict | None = None,
                 _tuned: dict | None = None):
        from repro_torch.ops import conv2d, dense, fused_conv_block, qdense
        from repro_torch.stream.executor import (stream_conv2d,
                                                 stream_fused_conv_block)
        base = self._base_policy(policy)
        dense_pol = base.with_options(quant=self.quant, qformat=self.qformat)
        env: dict[int, object] = {}
        # {node id: (ko, ki)} of activations held channel-sharded over the
        # model axis (see core.parallelism.gather_channels); absent = whole
        layout: dict[int, tuple[int, int]] = {}
        folded = _folded or {}
        # a bound plan's placed stages hold this rank's blocks already
        blocked = _placed is not None
        placed = _placed or {}
        tuned = _tuned or {}

        def _weight(node, idx, attr):
            """Weight operand: this rank's block, pre-placed by a mesh
            ``bind``; else through the lowered graph's quantize node
            (possibly pre-folded); else read from the ParamRef."""
            if (node.id, attr) in placed:
                return placed[(node.id, attr)]
            if len(node.inputs) > idx:
                return env[node.inputs[idx]]
            ref = getattr(node, attr)
            return None if ref is None else ref.fetch(params)

        def _whole(nid):
            """%nid with every channel (gathered over the model axis)."""
            v = env[nid]
            if nid not in layout:
                return v
            return self._gather_channels(v, layout[nid])

        batch = x.shape[0]
        x, batch_rows = self._scatter(x)
        for node in self.graph:
            if isinstance(node, InputNode):
                env[node.id] = x
            elif isinstance(node, QuantizeNode):
                if node.id in folded:
                    env[node.id] = folded[node.id]
                    continue
                if node.constant:
                    val = node.ref.fetch(params)
                else:
                    val = env[node.inputs[0]]
                    if node.inputs[0] in layout:
                        layout[node.id] = layout[node.inputs[0]]
                if (node.kind == "int8_act" and self.mesh is not None
                        and (node.id in layout or batch_rows is not None)):
                    # one scale over the whole batch and every channel,
                    # as the unsharded plan computes it
                    from repro_torch.core.parallelism import all_reduce_max
                    amax = all_reduce_max(
                        val.to(torch.float32).abs().amax(), self.mesh)
                    env[node.id] = quantize_int8(val, axis=None, amax=amax)
                else:
                    env[node.id] = _apply_quantize(node, val, self.qformat)
            elif node.id in self.grids:
                env[node.id] = self._sharded_stage(
                    node, env, layout, _weight, blocked, base, batch=batch)
                out_layout = self.grids[node.id].out_layout
                if out_layout is not None:
                    layout[node.id] = out_layout
            elif isinstance(node, FusedConvBlockNode):
                args = (_whole(node.inputs[0]), _weight(node, 1, "w"),
                        _weight(node, 2, "b"))
                pol = self._stage_policy(base, tuned.get(node.id))
                if node.tiling is not None:
                    # over-budget stage: halo-overlapped row bands
                    env[node.id] = stream_fused_conv_block(
                        *args, stride=node.stride, odd=node.odd,
                        tiling=node.tiling, policy=pol)
                else:
                    env[node.id] = fused_conv_block(
                        *args, stride=node.stride, odd=node.odd,
                        policy=pol)
            elif isinstance(node, Conv2DNode):
                args = (_whole(node.inputs[0]), _weight(node, 1, "w"),
                        _weight(node, 2, "b"))
                pol = self._stage_policy(base, tuned.get(node.id))
                if node.tiling is not None:
                    env[node.id] = stream_conv2d(
                        *args, stride=node.stride, tiling=node.tiling,
                        policy=pol)
                else:
                    env[node.id] = conv2d(*args, stride=node.stride,
                                          policy=pol)
            elif isinstance(node, (ReluNode, MaxPool2Node)):
                v = env[node.inputs[0]]
                env[node.id] = (torch.relu(v) if isinstance(node, ReluNode)
                                else maxpool2(v, odd=node.odd))
                if node.inputs[0] in layout:
                    layout[node.id] = layout[node.inputs[0]]
            elif isinstance(node, FlattenNode):
                v = _whole(node.inputs[0])        # the conv→fc gather
                env[node.id] = v.reshape(v.shape[0], -1)
            elif isinstance(node, DenseNode):
                wq = folded.get(node.id)
                if wq is not None:
                    # bind pre-quantized this dense weight: the int8
                    # datapath directly (== ops.dense under int8)
                    out = qdense(env[node.inputs[0]], wq,
                                 policy=self._stage_policy(
                                     base, tuned.get(node.id)))
                    b = _weight(node, 2, "b")
                    env[node.id] = out if b is None else out + b
                else:
                    env[node.id] = dense(
                        env[node.inputs[0]], _weight(node, 1, "w"),
                        _weight(node, 2, "b"), policy=dense_pol)
            else:
                raise TypeError(f"no executor for node {node.pretty()}")
        out = _whole(self.graph.output_id)
        if batch_rows is not None:
            from repro_torch.core.parallelism import gather_batch
            out = gather_batch(out, self.mesh)
        return out

    # ---------- the mesh ----------
    def _scatter(self, x):
        """This rank's data-axis slice of the batch, with its (start,
        stop) rows, or the whole batch and None: off a mesh, without a
        data axis, or when the batch does not divide it (it then stays
        replicated, as in the reference). The rule is
        ``core.parallelism.batch_shard``'s alone; the engine's bucket
        ladder keeps the buckets it slices."""
        if self.mesh is None:
            return x, None
        from repro_torch.core.parallelism import batch_shard
        rows = batch_shard(self.mesh, x.shape[0])
        return (x, None) if rows is None else (x[rows[0]:rows[1]], rows)

    def _gather_channels(self, v, layout):
        """All-gather a channel-sharded value over the model axis only
        (the batch keeps its data-axis slice): a tensor, or an int8
        activation's codes (its per-tensor scale is already global)."""
        from repro_torch.core.parallelism import gather_channels
        if isinstance(v, QTensor):
            return QTensor(gather_channels(v.codes, self.mesh, layout),
                           v.scale)
        return gather_channels(v, self.mesh, layout)

    def _stage_input(self, nid, env, layout, grid, n: int):
        """The input channels a placed stage reads on this rank: block
        ``i`` of ``ki`` of the N channels (all of them under OCP), sliced
        from what the rank holds when every rank's shard holds its block,
        else from the all-gathered value. The choice depends on the
        layouts alone, so every rank of the group makes it alike (a
        gather one rank skips would hang the others)."""
        v = env[nid]
        lo, hi = _needed(grid, grid.o * grid.ki + grid.i, n)
        if nid in layout:
            held = layout[nid]
            size = grid.ki * grid.ko
            if all(_held(held, r, n)[0] <= _needed(grid, r, n)[0]
                   and _needed(grid, r, n)[1] <= _held(held, r, n)[1]
                   for r in range(size)):
                a = _held(held, grid.o * grid.ki + grid.i, n)[0]
                return _channel_slice(v, lo - a, hi - a)
            v = self._gather_channels(v, held)
        return _channel_slice(v, lo, hi)

    def _sharded_stage(self, node, env, layout, weight, blocked, base, *,
                       batch: int):
        """One placed conv stage on this rank: its input channels, its
        weight block (placed by ``bind`` when ``blocked``, else sliced
        now), then the per-shard schedule of ``core.parallelism``.
        ``batch`` is the whole batch's size, which a data-sharded stage
        must split."""
        from repro_torch.core.parallelism import (axis_size, conv2d_shard,
                                                  fused_conv_block_shard)
        from repro_torch.ops.impls import split_int8
        spec, grid = node.sharding, self.grids[node.id]
        dsize = axis_size(self.mesh, "data")
        if spec.data and batch % dsize:
            raise ValueError(
                f"batch {batch} does not divide the 'data' axis ({dsize} "
                f"devices); pad the batch or pass data_axis=None to "
                f"replicate it")
        xin = self._stage_input(node.inputs[0], env, layout, grid,
                                node.w.shape[1])
        wv, bv = weight(node, 1, "w"), weight(node, 2, "b")
        if not blocked:
            wv, bv = _w_block(wv, grid), grid.v_block(bv)
        x_arr, w_arr, scale = split_int8(xin, wv)
        if isinstance(node, FusedConvBlockNode):
            return fused_conv_block_shard(x_arr, w_arr, bv, scale, grid=grid,
                                          stride=node.stride, odd=node.odd,
                                          policy=base)
        return conv2d_shard(x_arr, w_arr, bv, scale, grid=grid,
                            stride=node.stride, policy=base)

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

    def _stage_calls(self, params, folded: dict):
        """Yield (node, op, args, kwargs) for every tunable stage: the
        concrete call the autotuner measures, with a representative
        activation from the graph's static specs (seeded, on the params'
        device) and the real bound weights (int8 stages get the
        activation's and the weights' int8 codes plus the requant scale
        operand, as the served stage hands them to the kernels' int8
        route)."""
        from repro_torch.ops.impls import split_int8
        dev = _params_device(params)
        rng = np.random.RandomState(0)
        for node in tunable_stages(self.graph):
            spec = stage_input_spec(self.graph, node)
            x = torch.from_numpy(rng.standard_normal(spec.shape).astype(
                np.float32)).to(dev)
            if isinstance(node, DenseNode):
                wq = folded.get(node.id)
                if wq is None:          # fp dense is a plain matmul —
                    continue            # nothing to tune
                xq = quantize_int8(x.reshape(x.shape[0], -1), axis=-1)
                yield node, "qmatmul", (xq.codes, wq.codes, xq.scale,
                                        wq.scale), {}
                continue
            fused = isinstance(node, FusedConvBlockNode)
            tiling = node.tiling
            op = "fused_conv_block" if fused else "conv2d"
            if tiling is not None:          # streamed stage: tune th
                op = "stream_" + op
            wv = (folded[node.inputs[1]] if len(node.inputs) > 1
                  else node.w.fetch(params))
            bv = (folded.get(node.inputs[2]) if len(node.inputs) > 2
                  else (None if node.b is None else node.b.fetch(params)))
            scale = None
            if isinstance(wv, QTensor):
                x, w_arr, scale = split_int8(quantize_int8(x, axis=None),
                                             wv)
            else:
                w_arr = wv
            kw = dict(stride=tuple(node.stride))
            if tiling is not None:
                kw["tiling"] = tiling
            if fused:
                kw.update(scale=scale, odd=node.odd)
            elif tiling is not None:
                kw["scale"] = scale
            yield node, op, (x, w_arr, bv), kw

    def _autotune_stages(self, params, folded: dict,
                         policy: ExecPolicy | None = None
                         ) -> dict[int, dict]:
        """Measure launch-shape winners for every tunable stage (DESIGN.md
        §10): ``ensure_tuned`` on the stage's concrete call (a cache hit
        skips the measurement), returning {node id: namespaced tiling
        overrides} to bake. Stages whose dispatch under the bind
        ``policy`` would not run the ``cuda`` kernel on the card tune
        nothing; a winner that IS the heuristic point bakes nothing
        either, the default resolution already gives that program."""
        from repro_torch.ops.autotune import ensure_tuned, heuristic_tiles
        base = self._base_policy(policy)
        tuned: dict[int, dict] = {}
        for node, op, args, kw in self._stage_calls(params, folded):
            best = ensure_tuned(op, *args, policy=base, **kw)
            if best and best != heuristic_tiles(op, *args, **kw):
                tuned[node.id] = {f"{op}.{k}": v for k, v in best.items()}
        return tuned

    def pin_heuristic_tiles(self, params, folded: dict | None = None
                            ) -> int:
        """Winner validation (DESIGN.md §10): overwrite every tunable
        stage's tuning-cache entry with the heuristic point, for when a
        plan-level A/B shows op-level winners losing end to end; a later
        bind then bakes nothing. Returns how many entries were pinned."""
        from repro_torch.ops.autotune import heuristic_tiles, signature_of
        from repro_torch.ops.tiling import TUNING_CACHE, platform_key
        if folded is None:
            folded = self._fold_constants(params)
        pinned = 0
        for _, op, args, kw in self._stage_calls(params, folded):
            heur = heuristic_tiles(op, *args, **kw)
            if heur is None:
                continue
            TUNING_CACHE.put(op, signature_of(op, args, kw), args[0].dtype,
                             heur, platform=platform_key(args[0].device))
            pinned += 1
        return pinned

    def bind(self, params, *, policy: ExecPolicy | None = None,
             verify: bool = True) -> "BoundPlan":
        """Fold weight quantization against ``params`` now, so per-batch
        calls skip weight requantization. On an ``autotune=True`` plan the
        measured tile winners are baked in too. ``verify=True`` (the
        default) re-runs the static verifier over the bound plan, adding
        the bound-level checks (folded QTensor shapes, serializable
        fingerprint inputs); it is read-only."""
        folded = self._fold_constants(params)
        tuned: dict = {}
        if self.autotune:
            with phase("tune"):
                tuned = self._autotune_stages(params, folded, policy=policy)
        placed = self._place_weights(params, folded)
        bound = BoundPlan(plan=self, params=params, folded=folded,
                          policy=policy, placed=placed, tuned=tuned)
        if verify:
            from repro_torch.analysis.verifier import verify_plan
            verify_plan(bound)
        return bound

    def _place_weights(self, params, folded: dict) -> dict:
        """The mesh half of ``bind``: keep on this rank only its block of
        every placed stage's weight-side operands: OCP the M/S rows (and
        their bias and int8 scale), ICP the N/S columns (the bias whole),
        a composed split the (M/ocp, N/icp) block. A lowered (folded)
        operand's block replaces it in ``folded``, so the whole fold is
        not kept; an operand read from params has its block returned,
        keyed by (node id, attr). Each block lives in one of the two. The
        artifact loader runs this on restored payloads without re-running
        the placement."""
        placed: dict = {}
        for nid, grid in self.grids.items():
            node = self.graph.node(nid)
            if len(node.inputs) > 1:            # quantize-lowered weight
                folded[node.inputs[1]] = _w_block(folded[node.inputs[1]],
                                                  grid)
            else:
                placed[(nid, "w")] = _w_block(node.w.fetch(params), grid)
            if len(node.inputs) > 2:            # qformat-lowered bias
                folded[node.inputs[2]] = grid.v_block(folded[node.inputs[2]])
            elif node.b is not None:
                placed[(nid, "b")] = grid.v_block(node.b.fetch(params))
        return placed

    def save(self, params, path, *, policy: ExecPolicy | None = None
             ) -> str:
        """``bind`` against ``params`` and persist the result as a plan
        artifact (``repro_torch.artifact.store.save_plan``); returns the
        content fingerprint."""
        return self.bind(params, policy=policy).save(path)

    def stages(self) -> list[str]:
        return [n.pretty() for n in self.graph]

    def num_fused(self) -> int:
        return sum(isinstance(n, FusedConvBlockNode) for n in self.graph)

    def num_sharded(self) -> int:
        return sum(getattr(n, "sharding", None) is not None
                   and n.sharding.mode != "none" for n in self.graph)

    def pretty(self) -> str:
        mesh = ""
        if self.mesh is not None:
            from repro_torch.artifact.fingerprint import mesh_shape_doc
            mesh = f", mesh={dict(mesh_shape_doc(self.mesh))}"
        head = (f"ExecutionPlan(quant={self.quant}, "
                f"{len(self.graph)} nodes, {self.num_fused()} fused{mesh})")
        return head + "\n" + self.graph.pretty()


def _needed(grid, r: int, n: int) -> tuple[int, int]:
    """The input channels [lo, hi) of N that model coordinate ``r``
    reads under ``grid``: block ``r % ki`` of ``ki``."""
    if grid.ki == 1:
        return 0, n
    i = r % grid.ki
    return i * n // grid.ki, (i + 1) * n // grid.ki


def _held(layout, r: int, n: int) -> tuple[int, int]:
    """The channels [lo, hi) of N that model coordinate ``r`` holds of
    an activation laid out ``(ko, ki)``: block ``r // ki`` of ``ko``."""
    ko, ki = layout
    o = r // ki
    return o * n // ko, (o + 1) * n // ko


def _channel_slice(v, lo: int, hi: int):
    """Channels [lo, hi) of a tensor or of an int8 activation's codes
    (its per-tensor scale is shared)."""
    if isinstance(v, QTensor):
        return QTensor(v.codes[:, lo:hi], v.scale)
    return v[:, lo:hi]


def _w_block(w, grid):
    """This rank's block of a conv weight: a tensor, or a folded int8
    QTensor (codes blocked, per-output-channel scale sliced with M)."""
    if isinstance(w, QTensor):
        return QTensor(grid.w_block(w.codes), grid.v_block(w.scale))
    return grid.w_block(w)


def _params_device(params) -> torch.device:
    from repro_torch.artifact.fingerprint import params_device
    return params_device(params) or torch.device("cpu")


@dataclass(frozen=True)
class BoundPlan:
    """An ExecutionPlan closed over one params dict with weight
    quantization pre-folded (and, on an autotuned plan, measured tiles
    pre-baked) — call as ``bound(images)``."""

    plan: ExecutionPlan
    params: object
    folded: dict
    policy: ExecPolicy | None = None
    # {(node id, "w" | "b"): this rank's block} of each placed stage's
    # operand read from params (a lowered one's block is in ``folded``)
    placed: dict = field(default_factory=dict)
    # {node id: namespaced tiling overrides} measured at bind time
    tuned: dict = field(default_factory=dict)

    def __call__(self, x, *, policy: ExecPolicy | None = None):
        return self.plan(self.params, x,
                         policy=policy if policy is not None else self.policy,
                         _folded=self.folded, _placed=self.placed,
                         _tuned=self.tuned)

    def operand(self, node, idx: int, attr: str):
        """The weight-side operand (``idx`` 1 ``"w"``, 2 ``"b"``) this
        rank keeps for a conv stage: a lowered one from ``folded``, else
        a placed stage's block from ``placed``, else the whole param."""
        if len(node.inputs) > idx:
            return self.folded.get(node.inputs[idx])
        if (node.id, attr) in self.placed:
            return self.placed[(node.id, attr)]
        ref = getattr(node, attr)
        return None if ref is None else ref.fetch(self.params)

    def stage_weight_bytes(self) -> dict[int, int]:
        """{conv stage id: bytes of the weight, bias and requant scale
        this rank keeps for it}: a placed stage's block, else the whole
        operand."""
        def nbytes(v):
            if v is None:
                return 0
            if isinstance(v, QTensor):
                return nbytes(v.codes) + nbytes(v.scale)
            return v.numel() * v.element_size()

        return {node.id: nbytes(self.operand(node, 1, "w"))
                + nbytes(self.operand(node, 2, "b"))
                for node in self.plan.graph
                if isinstance(node, (Conv2DNode, FusedConvBlockNode))}

    @property
    def device(self) -> torch.device:
        """Where the params (and so every stage) live."""
        return _params_device(self.params)

    def fingerprint(self) -> str:
        """Content fingerprint over graph IR + quant + tiles + policies +
        weights + the build (``repro_torch.artifact.fingerprint``)."""
        from repro_torch.artifact.fingerprint import plan_fingerprint
        return plan_fingerprint(self.plan, params=self.params,
                                tuned=self.tuned, bind_policy=self.policy)

    def save(self, path) -> str:
        """Persist as a versioned plan artifact; returns the content
        fingerprint. See ``repro_torch.artifact.store.save_plan``."""
        from repro_torch.artifact.store import save_plan
        return save_plan(self, path)

    @classmethod
    def load(cls, path, *, params=None, device=None) -> "BoundPlan":
        """Reconstruct a bound plan from an artifact onto ``device`` (the
        card unless the caller asks for the CPU) — no trace, no passes,
        no tuning. ``params`` (optional) asserts the artifact holds the
        caller's weights. Raises ``repro_torch.artifact.ArtifactError``
        when the artifact is unusable (serving uses ``PlanStore.load``
        to warn and fall back)."""
        from repro_torch.artifact.store import load_plan
        kw = {} if device is None else {"device": device}
        return load_plan(path, params=params, **kw).bound


def compile_model(model, input_shape: tuple[int, ...] | None = None, *,
                  policy: ExecPolicy | None = None, fuse: bool = True,
                  mesh=None, autotune: bool = False,
                  stream_budget: int | None = None,
                  dtype: str = "float32",
                  verify: bool = True) -> ExecutionPlan:
    """trace → passes → spatial-tiling placement → plan for any model
    whose forward routes through the hooked functional layer. The
    quantization mode resolves now (explicit ``policy`` > model-config
    policy > ambient ``use_policy``); backend and launch shape stay
    dynamic through the registry.

    ``mesh`` (a ``DeviceMesh`` with a ``model`` axis, optionally a
    ``data`` axis) runs the channel-parallel placement pass (DESIGN.md
    §9/§15) and bakes the mesh into the plan: an icp × ocp split of the
    model axis per conv stage from its arithmetic intensity, overridable
    with ``ExecPolicy.channel_parallel``; batches scatter over ``data``.
    Every rank of the mesh compiles the same plan.

    ``autotune=True`` (or ``ExecPolicy.autotune``): ``plan.bind``
    measures launch shapes per stage on the card and bakes the winners
    into the BoundPlan (DESIGN.md §10). A mesh refuses it: ranks tuning
    apart could bake different tiles.

    ``stream_budget`` (bytes, default
    ``repro_torch.stream.STREAM_VMEM_BUDGET_BYTES``) is the per-image
    stage footprint above which conv/fused stages get a ``SpatialTiling``
    and execute as halo-overlapped row bands (DESIGN.md §13).

    ``verify=True`` (the default) runs the static plan verifier
    (``repro_torch.analysis.verify_plan``, DESIGN.md §14) over the
    finished plan, raising ``PlanVerificationError`` with named
    violations; it is read-only."""
    if input_shape is None:
        input_shape = model.input_shape()
    pol = policy
    if pol is None:
        exec_pol = getattr(getattr(model, "cfg", None), "exec_policy", None)
        pol = exec_pol() if callable(exec_pol) else None
    quant_pol = pol if pol is not None else current_policy()
    with phase("trace"):
        graph = trace(model, tuple(input_shape), dtype)
    with phase("fuse"):
        graph = default_passes(graph, quant=quant_pol.quant,
                               qformat=quant_pol.qformat, fuse=fuse)
    if mesh is not None:
        from repro_torch.core.parallelism import axis_size, check_mesh
        names = check_mesh(mesh)
        if autotune or quant_pol.autotune:
            raise ValueError(
                "autotune=True with a mesh: ranks tuning apart could bake "
                "different launch shapes; tune on one device and serve "
                "the TuningCache")
        with phase("place"):
            graph = place_channel_parallel(
                graph, axis_size(mesh, "model"),
                override=quant_pol.channel_parallel,
                data="data" in names)
    # runs on every compile: under-budget graphs (all MNIST-sized plans)
    # come back node for node identical. Imported here: repro_torch.stream
    # imports the graph IR, whose package imports this module.
    from repro_torch.stream.passes import place_spatial_tiling
    with phase("place"):
        graph = place_spatial_tiling(graph, budget_bytes=stream_budget)
    plan = ExecutionPlan(graph=graph, quant=quant_pol.quant,
                         qformat=quant_pol.qformat, compile_policy=pol,
                         mesh=mesh, autotune=autotune or quant_pol.autotune)
    if verify:
        from repro_torch.analysis.verifier import verify_plan
        verify_plan(plan)
    return plan
