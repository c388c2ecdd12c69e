"""Graph pass: stamp ``SpatialTiling`` on stages that exceed the budget.

Port of ``repro.stream.passes``. ``place_spatial_tiling`` is the
streaming half of the pass pipeline (DESIGN.md §13): for every
*unsharded* conv / fused-conv stage it computes the per-image activation footprint (full
input + full output, ``image_working_set``) and, when that exceeds the
budget, attaches a ``SpatialTiling`` whose ``tile_rows`` is the largest
band fitting the same budget. Stages that fit — every MNIST-sized
PaperCNN stage — are left untouched, so existing plans come back node
for node identical with streaming compiled in.

Channel-sharded stages (``sharding.mode != "none"``) are skipped, as
the reference skips them: their per-rank shapes are the shard's, and
spatial banding does not compose with the stage's collectives.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.graph.ir import Conv2DNode, FusedConvBlockNode, Graph, Node
from repro_torch.graph.passes import stage_input_spec
from repro_torch.stream.tiling import (STREAM_VMEM_BUDGET_BYTES,
                                       SpatialTiling, choose_tile_rows,
                                       halo_rows, image_working_set)

__all__ = ["place_spatial_tiling"]


def place_spatial_tiling(graph: Graph, *,
                         budget_bytes: int | None = None) -> Graph:
    """Attach a ``SpatialTiling`` to every over-budget unsharded conv /
    fused stage; ``budget_bytes=None`` means ``STREAM_VMEM_BUDGET_BYTES``. A
    stage whose full output already fits in one band stays untiled
    (tiling would be a no-op program)."""
    budget = STREAM_VMEM_BUDGET_BYTES if budget_bytes is None \
        else int(budget_bytes)
    placed: list[Node] = []
    for node in graph:
        if not isinstance(node, (Conv2DNode, FusedConvBlockNode)):
            placed.append(node)
            continue
        spec = node.sharding
        if spec is not None and spec.mode != "none":
            placed.append(node)
            continue
        in_spec = stage_input_spec(graph, node)
        _, n, h, w = in_spec.shape
        m, _, kh, kw = node.w.shape
        sh, sw = node.stride
        # footprint counts the CONV-resolution activation even for fused
        # stages (their node.out is pooled): the pre-pool rows are what
        # streaming keeps banded, and what an unfused conv materializes
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        itemsize = np.dtype(in_spec.dtype).itemsize
        if image_working_set(n, h, w, m, oh, ow, itemsize) <= budget:
            placed.append(node)
            continue
        fused = isinstance(node, FusedConvBlockNode)
        tr = choose_tile_rows(n, h, w, m, kh, kw, node.stride, itemsize,
                              pooled=fused, budget=budget)
        if tr >= oh:                      # one band == the whole stage
            placed.append(node)
            continue
        placed.append(replace(node, tiling=SpatialTiling(
            tile_rows=tr, halo=halo_rows(kh, node.stride[0]),
            pooled=fused, budget_bytes=budget)))
    return replace(graph, nodes=tuple(placed)).validate()
