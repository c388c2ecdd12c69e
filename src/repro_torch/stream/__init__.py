"""repro_torch.stream — halo-aware streaming spatial tiler (DESIGN.md §13).

Port of ``repro.stream``: images larger than one stage's budget stream
through the existing conv kernels (``fused_cwp``, ``conv_window``) as
row-band tiles with line-buffer-style halo overlap.

  * ``tiling``   — the halo math, ``SpatialTiling`` spec, budgets;
  * ``passes``   — ``place_spatial_tiling`` graph pass;
  * ``executor`` — ``stream_conv2d`` / ``stream_fused_conv_block``.
"""
from repro_torch.stream.tiling import (SpatialTiling,
                                       STREAM_VMEM_BUDGET_BYTES,
                                       band_input_rows, band_working_set,
                                       choose_tile_rows, conv_bands,
                                       halo_rows, image_working_set,
                                       pooled_bands, streamed_input_rows,
                                       tiling_from_doc, tiling_to_doc)
from repro_torch.stream.passes import place_spatial_tiling
from repro_torch.stream.executor import (resolve_tile_rows, stream_conv2d,
                                         stream_fused_conv_block)

__all__ = ["SpatialTiling", "STREAM_VMEM_BUDGET_BYTES", "band_input_rows",
           "band_working_set", "choose_tile_rows", "conv_bands",
           "halo_rows", "image_working_set", "pooled_bands",
           "streamed_input_rows", "tiling_to_doc", "tiling_from_doc",
           "place_spatial_tiling", "resolve_tile_rows", "stream_conv2d",
           "stream_fused_conv_block"]
