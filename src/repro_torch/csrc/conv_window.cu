// conv_window: VALID strided NCHW conv with a +bias epilogue.
//
// Replaces the Pallas TPU kernel repro/kernels/conv_window/kernel.py
// (_conv_window_kernel, launched by conv2d_window_pallas).
//
// What bounds it on an H100: the same contraction as fused_cwp without the
// pool, so four times the output bytes. At B = 1024 conv2 of the paper CNN
// is bound by fp32 operations on the CUDA cores (TF32 is ruled out, the
// reference pins fp32) and conv1, whose unpooled output is 41.5 MB, by
// bytes. At the eager forward's batches (B <= 8) the launch sets the pace.
//
// What this design does about it: the shared template of conv_tile.cuh
// without the pool. The input band and the weights are staged in shared
// memory once per block, a thread holds 2x2 conv points x 4 channels (16
// independent FMA chains), `split` lanes share a tile where the tiles
// cannot fill the card, and each point is stored with +bias
// (__fadd_rn). Any VALID output is taken: at an odd last row or column
// the tile stores only the points that exist and reads nothing past the
// input.
#include "conv_tile.cuh"

extern "C" int conv_window_launch(const void* x, const void* w,
                                  const void* bias, void* out, int B, int N,
                                  int H, int W, int M, int Kh, int Kw, int sh,
                                  int sw, int threads, int cpb, int band,
                                  int split, int ipb, int ld, int smem,
                                  void* stream) {
  return conv_tile::launch<false>(x, w, nullptr, bias, out, B, N, H, W, M,
                                  Kh, Kw, sh, sw, threads, cpb, band, split,
                                  ipb, ld, smem, 0, stream);
}
