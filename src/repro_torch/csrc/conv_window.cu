// conv_window: VALID strided NCHW conv with a +bias epilogue.
//
// Replaces the Pallas TPU kernel repro/kernels/conv_window/kernel.py
// (_conv_window_kernel, launched by conv2d_window_pallas).
//
// What bounds it on an H100: the same contraction as fused_cwp without the
// pool, so four times the output bytes. fp32 operands: at B = 1024 conv2
// of the paper CNN is bound by fp32 operations on the CUDA cores (TF32 is
// ruled out, the reference pins fp32) and conv1, whose unpooled output is
// 41.5 MB, by bytes. int8 codes: bytes at every shape, most of them the
// fp32 output. At the eager forward's batches (B <= 8) the launch sets
// the pace.
//
// What this design does about it: the shared template of conv_tile.cuh
// without the pool, in two routes. fp32 (`kernel<STAGED, false, KW>`):
// the input band and the weights land in shared memory by 4-byte cp.async
// (one commit group: more, each with its barrier, measured slower), a
// thread holds 2x2 conv points x 4 channels (16 independent FMA chains, 2
// input loads a tap at stride 1, a kernel row's loads ahead of its FMAs
// at widths 3, 5 and 6), `split` lanes share a tile where the tiles
// cannot fill the card.
// int8 (`s8_kernel<false, NT>`, launched by conv_window_s8_launch):
// mma.sync.m16n8k32 s8 tiles over codes staged by cp.async in one commit
// group a block (a ring of stages measured slower), the exact int32
// sums stored as fp32 (the requant epilogue stays outside the kernel, as
// the reference's conv_epilogue). Each point is stored with +bias
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

extern "C" int conv_window_s8_launch(const void* x, const void* w,
                                     const void* bias, void* out, int B,
                                     int N, int H, int W, int M, int Kh,
                                     int Kw, int sh, int sw, int cpb,
                                     int band, int ips, int smem,
                                     void* stream) {
  return conv_tile::launch_s8<false>(x, w, nullptr, bias, out, B, N, H, W, M,
                                     Kh, Kw, sh, sw, cpb, band, ips, smem, 0,
                                     stream);
}
