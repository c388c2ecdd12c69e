// fused_cwp: VALID strided NCHW conv + requant scale + bias + relu + 2x2/2
// max pool in one kernel; only the pooled tile is written.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_cwp/kernel.py
// (_fused_cwp_kernel, launched by fused_cwp_pallas).
//
// What bounds it on an H100. fp32 operands (the `none` and `qformat`
// formats): at B = 1024, conv2 of the paper CNN (1.38 MFLOP per image
// over 11.4 KB of activations) is bound by fp32 operations on the CUDA
// cores (67 TFLOP/s; TF32 is ruled out, the reference pins fp32), conv1
// (0.18 MFLOP over 13.3 KB) by bytes. int8 codes (the `int8` format the
// served CNNs run): the s8 tensor cores' 1,979 TOP/s put every shape's
// operations below its bytes, 1-byte codes in and the pooled fp32 out. At
// the served batches (B <= 8) both routes are a few microseconds of work,
// so the launch and the round trips to memory set the pace.
//
// What this design does about it: the shared template of conv_tile.cuh
// with its pooling epilogue, in two routes.
//  * fp32 route (`kernel<STAGED, true, KW>`): the input band and the
//    weights land in shared memory by 4-byte cp.async (one commit group:
//    4 groups over input channels, the FMAs of each starting once it
//    landed, ran 10-14% slower for their barriers), so the overlapping
//    windows cost one read from memory; a thread's 2x2 window x 4
//    channels are 16 independent FMA chains, fed at stride 1 by 2 input
//    loads and a float4 of weights a tap (the window's right column is
//    the next tap's left), a kernel row's loads issued ahead of its FMAs
//    at the main path's widths (3, 5, 6); where the tiles cannot fill
//    the card `split` lanes share a tile, and a block then holds up to
//    512 threads.
//  * int8 route (`s8_kernel<true, NT>`, launched by fused_cwp_s8_launch):
//    mma.sync.m16n8k32 s8 tiles; rows are the four points of 8 pooling
//    windows, ordered so that a thread's int32 accumulators hold a whole
//    2x2 window of 2 channels, and the pool runs in registers; a block's
//    codes and weights land by 4-byte cp.async in one commit group (a
//    ring of stages, later items landing while earlier ones compute,
//    measured slower: a block's work is too short to hide a load behind);
//    int32 sums are exact and convert to fp32 exactly.
// Both keep the reference's epilogue: __fadd_rn(__fmul_rn(acc, s), b),
// the relu floor at 0, the 2x2 max, and only the pooled value is stored.
// An odd conv map is pooled as core/window.py's maxpool2 does: `pad` = 0
// drops the last row/column (odd='drop'), 1 pools it against -inf
// (odd='pad').
#include "conv_tile.cuh"

extern "C" int fused_cwp_launch(const void* x, const void* w,
                                const void* scale, const void* bias, void* out,
                                int B, int N, int H, int W, int M, int Kh,
                                int Kw, int sh, int sw, int threads, int cpb,
                                int band, int split, int ipb, int ld, int smem,
                                int pad, void* stream) {
  return conv_tile::launch<true>(x, w, scale, bias, out, B, N, H, W, M, Kh,
                                 Kw, sh, sw, threads, cpb, band, split, ipb,
                                 ld, smem, pad, stream);
}

extern "C" int fused_cwp_s8_launch(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int B, int N, int H, int W,
                                   int M, int Kh, int Kw, int sh, int sw,
                                   int cpb, int band, int ips, int smem,
                                   int pad, void* stream) {
  return conv_tile::launch_s8<true>(x, w, scale, bias, out, B, N, H, W, M, Kh,
                                    Kw, sh, sw, cpb, band, ips, smem, pad,
                                    stream);
}
