// fused_cwp: VALID strided NCHW conv + requant scale + bias + relu + 2x2/2
// max pool in one kernel; only the pooled tile is written.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_cwp/kernel.py
// (_fused_cwp_kernel, launched by fused_cwp_pallas).
//
// What bounds it on an H100: at B = 1024, conv2 of the paper CNN (1.38
// MFLOP per image over 11.4 KB of activations) is bound by fp32
// operations on the CUDA cores (67 TFLOP/s; TF32 is ruled out, the
// reference pins fp32), conv1 (0.18 MFLOP over 13.3 KB) by bytes. At the
// served batches (B <= 8) both are under a microsecond of work, so the
// launch and one round trip to memory set the pace.
//
// What this design does about it: the shared template of conv_tile.cuh
// with its pooling epilogue. The input band and the weights are staged
// in shared memory once per block, so the overlapping windows cost one
// read from memory; a thread's 2x2 window x 4 channels are 16 independent
// FMA chains; at served batches `split` lanes share a tile. The epilogue
// is the reference's: __fadd_rn(__fmul_rn(acc, s), b), the relu floor at
// 0, the 2x2 max, and only the pooled value is stored. An odd conv map
// is pooled as core/window.py's maxpool2 does: `pad` = 0 drops the last
// row/column (odd='drop'), 1 pools it against -inf (odd='pad').
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
