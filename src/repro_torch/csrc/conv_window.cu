// conv_window: VALID strided NCHW conv with a +bias epilogue.
//
// Replaces the Pallas TPU kernel repro/kernels/conv_window/kernel.py
// (_conv_window_kernel, launched by conv2d_window_pallas).
//
// What bounds it on an H100: the same contraction as fused_cwp without the
// pool, so four times the output bytes. By its work, launch latency sets
// the pace at the eager forward's batches; at large batches conv2 is bound
// by fp32 operations and conv1 by bytes.
//
// What this design does about it: one thread per conv output, a sequential
// fp32 FMA loop over eta, whole-warp blocks spread over as many SMs as the
// outputs fill (repro_torch/ops/tiling.py). The kernel masks its own
// ragged edge, so none of the TPU wrapper's row and batch padding is
// carried over. Each thread's dependent FMA chain (540 on conv2), not the
// card's bound, sets its time; reuse of the overlapping windows through
// shared memory is later work.
#include "conv_common.cuh"

extern "C" int conv_window_launch(const void* x, const void* w,
                                  const void* bias, void* out, int B, int N,
                                  int H, int W, int M, int Kh, int Kw, int sh,
                                  int sw, int threads, void* stream) {
  return launch_conv<false>(x, w, nullptr, bias, out, B, N, H, W, M, Kh, Kw,
                            sh, sw, threads, stream);
}
