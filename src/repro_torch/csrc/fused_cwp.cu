// fused_cwp: VALID strided NCHW conv + requant scale + bias + relu + 2x2/2
// max pool in one kernel; only the pooled tile is written.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_cwp/kernel.py
// (_fused_cwp_kernel, launched by fused_cwp_pallas).
//
// What bounds it on an H100: by its work, nothing but launch latency at
// the paper CNN's serving batches (B = 8 is under a microsecond at the
// card's 67 TFLOP/s fp32 and 3.35 TB/s). At B = 1024, conv2 (1.38 MFLOP
// per image over 11.4 KB of activations) is bound by fp32 operations and
// conv1 (0.18 MFLOP over 13.3 KB) by bytes.
//
// What this design does about it: one thread per pooled output, so the
// pre-pool activation never leaves registers (the fusion the TPU kernel
// exists for), whole-warp blocks spread over as many SMs as the outputs
// fill (repro_torch/ops/tiling.py), and the kernel masks its own ragged
// edge. It is the simple, exact first version: each thread runs its four
// conv points one after another, each a sequential fp32 FMA loop on CUDA
// cores with no reuse through shared memory, so a thread's dependent FMA
// chain (4 x 540 on conv2) and not the card's bound sets its time.
// Interleaving the four points and staging the slab and weights in
// shared memory is the redesign's work.
#include "conv_common.cuh"

extern "C" int fused_cwp_launch(const void* x, const void* w,
                                const void* scale, const void* bias, void* out,
                                int B, int N, int H, int W, int M, int Kh,
                                int Kw, int sh, int sw, int threads,
                                void* stream) {
  return launch_conv<true>(x, w, scale, bias, out, B, N, H, W, M, Kh, Kw, sh,
                           sw, threads, stream);
}
