// qmatmul: int8 x int8 -> int32 GEMM with the per-row x per-column scale
// epilogue, (acc * xs[row]) * ws[col], f32 out.
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul/kernel.py
// (_qmatmul_kernel, launched by qmatmul_pallas).
//
// What bounds it on an H100: on the paper CNN's fc layer, (B, 320) x
// (320, 10), it moves a few kilobytes and does a few hundred thousand
// integer operations per served batch, so launch latency bounds it at
// every batch the engine serves.
//
// What this design does about it: one thread per output element and an
// int32 accumulator over K (exact, like the TPU kernel's int32 scratch),
// no K blocking and no cross-block reduction, so nothing carries between
// blocks. The epilogue uses the round-to-nearest intrinsics in the
// reference's order so it stays bitwise equal. Tensor-core int8 (wgmma
// s8) is later work; with N = 10 it would leave most of a tile empty.
#include <cuda_runtime.h>
#include <cstdint>

__global__ void qmatmul_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ w,
                               const float* __restrict__ xs,
                               const float* __restrict__ ws,
                               float* __restrict__ out, int M, int N, int K) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * N) return;  // the ragged last block
  const int row = (int)(idx / N);
  const int col = (int)(idx % N);
  const int8_t* xr = x + (size_t)row * K;
  const int8_t* wc = w + col;
  int acc = 0;
  for (int k = 0; k < K; ++k) {
    acc += (int)xr[k] * (int)wc[(size_t)k * N];
  }
  out[idx] = __fmul_rn(__fmul_rn((float)acc, xs[row]), ws[col]);
}

extern "C" int qmatmul_launch(const void* x, const void* w, const void* xs,
                              const void* ws, void* out, int M, int N, int K,
                              int threads, void* stream) {
  const long long blocks = ((long long)M * N + threads - 1) / threads;
  qmatmul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)xs, (const float*)ws,
      (float*)out, M, N, K);
  return (int)cudaGetLastError();
}
