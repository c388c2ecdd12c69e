// qmatmul: int8 x int8 -> int32 GEMM with the per-row x per-column scale
// epilogue, (acc * xs[row]) * ws[col], f32 out.
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul/kernel.py
// (_qmatmul_kernel, launched by qmatmul_pallas).
//
// What bounds it on an H100: on the paper CNN's fc layer, (B, 320) x
// (320, 10), it moves a few kilobytes and does at most 6.6 million integer
// operations per call (B = 1024), about 50 cycles of one SM's __dp4a
// rate, so the launch and the round trips to memory set the pace at every
// batch the engine serves. Tensor-core int8 (mma.sync or wgmma s8) is left
// out: N = 10 fills less than one tile, and the work would not be what
// takes the time.
//
// What this design does about it:
//  * Staging. A block stages a slice of `cols` columns of w in shared
//    memory, transposed to [column][k/4] 32-bit words, 4 consecutive k of
//    one column packed as a char4, zero past K and past N; byte loads of
//    adjacent columns by adjacent threads, 32 loads in flight a thread.
//  * One warp per row. A warp takes a row of x and its lanes walk it in
//    4-byte words (128 bytes a warp a step, coalesced). Each lane keeps
//    one int32 per column of a 16-column pass and accumulates with
//    __dp4a, four int8 products a instruction. The first 128 words of the
//    row and the epilogue's two scales are loaded before the staging
//    barrier, so every round trip to memory overlaps the staging's.
//  * Folding and epilogue. The warp folds each column's 32 partials with
//    __shfl_xor_sync; lane c applies __fmul_rn(__fmul_rn((float)acc,
//    xs[row]), ws[col]) to column c, the reference's two roundings.
// Integer sums are exact in any order, so the result is bitwise equal to
// the plain version's. The grid is (M / rows) x (N / cols) blocks; a K
// longer than one slice of `kslice` words loops over slices inside the
// block, carrying the accumulators in registers; a row that is not 4-byte
// aligned (K % 4 != 0, or an unaligned view) is read with byte loads. No
// (M, K, N) is refused.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int CC = 16;     // columns a lane holds in one pass
constexpr int XP = 4;      // x words a lane loads ahead of the staging
constexpr int STAGE = 8;   // w words a thread packs per round of loads

// x word q of a row: k = 4q .. 4q+3 as a char4, zero past K
template <bool ALIGNED>
__device__ __forceinline__ int x_word(const int8_t* __restrict__ xr, int q,
                                      int K) {
  if constexpr (ALIGNED) {
    return reinterpret_cast<const int*>(xr)[q];
  } else {
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * q + i;
      if (k < K) v |= (unsigned)(uint8_t)xr[k] << (8 * i);
    }
    return (int)v;
  }
}

template <bool ALIGNED>
__global__ void qmatmul_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ w,
                               const float* __restrict__ xs,
                               const float* __restrict__ ws,
                               float* __restrict__ out, int M, int N, int K,
                               int rows, int cols, int kslice, int ld) {
  extern __shared__ int wsm[];  // [column of the slice][ld] packed words
  const int kw = (K + 3) / 4;
  const int cslices = (N + cols - 1) / cols;
  const int row0 = (blockIdx.x / cslices) * rows;
  const int col0 = (blockIdx.x % cslices) * cols;
  const int ncols = min(cols, N - col0);
  const int warps = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int nks = (kw + kslice - 1) / kslice;
  const int rounds = (rows + warps - 1) / warps;

  // every loop bound below is uniform over the block: all threads reach
  // the staging barriers
  for (int rr = 0; rr < rounds; ++rr) {
    const int rl = rr * warps + warp;
    const int row = row0 + rl;
    const bool live = rl < rows && row < M;  // uniform over the warp
    const int8_t* xr = x + (size_t)(live ? row : 0) * K;
    // the epilogue's scales, loaded ahead of the contraction
    const float xsr = live ? xs[row] : 0.f;
    for (int c0 = 0; c0 < ncols; c0 += CC) {
      const int col = col0 + c0 + lane;
      const bool mine = live && lane < CC && c0 + lane < ncols;
      const float wsc = mine ? ws[col] : 0.f;
      int acc[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[c] = 0;
      for (int ks = 0; ks < nks; ++ks) {
        const int q0 = ks * kslice, nq = min(kslice, kw - q0);
        int xp[XP];
#pragma unroll
        for (int u = 0; u < XP; ++u) {
          const int ql = lane + u * WARP;
          xp[u] = live && ql < nq ? x_word<ALIGNED>(xr, q0 + ql, K) : 0;
        }
        // one slice of every column when K fits (staged once), else this
        // pass's 16 columns of K slice ks
        if (nks > 1 || (rr == 0 && c0 == 0)) {
          const int cb = nks > 1 ? c0 : 0;
          const int nc = nks > 1 ? CC : (ncols + CC - 1) / CC * CC;
          const int total = nc * nq;
          __syncthreads();  // the previous pass has read the old slice
          for (int i0 = threadIdx.x; i0 < total; i0 += STAGE * blockDim.x) {
            unsigned v[STAGE];
#pragma unroll
            for (int u = 0; u < STAGE; ++u) {
              const int idx = i0 + u * blockDim.x;
              const int c = cb + idx % nc, q = q0 + idx / nc;
              v[u] = 0;
              if (idx < total && c < ncols) {
                const int8_t* wc = w + col0 + c;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int k = 4 * q + i;
                  if (k < K) {
                    v[u] |= (unsigned)(uint8_t)wc[(size_t)k * N] << (8 * i);
                  }
                }
              }
            }
#pragma unroll
            for (int u = 0; u < STAGE; ++u) {
              const int idx = i0 + u * blockDim.x;
              if (idx < total) {
                wsm[(cb + idx % nc) * ld + idx / nc] = (int)v[u];
              }
            }
          }
          __syncthreads();
        }
        if (live) {
          const int* wt = wsm + c0 * ld;
#pragma unroll
          for (int u = 0; u < XP; ++u) {
            const int ql = lane + u * WARP;
            if (ql < nq) {
#pragma unroll
              for (int c = 0; c < CC; ++c)
                acc[c] = __dp4a(xp[u], wt[c * ld + ql], acc[c]);
            }
          }
          for (int ql = lane + XP * WARP; ql < nq; ql += WARP) {
            const int xv = x_word<ALIGNED>(xr, q0 + ql, K);
#pragma unroll
            for (int c = 0; c < CC; ++c)
              acc[c] = __dp4a(xv, wt[c * ld + ql], acc[c]);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int c = 0; c < CC; ++c)
#pragma unroll
          for (int o = WARP / 2; o > 0; o >>= 1)
            acc[c] += __shfl_xor_sync(FULL, acc[c], o);
        int v = acc[0];  // every lane holds every sum: lane c takes c's
#pragma unroll
        for (int c = 1; c < CC; ++c)
          if (lane == c) v = acc[c];
        if (mine) {
          out[(size_t)row * N + col] = __fmul_rn(__fmul_rn((float)v, xsr),
                                                 wsc);
        }
      }
    }
  }
}

template <bool ALIGNED>
int launch(const void* x, const void* w, const void* xs, const void* ws,
           void* out, int M, int N, int K, int threads, int rows, int cols,
           int kslice, int ld, int smem, long long grid, cudaStream_t st) {
  // opt in to more than 48 KB once per device and size: never again on a
  // later launch (or inside a CUDA graph capture) that needs no more
  static int opted[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& have = opted[dev & 63];
  if (smem > 48 * 1024 && smem > have) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmatmul_kernel<ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    have = smem;
  }
  qmatmul_kernel<ALIGNED><<<(unsigned)grid, threads, smem, st>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)xs, (const float*)ws,
      (float*)out, M, N, K, rows, cols, kslice, ld);
  return (int)cudaGetLastError();
}

}  // namespace

// Host side: launch on `stream`, return a CUDA error code (0 = launched).
// threads is a multiple of 32, rows, cols and kslice >= 1; smem holds
// ceil(cols / 16) * 16 columns of the slice at the word stride ld >=
// kslice (repro_torch/ops/tiling.py resolves and checks them all).
extern "C" int qmatmul_launch(const void* x, const void* w, const void* xs,
                              const void* ws, void* out, int M, int N, int K,
                              int threads, int rows, int cols, int kslice,
                              int ld, int smem, void* stream) {
  const long long grid =
      (long long)((M + rows - 1) / rows) * ((N + cols - 1) / cols);
  const bool aligned = ((uintptr_t)x & 3) == 0 && (K & 3) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return aligned ? launch<true>(x, w, xs, ws, out, M, N, K, threads, rows,
                                cols, kslice, ld, smem, grid, st)
                 : launch<false>(x, w, xs, ws, out, M, N, K, threads, rows,
                                 cols, kslice, ld, smem, grid, st);
}
