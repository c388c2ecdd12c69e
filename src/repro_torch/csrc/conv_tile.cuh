// Shared body of the fused_cwp and conv_window kernels: a VALID strided
// NCHW conv, tiled in shared memory with a 2x2-point x 4-channel register
// tile, and one of two epilogues.
//
//  * POOL = true (fused_cwp): requant scale, bias, relu floor, 2x2/2 max;
//    only the pooled value is stored. Output (B, M, Po, Qo): Ho/2 x Wo/2
//    (an odd last conv row or column is dropped, odd='drop'), or with
//    `pad` ceil(Ho/2) x ceil(Wo/2), whose last tile pools the points that
//    exist (odd='pad': the missing ones are -inf, below the relu floor).
//  * POOL = false (conv_window): bias only; each of the tile's 4 conv
//    points is stored. Output (B, M, Ho, Wo), on a grid of Po = ceil(Ho/2)
//    x Qo = ceil(Wo/2) tiles; a tile at an odd last row or column stores
//    only the points that exist.
//
// Tiling. A block owns `ipb` images, a group of `cpb` output channels and
// a band of `band` tile rows. It stages the input band (N channels x the
// band's rows + the Kh - sh halo x W, at a row stride `ld` padded so a
// warp's 2x2 windows fall in distinct banks) and the group's weights,
// transposed to [eta][cpb], in shared memory, with four loads in flight a
// thread, so the overlapping windows are read from memory once and the
// weights once for `ipb` images. Where even a one-row band of one channel
// group would not fit (huge N*W or kernels), the same loop reads from
// device memory instead (STAGED = false): no shape is refused.
//
// Register tile. A thread holds the 2x2 conv points of one tile x 4
// channels: 16 independent fp32 FMA chains, fed per kernel tap by 4 input
// loads and one float4 weight load (a broadcast). At a ragged edge the
// missing points read the first point's window again (never past the
// band or past H) and are not stored; pooled, they repeat a point that
// exists, so the 2x2 max is that of the points that exist.
//
// Small batches. Where the tiles cannot fill 132 SMs, `split` adjacent
// lanes (a power of two up to 32) share one tile, each taking every
// split-th kernel row of the contraction; shuffles down combine their
// partials in a fixed order inside the warp.
//
// The epilogue is spelled with the round-to-nearest intrinsics
// (__fadd_rn(__fmul_rn(acc, s), b)) so nvcc cannot contract it, as the
// reference's optimization barrier pins it. int8 codes and Q8.8 values
// make every partial sum exact (540 * 127^2 < 2^24), so the order is
// bitwise there; fp32 moves within the stated 1e-5.
#pragma once

#include <cuda_runtime.h>

namespace conv_tile {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CT = 4;  // output channels in a thread's register tile

struct Shape {
  // ragged: the tile grid covers an odd last conv row/column (Po =
  // ceil(Ho/2)); conv_window always, fused_cwp under odd='pad'
  int B, N, H, W, M, Kh, Kw, sh, sw, Ho, Wo, Po, Qo, ragged;
};

template <bool STAGED, bool POOL>
__global__ void kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       float* __restrict__ out, Shape s, int cpb, int band,
                       int split, int ipb, int ld) {
  extern __shared__ __align__(16) float smem[];
  const bool ragged = !POOL || s.ragged;
  const int eta = s.N * s.Kh * s.Kw;
  const int groups = (s.M + cpb - 1) / cpb;
  const int bands = (s.Po + band - 1) / band;
  int bid = blockIdx.x;
  const int bi = bid % bands;
  bid /= bands;
  const int m0 = (bid % groups) * cpb;
  const int b0 = (bid / groups) * ipb;
  const int nimg = min(ipb, s.B - b0);
  const int ph0 = bi * band;
  const int nph = min(band, s.Po - ph0);
  const int row0 = 2 * ph0 * s.sh;
  // input rows of the band; a ragged last tile row reads none past H
  int rows = (2 * nph - 1) * s.sh + s.Kh;
  if (ragged) rows = min(rows, s.H - row0);
  const float* xb = x + ((size_t)b0 * s.N * s.H + row0) * s.W;

  // the contraction reads x through (xs, ld = row stride, cs = channel
  // stride) and the weights through ws ([eta][cpb]) or w ([M][eta])
  const float* xs = xb;
  size_t cs = (size_t)s.H * s.W;
  int xld = s.W;
  if constexpr (STAGED) {
    // UNROLL independent loads in flight per thread while staging
    constexpr int UNROLL = 4;
    const int step = blockDim.x * UNROLL;
    for (int i0 = threadIdx.x; i0 < cpb * eta; i0 += step) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = i0 + u * blockDim.x;
        const int m = m0 + idx / eta;
        v[u] = idx < cpb * eta && m < s.M
                   ? w[(size_t)m0 * eta + idx] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = i0 + u * blockDim.x;
        const int c = idx / eta;
        if (idx < cpb * eta) smem[(idx - c * eta) * cpb + c] = v[u];
      }
    }
    // the band of each (image, channel) is `rows` whole rows: contiguous
    // in memory, at row stride ld in shared memory
    float* xsm = smem + (size_t)eta * cpb;
    const int chunk = rows * s.W;
    const int total = nimg * s.N * chunk;
    for (int i0 = threadIdx.x; i0 < total; i0 += step) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = i0 + u * blockDim.x;
        const int c = idx / chunk;
        v[u] = idx < total ? xb[c * cs + (idx - c * chunk)] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = i0 + u * blockDim.x;
        const int c = idx / chunk, k = idx - c * chunk;
        const int r = k / s.W;
        if (idx < total) xsm[(c * rows + r) * ld + (k - r * s.W)] = v[u];
      }
    }
    xs = xsm;
    cs = (size_t)rows * ld;
    xld = ld;
    __syncthreads();
  }

  const int cgs = cpb / CT;
  const int tiles = nimg * cgs * nph * s.Qo;
  const int part = threadIdx.x % split;
  const int per_round = blockDim.x / split;
  const int krows = s.N * s.Kh;
  // a uniform trip count: every lane reaches the shuffles
  for (int t0 = 0; t0 < tiles; t0 += per_round) {
    const int t = t0 + threadIdx.x / split;
    int pw = 0, phl = 0, cgl = 0, img = 0;
    bool live = t < tiles;
    if (live) {
      pw = t % s.Qo;
      int r = t / s.Qo;
      phl = r % nph;
      r /= nph;
      cgl = r % cgs;
      img = r / cgs;
      live = m0 + cgl * CT < s.M;
    }
    const int oh = 2 * (ph0 + phl), ow = 2 * pw;
    // the tile's second row and column: at a ragged edge, the first again
    int down_rows = s.sh, right = s.sw;
    if (ragged) {
      if (oh + 1 >= s.Ho) down_rows = 0;
      if (ow + 1 >= s.Wo) right = 0;
    }
    float acc[4][CT];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[p][c] = 0.f;
    if (live) {
      const float* xt = xs + (size_t)img * s.N * cs +
                        (size_t)(2 * phl * s.sh) * xld + ow * s.sw;
      const size_t down = (size_t)down_rows * xld;
      for (int kr = part; kr < krows; kr += split) {
        const int n = kr / s.Kh, i = kr - n * s.Kh;
        const float* p0 = xt + n * cs + (size_t)i * xld;
        const float* p1 = p0 + down;
        const int e0 = kr * s.Kw;
#pragma unroll 2
        for (int j = 0; j < s.Kw; ++j) {
          float4 wv;
          if constexpr (STAGED) {
            wv = reinterpret_cast<const float4*>(smem)[(e0 + j) * cgs + cgl];
          } else {
            const int m = m0 + cgl * CT;
            const float* wm = w + (size_t)m * eta + e0 + j;
            wv.x = wm[0];
            wv.y = m + 1 < s.M ? wm[(size_t)eta] : 0.f;
            wv.z = m + 2 < s.M ? wm[(size_t)2 * eta] : 0.f;
            wv.w = m + 3 < s.M ? wm[(size_t)3 * eta] : 0.f;
          }
          const float xv[4] = {p0[j], p0[j + right], p1[j], p1[j + right]};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[p][0] = fmaf(xv[p], wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv[p], wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv[p], wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv[p], wv.w, acc[p][3]);
          }
        }
      }
    }
    // the split lanes of a tile are adjacent: fold them onto the first
    for (int o = split >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < CT; ++c)
          acc[p][c] += __shfl_down_sync(FULL, acc[p][c], o);
    }
    if (live && part == 0) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int m = m0 + cgl * CT + c;
        if (m >= s.M) break;
        float a[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          a[p] = acc[p][c];
          if (scale != nullptr) a[p] = __fmul_rn(a[p], scale[m]);
          if (bias != nullptr) a[p] = __fadd_rn(a[p], bias[m]);
        }
        const size_t plane = (size_t)(b0 + img) * s.M + m;
        if constexpr (POOL) {
          // relu floor: max(relu(a), ...) == max(0, a, ...); a missing
          // point of a ragged tile repeats one that exists
          float v = 0.f;
#pragma unroll
          for (int p = 0; p < 4; ++p) v = fmaxf(v, a[p]);
          out[(plane * s.Po + ph0 + phl) * s.Qo + pw] = v;
        } else {
          // scalar stores: pairing a row's two points into one float2
          // took 15% longer at conv2, B = 1024
          float* o0 = out + (plane * s.Ho + oh) * s.Wo + ow;
          o0[0] = a[0];
          if (right) o0[1] = a[1];
          if (down_rows) {
            o0[s.Wo] = a[2];
            if (right) o0[s.Wo + 1] = a[3];
          }
        }
      }
    }
  }
}

// Host side: launch on `stream`, return a CUDA error code (0 = launched).
// cpb is a multiple of 4, split a power of two up to 32, threads a
// multiple of 32; smem is the staged slab's bytes, 0 to read device memory
// (repro_torch/ops/tiling.py resolves and checks all of them). `pad`
// (POOL only) pools an odd last row/column against -inf instead of
// dropping it.
template <bool POOL>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int B, int N, int H, int W, int M, int Kh, int Kw,
           int sh, int sw, int threads, int cpb, int band, int split, int ipb,
           int ld, int smem, int pad, void* stream) {
  const int Ho = (H - Kh) / sh + 1, Wo = (W - Kw) / sw + 1;
  const bool ragged = !POOL || pad;
  const Shape s{B, N, H, W, M, Kh, Kw, sh, sw, Ho, Wo,
                ragged ? (Ho + 1) / 2 : Ho / 2,
                ragged ? (Wo + 1) / 2 : Wo / 2, ragged ? 1 : 0};
  const long long grid = (long long)((B + ipb - 1) / ipb) *
                         ((M + cpb - 1) / cpb) * ((s.Po + band - 1) / band);
  cudaStream_t st = (cudaStream_t)stream;
  const float* args[4] = {(const float*)x, (const float*)w,
                          (const float*)scale, (const float*)bias};
  if (smem > 0) {
    // opt in to more than 48 KB once per device and size: never again
    // on a later launch (or inside a CUDA graph capture) that needs no more
    static int opted[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int& have = opted[dev & 63];
    if (smem > 48 * 1024 && smem > have) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel<true, POOL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
      have = smem;
    }
    kernel<true, POOL><<<(unsigned)grid, threads, smem, st>>>(
        args[0], args[1], args[2], args[3], (float*)out, s, cpb, band, split,
        ipb, ld);
  } else {
    kernel<false, POOL><<<(unsigned)grid, threads, 0, st>>>(
        args[0], args[1], args[2], args[3], (float*)out, s, cpb, band, split,
        ipb, ld);
  }
  return (int)cudaGetLastError();
}

}  // namespace conv_tile
