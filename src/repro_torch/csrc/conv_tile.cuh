// Shared body of the fused_cwp and conv_window kernels: a VALID strided
// NCHW conv with one of two epilogues, in two routes.
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
// A tile is 2x2 conv points (one pooled output). At a ragged edge the
// missing points read the first point's window again (never past the band
// or past H) and are not stored; pooled, they repeat a point that exists,
// so the 2x2 max is that of the points that exist.
//
// The fp32 route (`kernel`: fp32 operands; also fp32 codes, Q8.8 values).
// A block owns `ipb` images, a group of `cpb` output channels and a band
// of `band` tile rows. It stages the group's weights, transposed to
// [eta][cpb], and the input band (N channels x the band's rows + the
// Kh - sh halo x W, at a row stride `ld` padded so a warp's 2x2 windows
// fall in distinct banks) in shared memory with 4-byte cp.async copies in
// one commit group (4 groups over input channels, the FMAs of each
// starting once it landed, ran 10-14% behind one on an H100 for their
// barriers), the weights' rows padded by 4 floats so the transposing copy
// hits 32 banks. A thread holds the 2x2
// conv points of one tile x 4 channels: 16 independent FMA chains. At
// stride 1 and the main path's kernel widths (3, 5, 6: the KW template)
// a kernel row's KW + 1 columns of the tile's two rows and its KW weight
// float4s are all loaded ahead of its FMAs, each column serving two taps
// (16 FMAs for 3 loads a tap); otherwise a tap loads 4 inputs. Where the
// tiles cannot fill 132 SMs, `split` adjacent lanes (a power of two up to
// 32) share one tile, each taking every split-th kernel row; shuffles down
// combine their partials in a fixed order. Where even a one-row band of
// one channel group would not fit (huge N*W or kernels), the same loop
// reads from device memory instead (STAGED = false): no shape is refused.
//
// The int8 route (`s8_kernel`: int8 codes, card only). An implicit GEMM on
// mma.sync.m16n8k32 s8 tensor cores: rows are conv points, columns output
// channels (NT x 8 a block), depth eta' = N*Kh*Kw', with Kw padded to
// Kw' = 4*ceil(Kw/4) by zero weights so that the 4 consecutive k of an A
// fragment register are 4 consecutive input bytes of one kernel row
// (depth padded to 32 by zero weights too). Two 16-row MMA tiles take the
// four points of 8 tiles in the order (0,0) | (0,1) and (1,0) | (1,1), so
// a thread's accumulators hold a whole 2x2 window of 2 channels and the
// pooled epilogue stays in registers. A block of 8 warps owns `ips` items
// (an item: one image's band of `band` tile rows) and a channel group;
// the items' slabs (each channel's band rows, as they lie in memory, at
// the source's byte offset mod 4) and the raw weights land by 4-byte
// cp.async in one commit group. (A ring of stages, later items landing
// while the tensor cores work on earlier ones, tied or lost, by up to 40%,
// on an H100 at every served shape: a block's few microseconds of work
// leave a second stage nothing to hide.) The weights are then expanded in
// shared memory to [cpb][eta'] (K-major: one 32-bit load a B register),
// and an A register is one 4-byte window of the slab (two aligned loads
// and a funnel shift). int32 sums are exact, converted to fp32 exactly
// (|sum| <= eta * 128^2 < 2^24).
//
// Both routes spell the epilogue with the round-to-nearest intrinsics
// (__fadd_rn(__fmul_rn(acc, s), b)) so nvcc cannot contract it, as the
// reference's optimization barrier pins it. int8 codes and Q8.8 values
// make every partial sum exact (540 * 127^2 < 2^24), so either route and
// any order is bitwise there; fp32 moves within the stated 1e-5.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_tile {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CT = 4;      // fp32: output channels in a thread's tile
constexpr int S8_MAX_NT = 4;  // int8: 8-channel MMA columns a block
// int8: threads a block (8 warps: up to 4x ahead of fewer on an H100 at
// the served shapes)
constexpr int S8_THREADS = 256;
constexpr int S8_WARPS = S8_THREADS / 32;

struct Shape {
  // ragged: the tile grid covers an odd last conv row/column (Po =
  // ceil(Ho/2)); conv_window always, fused_cwp under odd='pad'
  int B, N, H, W, M, Kh, Kw, sh, sw, Ho, Wo, Po, Qo, ragged;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until this thread's copies have all landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ fp32 route

// KW: the kernel width at compile time (0: s.Kw at run time), so that a
// kernel row's loads are all issued ahead of its FMAs
template <bool STAGED, bool POOL, int KW>
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
  // stride) and the weights through ws ([eta][cpb + 4]) or w ([M][eta])
  const int cq = cpb / CT + 1;  // float4s a staged weight row
  const float* xs = xb;
  size_t cs = (size_t)s.H * s.W;
  int xld = s.W;
  if constexpr (STAGED) {
    // the weights, transposed to [eta][cpb + 4] (a channel past M is
    // zero), and the bands, in one commit group. A warp copies 8 taps x 4
    // channels: a 32-byte run of each of 4 weight rows, into 32 distinct
    // banks (the row stride, 4 floats past cpb, spreads the 8 taps over
    // them)
    const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const int cps = 4 * cq;
    for (int c = lane & 3; c < cpb; c += 4) {
      const float* wc = w + (size_t)(m0 + c) * eta;
      for (int e = (threadIdx.x >> 5) * 8 + (lane >> 2); e < eta;
           e += nwarps * 8) {
        if (m0 + c < s.M)
          cp_async4(smem + e * cps + c, wc + e);
        else
          smem[e * cps + c] = 0.f;
      }
    }
    // the bands: each channel of each image `rows` whole rows at row
    // stride ld in shared memory. A warp copies a row (two or more where a
    // row is under 32 words), its lanes along the row: the address
    // arithmetic is a row's, not an element's
    float* xsm = smem + (size_t)eta * cps;
    const int rpw = s.W < 32 ? 32 / s.W : 1;  // rows a warp takes at once
    const int sub = s.W < 32 ? lane / s.W : 0;
    const int col0 = lane - sub * s.W;
    const int nrows = nimg * s.N * rows;
    if (sub < rpw) {
      for (int row = (threadIdx.x >> 5) * rpw + sub; row < nrows;
           row += nwarps * rpw) {
        // q: the row's (image, channel) plane, img * N + n
        const int q = row / rows, r = row - q * rows;
        const float* src = xb + (size_t)q * cs + (size_t)r * s.W;
        float* dst = xsm + ((size_t)q * rows + r) * ld;
        for (int col = col0; col < s.W; col += 32)
          cp_async4(dst + col, src + col);
      }
    }
    cp_async_commit();
    xs = xsm;
    cs = (size_t)rows * ld;
    xld = ld;
  }

  const int cgs = cpb / CT;
  const int tiles = nimg * cgs * nph * s.Qo;
  const int part = threadIdx.x % split;
  const int per_round = blockDim.x / split;
  // a uniform trip count: every lane reaches the barriers and shuffles
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
    const float* xt = xs + (size_t)img * s.N * cs +
                      (size_t)(2 * phl * s.sh) * xld + ow * s.sw;
    const size_t down = (size_t)down_rows * xld;
    if (STAGED && t0 == 0) {
      // the weights and the bands have landed
      cp_async_wait_all();
      __syncthreads();
    }
    // the kernel rows, every split-th from the lane's own
    for (int kr = part; live && kr < s.N * s.Kh; kr += split) {
      const int n = kr / s.Kh, i = kr - n * s.Kh;
      const float* p0 = xt + n * cs + (size_t)i * xld;
      const float* p1 = p0 + down;
      const int e0 = kr * s.Kw;
      const float4* ws4 = reinterpret_cast<const float4*>(smem) + cgl;
      if (STAGED && KW > 0 && s.sw == 1) {
        // the kernel row's KW + 1 columns (the last where the tile's
        // right column exists) and its KW weight float4s, all loaded
        // ahead of the 16 x KW FMAs
        constexpr int KA = KW > 0 ? KW : 1;  // KW = 0 never gets here
        float r0[KA + 1], r1[KA + 1];
        float4 wv[KA];
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          r0[j] = p0[j];
          r1[j] = p1[j];
          wv[j] = ws4[(e0 + j) * cq];
        }
        r0[KA] = right ? p0[KA] : 0.f;
        r1[KA] = right ? p1[KA] : 0.f;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const float xv[4] = {r0[j], right ? r0[j + 1] : r0[j], r1[j],
                               right ? r1[j + 1] : r1[j]};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[p][0] = fmaf(xv[p], wv[j].x, acc[p][0]);
            acc[p][1] = fmaf(xv[p], wv[j].y, acc[p][1]);
            acc[p][2] = fmaf(xv[p], wv[j].z, acc[p][2]);
            acc[p][3] = fmaf(xv[p], wv[j].w, acc[p][3]);
          }
        }
      } else {
#pragma unroll 2
        for (int j = 0; j < s.Kw; ++j) {
          float4 wv;
          if constexpr (STAGED) {
            wv = ws4[(e0 + j) * cq];
          } else {
            const int m = m0 + cgl * CT;
            const float* wm = w + (size_t)m * eta + e0 + j;
            wv.x = wm[0];
            wv.y = m + 1 < s.M ? wm[(size_t)eta] : 0.f;
            wv.z = m + 2 < s.M ? wm[(size_t)2 * eta] : 0.f;
            wv.w = m + 3 < s.M ? wm[(size_t)3 * eta] : 0.f;
          }
          const float xv[4] = {p0[j], p0[j + right], p1[j],
                               p1[j + right]};
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
  if (STAGED && tiles == 0) cp_async_wait_all();  // nothing left in flight
}

// ------------------------------------------------------------ int8 route

// Geometry of the int8 route, shared by the kernel and its launcher
// (repro_torch/ops/tiling.py conv_s8_smem_bytes mirrors it).
struct S8Geom {
  int kwp;    // Kw padded to a multiple of 4
  int runs;   // 4-byte runs of real k: N * Kh * kwp / 4
  int etap;   // padded depth: 32 * ceil(4 * runs / 32)
  int ldw;    // bytes a weight row in shared memory: etap + 16
  int eta;    // N * Kh * Kw: bytes a raw weight row
  int cst;    // bytes a staged channel band: 16 * ceil((rows * W + 19) / 16)
  int wraw;   // bytes of the raw weights, 16 * ceil((8 * NT * eta + 4) /
              // 16), and at least the partial sums' 4096 * NT
  int cbase;  // bytes of the slab offsets: 16 * ceil(4 * items * N / 16)
};

// the int32 partial sums of warps sharing a unit's depth (when a stage
// has fewer 8-tile units than warps), in the raw weights' bytes once they
// are expanded: at most 4 units x 8*NT sums x 32 lanes
constexpr int S8_RED_UNITS = 4;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline S8Geom s8_geom(const Shape& s, int nt, int band,
                                          int items) {
  S8Geom g;
  g.kwp = round_up(s.Kw, 4);
  g.runs = s.N * s.Kh * (g.kwp / 4);
  g.etap = round_up(4 * g.runs, 32);
  g.ldw = g.etap + 16;
  g.eta = s.N * s.Kh * s.Kw;
  int rows = (2 * band - 1) * s.sh + s.Kh;
  if (rows > s.H) rows = s.H;
  g.cst = round_up(rows * s.W + 19, 16);
  g.wraw = round_up(8 * nt * g.eta + 4, 16);
  if (g.wraw < S8_RED_UNITS * 8 * nt * 32 * 4)
    g.wraw = S8_RED_UNITS * 8 * nt * 32 * 4;
  g.cbase = round_up(4 * items * s.N, 16);
  return g;
}

__host__ __device__ inline long long s8_smem(const Shape& s, int nt, int band,
                                             int items) {
  const S8Geom g = s8_geom(s, nt, band, items);
  return (long long)8 * nt * g.ldw + 8LL * (g.etap / 4) + g.wraw + g.cbase +
         (long long)items * s.N * g.cst;
}

// one 4-byte word of a staged run: a 4-byte cp.async where the whole word
// lies in the tensor [lo, hi), else its bytes that do, one by one (the
// word that straddles an unaligned tensor's first or last byte)
__device__ __forceinline__ void stage_word(unsigned char* dst,
                                           const int8_t* src,
                                           uintptr_t lo, uintptr_t hi) {
  const uintptr_t a = (uintptr_t)src;
  if (a >= lo && a + 4 <= hi) {
    cp_async4(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (a + e >= lo && a + e < hi) dst[e] = (unsigned char)src[e];
  }
}

// the 4 bytes at byte offset `a` of the slab: two aligned words and a
// funnel shift (the bytes after a run's last real k meet zero weights)
__device__ __forceinline__ unsigned gather4(const unsigned* slab, int a) {
  const unsigned lo = slab[a >> 2], hi = slab[(a >> 2) + 1];
  return __funnelshift_r(lo, hi, (a & 3) << 3);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool POOL, int NT>
__global__ void s8_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          float* __restrict__ out, Shape s, int band,
                          int ips) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int CPB = 8 * NT;
  const bool ragged = !POOL || s.ragged;
  const S8Geom g = s8_geom(s, NT, band, ips);
  const int groups = (s.M + CPB - 1) / CPB;
  const int bands = (s.Po + band - 1) / band;
  const int items = s.B * bands;
  const int m0 = (blockIdx.x % groups) * CPB;
  const int nm = min(CPB, s.M - m0);
  const int item0 = (blockIdx.x / groups) * ips;
  const int nitems = min(ips, items - item0);
  const int R = g.etap / 4;

  unsigned char* ws = sm;                                   // [CPB][ldw]
  int2* tbl = reinterpret_cast<int2*>(ws + CPB * g.ldw);    // [R]
  unsigned char* wraw = reinterpret_cast<unsigned char*>(tbl + R);
  int* cbase = reinterpret_cast<int*>(wraw + g.wraw);       // [items][N]
  unsigned char* slab = reinterpret_cast<unsigned char*>(cbase) + g.cbase;
  const uintptr_t x_lo = (uintptr_t)x,
                  x_hi = x_lo + (size_t)s.B * s.N * s.H * s.W;
  const uintptr_t w_lo = (uintptr_t)w, w_hi = w_lo + (size_t)s.M * g.eta;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // one commit group: the group's raw weights and the items' slabs
  const int8_t* wsrc = w + (size_t)m0 * g.eta;
  const int wsh = (int)((uintptr_t)wsrc & 3);
  const int words = (wsh + nm * g.eta + 3) / 4;
  for (int i = threadIdx.x; i < words; i += S8_THREADS)
    stage_word(wraw + 4 * i, wsrc - wsh + 4 * i, w_lo, w_hi);
  // a warp a channel band, its lanes along the band's words
  for (int t = warp; t < nitems * s.N; t += S8_WARPS) {
    const int n = t % s.N, li = t / s.N;
    const int it = item0 + li, img = it / bands, ph0 = (it % bands) * band;
    const int row0 = 2 * ph0 * s.sh;
    int rows = (2 * min(band, s.Po - ph0) - 1) * s.sh + s.Kh;
    if (ragged) rows = min(rows, s.H - row0);
    const int8_t* src = x + (((size_t)img * s.N + n) * s.H + row0) * s.W;
    const int sh = (int)((uintptr_t)src & 3);
    const int slot = li * s.N + n;
    if (lane == 0) cbase[slot] = slot * g.cst + sh;
    unsigned char* dst = slab + (size_t)slot * g.cst;
    for (int wi = lane; 4 * wi < sh + rows * s.W; wi += 32)
      stage_word(dst + 4 * wi, src - sh + 4 * wi, x_lo, x_hi);
  }
  cp_async_commit();
  // the run table: run r of the padded depth is (n, i, 4-byte column jq):
  // its bytes sit at i * W + 4 * jq of channel n's band from a point;
  // padding runs read channel 0 (their weights are zero)
  const int jqs = g.kwp / 4;
  for (int r = threadIdx.x; r < R; r += S8_THREADS) {
    int2 e = make_int2(0, 0);
    if (r < g.runs) {
      const int t2 = r / jqs, jq = r - t2 * jqs;
      e = make_int2(t2 / s.Kh, (t2 % s.Kh) * s.W + 4 * jq);
    }
    tbl[r] = e;
  }
  cp_async_wait_all();  // the raw weights and the slabs have landed
  __syncthreads();
  // the weights, expanded to [CPB][ldw] (a warp a channel row): word
  // (ml, r) holds run r's 4 bytes; past Kw, past the real depth and past
  // M they are zero
  unsigned* ws32 = reinterpret_cast<unsigned*>(ws);
  const int wpr = g.ldw / 4;
  for (int ml = warp; ml < CPB; ml += S8_WARPS) {
    for (int r = lane; r < wpr; r += 32) {
      unsigned v = 0;
      if (ml < nm && r < g.runs) {
        const int t2 = jqs == 1 ? r : r / jqs, j0 = 4 * (r - t2 * jqs);
        const unsigned char* src = wraw + wsh + ml * g.eta + t2 * s.Kw;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + e < s.Kw) v |= (unsigned)src[j0 + e] << (8 * e);
      }
      ws32[ml * wpr + r] = v;
    }
  }
  __syncthreads();
  const unsigned* slab32 = reinterpret_cast<const unsigned*>(slab);
  const int gq = lane >> 2, tig = lane & 3;
  const int upi = (band * s.Qo + 7) / 8;  // 8-tile units an item
  const int ksteps = g.etap / 32;
  // fewer 8-tile units than warps: `kparts` warps (at most the k-steps)
  // share a unit's depth, their int32 sums added exactly in shared memory
  // (then one round: units * kparts <= warps, so units <= S8_RED_UNITS).
  // The raw weights are dead then, and their bytes hold the sums, zeroed
  const int units = nitems * upi;
  const int kparts =
      ksteps > 1 && units < S8_WARPS ? min(S8_WARPS / units, ksteps) : 1;
  int* red = reinterpret_cast<int*>(wraw);
  if (kparts > 1) {
    for (int i = threadIdx.x; i < S8_RED_UNITS * 8 * NT * 32;
         i += S8_THREADS)
      red[i] = 0;
    __syncthreads();
  }
  const int per_round = S8_WARPS / kparts;
  for (int u0 = 0; u0 < units; u0 += per_round) {
    const int slotu = warp / kparts, part = warp - slotu * kparts;
    const int u = min(u0 + slotu, units - 1);
    const bool on = slotu < per_round && u0 + slotu < units;
    const int li = u / upi, tu = u % upi;
    const int it = item0 + li, img = it / bands;
    const int ph0 = (it % bands) * band;
    const int T = min(band, s.Po - ph0) * s.Qo;
    const int t = tu * 8 + gq;
    const bool live = t < T;
    const int tc = min(t, T - 1);
    const int phl = tc / s.Qo, pw = tc - phl * s.Qo;
    const int oh = 2 * (ph0 + phl), ow = 2 * pw;
    int down_rows = s.sh, right = s.sw;
    if (ragged) {
      if (oh + 1 >= s.Ho) down_rows = 0;
      if (ow + 1 >= s.Wo) right = 0;
    }
    // byte offsets of the tile's points from its channel band's start
    const int p00 = 2 * phl * s.sh * s.W + ow * s.sw;
    const int p01 = p00 + right, p10 = p00 + down_rows * s.W,
              p11 = p10 + right;
    const int* cb = cbase + li * s.N;
    int acc[2][NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][nt][e] = 0;
    for (int ks = part; on && ks < ksteps; ks += kparts) {
      const int2 r0 = tbl[ks * 8 + tig], r1 = tbl[ks * 8 + 4 + tig];
      const int b0 = cb[r0.x] + r0.y, b1 = cb[r1.x] + r1.y;
      // rows g and g+8 of MMA tile 0 are points (0,0) and (0,1) of tile
      // g, of MMA tile 1 points (1,0) and (1,1); k 4*tig.. and 16+4*tig..
      const unsigned a0[4] = {gather4(slab32, b0 + p00),
                              gather4(slab32, b0 + p01),
                              gather4(slab32, b1 + p00),
                              gather4(slab32, b1 + p01)};
      const unsigned a1[4] = {gather4(slab32, b0 + p10),
                              gather4(slab32, b0 + p11),
                              gather4(slab32, b1 + p10),
                              gather4(slab32, b1 + p11)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned* wr = ws32 + (nt * 8 + gq) * wpr + ks * 8 + tig;
        const unsigned bw0 = wr[0], bw1 = wr[4];
        mma_s8(acc[0][nt], a0, bw0, bw1);
        mma_s8(acc[1][nt], a1, bw0, bw1);
      }
    }
    if (kparts > 1) {
      int* rs = red + slotu * 8 * NT * 32 + lane;
      if (on) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              atomicAdd(rs + ((h * NT + nt) * 4 + e) * 32, acc[h][nt][e]);
      }
      __syncthreads();
      if (on && part == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[h][nt][e] = rs[((h * NT + nt) * 4 + e) * 32];
      }
    }
    if (live && on && part == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + nt * 8 + 2 * tig + e;
          if (m >= s.M) continue;
          // points (0,0), (0,1), (1,0), (1,1): exact in fp32
          float a[4] = {__int2float_rn(acc[0][nt][e]),
                        __int2float_rn(acc[0][nt][2 + e]),
                        __int2float_rn(acc[1][nt][e]),
                        __int2float_rn(acc[1][nt][2 + e])};
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (scale != nullptr) a[p] = __fmul_rn(a[p], scale[m]);
            if (bias != nullptr) a[p] = __fadd_rn(a[p], bias[m]);
          }
          const size_t plane = (size_t)img * s.M + m;
          if constexpr (POOL) {
            float v = 0.f;
#pragma unroll
            for (int p = 0; p < 4; ++p) v = fmaxf(v, a[p]);
            out[(plane * s.Po + ph0 + phl) * s.Qo + pw] = v;
          } else {
            // a row's two points as one 8-byte store where aligned
            float* o0 = out + (plane * s.Ho + oh) * s.Wo + ow;
            const bool pair = right && ((uintptr_t)o0 & 7) == 0 &&
                              (s.Wo & 1) == 0;
            if (pair) {
              *reinterpret_cast<float2*>(o0) = make_float2(a[0], a[1]);
            } else {
              o0[0] = a[0];
              if (right) o0[1] = a[1];
            }
            if (down_rows) {
              if (pair) {
                *reinterpret_cast<float2*>(o0 + s.Wo) =
                    make_float2(a[2], a[3]);
              } else {
                o0[s.Wo] = a[2];
                if (right) o0[s.Wo + 1] = a[3];
              }
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ launchers

inline Shape make_shape(bool pool, int B, int N, int H, int W, int M, int Kh,
                        int Kw, int sh, int sw, int pad) {
  const int Ho = (H - Kh) / sh + 1, Wo = (W - Kw) / sw + 1;
  const bool ragged = !pool || pad;
  return Shape{B, N, H, W, M, Kh, Kw, sh, sw, Ho, Wo,
               ragged ? (Ho + 1) / 2 : Ho / 2,
               ragged ? (Wo + 1) / 2 : Wo / 2, ragged ? 1 : 0};
}

// opt a kernel in to `smem` bytes of dynamic shared memory once per device
// and size: never again on a later launch (or inside a CUDA graph
// capture) that needs no more
template <typename K>
inline int opt_in(K kern, int smem, int (&opted)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& have = opted[dev & 63];
  if (smem > 48 * 1024 && smem > have) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    have = smem;
  }
  return 0;
}

template <bool POOL, int KW>
int launch_staged(const float* const (&args)[4], void* out, const Shape& s,
                  long long grid, int threads, int smem, int cpb, int band,
                  int split, int ipb, int ld, cudaStream_t st) {
  static int opted[64];
  const int e = opt_in(kernel<true, POOL, KW>, smem, opted);
  if (e != 0) return e;
  kernel<true, POOL, KW><<<(unsigned)grid, threads, smem, st>>>(
      args[0], args[1], args[2], args[3], (float*)out, s, cpb, band, split,
      ipb, ld);
  return (int)cudaGetLastError();
}

// fp32 route: launch on `stream`, return a CUDA error code (0 = launched).
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
  const Shape s = make_shape(POOL, B, N, H, W, M, Kh, Kw, sh, sw, pad);
  const long long grid = (long long)((B + ipb - 1) / ipb) *
                         ((M + cpb - 1) / cpb) * ((s.Po + band - 1) / band);
  cudaStream_t st = (cudaStream_t)stream;
  const float* args[4] = {(const float*)x, (const float*)w,
                          (const float*)scale, (const float*)bias};
  if (smem > 0) {
    // the kernel widths of the main path's convs at compile time
    switch (Kw) {
      case 3: return launch_staged<POOL, 3>(args, out, s, grid, threads,
                                            smem, cpb, band, split, ipb, ld,
                                            st);
      case 5: return launch_staged<POOL, 5>(args, out, s, grid, threads,
                                            smem, cpb, band, split, ipb, ld,
                                            st);
      case 6: return launch_staged<POOL, 6>(args, out, s, grid, threads,
                                            smem, cpb, band, split, ipb, ld,
                                            st);
      default: return launch_staged<POOL, 0>(args, out, s, grid, threads,
                                             smem, cpb, band, split, ipb,
                                             ld, st);
    }
  }
  kernel<false, POOL, 0><<<(unsigned)grid, threads, 0, st>>>(
      args[0], args[1], args[2], args[3], (float*)out, s, cpb, band, split,
      ipb, ld);
  return (int)cudaGetLastError();
}

template <bool POOL, int NT>
int launch_s8_nt(const Shape& s, const int8_t* x, const int8_t* w,
                 const float* scale, const float* bias, float* out,
                 int band, int ips, int smem, cudaStream_t st) {
  static int opted[64];
  const int e = opt_in(s8_kernel<POOL, NT>, smem, opted);
  if (e != 0) return e;
  const int groups = (s.M + 8 * NT - 1) / (8 * NT);
  const long long grid =
      ((long long)s.B * ((s.Po + band - 1) / band) + ips - 1) / ips * groups;
  s8_kernel<POOL, NT><<<(unsigned)grid, S8_THREADS, smem, st>>>(
      x, w, scale, bias, out, s, band, ips);
  return (int)cudaGetLastError();
}

// int8 route: x (B, N, H, W) and w (M, N, Kh, Kw) int8 codes, any byte
// alignment; cpb 8, 16, 24 or 32 output channels a block, `band` tile
// rows an item, `ips` items a block; smem must be s8_smem's bytes
// (tiling.py conv_s8_tiles computes both). Returns a CUDA error code (0 =
// launched; cudaErrorInvalidValue for keys it does not take).
template <bool POOL>
int launch_s8(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int B, int N, int H, int W, int M,
              int Kh, int Kw, int sh, int sw, int cpb, int band, int ips,
              int smem, int pad, void* stream) {
  const Shape s = make_shape(POOL, B, N, H, W, M, Kh, Kw, sh, sw, pad);
  const int nt = cpb / 8;
  if (cpb % 8 || nt < 1 || nt > S8_MAX_NT || band < 1 || ips < 1 ||
      smem != s8_smem(s, nt, band, ips))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* xc = (const int8_t*)x;
  const int8_t* wc = (const int8_t*)w;
  const float* sc = (const float*)scale;
  const float* bc = (const float*)bias;
  float* o = (float*)out;
  switch (nt) {
    case 1: return launch_s8_nt<POOL, 1>(s, xc, wc, sc, bc, o, band, ips,
                                         smem, st);
    case 2: return launch_s8_nt<POOL, 2>(s, xc, wc, sc, bc, o, band, ips,
                                         smem, st);
    case 3: return launch_s8_nt<POOL, 3>(s, xc, wc, sc, bc, o, band, ips,
                                         smem, st);
    default: return launch_s8_nt<POOL, 4>(s, xc, wc, sc, bc, o, band, ips,
                                          smem, st);
  }
}

}  // namespace conv_tile
