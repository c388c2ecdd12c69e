// qmatmul: int8 x int8 -> int32 GEMM with the per-row x per-column scale
// epilogue, (acc * xs[row]) * ws[col], f32 out. With raw != 0 the epilogue
// is skipped and out takes the int32 accumulator itself (a row-parallel
// shard's partial sum, reduced exactly across ranks before the scales).
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul/kernel.py
// (_qmatmul_kernel, launched by qmatmul_pallas).
//
// x is (M, K) and w (K, N), both row-major int8 as every caller passes
// them; nothing is packed ahead of the call. Integer sums are exact in any
// order, so both bodies below are bitwise equal to the plain version,
// whichever order they add in, and the epilogue keeps the reference's two
// roundings. repro_torch/ops/tiling.py picks the body by shape.
//
// Body 1, tensor-core tiles (tc_kernel; M >= 8, N >= 64). At the LMs'
// prefill shapes the card's bound is the int8 operations (1,979 TOP/s) or,
// below M of a few hundred, the bytes of w (3.35 TB/s); CUDA cores alone
// (__dp4a) reach neither. Design:
//  * A block owns a BM x 128 output tile (BM = 64 or 128; 8 warps, each
//    BM/2 x 32) and walks its K range in 64-byte steps through a ring of
//    4 shared-memory stages filled by 16-byte cp.async.cg copies, so the
//    loads of the next 3 steps stay in flight while the tensor cores work
//    on this one (3 stages were nowhere more than 3.5% ahead on an H100:
//    scripts/torch_kernel_probe.py --sweep). A chunk that is ragged (past
//    K, M or N) or not 16-byte aligned (K % 16 != 0, an unaligned view) is
//    loaded with byte loads instead, zero past the edge.
//  * The product is mma.sync.m16n8k32.row.col.s32.s8.s8.s32, int32 sums in
//    registers. Its B operand must be K-major, and w's rows are
//    N-contiguous, and ldmatrix.trans moves 16-bit elements only: so w's
//    stage lands as it lies (16-byte chunks swizzled by k / 4 so that the
//    next step reads without bank conflicts) and a transposition pass
//    turns each 4 k x 4 n byte block into four K-major words with eight
//    __byte_perm, into a [n][k] tile whose 80-byte rows keep both the
//    pass's stores and the ldmatrix fragment loads free of bank conflicts.
//  * Where the output tiles alone cannot fill the card, K is split across
//    blocks (gridDim.z); each block adds its int32 tile into a zeroed
//    buffer, and the last block of a tile to arrive applies the epilogue
//    (finish_tile); raw, the blocks add into the zeroed output.
//
// Body 0, split-K weight streaming (stream_kernel; decode's M < 8, and
// narrow N such as the CNN's fc). The bound is the bytes of w, read once.
// Design:
//  * A block takes MR rows (4, 8 or 16), a slice of `tile_n` columns and a
//    slice of K; the x rows of its slice sit in shared memory. Adjacent
//    threads take adjacent CW-byte words of a w row (CW = 64 / MR, so a
//    thread holds MR x CW = 64 int32 sums); a thread reads 4 consecutive k
//    rows of its word, byte-transposes them (__byte_perm) into CW words of
//    4 k of one column, and runs __dp4a on each against the matching x
//    word, broadcast from shared memory. Threads of one column word walk
//    the block's K slice in turn.
//  * K is split across blocks until the grid holds at least 2 x 132
//    blocks where the weight is larger than 32 KB; the threads of a
//    column word fold their sums with shuffles and shared-memory atomics,
//    and the block adds each sum into the entry's zeroed 64-bit slot that
//    counts the adds beside the exact sum: the block that completes the
//    count applies the epilogue (add_split), with no further round trip
//    (or the block writes the epilogue itself when K is not split).
//  * The tile's scales are loaded at the block's start (both bodies): no
//    epilogue waits on a round trip to memory.
// (Measured on an H100: the last-block epilogue costs decode two round
// trips that add_split saves, and add_split's 64-bit atomics, which return
// their value, cost body 1 a fifth of its time at M = 512; so each body
// keeps its own split.)
//
// The kernels allocate nothing: the wrapper zeroes the buffer on the
// current stream, so a launch is capturable in a CUDA graph. Shared memory
// over 48 KB is opted in to at the first launch that needs it (the
// warm-up, before any capture).
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;           // body 1: 8 warps a block
constexpr int STREAM_THREADS = 128;    // body 0: 4 warps a block
constexpr int TC_BN = 128;             // body 1: output columns a block
constexpr int TC_BK = 64;              // body 1: K bytes a stage
constexpr int TC_LD = TC_BK + 16;      // body 1: staged row stride, bytes
constexpr int TC_RAW = TC_BK * TC_BN;  // body 1: a stage of w as it lies
constexpr int STAGES = 4;              // body 1: cp.async stages in the ring

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float epilogue(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn((float)acc, xs), ws);
}

// the 4 x 4 byte block r[i] = bytes (w[k+i][n..n+3]) as o[j] = bytes
// (w[k..k+3][n+j]): 8 byte permutations
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1,
                                           unsigned r2, unsigned r3,
                                           unsigned& o0, unsigned& o1,
                                           unsigned& o2, unsigned& o3) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);
  const unsigned t1 = __byte_perm(r0, r1, 0x7362);
  const unsigned t2 = __byte_perm(r2, r3, 0x5140);
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);
  o0 = __byte_perm(t0, t2, 0x5410);
  o1 = __byte_perm(t0, t2, 0x7632);
  o2 = __byte_perm(t1, t3, 0x5410);
  o3 = __byte_perm(t1, t3, 0x7632);
}

// 16 bytes from global into shared: one cp.async where all 16 are in range
// and the source is 16-byte aligned, else byte loads, zero past `valid`
__device__ __forceinline__ void stage16(uint8_t* dst, const int8_t* src,
                                        int valid) {
  if (valid >= 16 && ((uintptr_t)src & 15) == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  } else {
    unsigned v0 = 0, v1 = 0, v2 = 0, v3 = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const unsigned byte = b < valid ? (unsigned)(uint8_t)src[b] : 0u;
      const unsigned sh = byte << (8 * (b & 3));
      if (b < 4) v0 |= sh;
      else if (b < 8) v1 |= sh;
      else if (b < 12) v2 |= sh;
      else v3 |= sh;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(v0, v1, v2, v3);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The scales of a tile's rows (r0.., at most 128) and columns (c0..,
// at most 128): loaded into registers (entries tid and tid + blockDim.x of
// rows then columns) at the block's start, stored into shared memory
// before its first barrier, so that no epilogue waits on their loads.
__device__ __forceinline__ void load_scales(float (&v)[2],
                                            const float* __restrict__ xs,
                                            const float* __restrict__ ws,
                                            int M, int N, int r0, int rows,
                                            int c0, int cols) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    const int c = c0 + i - rows;
    v[u] = i < rows ? (r0 + i < M ? xs[r0 + i] : 0.f)
                    : (i < rows + cols && c < N ? ws[c] : 0.f);
  }
}

__device__ __forceinline__ void store_scales(const float (&v)[2], float* sx,
                                             float* sw, int rows, int cols) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < rows) sx[i] = v[u];
    else if (i < rows + cols) sw[i - rows] = v[u];
  }
}

// Body 0's split: a block adds its sum v of an output entry into the
// entry's zeroed 64-bit slot as 2^48 + v: the top 16 bits count the blocks
// that have added (gridDim.z < 2^16), the low 48 hold their exact sum
// (|sum| < splits x 2^31 <= 2^47). The block whose add completes the
// count applies the epilogue to the sum's low 32 bits, the int32 sum.
__device__ __forceinline__ void add_split(unsigned long long* slot, int v,
                                          float* out, float xs, float ws) {
  const unsigned long long add =
      (1ull << 48) + (unsigned long long)(long long)v;
  const unsigned long long now = atomicAdd(slot, add) + add;
  if ((now + (1ull << 47)) >> 48 == gridDim.z)
    *out = epilogue((int)(unsigned)now, xs, ws);
}

// Body 1's split: every block adds its int32 tile into a zeroed buffer
// (fire-and-forget atomics, far cheaper than add_split's at a tile's 8,192
// to 16,384 entries); the last block of a tile to arrive, by its zeroed
// counter, applies the epilogue to the tile (rows r0.., cols c0..) from
// the buffer into out, with the scales staged in sx and sw.
__device__ void finish_tile(const int* __restrict__ acc,
                            unsigned* __restrict__ cnt,
                            float* __restrict__ out, const float* sx,
                            const float* sw, int M, int N, int r0, int rows,
                            int c0, int cols, int tile) {
  __shared__ unsigned last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(cnt + tile, 1u) == gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // eight entries a thread a round, every load in flight before a store
  constexpr int U = 8;
  for (int e0 = threadIdx.x; e0 < rows * cols; e0 += U * blockDim.x) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = r0 + e / cols, c = c0 + e % cols;
      v[u] = e < rows * cols && r < M && c < N
                 ? __ldcg(acc + (size_t)r * N + c) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      const int i = e / cols, j = e % cols;
      if (e < rows * cols && r0 + i < M && c0 + j < N)
        out[(size_t)(r0 + i) * N + c0 + j] = epilogue(v[u], sx[i], sw[j]);
    }
  }
}

// ----------------------------------------------------------- body 1

template <int BM>
__device__ __forceinline__ void tc_load(uint8_t* sa, uint8_t* sw,
                                        const int8_t* __restrict__ x,
                                        const int8_t* __restrict__ w,
                                        int M, int N, int K, int m0, int n0,
                                        int kt) {
  const int k0 = kt * TC_BK;
  // x: BM rows x 4 chunks of 16 bytes, at the padded row stride
#pragma unroll
  for (int q = threadIdx.x; q < BM * 4; q += THREADS) {
    const int r = q >> 2, c = q & 3;
    const int gm = m0 + r, gk = k0 + 16 * c;
    stage16(sa + r * TC_LD + 16 * c, x + (size_t)gm * K + gk,
            gm < M ? K - gk : 0);
  }
  // w: 64 rows x 8 chunks as they lie, chunk c of row r at c ^ (r / 4 % 8)
#pragma unroll
  for (int q = threadIdx.x; q < TC_BK * 8; q += THREADS) {
    const int r = q >> 3, c = q & 7;
    const int gk = k0 + r, gn = n0 + 16 * c;
    stage16(sw + r * TC_BN + ((c ^ ((r >> 2) & 7)) << 4),
            w + (size_t)gk * N + gn, gk < K ? N - gn : 0);
  }
}

// the stage of w as it lies -> st[n][k], K-major words at the 80-byte
// stride. Each thread takes two 4 k x 4 n blocks; a warp reads 8 k-blocks
// x 4 n-words (distinct banks through the swizzle) and writes 4 n-words
// x 8 k-words, lanes with n-word & 2 writing their rows in the order 2,
// 3, 0, 1 so that no two lanes of a store share a bank.
__device__ __forceinline__ void tc_transpose(const uint8_t* raw,
                                             uint8_t* st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int al = lane & 3, bl = lane >> 2;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int p = 2 * warp + u, g = p & 7, h = p >> 3;
    const int a = 4 * g + al, b = 8 * h + bl;  // n = 4a.., k = 4b..
    unsigned r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const unsigned*>(
          raw + (4 * b + i) * TC_BN + ((g ^ bl) << 4) + 4 * al);
    unsigned o0, o1, o2, o3;
    transpose4(r[0], r[1], r[2], r[3], o0, o1, o2, o3);
    const int s = al & 2;
    if (s) {
      unsigned t = o0; o0 = o2; o2 = t;
      t = o1; o1 = o3; o3 = t;
    }
    uint8_t* row = st + 4 * a * TC_LD + 4 * b;
    *reinterpret_cast<unsigned*>(row + (0 ^ s) * TC_LD) = o0;
    *reinterpret_cast<unsigned*>(row + (1 ^ s) * TC_LD) = o1;
    *reinterpret_cast<unsigned*>(row + (2 ^ s) * TC_LD) = o2;
    *reinterpret_cast<unsigned*>(row + (3 ^ s) * TC_LD) = o3;
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
    tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ xs, const float* __restrict__ ws,
              void* __restrict__ out, int* __restrict__ acc,
              unsigned* __restrict__ cnt, int M, int N, int K, int kps,
              int raw) {
  constexpr int MT = BM / 32;  // m16 tiles a warp: its BM / 2 rows
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sx[BM], sw_[TC_BN];      // the tile's scales
  uint8_t* sa = smem;                       // STAGES x BM x TC_LD
  uint8_t* sw = sa + STAGES * BM * TC_LD;   // STAGES x TC_RAW, swizzled
  uint8_t* st = sw + STAGES * TC_RAW;       // TC_BN x TC_LD, K-major w
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TC_BN;
  const int ktiles = (K + TC_BK - 1) / TC_BK;
  const int kt0 = blockIdx.z * kps;
  const int nk = min(kps, ktiles - kt0);
  const bool split = gridDim.z > 1;
  float sv[2];  // this tile's scales, stored before the first barrier
  if (!raw) load_scales(sv, xs, ws, M, N, m0, BM, n0, TC_BN);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      tc_load<BM>(sa + s * BM * TC_LD, sw + s * TC_RAW, x, w, M, N, K, m0,
                  n0, kt0 + s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (!raw) store_scales(sv, sx, sw_, BM, TC_BN);
  int c[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0;

  for (int i = 0; i < nk; ++i) {
    const int slot = i % STAGES;
    // step i has landed, and every warp is done with step i - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    tc_transpose(sw + slot * TC_RAW, st);
    if (i + STAGES - 1 < nk) {
      const int ns = (i + STAGES - 1) % STAGES;
      tc_load<BM>(sa + ns * BM * TC_LD, sw + ns * TC_RAW, x, w, M, N, K, m0,
                  n0, kt0 + i + STAGES - 1);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    __syncthreads();
    const uint8_t* a_s = sa + slot * BM * TC_LD;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned af[MT][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], a_s + (wm * (BM / 2) + 16 * mt + (lane & 15)) *
                                      TC_LD + 32 * ks + 16 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, st + (wn * 32 + 8 * (2 * np + (lane >> 4)) +
                             (lane & 7)) * TC_LD +
                           32 * ks + 16 * ((lane >> 3) & 1));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(c[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the scales are staged even where K is empty

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * (BM / 2) + 16 * mt + (lane >> 2) +
                        8 * (e >> 1);
        const int col = n0 + wn * 32 + 8 * nt + 2 * (lane & 3) + (e & 1);
        if (row < M && col < N) {
          const size_t idx = (size_t)row * N + col;
          const int v = c[mt][nt][e];
          if (split) {
            atomicAdd((raw ? reinterpret_cast<int*>(out) : acc) + idx, v);
          } else if (raw) {
            reinterpret_cast<int*>(out)[idx] = v;
          } else {
            reinterpret_cast<float*>(out)[idx] = epilogue(
                v, sx[row - m0], sw_[col - n0]);
          }
        }
      }
  if (split && !raw)
    finish_tile(acc, cnt, reinterpret_cast<float*>(out), sx, sw_, M, N, m0,
                BM, n0, TC_BN, blockIdx.y * gridDim.x + blockIdx.x);
}

// ----------------------------------------------------------- body 0

// CW bytes of one w row as CW / 4 words
template <int CW>
__device__ __forceinline__ void load_word(unsigned (&v)[CW / 4],
                                          const int8_t* p) {
  if constexpr (CW == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (CW == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// The block's x slice (MR rows x kpad bytes, zero past M and past the
// slice) into shared memory in V-byte words (V = 16 or 4 where every row
// of the slice starts V-aligned, else bytes); each thread's loads of a
// round are all in flight before its stores.
template <int MR, int V>
__device__ __forceinline__ void stage_x(uint8_t* xsm,
                                        const int8_t* __restrict__ x, int M,
                                        int K, int m0, int k0, int kn,
                                        int kpad) {
  using W = typename std::conditional<
      V == 16, uint4, typename std::conditional<V == 4, unsigned,
                                                uint8_t>::type>::type;
  constexpr int U = V == 1 ? 16 : 4;  // words a thread a round
  const int per_row = (kpad + V - 1) / V, total = MR * per_row;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * STREAM_THREADS) {
    W v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * STREAM_THREADS;
      const int r = e / per_row, q = e - r * per_row;
      if (e < total && m0 + r < M && q * V < kn) {
        v[u] = *reinterpret_cast<const W*>(x + (size_t)(m0 + r) * K + k0 +
                                           q * V);
      } else {
        v[u] = W{};
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * STREAM_THREADS;
      if (e < total) {
        const int r = e / per_row, q = e - r * per_row;
        *reinterpret_cast<W*>(xsm + r * kpad + q * V) = v[u];
      }
    }
  }
}

template <int MR>
__global__ void __launch_bounds__(STREAM_THREADS)
    stream_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  void* __restrict__ out,
                  unsigned long long* __restrict__ acc, int M, int N, int K,
                  int tile_n, int kslice, int wvec, int xvec, int raw) {
  constexpr int CW = 64 / MR;  // columns a thread: MR x CW = 64 sums
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sx[MR], sw_[TC_BN];   // the tile's scales
  const int kpad = (kslice + 3) & ~3;
  uint8_t* xsm = smem;                                     // MR x kpad
  int* sacc = reinterpret_cast<int*>(smem + MR * kpad);    // MR x tile_n
  const int tid = threadIdx.x, lane = tid & 31;
  const int cl = tile_n / CW;  // threads across the slice: a power of 2
  const int m0 = blockIdx.y * MR, n0 = blockIdx.x * tile_n;
  const int k0 = blockIdx.z * kslice, kn = min(kslice, K - k0);

  const bool split = gridDim.z > 1;
  float sv[2];  // this tile's scales, stored before x's barrier
  if (!raw) load_scales(sv, xs, ws, M, N, m0, MR, n0, tile_n);
  for (int e = tid; e < MR * tile_n; e += STREAM_THREADS) sacc[e] = 0;
  if (xvec == 16) {
    stage_x<MR, 16>(xsm, x, M, K, m0, k0, kn, kpad);
  } else if (xvec == 4) {
    stage_x<MR, 4>(xsm, x, M, K, m0, k0, kn, kpad);
  } else {
    stage_x<MR, 1>(xsm, x, M, K, m0, k0, kn, kpad);
  }
  if (!raw) store_scales(sv, sx, sw_, MR, tile_n);
  __syncthreads();

  const int c = tid % cl, kl = STREAM_THREADS / cl;
  const int col = n0 + CW * c;
  const int8_t* wc = w + (size_t)k0 * N + col;
  const bool vec = wvec && col < N;  // N % CW == 0: the word is whole
  int a[MR][CW];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < CW; ++j) a[m][j] = 0;
  const int groups = (kn + 3) / 4;
#pragma unroll 2
  for (int g = tid / cl; g < groups; g += kl) {
    const int k = 4 * g;
    unsigned t[CW];  // t[j]: w[k..k+3][col + j]
    if (vec) {
      unsigned rw[4][CW / 4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k + i < kn) {
          load_word<CW>(rw[i], wc + (size_t)(k + i) * N);
        } else {
#pragma unroll
          for (int q = 0; q < CW / 4; ++q) rw[i][q] = 0;
        }
      }
#pragma unroll
      for (int q = 0; q < CW / 4; ++q)
        transpose4(rw[0][q], rw[1][q], rw[2][q], rw[3][q], t[4 * q],
                   t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        unsigned v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < kn && col + j < N)
            v |= (unsigned)(uint8_t)wc[(size_t)(k + i) * N + j] << (8 * i);
        t[j] = v;
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int xv = *reinterpret_cast<const int*>(xsm + m * kpad + k);
#pragma unroll
      for (int j = 0; j < CW; ++j) a[m][j] = __dp4a(xv, (int)t[j], a[m][j]);
    }
  }
  // lanes l and l + cl share a column word: fold a warp's, then one lane
  // a word adds them into the block's sums
  for (int o = cl; o < 32; o <<= 1) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < CW; ++j)
        a[m][j] += __shfl_xor_sync(FULL, a[m][j], o);
  }
  if (lane < cl) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < CW; ++j)
        atomicAdd(sacc + m * tile_n + CW * c + j, a[m][j]);
  }
  __syncthreads();

#pragma unroll 4
  for (int e = tid; e < MR * tile_n; e += STREAM_THREADS) {
    const int r = m0 + e / tile_n, cc = n0 + e % tile_n;
    if (r < M && cc < N) {
      const size_t idx = (size_t)r * N + cc;
      if (raw && split) {
        atomicAdd(reinterpret_cast<int*>(out) + idx, sacc[e]);
      } else if (raw) {
        reinterpret_cast<int*>(out)[idx] = sacc[e];
      } else if (split) {
        add_split(acc + idx, sacc[e], reinterpret_cast<float*>(out) + idx,
                  sx[r - m0], sw_[cc - n0]);
      } else {
        reinterpret_cast<float*>(out)[idx] = epilogue(sacc[e], sx[r - m0],
                                                      sw_[cc - n0]);
      }
    }
  }
}

// opt in to more than 48 KB of dynamic shared memory once per device,
// kernel and size: never again on a later launch (or inside a CUDA graph
// capture) that needs no more
int opt_in(const void* fn, int (&have)[64], int smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  int& h = have[dev & 63];
  if (smem <= h) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  h = smem;
  return 0;
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  void* out;
  void* scratch;
  int M, N, K;
};

template <int BM>
int launch_tc(const Args& a, int ksplit, int smem, int raw, cudaStream_t st) {
  static int have[64];
  if (int e = opt_in((const void*)tc_kernel<BM>, have, smem)) return e;
  int* acc = reinterpret_cast<int*>(a.scratch);
  const dim3 grid((a.N + TC_BN - 1) / TC_BN, (a.M + BM - 1) / BM,
                  a.K > 0 ? (a.K + ksplit - 1) / ksplit : 1);
  tc_kernel<BM><<<grid, THREADS, smem, st>>>(
      a.x, a.w, a.xs, a.ws, a.out, acc,
      acc ? reinterpret_cast<unsigned*>(acc + (size_t)a.M * a.N) : nullptr,
      a.M, a.N, a.K, ksplit / TC_BK, raw);
  return (int)cudaGetLastError();
}

template <int MR>
int launch_stream(const Args& a, int tile_n, int ksplit, int smem, int raw,
                  cudaStream_t st) {
  static int have[64];
  if (int e = opt_in((const void*)stream_kernel<MR>, have, smem)) return e;
  constexpr int CW = 64 / MR;
  const int wvec = ((uintptr_t)a.w % CW) == 0 && a.N % CW == 0;
  // x's slices start V-aligned where x, K and ksplit all are
  const auto fits = [&](int v) {
    return ((uintptr_t)a.x % v) == 0 && a.K % v == 0 && ksplit % v == 0;
  };
  const int xvec = fits(16) ? 16 : fits(4) ? 4 : 1;
  const dim3 grid((a.N + tile_n - 1) / tile_n, (a.M + MR - 1) / MR,
                  a.K > 0 ? (a.K + ksplit - 1) / ksplit : 1);
  stream_kernel<MR><<<grid, STREAM_THREADS, smem, st>>>(
      a.x, a.w, a.xs, a.ws, a.out,
      reinterpret_cast<unsigned long long*>(a.scratch), a.M, a.N, a.K,
      tile_n, ksplit, wvec, xvec, raw);
  return (int)cudaGetLastError();
}

}  // namespace

// Host side: launch on `stream`, return a CUDA error code (0 = launched).
// body 1: tile_m in {64, 128}, ksplit a multiple of 64 (tile_n is not
// read: a tile is 128 columns); body 0: tile_m in {4, 8, 16}, tile_n in
// {16, 32, 64, 128}, ksplit a multiple of 4 (repro_torch/ops/tiling.py
// resolves and checks them, and smem). Where K is split (ksplit < K) with
// the epilogue, scratch is zeroed and holds, for body 1, M x N int32 sums
// and one arrival counter an output tile, for body 0, M x N 64-bit slots
// (add_split); raw's out is zeroed instead. Else scratch is not read.
// raw: out is int32 and takes the accumulator (xs and ws are not read).
// Anything else: an error code.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* xs,
                              const void* ws, void* out, void* scratch,
                              int M, int N, int K, int body, int tile_m,
                              int tile_n, int ksplit, int smem, int raw,
                              void* stream) {
  const Args a{(const int8_t*)x, (const int8_t*)w, (const float*)xs,
               (const float*)ws, out, scratch, M, N, K};
  cudaStream_t st = (cudaStream_t)stream;
  if (ksplit < 1) return (int)cudaErrorInvalidValue;
  if (body == 1 && ksplit % TC_BK == 0) {
    if (tile_m == 64) return launch_tc<64>(a, ksplit, smem, raw, st);
    if (tile_m == 128) return launch_tc<128>(a, ksplit, smem, raw, st);
  } else if (body == 0 && ksplit % 4 == 0) {
    if (tile_m == 4) return launch_stream<4>(a, tile_n, ksplit, smem, raw, st);
    if (tile_m == 8) return launch_stream<8>(a, tile_n, ksplit, smem, raw, st);
    if (tile_m == 16)
      return launch_stream<16>(a, tile_n, ksplit, smem, raw, st);
  }
  return (int)cudaErrorInvalidValue;
}
