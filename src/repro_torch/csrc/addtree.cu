// addtree: the paper's odd-even addition tree (section III.B.1, C2) over
// the last axis of an (R, eta) f32 matrix -> (R,).
//
// Replaces the Pallas TPU kernel repro/kernels/addtree/kernel.py
// (_addtree_kernel, launched by tree_reduce_sum_pallas).
//
// The summation order is the contract: level by level, pairs (0,1),
// (2,3), ... are added and an odd tail is forwarded to the END of the next
// level, widths eta -> ceil(eta/2) -> ... -> 1, so the result is bitwise
// equal to repro_torch.core.addtree.pairwise_sum. Adds are __fadd_rn only;
// no atomics, and no stock warp reduction (those pair lane i with lane
// i+16 first, which is another association).
//
// What bounds it on an H100: bytes. It reads 4*R*eta and writes 4*R bytes
// against R*(eta-1) fp32 adds; at 3.35 TB/s and 33.5 T adds/s (half the
// 67 TFLOP/s FMA rate) the adds are never the limit.
//
// What this design does about it: it streams rows, many to a block, so
// block scheduling no longer sets the pace. Two facts about the odd-even
// tree make that possible: at level k every element but the last is the
// perfect binary tree of the aligned chunk x[i*2^k, (i+1)*2^k), and the
// last is the odd-even tree of the remainder (kernels/addtree/ref.py
// restates the kernel's order that way and the tests hold it bitwise).
//  * Short rows (eta <= short_eta): one thread per row. The block copies
//    its tile of `rows` contiguous rows into shared memory with coalesced
//    loads (16-byte loads where eta is odd and the tile aligned), with the
//    row stride padded to an odd number of words so a warp's 32 rows sit
//    in 32 banks; each thread then runs the levels in place inside its
//    own row and the block stores its tile of sums coalesced.
//  * Long rows: `row_lanes` lanes per row, a half-warp (two rows a warp)
//    where the rows are few, a whole warp where they fill the card many
//    times over; no __syncthreads(). A lane loads one float4 (level 2 of
//    its aligned 4-chunk: (a+b)+(c+d)) where eta*4 is a multiple of 16
//    and the matrix is 16-byte aligned, else one float (level 0), up to
//    nine loads in flight per lane. Four shuffles down by 1, 2, 4 and 8
//    lanes add each element to its right-hand neighbour: adjacent chunks
//    first, which is the tree's own order, up to level 6 (or 4). Where a
//    half-warp's row took one batch of loads, its lane 0 now holds that
//    whole level and finishes the tree in registers; otherwise lanes 0
//    and 16 put it into the row's slice of shared memory, ceil(eta/16)
//    floats at most, and the row's lanes finish the levels there in
//    place, __syncwarp() between a round's reads and its writes. Half-
//    warps put the paper's conv2 product matrix at B = 8 (10,240 rows) on
//    the card in one wave of resident warps.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// loads in flight per lane on the long path: nine 16-byte loads cover a
// half-warp's row of eta <= 576 (the paper's conv2 eta = 540) in one batch
constexpr int UNROLL = 9;

__global__ void addtree_short(const float* __restrict__ x,
                              float* __restrict__ out, int R, int eta,
                              int rows) {
  extern __shared__ __align__(16) float tile[];  // rows * (eta | 1) floats
  const int stride = eta | 1;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, (long long)R - r0);
  const int n = nrows * eta;
  const float* src = x + r0 * eta;
  if (stride == eta && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // odd eta: the tile's layout in shared memory is its layout in memory
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int v = threadIdx.x; v < n4; v += blockDim.x) t4[v] = s4[v];
    for (int e = (n4 << 2) + threadIdx.x; e < n; e += blockDim.x) {
      tile[e] = src[e];
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int row = e / eta;
      tile[row * stride + (e - row * eta)] = src[e];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
    float* p = tile + t * stride;
    // in place: step i reads p[2i], p[2i+1] before it writes p[i]
    for (int w = eta; w > 1; w = (w + 1) >> 1) {
      const int half = w >> 1;
      for (int i = 0; i < half; ++i) p[i] = __fadd_rn(p[2 * i], p[2 * i + 1]);
      if (w & 1) p[half] = p[w - 1];
    }
    out[r0 + t] = p[0];
  }
}

__device__ __forceinline__ float tree4(float4 q) {
  return __fadd_rn(__fadd_rn(q.x, q.y), __fadd_rn(q.z, q.w));
}

// L lanes a row (16 or 32), 32 / L rows a warp at once
template <int L>
__global__ void addtree_long(const float* __restrict__ x,
                             float* __restrict__ out, int R, int eta,
                             int rows, int slice) {
  constexpr int G = 32 / L;
  extern __shared__ __align__(16) float buf[];  // G * warps * slice floats
  const int lane = threadIdx.x & (L - 1);        // lane within the row
  const int sub = (threadIdx.x & 31) / L;        // the warp's row
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* s = buf + (G * warp + sub) * slice;
  const bool vec = (eta & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int n = vec ? eta >> 2 : eta;  // width of the level a lane loads
  const int wk = (n + 15) >> 4;        // width four levels up
  // a half-warp's row of one batch: its lane 0 ends up holding all wk
  // elements of that level, so the tree finishes in its registers
  const bool in_regs = L == 16 && n <= 16 * UNROLL;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long rend = min(r0 + rows, (long long)R);
  // the trip count is the warp's, so every lane reaches every shuffle and
  // __syncwarp()
  for (long long rp = r0 + G * warp; rp < rend; rp += G * warps) {
    const long long r = rp + sub;
    const int nr = r < rend ? n : 0;   // a missing row loads nothing
    const float* row = x + r * eta;
    float v[UNROLL];
    for (int base = 0; base < n; base += L * UNROLL) {
      if (vec) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        float4 q[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = base + u * L + lane;
          q[u] = j < nr ? row4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = tree4(q[u]);
      } else {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = base + u * L + lane;
          v[u] = j < nr ? row[j] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int b = base + u * L;
        if (b >= n) break;               // the same for the whole warp
        const int j = b + lane;
        // lane j (a multiple of 2d) holds the element of its chunk; its
        // right-hand neighbour exists while j + d < n (odd tail forwarded)
#pragma unroll
        for (int d = 1; d < 16; d <<= 1) {
          const float o = __shfl_down_sync(FULL, v[u], d);
          if (j + d < n) v[u] = __fadd_rn(v[u], o);
        }
        if (!in_regs && (lane & 15) == 0 && j < n) s[j >> 4] = v[u];
      }
    }
    if (in_regs) {
      // v[u] of lane 0 is element u of the level: the odd-even levels in
      // place, w -> ceil(w/2), pair i read before it is written
      int w = wk;
#pragma unroll
      for (int lvl = 0; (1 << lvl) < UNROLL; ++lvl) {
#pragma unroll
        for (int i = 0; i < (UNROLL + 1) / 2; ++i) {
          if (2 * i + 1 < w) {
            v[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
          } else if (2 * i < w) {
            v[i] = v[2 * i];
          }
        }
        w = (w + 1) >> 1;
      }
      if (lane == 0 && r < rend) out[r] = v[0];
      continue;
    }
    __syncwarp();
    for (int w = wk; w > 1; w = (w + 1) >> 1) {
      const int pairs = w >> 1;
      // rounds of L pairs; round k reads [2Lk, 2Lk+2L) and writes
      // [Lk, Lk+L), so no later round reads what an earlier one wrote
      for (int b = 0; b < pairs; b += L) {
        const int i = b + lane;
        float t = 0.f;
        if (i < pairs) t = __fadd_rn(s[2 * i], s[2 * i + 1]);
        __syncwarp();
        if (i < pairs) s[i] = t;
        __syncwarp();
      }
      if ((w & 1) && lane == 0) s[pairs] = s[w - 1];
      __syncwarp();
    }
    if (lane == 0 && r < rend) out[r] = s[0];
    __syncwarp();
  }
}

template <int L>
int launch_long(const float* x, float* out, int R, int eta, int threads,
                int rows, unsigned grid, cudaStream_t st) {
  const int slice = (eta + 15) / 16;
  const size_t smem = (size_t)(threads / L) * slice * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        addtree_long<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  addtree_long<L><<<grid, threads, smem, st>>>(x, out, R, eta, rows, slice);
  return 0;
}

}  // namespace

// Host side: launch on `stream`, return a CUDA error code (0 = launched).
extern "C" int addtree_launch(const void* x, void* out, int R, int eta,
                              int threads, int rows, int short_eta,
                              int row_lanes, void* stream) {
  const unsigned grid = (unsigned)((R + (long long)rows - 1) / rows);
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (eta <= short_eta) {
    const size_t smem = (size_t)rows * (eta | 1) * sizeof(float);
    if (smem > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(
          addtree_short, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
    }
    if (err == 0) {
      addtree_short<<<grid, threads, smem, st>>>((const float*)x,
                                                 (float*)out, R, eta, rows);
    }
  } else if (row_lanes == 16) {
    err = launch_long<16>((const float*)x, (float*)out, R, eta, threads,
                          rows, grid, st);
  } else {
    err = launch_long<32>((const float*)x, (float*)out, R, eta, threads,
                          rows, grid, st);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
