// addtree: the paper's odd-even addition tree (section III.B.1, C2) over
// the last axis of an (R, eta) f32 matrix -> (R,).
//
// Replaces the Pallas TPU kernel repro/kernels/addtree/kernel.py
// (_addtree_kernel, launched by tree_reduce_sum_pallas).
//
// The summation order is the contract: level by level, pairs (0,1),
// (2,3), ... are added and an odd tail is forwarded to the END of the next
// level, widths eta -> ceil(eta/2) -> ... -> 1, so the result is bitwise
// equal to repro_torch.core.addtree.pairwise_sum. A stock warp or block
// reduction pairs lane i with lane i+16 and would not be.
//
// What bounds it on an H100: bytes. It reads 4*R*eta and writes 4*R bytes
// against R*(eta-1) fp32 adds; at 3.35 TB/s and 33.5 T adds/s (half the
// 67 TFLOP/s FMA rate) the adds are never the limit.
//
// What this design does about it: little yet. One block per row, so the
// grid covers R exactly and nothing is masked or padded; the row is read
// once, coalesced, into shared memory, where two ping-pong buffers of eta
// floats hold one level each, one __syncthreads() per level. A block that
// reduces a short row (eta = 9: 28 of its 32 threads idle, a few dozen
// instructions) costs little more than its scheduling, which then sets
// the pace instead of the bytes; packing several short rows into one warp
// is later work. Dynamic shared memory caps eta at 6144 (2 * 4 * 6144
// bytes = the 48 KB a block gets without opting in to more); the wrapper
// refuses wider rows.
#include <cuda_runtime.h>

__global__ void addtree_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int eta) {
  extern __shared__ float buf[];  // 2 * eta floats
  float* src = buf;
  float* dst = buf + eta;
  const float* row = x + (size_t)blockIdx.x * eta;
  for (int j = threadIdx.x; j < eta; j += blockDim.x) src[j] = row[j];
  __syncthreads();
  for (int w = eta; w > 1; w = (w + 1) / 2) {
    const int half = w / 2;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      dst[i] = __fadd_rn(src[2 * i], src[2 * i + 1]);
    }
    if ((w & 1) && threadIdx.x == 0) dst[half] = src[w - 1];
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = src[0];
}

extern "C" int addtree_launch(const void* x, void* out, int R, int eta,
                              int threads, void* stream) {
  const size_t smem = 2 * (size_t)eta * sizeof(float);
  addtree_kernel<<<(unsigned)R, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, eta);
  return (int)cudaGetLastError();
}
