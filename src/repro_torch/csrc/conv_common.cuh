// Shared body of the conv_window and fused_cwp kernels.
//
// One thread computes one output element. The contraction is a sequential
// fp32 FMA loop over eta = N*Kh*Kw in the reference's (N, Kh, Kw) feature
// order, reading the input window straight from device memory (VALID
// padding, strided) and the weight row w[m, :] from the (M, N, Kh, Kw)
// layout, which is already the (M, eta) matrix the Pallas kernels contract.
// No tensor cores: TF32 would break the fp32 parity the reference pins.
//
// The requant epilogue is spelled with the round-to-nearest intrinsics so
// nvcc cannot contract it into an FMA: acc*scale rounds, then +bias
// rounds, exactly as the reference's optimization barrier pins it.
#pragma once

#include <cuda_runtime.h>

struct ConvShape {
  int B, N, H, W, M, Kh, Kw, sh, sw, Ho, Wo;
};

__device__ __forceinline__ float conv_point(const float* __restrict__ x,
                                            const float* __restrict__ w,
                                            const ConvShape& s, int b, int m,
                                            int oh, int ow) {
  const float* xw = x + (size_t)b * s.N * s.H * s.W +
                    (size_t)oh * s.sh * s.W + (size_t)ow * s.sw;
  const float* wm = w + (size_t)m * s.N * s.Kh * s.Kw;
  float acc = 0.f;
  for (int n = 0; n < s.N; ++n) {
    const float* xn = xw + (size_t)n * s.H * s.W;
    for (int i = 0; i < s.Kh; ++i) {
      const float* xr = xn + (size_t)i * s.W;
      for (int j = 0; j < s.Kw; ++j) {
        acc = fmaf(xr[j], *wm++, acc);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float conv_epilogue(float acc,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias,
                                               int m) {
  if (scale != nullptr) acc = __fmul_rn(acc, scale[m]);
  if (bias != nullptr) acc = __fadd_rn(acc, bias[m]);
  return acc;
}

// POOL=false: out (B, M, Ho, Wo) = epilogue(conv).
// POOL=true:  out (B, M, Ho/2, Wo/2) = max over the 2x2 window of
//             relu(epilogue(conv)); the pre-pool value lives in a register.
template <bool POOL>
__global__ void conv_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            float* __restrict__ out, ConvShape s) {
  const int oh_n = POOL ? s.Ho / 2 : s.Ho;
  const int ow_n = POOL ? s.Wo / 2 : s.Wo;
  const long long total = (long long)s.B * s.M * oh_n * ow_n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;  // the ragged last block
  const int ow = (int)(idx % ow_n);
  long long r = idx / ow_n;
  const int oh = (int)(r % oh_n);
  r /= oh_n;
  const int m = (int)(r % s.M);
  const int b = (int)(r / s.M);
  float v;
  if (POOL) {
    v = 0.f;  // relu floor: max(relu(a), ...) == max(0, a, ...)
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const float acc = conv_point(x, w, s, b, m, 2 * oh + dy, 2 * ow + dx);
        v = fmaxf(v, conv_epilogue(acc, scale, bias, m));
      }
    }
  } else {
    v = conv_epilogue(conv_point(x, w, s, b, m, oh, ow), scale, bias, m);
  }
  out[idx] = v;
}

// Host side: launch on `stream`, return cudaGetLastError() (0 = launched).
template <bool POOL>
int launch_conv(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int B, int N, int H, int W, int M,
                int Kh, int Kw, int sh, int sw, int threads, void* stream) {
  ConvShape s{B, N, H, W, M, Kh, Kw, sh, sw, (H - Kh) / sh + 1,
              (W - Kw) / sw + 1};
  const long long outs = (long long)B * M * (POOL ? (s.Ho / 2) * (s.Wo / 2)
                                                  : s.Ho * s.Wo);
  const long long blocks = (outs + threads - 1) / threads;
  conv_kernel<POOL><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)scale,
      (const float*)bias, (float*)out, s);
  return (int)cudaGetLastError();
}
