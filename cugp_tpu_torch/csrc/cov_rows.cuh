// Hoisted rows and norms, shared by cov.cu (the covariance tile) and
// cov_matvec.cu (the fused matvec): both kernels run a pre-pass that
// writes each row of lengthscale-scaled X padded to a multiple of 4
// features (so a row comes in as float4 loads) and its half squared norm
// h = s / 2, summed in the cross term's fmaf order (start4, then fma4 a
// group of 4 features at a time). So cross_ii == s_i bitwise and the rbf
// exponent (cross - h_i) - h_j on a square build's diagonal is exactly 0.
// For rbf the rows are scaled by sqrt(log2 e) as well: the cross term and
// the norms come out in log2 units and each entry is one ex2.

#pragma once

#include <cuda_runtime.h>

#include "cov_epilogue.cuh"

namespace cugp {

constexpr float SQRT_LOG2E = 1.2011224087864498f;

__host__ __device__ constexpr int pad4(int x) { return (x + 3) / 4 * 4; }

// PTX's ex2.approx.ftz: exp2f's own rounding without its subnormal-result
// fixup (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A float4 from any address space (the matvec's shared-memory tiles)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// A float4 from global memory no thread of the launch writes (the tile
// kernel's padded rows and half-norms), through the read-only path: at
// 32768^2, d = 8 the tile kernel takes 1.39 ms with it and 1.56 with ld4
// (H100 80GB HBM3 at 700 W, chip_smoke.time_cov)
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// c + a . b over 4 features, in the norms' fmaf order
__device__ __forceinline__ float fma4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}
// a . b over the first 4 features: fma4 from 0 (a.x b.x is fmaf(a.x,
// b.x, 0) rounded the same way), with no zeroed sum to start from
__device__ __forceinline__ float start4(float4 a, float4 b) {
  float c = a.x * b.x;
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// One entry of K from the cross term and the half-norms. rbf: K / sf2 in
// log2 units (the caller applies sf2 once an output); the other kinds:
// their cov_epilogue.cuh formula on s = 2h.
template <int KIND>
__device__ __forceinline__ float entry(float cross, float hi, float hj,
                                       float sf2, float alpha) {
  if constexpr (KIND == RBF) return ex2((cross - hi) - hj);
  else return epilogue<KIND>(cross, hi + hi, hj + hj, sf2, alpha);
}

// Row i of x (n rows of d features, row-major) into row i of xs (dp
// features, times scale, zero padded) and its half squared norm into h[i];
// rows n <= i < npad are written as zeros.
__device__ __forceinline__ void prep_row(const float* __restrict__ x,
                                         float* __restrict__ xs,
                                         float* __restrict__ h, long long i,
                                         long long n, int d, int dp,
                                         float scale) {
  float s = 0.0f;
  for (int k = 0; k < dp; ++k) {
    const float xk = (i < n && k < d) ? x[i * d + k] * scale : 0.0f;
    xs[i * dp + k] = xk;
    s = fmaf(xk, xk, s);
  }
  h[i] = 0.5f * s;
}

}  // namespace cugp
