// Per-family covariance epilogue, shared by cov.cu (the covariance tile) and
// cov_matvec.cu (the fused matvec): the formulas of
// cugp_tpu/ops/cov_pallas.py::_cov_kernel on the cross term and the
// squared row/column norms of lengthscale-scaled inputs,
//   rbf      sf2 * exp(cross - s1/2 - s2/2)      (fused exponent, unclamped)
//   matern*  on d2 = max(s1 + s2 - 2 cross, 0), r = sqrt(max(d2, 1e-12))
//   rq       sf2 * exp(-a * log1p(d2 / (2a)))
//   linear   sf2 * cross + alpha                 (alpha slot = bias variance)
// Built without --use_fast_math: expf/log1pf/sqrtf keep parity with the
// JAX epilogue.

#pragma once

#include <cuda_runtime.h>

namespace cugp {

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, RQ = 4,
            LINEAR = 5 };

template <int KIND>
__device__ __forceinline__ float epilogue(float cross, float s1, float s2,
                                          float sf2, float alpha) {
  if (KIND == LINEAR) return sf2 * cross + alpha;
  if (KIND == RBF) return sf2 * expf(cross - 0.5f * s1 - 0.5f * s2);
  const float d2 = fmaxf(s1 + s2 - 2.0f * cross, 0.0f);
  if (KIND == RQ) return sf2 * expf(-alpha * log1pf(d2 / (2.0f * alpha)));
  const float r = sqrtf(fmaxf(d2, 1e-12f));
  if (KIND == MATERN12) return sf2 * expf(-r);
  if (KIND == MATERN32) {
    const float s = 1.7320508075688772f * r;
    return sf2 * ((1.0f + s) * expf(-s));
  }
  const float s = 2.23606797749979f * r;  // MATERN52
  return sf2 * ((1.0f + s + (s * s) / 3.0f) * expf(-s));
}

}  // namespace cugp
