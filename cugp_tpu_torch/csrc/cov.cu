// Covariance tile kernel: K(X1, X2) from lengthscale-scaled rows.
//
// Replaces cugp_tpu/ops/cov_pallas.py::_cov_kernel (the fused Pallas
// covariance tile). Same arithmetic: the cross term X1 X2^T, the row/column
// squared norms s1/s2, and the per-family epilogue of cov_epilogue.cuh,
// then the padding contract of cov_pallas.py:11-14: a square build adds
// diag_add on the diagonal and writes an identity block at rows/cols
// >= n_true; a cross build writes 0 beyond the true extent.
//
// What bounds it on the H100: at d <= 32 the N^2 fp32 store (4.29 GB at
// N = 32768, about 1.3 ms at 3.35 TB/s); the expf per element is second.
// Design: one 64x64 output tile per 256-thread CTA. Each thread owns one
// column and 16 rows, so every warp store is 32 consecutive floats of one
// row (a full 128-byte segment). Row chunks of 32 features of X1 and X2
// are staged in shared memory and the loop over chunks serves any d (the
// Pallas kernel has two paths, d <= 32 and d > 32). The output is written
// at exactly m x n with leading dimension ldo; the ragged edge is masked
// here, so there is no padded output and no crop copy. The three scalars
// [sf2, diag_add, alpha] are read through a device pointer, so a fit loop
// never syncs the host to launch a build.

#include <cuda_runtime.h>

#include "cov_epilogue.cuh"

using namespace cugp;

namespace {

constexpr int TM = 64;         // tile rows
constexpr int TN = 64;         // tile cols
constexpr int DC = 32;         // feature chunk staged per pass
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / TN;     // 4
constexpr int RPT = TM / ROW_STEP;         // 16 rows per thread

template <int KIND>
__global__ void __launch_bounds__(THREADS)
cov_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
           const float* __restrict__ scal, float* __restrict__ out,
           int m, int n, int d, long long ldo, int square, int n1, int n2) {
  __shared__ float a_s[TM][DC + 1];  // X1 chunk, row-major
  __shared__ float b_s[DC][TN + 1];  // X2 chunk, transposed
  __shared__ float s1_s[TM];
  __shared__ float s2_s[TN];

  const int tid = threadIdx.x;
  const int col = tid % TN;
  const int row0 = tid / TN;
  const int i0 = blockIdx.y * TM;
  const int j0 = blockIdx.x * TN;

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
  if (tid < TM) s1_s[tid] = 0.0f;
  else if (tid < TM + TN) s2_s[tid - TM] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kc = min(DC, d - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < TM * DC; e += THREADS) {
      const int r = e / DC, k = e % DC;
      const int gk = k0 + k;
      const int gi = i0 + r, gj = j0 + r;
      a_s[r][k] = (gi < m && gk < d) ? x1[(long long)gi * d + gk] : 0.0f;
      b_s[k][r] = (gj < n && gk < d) ? x2[(long long)gj * d + gk] : 0.0f;
    }
    __syncthreads();
    if (tid < TM) {
      float s = s1_s[tid];
      for (int k = 0; k < kc; ++k) s += a_s[tid][k] * a_s[tid][k];
      s1_s[tid] = s;
    } else if (tid < TM + TN) {
      const int c = tid - TM;
      float s = s2_s[c];
      for (int k = 0; k < kc; ++k) s += b_s[k][c] * b_s[k][c];
      s2_s[c] = s;
    }
    for (int k = 0; k < kc; ++k) {
      const float b = b_s[k][col];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] += a_s[row0 + ROW_STEP * r][k] * b;
    }
  }
  __syncthreads();  // s1_s / s2_s complete

  const int gj = j0 + col;
  if (gj >= n) return;
  const float sf2 = scal[0], diag_add = scal[1], alpha = scal[2];
  const float s2 = s2_s[col];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int li = row0 + ROW_STEP * r;
    const int gi = i0 + li;
    if (gi >= m) break;
    float v = epilogue<KIND>(acc[r], s1_s[li], s2, sf2, alpha);
    const bool pad = gi >= n1 || gj >= n2;
    if (square) {
      const bool diag = gi == gj;
      if (diag) v += diag_add;
      if (pad) v = diag ? 1.0f : 0.0f;
    } else if (pad) {
      v = 0.0f;
    }
    out[(long long)gi * ldo + gj] = v;
  }
}

template <int KIND>
void launch(dim3 grid, cudaStream_t s, const float* x1, const float* x2,
            const float* scal, float* out, int m, int n, int d,
            long long ldo, int square, int n1, int n2) {
  cov_kernel<KIND><<<grid, THREADS, 0, s>>>(x1, x2, scal, out, m, n, d, ldo,
                                            square, n1, n2);
}

}  // namespace

extern "C" const char* cugp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x1 (m, d) and x2 (n, d) row-major fp32, already divided by the
// lengthscale; scal = [sf2, diag_add, alpha] on the device; out (m, n)
// with leading dimension ldo. kind: 0 rbf, 1 matern12, 2 matern32,
// 3 matern52, 4 rq, 5 linear.
extern "C" int cugp_cov(const float* x1, const float* x2, const float* scal,
                        float* out, int m, int n, int d, long long ldo,
                        int kind, int square, int n1_true, int n2_true,
                        void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (d <= 0 || (m + TM - 1) / TM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: launch<RBF>(grid, s, x1, x2, scal, out, m, n, d, ldo, square, n1_true, n2_true); break;
    case MATERN12: launch<MATERN12>(grid, s, x1, x2, scal, out, m, n, d, ldo, square, n1_true, n2_true); break;
    case MATERN32: launch<MATERN32>(grid, s, x1, x2, scal, out, m, n, d, ldo, square, n1_true, n2_true); break;
    case MATERN52: launch<MATERN52>(grid, s, x1, x2, scal, out, m, n, d, ldo, square, n1_true, n2_true); break;
    case RQ: launch<RQ>(grid, s, x1, x2, scal, out, m, n, d, ldo, square, n1_true, n2_true); break;
    case LINEAR: launch<LINEAR>(grid, s, x1, x2, scal, out, m, n, d, ldo, square, n1_true, n2_true); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
