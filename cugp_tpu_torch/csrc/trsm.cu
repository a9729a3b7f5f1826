// Diagonal-block triangular solve (TRSM) kernel: op(L) X = B, op in {L, L^T}.
//
// Replaces cugp_tpu/ops/trsm_pallas.py::_trsm_kernel together with its
// in-kernel helper chol_pallas.py::_trtri_tile, the base case of the
// recursive blocked solves. L is lower (any n <= 1024, leading dimension
// ldl; only its lower triangle is read). B is (n, k) with arbitrary row
// and column strides, and X overwrites it in place: a right-side solve
// X L^T = B is L X^T = B^T, i.e. the same call with B's strides swapped,
// where the Pallas wrapper made a transposed copy.
//
// What bounds it on the H100: with k = 1 (the alpha solve) a single CTA,
// latency-bound; with k = 4096 (predict) or k = N (the Cholesky
// recursion) the n^2/2 FMAs per column from shared memory and L2.
// Design: the grid runs over slabs of 32 RHS columns; each CTA keeps its
// (n, 32) slab in shared memory for the whole solve. It walks 32-row
// panels (forward for L, backward for L^T): a strip update from the rows
// already solved, with 32x32 tiles of L staged in shared memory, then
// substitution against the diagonal tile, one warp per column with the
// pivots passed by shuffle. There is no trtri: the inverse-then-GEMM
// shape of the Pallas kernel existed to put the diagonal solve on the MXU.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;         // panel rows
constexpr int COLS = 32;       // RHS columns per CTA
constexpr int THREADS = 1024;  // 32 warps: one per column in the substitution
constexpr int MAXN = 1024;

__global__ void __launch_bounds__(THREADS)
trsm_kernel(const float* __restrict__ l, long long ldl, float* b,
            long long rs, long long cs, int n, int k, int transpose) {
  extern __shared__ float smem[];
  float (*Ls)[NB + 1] = reinterpret_cast<float (*)[NB + 1]>(smem);
  float (*Ld)[NB + 1] = reinterpret_cast<float (*)[NB + 1]>(smem + NB * (NB + 1));
  float (*X)[COLS + 1] =
      reinterpret_cast<float (*)[COLS + 1]>(smem + 2 * NB * (NB + 1));
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int c0 = blockIdx.x * COLS;
  const int kc = min(COLS, k - c0);

  // the slab, read along B's unit-stride dimension
  for (int e = tid; e < n * COLS; e += THREADS) {
    int i, c;
    if (rs == 1) { i = e % n; c = e / n; } else { c = e % COLS; i = e / COLS; }
    X[i][c] = (c < kc) ? b[(long long)i * rs + (long long)(c0 + c) * cs] : 0.0f;
  }
  __syncthreads();

  const int npan = (n + NB - 1) / NB;
  const int r = warp, c = lane;  // (panel row, column) in the strip update
  for (int t = 0; t < npan; ++t) {
    const int p = (transpose ? npan - 1 - t : t) * NB;
    const int pb = min(NB, n - p);
    {
      float v;
      if (r < pb && c < pb)
        v = (c <= r) ? l[(long long)(p + r) * ldl + p + c] : 0.0f;
      else
        v = (r == c) ? 1.0f : 0.0f;
      Ld[r][c] = v;
    }

    // strip update: X[p+r][c] -= sum over solved rows m of op(L)[p+r][m] X[m][c]
    float acc = 0.0f;
    if (!transpose) {
      for (int m0 = 0; m0 < p; m0 += NB) {
        __syncthreads();
        Ls[r][c] = (p + r < n) ? l[(long long)(p + r) * ldl + m0 + c] : 0.0f;
        __syncthreads();
#pragma unroll
        for (int mm = 0; mm < NB; ++mm) acc += Ls[r][mm] * X[m0 + mm][c];
      }
    } else {
      for (int m0 = p + pb; m0 < n; m0 += NB) {
        const int mc = min(NB, n - m0);
        __syncthreads();
        // Ls[mm][rr] = L[m0 + mm][p + rr]: the strip of L^T
        Ls[r][c] = (r < mc) ? l[(long long)(m0 + r) * ldl + p + c] : 0.0f;
        __syncthreads();
        for (int mm = 0; mm < mc; ++mm) acc += Ls[mm][r] * X[m0 + mm][c];
      }
    }
    if (p + r < n) X[p + r][c] -= acc;
    __syncthreads();

    // substitution against the diagonal tile: warp w solves column w
    {
      const int col = warp;
      float val = (lane < pb) ? X[p + lane][col] : 0.0f;
      if (!transpose) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float xj = __shfl_sync(0xffffffffu, val, j) / Ld[j][j];
          if (lane == j) val = xj;
          else if (lane > j) val -= Ld[lane][j] * xj;
        }
      } else {
#pragma unroll
        for (int j = NB - 1; j >= 0; --j) {
          const float xj = __shfl_sync(0xffffffffu, val, j) / Ld[j][j];
          if (lane == j) val = xj;
          else if (lane < j) val -= Ld[j][lane] * xj;
        }
      }
      if (lane < pb) X[p + lane][col] = val;
    }
    __syncthreads();
  }

  for (int e = tid; e < n * COLS; e += THREADS) {
    int i, cc;
    if (rs == 1) { i = e % n; cc = e / n; } else { cc = e % COLS; i = e / COLS; }
    if (cc < kc) b[(long long)i * rs + (long long)(c0 + cc) * cs] = X[i][cc];
  }
}

}  // namespace

// l: (n, n) lower, leading dimension ldl. b: (n, k), element (i, j) at
// b[i * row_stride + j * col_stride], overwritten with op(L)^{-1} B.
extern "C" int cugp_trsm(const float* l, long long ldl, float* b,
                         long long row_stride, long long col_stride, int n,
                         int k, int transpose, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (n > MAXN || ldl < n) return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>(2 * NB * (NB + 1)) + static_cast<size_t>(n) * (COLS + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((k + COLS - 1) / COLS);
  trsm_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      l, ldl, b, row_stride, col_stride, n, k, transpose);
  return static_cast<int>(cudaGetLastError());
}
