// Diagonal-block Cholesky (potrf) kernel: A = L L^T for one SPD block.
//
// Replaces cugp_tpu/ops/chol_pallas.py::_potrf_kernel, the base case of
// the recursive blocked Cholesky. The Pallas kernel holds the whole block
// in VMEM and needs n % 128 == 0; this one takes any n <= 1024 with a
// leading dimension, so it factors a diagonal block of the big buffer in
// place, and a leading batch through the grid (one CTA per block).
//
// What bounds it on the H100: one SM, serial over panels. A 1024^2 fp32
// block is 4 MB, far over a CTA's 227 KB of shared memory, so the block
// stays in global memory (L2, 50 MB, holds it) and only the working
// panel lives in shared memory. Design: one CTA of 1024 threads,
// right-looking over 32-wide panels:
//   1. the 32x32 diagonal tile is loaded into shared memory (identity
//      padded when n is not a multiple of 32) and factored there, one
//      thread per element;
//   2. each thread solves one row of the sub-diagonal panel against it
//      (x L11^T = a) in registers, writing L21 to global memory and to a
//      shared copy of the panel;
//   3. the trailing lower triangle is updated in fp32 FMA from the shared
//      panel: each warp takes a row, its lanes consecutive columns, so the
//      read-modify-write of A is coalesced.
// Only the lower triangle is read (callers pass SYRK-lower results whose
// upper triangle is garbage) and zeros are written above the diagonal.
// A non-positive pivot gives sqrtf of a negative number: NaN, which
// propagates, so callers can detect a failed factorization.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;         // panel width
constexpr int THREADS = 1024;  // 32 x 32: one thread per tile element
constexpr int MAXN = 1024;

__global__ void __launch_bounds__(THREADS)
potrf_kernel(float* __restrict__ a_base, long long lda,
             long long batch_stride, int n) {
  extern __shared__ float smem[];
  float (*D)[NB + 1] = reinterpret_cast<float (*)[NB + 1]>(smem);
  float (*P)[NB + 1] = reinterpret_cast<float (*)[NB + 1]>(smem + NB * (NB + 1));
  float* a = a_base + blockIdx.x * batch_stride;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int p = 0; p < n; p += NB) {
    const int pb = min(NB, n - p);
    // 1. diagonal tile: lower part of A[p:p+pb, p:p+pb], identity padded
    {
      const int r = warp, c = lane;
      float v;
      if (r < pb && c < pb)
        v = (c <= r) ? a[(long long)(p + r) * lda + p + c] : 0.0f;
      else
        v = (r == c) ? 1.0f : 0.0f;
      D[r][c] = v;
      __syncthreads();
      for (int j = 0; j < NB; ++j) {
        const float dj = sqrtf(D[j][j]);
        const float lrj = D[r][j] / dj;
        const float lcj = D[c][j] / dj;
        __syncthreads();
        if (c == j && r >= j)
          D[r][j] = (r == j) ? dj : lrj;
        else if (c > j && r >= c)
          D[r][c] -= lrj * lcj;
        __syncthreads();
      }
      if (r < pb && c <= r) a[(long long)(p + r) * lda + p + c] = D[r][c];
    }

    // 2. panel solve: rows q.. of the panel, x L11^T = a, one row a thread
    const int q = p + pb;
    const int rows = n - q;
    for (int rr = tid; rr < rows; rr += THREADS) {
      float* arow = a + (long long)(q + rr) * lda + p;
      float x[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) x[j] = (j < pb) ? arow[j] : 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float s = x[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= x[k] * D[j][k];
        x[j] = s / D[j][j];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        P[rr][j] = x[j];
        if (j < pb) arow[j] = x[j];
      }
    }
    __syncthreads();

    // 3. trailing update of the lower triangle: A[q:, q:] -= L21 L21^T
    for (int ii = warp; ii < rows; ii += THREADS / 32) {
      float* arow = a + (long long)(q + ii) * lda + q;
      for (int kk = lane; kk <= ii; kk += 32) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) s += P[ii][j] * P[kk][j];
        arow[kk] -= s;
      }
    }
    __syncthreads();
  }

  // zeros above the diagonal
  for (int r = warp; r < n; r += THREADS / 32)
    for (int c = r + 1 + lane; c < n; c += 32) a[(long long)r * lda + c] = 0.0f;
}

}  // namespace

// a: batch blocks of (n, n) fp32, row-major with leading dimension lda,
// block b at a + b * batch_stride; factored in place (lower L, zeros above).
extern "C" int cugp_potrf(float* a, long long lda, long long batch_stride,
                          int n, int batch, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (n > MAXN || lda < n) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(NB + n) * (NB + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      potrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  potrf_kernel<<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, lda, batch_stride, n);
  return static_cast<int>(cudaGetLastError());
}
