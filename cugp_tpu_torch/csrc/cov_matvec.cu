// Fused covariance matvec: out = (K(X, X) + diag_add I) V, K never written.
//
// Replaces cugp_tpu/ops/cov_pallas.py::_cov_matvec_kernel (the Pallas
// kernel that builds a (512, 1024) tile of K in VMEM, masks it and
// contracts it with a 128-padded V on the MXU, accumulating across the
// column grid). Same function: the tile formulas of cov_epilogue.cuh on
// lengthscale-scaled rows, contracted with V, plus diag_add * V.
//
// What bounds it on the H100: fp32 operations, not bytes. Each of the n^2
// entries of K costs 2d flops for the cross term, a few for the exponent
// and 2r for the contraction (n = 100k, d = 4, r = 9: about 2.9e11 flops,
// 4.3 ms at 67 TFLOP/s); it reads only X and V and writes only the
// (n, r) output.
//
// Design: one CTA of 256 threads owns BM = 64 rows of the output and a
// chunk of RC columns of V, and loops over all column tiles of X (BN = 128
// columns each). Lane l of every warp owns rows l and l + 32; warp w owns
// columns [16w, 16w + 16) of each tile, so within a warp every lane reads
// the same column's features and V row from shared memory (a broadcast,
// 16 bytes per load: the column tile is stored feature-major and V rows
// are float4-aligned, which keeps shared-memory loads at about 3 per
// entry of K, under the FMA pipe's share). Per tile: the tile's features
// are staged in 32-wide chunks (any d), the cross terms accumulate in
// registers with the same fmaf order as the squared norms (so
// cross_ii == s_i bitwise and the diagonal exponent is exactly 0), the
// epilogue turns them into K entries, and each is contracted with the
// staged V row into RC register accumulators. After the last tile the 8
// warps' partial sums are added in shared memory in warp order,
// diag_add * v_i is added once per output row, and each output row is
// written once. There are no atomics: a launch is bitwise reproducible.
// Rows and columns at or beyond n are masked here (zero features and a
// skipped contraction), so n and r need no padding and there is no crop
// copy. The RC-wide V chunks are a grid axis: for r > 32 each chunk
// rebuilds K (the exponent work is paid once per chunk).

#include <cuda_runtime.h>

#include "cov_epilogue.cuh"

using namespace cugp;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // 8
constexpr int R = 2;                 // rows per lane
constexpr int BM = 32 * R;           // 64 output rows per CTA
constexpr int JW = 16;               // columns per warp per tile
constexpr int BN = WARPS * JW;       // 128 columns per tile
constexpr int DC = 32;               // feature chunk staged per pass
// shared-memory carve-up, in floats
constexpr int A_OFF = 0;                    // a_s[DC][BM], feature-major
constexpr int B_OFF = A_OFF + DC * BM;      // b_s[DC][BN], feature-major
constexpr int V_OFF = B_OFF + DC * BN;      // v_s[BN][RC] (RC <= 32)
constexpr int S2_OFF = V_OFF + BN * 32;     // s2_s[BN]
constexpr int S1_OFF = S2_OFF + BN;         // s1_s[BM]
constexpr int SMEM_FLOATS = S1_OFF + BM;    // 10,432 floats = 40.75 KB
static_assert(B_OFF % 4 == 0 && V_OFF % 4 == 0 && S2_OFF % 4 == 0,
              "float4 loads need 16-byte aligned arrays");
// the cross-warp reduction reuses [0, V_OFF + BN * 32) after the last tile
static_assert(WARPS * 32 * 33 <= S2_OFF, "reduction buffer does not fit");

__device__ __forceinline__ void stage_rows(float* a_s, const float* x,
                                           int i0, int k0, int kc, int n,
                                           int d) {
  for (int e = threadIdx.x; e < BM * kc; e += THREADS) {
    const int i = e / kc, k = e - i * kc;
    const int gi = i0 + i;
    a_s[k * BM + i] = gi < n ? x[(long long)gi * d + k0 + k] : 0.0f;
  }
}

template <int KIND, int RC>
__global__ void __launch_bounds__(THREADS)
cov_matvec_kernel(const float* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ scal, float* __restrict__ out,
                  int n, int d, int r, long long vrs, long long vcs,
                  long long ldo) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  float* a_s = smem + A_OFF;
  float* b_s = smem + B_OFF;
  float* v_s = smem + V_OFF;
  float* s2_s = smem + S2_OFF;
  float* s1_s = smem + S1_OFF;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * RC;
  const int rc = min(RC, r - c0);
  const int nchunks = (d + DC - 1) / DC;
  const float sf2 = scal[0], diag_add = scal[1], alpha = scal[2];

  // squared norms of this CTA's rows, in the cross term's fmaf order
  for (int k0 = 0; k0 < d; k0 += DC) {
    const int kc = min(DC, d - k0);
    __syncthreads();
    stage_rows(a_s, x, i0, k0, kc, n, d);
    __syncthreads();
    if (tid < BM) {
      float s = k0 == 0 ? 0.0f : s1_s[tid];
      for (int k = 0; k < kc; ++k) s = fmaf(a_s[k * BM + tid], a_s[k * BM + tid], s);
      s1_s[tid] = s;
    }
  }
  __syncthreads();
  float s1[R];
#pragma unroll
  for (int q = 0; q < R; ++q) s1[q] = s1_s[lane + 32 * q];

  float acc[R][RC];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[q][c] = 0.0f;

  for (int j0 = 0; j0 < n; j0 += BN) {
    float cr[R][JW];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int jj = 0; jj < JW; ++jj) cr[q][jj] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += DC) {
      const int kc = min(DC, d - k0);
      __syncthreads();  // the previous chunk (or tile) is consumed
      // with one chunk, a_s still holds this CTA's rows from the norms
      if (nchunks > 1) stage_rows(a_s, x, i0, k0, kc, n, d);
      for (int e = tid; e < BN * kc; e += THREADS) {
        const int j = e / kc, k = e - j * kc;
        const int gj = j0 + j;
        b_s[k * BN + j] = gj < n ? x[(long long)gj * d + k0 + k] : 0.0f;
      }
      if (k0 == 0) {
        for (int e = tid; e < BN * RC; e += THREADS) {
          const int j = e / RC, c = e - j * RC;
          const int gj = j0 + j;
          v_s[e] = (gj < n && c < rc)
                       ? v[(long long)gj * vrs + (long long)(c0 + c) * vcs]
                       : 0.0f;
        }
      }
      __syncthreads();
      if (tid < BN) {
        float s = k0 == 0 ? 0.0f : s2_s[tid];
        for (int k = 0; k < kc; ++k)
          s = fmaf(b_s[k * BN + tid], b_s[k * BN + tid], s);
        s2_s[tid] = s;
      }
      for (int k = 0; k < kc; ++k) {
        float a[R];
#pragma unroll
        for (int q = 0; q < R; ++q) a[q] = a_s[k * BM + lane + 32 * q];
        const float4* bk =
            reinterpret_cast<const float4*>(b_s + k * BN + warp * JW);
#pragma unroll
        for (int j4 = 0; j4 < JW / 4; ++j4) {
          const float4 b = bk[j4];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            cr[q][4 * j4] = fmaf(a[q], b.x, cr[q][4 * j4]);
            cr[q][4 * j4 + 1] = fmaf(a[q], b.y, cr[q][4 * j4 + 1]);
            cr[q][4 * j4 + 2] = fmaf(a[q], b.z, cr[q][4 * j4 + 2]);
            cr[q][4 * j4 + 3] = fmaf(a[q], b.w, cr[q][4 * j4 + 3]);
          }
        }
      }
    }
    __syncthreads();  // s2_s complete

#pragma unroll
    for (int jj = 0; jj < JW; ++jj) {
      const int j = warp * JW + jj;
      if (j0 + j < n) {  // warp-uniform: masks the ragged last tile
        const float s2 = s2_s[j];
        float kv[R];
#pragma unroll
        for (int q = 0; q < R; ++q)
          kv[q] = epilogue<KIND>(cr[q][jj], s1[q], s2, sf2, alpha);
        if constexpr (RC % 4 == 0) {
          const float4* vj = reinterpret_cast<const float4*>(v_s + j * RC);
#pragma unroll
          for (int c4 = 0; c4 < RC / 4; ++c4) {
            const float4 vv = vj[c4];
#pragma unroll
            for (int q = 0; q < R; ++q) {
              acc[q][4 * c4] = fmaf(kv[q], vv.x, acc[q][4 * c4]);
              acc[q][4 * c4 + 1] = fmaf(kv[q], vv.y, acc[q][4 * c4 + 1]);
              acc[q][4 * c4 + 2] = fmaf(kv[q], vv.z, acc[q][4 * c4 + 2]);
              acc[q][4 * c4 + 3] = fmaf(kv[q], vv.w, acc[q][4 * c4 + 3]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < RC; ++c)
#pragma unroll
            for (int q = 0; q < R; ++q)
              acc[q][c] = fmaf(kv[q], v_s[j * RC + c], acc[q][c]);
        }
      }
    }
  }

  // add the 8 warps' partial sums in warp order, one row slot at a time
  float* red = smem;  // red[WARPS * 32][RC + 1]
#pragma unroll
  for (int q = 0; q < R; ++q) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < RC; ++c) red[(warp * 32 + lane) * (RC + 1) + c] = acc[q][c];
    __syncthreads();
    for (int e = tid; e < 32 * rc; e += THREADS) {
      const int l = e / rc, c = e - l * rc;
      const int gi = i0 + 32 * q + l;
      if (gi >= n) continue;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * 32 + l) * (RC + 1) + c];
      s = fmaf(diag_add, v[(long long)gi * vrs + (long long)(c0 + c) * vcs], s);
      out[(long long)gi * ldo + c0 + c] = s;
    }
  }
}

template <int KIND, int RC>
void launch(int n, int d, int r, cudaStream_t s, const float* x,
            const float* v, const float* scal, float* out, long long vrs,
            long long vcs, long long ldo) {
  const dim3 grid((n + BM - 1) / BM, (r + RC - 1) / RC);
  cov_matvec_kernel<KIND, RC><<<grid, THREADS, 0, s>>>(x, v, scal, out, n,
                                                       d, r, vrs, vcs, ldo);
}

template <int KIND>
int launch_rc(int n, int d, int r, cudaStream_t s, const float* x,
              const float* v, const float* scal, float* out, long long vrs,
              long long vcs, long long ldo) {
  // the narrowest V chunk that holds r, else 32-wide chunks over the grid
  if (r == 1) launch<KIND, 1>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
  else if (r <= 4) launch<KIND, 4>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
  else if (r <= 8) launch<KIND, 8>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
  else if (r <= 16) launch<KIND, 16>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
  else launch<KIND, 32>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, d) row-major fp32, already divided by the lengthscale; v (n, r)
// fp32 with element strides (vrs, vcs); scal = [sf2, diag_add, alpha] on
// the device; out (n, r) with leading dimension ldo. kind: 0 rbf,
// 1 matern12, 2 matern32, 3 matern52, 4 rq, 5 linear.
extern "C" int cugp_cov_matvec(const float* x, const float* v,
                               const float* scal, float* out, int n, int d,
                               int r, long long vrs, long long vcs,
                               long long ldo, int kind, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (d <= 0 || (r + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: return launch_rc<RBF>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
    case MATERN12: return launch_rc<MATERN12>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
    case MATERN32: return launch_rc<MATERN32>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
    case MATERN52: return launch_rc<MATERN52>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
    case RQ: return launch_rc<RQ>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
    case LINEAR: return launch_rc<LINEAR>(n, d, r, s, x, v, scal, out, vrs, vcs, ldo);
    default: return cudaErrorInvalidValue;
  }
}
