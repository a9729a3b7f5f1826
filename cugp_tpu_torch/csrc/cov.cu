// Covariance tile kernel: K(X1, X2) from lengthscale-scaled rows.
//
// Replaces cugp_tpu/ops/cov_pallas.py::_cov_kernel (cov_pallas.py:48, the
// fused Pallas covariance tile). Same function: the cross term X1 X2^T,
// the squared row norms and the per-family epilogue of cov_epilogue.cuh,
// then the padding contract of cov_pallas.py:11-14: a square build adds
// diag_add on the diagonal and writes an identity block at rows/cols
// >= n_true; a cross build writes 0 beyond the true extent. The output is
// exactly m x n with leading dimension ldo; [sf2, diag_add, alpha] are
// read through a device pointer, so a fit loop never syncs the host.
// A batch of builds (chains or Monte Carlo draws as a leading dimension,
// the counterpart of the Pallas call under vmap, cov_pallas.py:134-138)
// is one launch pair: one pre-pass over every element, then the
// persistent CTAs walk (element, tile) pairs. Element b has its own rows
// and scalars [sf2, diag_add, alpha]_b and the same m, n, n1/n2_true.
//
// What bounds it on the H100: the m n fp32 store (256 MB at 8000^2, 4.29
// GB at 32768^2). At the byte bound the card issues only ~40
// thread-instructions an entry, so an entry is kept near 10:
//
//   pre-pass  one small launch (row code in cov_rows.cuh, shared with
//             cov_matvec.cu): the rows of X1 and X2 padded to 4 features
//             and 128 rows (times sqrt(log2 e) for rbf) and their half
//             squared norms, summed in the cross term's order, into a
//             scratch the wrapper allocates; one pass when X2 is X1. The
//             rbf diagonal's exponent is exactly 0: K_ii = sf2 + diag_add.
//   tiles     persistent CTAs of 256 threads, min(tiles, SMs x resident
//             CTAs), walk 128 x 128 output tiles in row-major tile order.
//             A thread owns 16 rows x 4 adjacent columns, so a warp writes
//             a 512-byte stretch of a row and one warp-uniform float4 load
//             of a row (a broadcast from L1) feeds 4 entries. At d <= 8
//             the columns' features stay in registers. Above, the cross
//             sums of 8 rows x 4 columns are formed a 4-feature group at a
//             time, the groups read through L1 like the rows: no shared
//             memory, no barrier (d > 8 is off the main paths).
//   entry     rbf: 4 cross FMA (d = 4), two subtractions, one ex2 (PTX
//             ex2.approx.ftz on log2-unit rows, as cov_matvec.cu: one MUFU
//             where expf costs about 8 instructions) and sf2 once. Other
//             kinds: cov_epilogue.cuh's formulas on the hoisted norms.
//   masks     only in tiles that meet the diagonal, n1/n2_true or the
//             ragged edge; interior tiles run a branch-free path.
//   stores    16-byte streaming stores (st.global.cs.v4) where ldo % 4 == 0
//             and out is 16-byte aligned (every main-path shape), else
//             4-byte streaming stores; cov_cuda.route names the route and
//             both write the same bits. By A/B on the card the streaming
//             hint beat plain 16-byte stores by 10% at 32768^2 and TMA
//             tile stores from a double-buffered shared tile by 22%.
//
// No atomics: a launch is bitwise reproducible, and an entry's value does
// not depend on m, n, its tile, the store route or the batch, so a row
// block built alone equals the same rows of a larger build, and each
// element of a batch equals its own 2-D build. Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 2; PERF.md): 1.39-1.40 ms at
// 32768^2, d = 8, against a 1.283 ms byte bound and 1.31 ms for
// out.fill_(1.0) on the same output: the write rate bounds it.

#include <climits>

#include <cuda_runtime.h>

#include "cov_rows.cuh"
#include "device_facts.cuh"

using namespace cugp;

namespace {

constexpr int BM = 128;              // tile rows
constexpr int BN = 128;              // tile columns (== BM: a tile meets
                                     // the diagonal iff ti == tj)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // 8
constexpr int RW = BM / WARPS;       // 16 rows a warp, and a thread
constexpr int ROW_PAD = BM;          // scratch rows padded to this

struct Args {
  const float* x1;  // (m_pad, dp) padded rows of X1, element 0
  const float* h1;  // (m_pad,) their half-norms
  const float* x2;  // (n_pad, dp), or x1 for a square build of one tensor
  const float* h2;
  const float* scal;  // (batch, 3)
  float* out;
  long long ldo;
  long long sstride;  // scratch floats an element (x1, h1, x2, h2)
  long long ostride;  // output floats an element
  int m, n, dp, n1, n2, square, tiles_n, tiles, total;  // total: batch tiles
};

// One element's padded rows and half-norms
struct Rows {
  const float* x1;
  const float* h1;
  const float* x2;
  const float* h2;
};

// One output: rbf applies sf2 here (entry() gives K / sf2)
template <int KIND>
__device__ __forceinline__ float value(float cross, float hi, float hj,
                                       float sf2, float alpha) {
  const float e = entry<KIND>(cross, hi, hj, sf2, alpha);
  if constexpr (KIND == RBF) return __fmul_rn(sf2, e);
  else return e;
}

// Row r's four entries at p, as streaming stores (st.global.cs: the output
// is written once and not read back here, so L2 keeps the rows instead).
// V4: one 16-byte store (p 16-byte aligned), else four 4-byte stores.
template <bool V4>
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  if constexpr (V4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) __stcs(p + c, v[c]);
  }
}

// The 4 entries of each of this thread's RW rows of a tile: rows i..i+RW-1,
// columns j..j+3. put(r, v) takes row r's four. MASKED adds diag_add on the
// diagonal and applies the padding contract; the interior path has neither.
// DP4 > 0: d <= 4 DP4 features, the columns' features held in registers
// and each row's cross terms formed as it is stored. DP4 == 0: any d, the
// cross sums of RH rows at a time formed first, a 4-feature group at a
// time (the columns' features are read once for each RH rows).
template <int KIND, int DP4, bool MASKED, class Put>
__device__ __forceinline__ void tile(const Args& a, const Rows& e, int i,
                                     int j, float sf2, float diag_add,
                                     float alpha, Put&& put) {
  constexpr int RH = DP4 > 0 ? RW : 8;
  const int dp = DP4 > 0 ? 4 * DP4 : a.dp;
  const float* x1 = e.x1 + static_cast<long long>(i) * dp;
  const float* x2 = e.x2 + static_cast<long long>(j) * dp;
  float hi[RW];
#pragma unroll
  for (int q = 0; q < RW; q += 4) {
    const float4 t = ldg4(e.h1 + i + q);
    hi[q] = t.x;
    hi[q + 1] = t.y;
    hi[q + 2] = t.z;
    hi[q + 3] = t.w;
  }
  const float4 h4 = ldg4(e.h2 + j);
  const float hj[4] = {h4.x, h4.y, h4.z, h4.w};
  float4 b[4][DP4 > 0 ? DP4 : 1];  // DP4 > 0: the columns' features
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < DP4; ++k) b[c][k] = ldg4(x2 + c * dp + 4 * k);

#pragma unroll
  for (int r0 = 0; r0 < RW; r0 += RH) {
    float acc[DP4 > 0 ? 1 : RH][4];  // DP4 == 0: the cross sums
    if constexpr (DP4 == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c][0] = ldg4(x2 + c * dp);
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const float4 ar = ldg4(x1 + (r0 + r) * dp);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = start4(ar, b[c][0]);
      }
      for (int k = 4; k < dp; k += 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c][0] = ldg4(x2 + c * dp + k);
#pragma unroll
        for (int r = 0; r < RH; ++r) {
          const float4 ar = ldg4(x1 + (r0 + r) * dp + k);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fma4(ar, b[c][0], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = r0; r < r0 + RH; ++r) {
      float cr[4];
      if constexpr (DP4 > 0) {
        float4 ar[DP4];
#pragma unroll
        for (int k = 0; k < DP4; ++k) ar[k] = ldg4(x1 + r * dp + 4 * k);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cr[c] = start4(ar[0], b[c][0]);
#pragma unroll
          for (int k = 1; k < DP4; ++k) cr[c] = fma4(ar[k], b[c][k], cr[c]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) cr[c] = acc[r - r0][c];
      }
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = value<KIND>(cr[c], hi[r], hj[c], sf2, alpha);
      if constexpr (MASKED) {
        const int gi = i + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int gj = j + c;
          const bool pad = gi >= a.n1 || gj >= a.n2;
          if (a.square) {
            const bool diag = gi == gj;
            if (diag) v[c] = __fadd_rn(v[c], diag_add);
            if (pad) v[c] = diag ? 1.0f : 0.0f;
          } else if (pad) {
            v[c] = 0.0f;
          }
        }
      }
      put(r, v);
    }
  }
}

// Is tile (ti, tj) clear of the diagonal, the padding and the ragged edge?
__device__ __forceinline__ bool interior(const Args& a, int ti, int tj) {
  return (ti + 1) * BM <= a.n1 && (tj + 1) * BN <= a.n2 &&
         !(a.square && ti == tj);
}

template <int KIND, int DP4, bool V4>
__global__ void __launch_bounds__(THREADS, 2) cov_tile_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int bt = blockIdx.x; bt < a.total; bt += gridDim.x) {
    const int b = bt / a.tiles, t = bt - b * a.tiles;
    const long long so = b * a.sstride;
    const Rows e{a.x1 + so, a.h1 + so, a.x2 + so, a.h2 + so};
    const float* sc = a.scal + 3 * b;
    const float sf2 = sc[0], diag_add = sc[1], alpha = sc[2];
    const int ti = t / a.tiles_n, tj = t - ti * a.tiles_n;
    const int i = ti * BM + RW * warp, j = tj * BN + 4 * lane;
    float* row0 = a.out + b * a.ostride + static_cast<long long>(i) * a.ldo + j;
    if (interior(a, ti, tj)) {
      tile<KIND, DP4, false>(a, e, i, j, sf2, diag_add, alpha,
                             [&](int r, const float (&v)[4]) {
                               put4<V4>(row0 + r * a.ldo, v);
                             });
    } else {
      tile<KIND, DP4, true>(a, e, i, j, sf2, diag_add, alpha,
                            [&](int r, const float (&v)[4]) {
                              if (i + r >= a.m) return;
                              float* p = row0 + r * a.ldo;
                              if (j + 3 < a.n) {
                                put4<V4>(p, v);
                              } else {
#pragma unroll
                                for (int c = 0; c < 4; ++c)
                                  if (j + c < a.n) __stcs(p + c, v[c]);
                              }
                            });
    }
  }
}

// Every element's rows: element b's X1 at x1 + b x1s and X2 at x2 + b x2s,
// its scratch at xs1 (h1, xs2, h2) + b ss.
__global__ void __launch_bounds__(THREADS)
cov_prep(const float* __restrict__ x1, const float* __restrict__ x2,
         float* __restrict__ xs1, float* __restrict__ h1,
         float* __restrict__ xs2, float* __restrict__ h2, int m, int n,
         int d, int dp, int m_pad, int n_pad, float scale, int batch,
         long long x1s, long long x2s, long long ss) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long rows = static_cast<long long>(m_pad) + n_pad;
  const long long total = rows * batch;
  for (long long e = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       e < total; e += stride) {
    const long long b = e / rows, r = e - b * rows, so = b * ss;
    if (r < m_pad) prep_row(x1 + b * x1s, xs1 + so, h1 + so, r, m, d, dp, scale);
    else prep_row(x2 + b * x2s, xs2 + so, h2 + so, r - m_pad, n, d, dp, scale);
  }
}

// ---------------------------------------------------------------------------
// Launchers. The persistent grid is min(tiles, SMs x resident CTAs of the
// kernel).

template <auto KERN>
cudaError_t launch_tiles(const Args& a, cudaStream_t s) {
  int cap = 0;
  cudaError_t err = resident_ctas<KERN, THREADS, 0>(&cap);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<Args*>(&a)};
  return cudaLaunchKernel(reinterpret_cast<const void*>(KERN),
                          dim3(a.total < cap ? a.total : cap), dim3(THREADS),
                          args, 0, s);
}

template <int KIND, int DP4>
cudaError_t launch_dp(const Args& a, bool v4, cudaStream_t s) {
  return v4 ? launch_tiles<cov_tile_kernel<KIND, DP4, true>>(a, s)
            : launch_tiles<cov_tile_kernel<KIND, DP4, false>>(a, s);
}

template <int KIND>
cudaError_t launch_kind(const Args& a, bool v4, cudaStream_t s) {
  if (a.dp == 4) return launch_dp<KIND, 1>(a, v4, s);
  if (a.dp == 8) return launch_dp<KIND, 2>(a, v4, s);
  return launch_dp<KIND, 0>(a, v4, s);
}

struct Plan {
  int dp, m_pad, n_pad;  // n_pad = 0: X2 is X1
  long long floats;      // of the scratch
};

Plan plan(int m, int n, int d, int same) {
  Plan p;
  p.dp = pad4(d);
  p.m_pad = (m + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  p.n_pad = same ? 0 : (n + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  p.floats = (static_cast<long long>(p.m_pad) + p.n_pad) * (p.dp + 1);
  return p;
}

}  // namespace

extern "C" const char* cugp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the scratch cugp_cov takes an element of the batch (when X2
// is X1 it uses less); -1 past INT_MAX.
extern "C" int cugp_cov_scratch(int m, int n, int d) {
  if (m <= 0 || n <= 0 || d <= 0) return 0;
  const long long f = plan(m, n, d, 0).floats;
  return f > INT_MAX ? -1 : static_cast<int>(f);
}

// A batch of builds: element b's x1 (m, d) at x1 + b x1_stride and x2
// (n, d) at x2 + b x2_stride, row-major fp32, already divided by the
// lengthscale (x2 == x1 with m == n and equal strides: one tensor, one
// pre-pass); scal (batch, 3) = [sf2, diag_add, alpha] on the device; out
// element b (m, n) at out + b out_stride, leading dimension ldo; scratch:
// batch x cugp_cov_scratch floats, 16-byte aligned. kind: 0 rbf, 1
// matern12, 2 matern32, 3 matern52, 4 rq, 5 linear. The stores are
// 16-byte ones where ldo % 4 == 0, out_stride % 4 == 0 and out is 16-byte
// aligned, else 4-byte ones (cov_cuda.route names the rule). Two
// launches: the pre-pass, then the tiles; a 2-D build is batch 1.
extern "C" int cugp_cov(const float* x1, const float* x2, const float* scal,
                        float* out, float* scratch, int m, int n, int d,
                        long long ldo, int kind, int square, int n1_true,
                        int n2_true, int batch, long long x1_stride,
                        long long x2_stride, long long out_stride,
                        void* stream) {
  if (m <= 0 || n <= 0 || batch <= 0) return 0;
  if (d <= 0 || kind < RBF || kind > LINEAR || ldo < n ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0)
    return cudaErrorInvalidValue;
  const bool v4 = ldo % 4 == 0 && (batch == 1 || out_stride % 4 == 0) &&
                  (reinterpret_cast<size_t>(out) & 15) == 0;
  const int same = x1 == x2 && m == n && x1_stride == x2_stride;
  const Plan p = plan(m, n, d, same);
  const long long tiles_n = (n + BN - 1) / BN;
  const long long tiles = (m + BM - 1) / BM * tiles_n;
  if (plan(m, n, d, 0).floats > INT_MAX || tiles * batch > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs1 = scratch;
  float* h1 = xs1 + static_cast<long long>(p.m_pad) * p.dp;
  float* xs2 = same ? xs1 : h1 + p.m_pad;
  float* h2 = same ? h1 : xs2 + static_cast<long long>(p.n_pad) * p.dp;
  const long long rows = (static_cast<long long>(p.m_pad) + p.n_pad) * batch;
  const int blocks = static_cast<int>(
      rows / THREADS + 1 < 1024 ? rows / THREADS + 1 : 1024);
  cov_prep<<<blocks, THREADS, 0, s>>>(x1, x2, xs1, h1, xs2, h2, m, n, d,
                                      p.dp, p.m_pad, p.n_pad,
                                      kind == RBF ? SQRT_LOG2E : 1.0f, batch,
                                      x1_stride, x2_stride, p.floats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{xs1, h1, xs2, h2, scal, out, ldo, p.floats, out_stride,
               m, n, p.dp, n1_true, n2_true, square,
               static_cast<int>(tiles_n), static_cast<int>(tiles),
               static_cast<int>(tiles * batch)};
  switch (kind) {
    case RBF: err = launch_kind<RBF>(a, v4, s); break;
    case MATERN12: err = launch_kind<MATERN12>(a, v4, s); break;
    case MATERN32: err = launch_kind<MATERN32>(a, v4, s); break;
    case MATERN52: err = launch_kind<MATERN52>(a, v4, s); break;
    case RQ: err = launch_kind<RQ>(a, v4, s); break;
    default: err = launch_kind<LINEAR>(a, v4, s); break;
  }
  return static_cast<int>(err);
}
