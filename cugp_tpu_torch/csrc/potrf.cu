// Diagonal-block Cholesky (potrf) kernel: A = L L^T for one SPD block.
//
// Replaces cugp_tpu/ops/chol_pallas.py::_potrf_kernel, the base case of
// the recursive blocked Cholesky. The Pallas kernel holds the whole block
// in VMEM and needs n % 128 == 0; this one takes any n <= 1024 with a
// leading dimension, so it factors a diagonal block of the big buffer in
// place, and a leading batch (the Pallas kernel's vmap, chol_pallas.py:
// 182-196) by one of two routes.
//
// What bounds it on the H100: not FMA issue. A 1024^2 block is n^3/3 =
// 358 MFLOP, 5 us at the card's fp32 peak, but a Cholesky is a chain of
// T-wide steps whose diagonal factor and panel solve are serial in the
// column, so the time is the chain: per step, the diagonal tile's
// factorization (a block barrier, a sqrt and a divide per column), the
// panel solve, two grid-wide barriers and two round trips to L2, with
// the trailing update spread over the SMs in between. Design: a tiled
// right-looking Cholesky on T x T tiles (T = 32: at T = 64 each column's
// serial work per thread is 4x larger and the kernel ran 1.4x slower,
// though with half the barriers), one persistent grid of G CTAs in one
// cooperative launch (G = min(co-resident CTAs, trailing tiles of step
// 0)). Step k:
//   1. panel: the tiles (i, k), i >= k, are dealt round-robin to CTAs.
//      Every owner loads the lower part of A_kk (identity padded past n)
//      into registers and factors it with the same code, so all get the
//      bitwise-same L_kk and no CTA waits for another: rows in registers,
//      one block barrier a column. The other owners (their tile's loads
//      issued before the factor) solve X L_kk^T = A_ik by substitution,
//      rows in parallel, pivots passed by shuffle with no block barrier,
//      and write L_ik in place. CTA 0 writes L_kk after the grid barrier,
//      since the other owners read A_kk until then.
//   2. update: the tiles (i, j), k < j <= i, are dealt round-robin;
//      A_ij -= L_ik L_jk^T with both panels staged transposed in shared
//      memory (all loads issued first) and a register micro-tile of
//      2 x 2 outputs a thread, read as float2: half a shared load an
//      FMA, not 2.
// Each phase ends in a grid barrier (cooperative_groups); tiles other
// CTAs wrote in this launch are read past L1 (__ldcg), which is not
// coherent across SMs. A tile's sums run in a fixed order whoever owns
// it, so the result does not depend on G.
//
// Two routes for a batch of blocks. The cooperative route above factors
// them one after another, each over the whole grid: right for one block
// or a few. The batch route (a batch of hyperparameter chains, 256
// blocks of n = 512) launches one CTA a block, an ordinary launch: the
// same code at G = 1, block barriers (__syncthreads) where the
// cooperative route has grid barriers, so every block's tiles run on one
// SM and the blocks run side by side. Since the result does not depend
// on G, the two routes give the same bits (chip_smoke.py phase 2 checks
// it). cugp_potrf picks the batch route from the batch and the card's SM
// count (BATCH_MIN_SM_SHARE) and says which route it takes through
// cugp_potrf_route. Only the lower triangle is
// read (callers pass SYRK-lower results whose upper triangle is stale);
// zeros are written above the diagonal at the end; nothing outside the
// block is written. A non-positive pivot gives sqrtf of a negative
// number: NaN, which propagates, so callers can detect a failed
// factorization. Fp32 FMA only (no tensor cores: their only fp32 path
// is TF32).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device_facts.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAXN = 1024;
constexpr int T = 32;             // tile edge
constexpr int RG = THREADS / T;   // threads a row in the panel phase
constexpr int CPT = T / RG;       // columns each of them holds
constexpr int LD1 = T + 1;        // row stride of L_kk in shared memory
constexpr int LD2 = T + 4;        // row stride of update tiles
constexpr int MR = 2;  // update micro-tile edge: 16 x 16 threads, float2 reads
// floats: L_kk, two column buffers and 1 / L_jj; or the two transposed
// panels of the update
constexpr int SMEM1 = T * LD1 + 3 * T, SMEM2 = 2 * T * LD2;
constexpr size_t SMEM_BYTES = (SMEM1 > SMEM2 ? SMEM1 : SMEM2) * sizeof(float);

__device__ __forceinline__ float* at(float* a, long long lda, int r, int c) {
  return a + static_cast<long long>(r) * lda + c;
}

// Row r of a T x T tile at (r0, c0), columns q, q + RG, ... of it, into
// thread (r, q)'s registers (rows x cols valid). A diagonal tile keeps
// only its lower part and is identity padded past n; a panel tile is
// zero padded. The loads are independent, so their latencies overlap.
__device__ __forceinline__ void load_rows(const float* a, long long lda,
                                          int r0, int rows, int c0, int cols,
                                          bool diag, float (&x)[CPT]) {
  const int r = threadIdx.x / RG, q = threadIdx.x % RG;
#pragma unroll
  for (int t = 0; t < CPT; ++t) {
    const int c = q + RG * t;
    float v = 0.0f;
    if (r < rows && c < cols && (!diag || c <= r))
      v = __ldcg(a + static_cast<long long>(r0 + r) * lda + c0 + c);
    else if (diag && r == c && r >= rows)
      v = 1.0f;
    x[t] = v;
  }
}

// Factor a diagonal tile held in registers as load_rows left it, into
// shared memory: Ls = L_kk (zeros above, identity past n), rinv[j] = 1 / L_jj.
// Column j is published to a double buffer, and after one barrier every
// thread scales it by 1 / sqrt(pivot) itself, so L_cj is the same product
// wherever it is used.
__device__ void factor_diag(float (&x)[CPT], float* Ls,
                            float* colbuf, float* rinv) {
  const int tid = threadIdx.x;
  const int r = tid / RG, q = tid % RG;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    float* col = colbuf + (j & 1) * T;
    if (q == j % RG) col[r] = x[j / RG];
    __syncthreads();
    const float d = sqrtf(col[j]);
    const float ri = 1.0f / d;
    const float lr = __fmul_rn(col[r], ri);
    if (q == j % RG && r >= j) x[j / RG] = (r == j) ? d : lr;
#pragma unroll
    for (int t = j / RG; t < CPT; ++t) {
      const int c = q + RG * t;
      if (c > j && c <= r)
        x[t] = __fmaf_rn(-lr, __fmul_rn(col[c], ri), x[t]);
    }
    if (tid == 0) rinv[j] = ri;
  }
#pragma unroll
  for (int t = 0; t < CPT; ++t) Ls[r * LD1 + q + RG * t] = x[t];
  __syncthreads();
}

// L_ik = A_ik L_kk^{-T} on a panel tile held as load_rows left it, by
// substitution with rows in parallel: x_j = a_j / L_jj is passed along
// the row's RG threads by shuffle, then a_c -= x_j L_cj for c > j. No
// block-wide barrier. Written in place (rows x cols valid).
__device__ void solve_panel(float (&x)[CPT], const float* Ls,
                            const float* rinv, float* a, long long lda,
                            int i0, int rows, int k0, int cols) {
  const int r = threadIdx.x / RG, q = threadIdx.x % RG;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float v = __fmul_rn(x[j / RG], rinv[j]);
    const float xj = __shfl_sync(0xffffffffu, v, j % RG, RG);
    if (q == j % RG) x[j / RG] = xj;
#pragma unroll
    for (int t = j / RG; t < CPT; ++t) {
      const int c = q + RG * t;
      if (c > j) x[t] = __fmaf_rn(-xj, Ls[c * LD1 + j], x[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < CPT; ++t) {
    const int c = q + RG * t;
    if (r < rows && c < cols) __stcg(at(a, lda, i0 + r, k0 + c), x[t]);
  }
}

// The lower part of L_kk (in Ls) to the diagonal tile at (k0, k0).
__device__ void write_diag(float* a, long long lda, int k0, int kb,
                           const float* Ls) {
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int r = e / T, c = e % T;
    if (r < kb && c <= r)
      __stcg(at(a, lda, k0 + r, k0 + c), Ls[r * LD1 + c]);
  }
}

// One panel tile's share of this thread, for staging transposed:
// v[s] = A[row0 + r][k0 + m] with (r, m) = rm(s). A warp reads 4 rows x 8
// columns (one 32-byte sector a row); with the row stride T + 4 the
// transposed stores dst[m][r] fall in 32 distinct banks.
struct Stage {
  static constexpr int RB = T / 4;
  static constexpr int PER = (T / 4) * (T / 8) / (THREADS / 32);
  __device__ static int row(int s) {
    return 4 * ((threadIdx.x / 32 + (THREADS / 32) * s) % RB) +
           (threadIdx.x % 32) / 8;
  }
  __device__ static int col(int s) {
    return 8 * ((threadIdx.x / 32 + (THREADS / 32) * s) / RB) +
           threadIdx.x % 8;
  }
  __device__ static void load(const float* a, long long lda, int n, int row0,
                              int k0, int kb, float (&v)[PER]) {
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int r = row(s), m = col(s);
      v[s] = (row0 + r < n && m < kb)
          ? __ldcg(a + static_cast<long long>(row0 + r) * lda + k0 + m)
          : 0.0f;
    }
  }
  __device__ static void store(const float (&v)[PER], float* dst) {
#pragma unroll
    for (int s = 0; s < PER; ++s) dst[col(s) * LD2 + row(s)] = v[s];
  }
};

// A_ij -= L_ik L_jk^T for the tile at rows i0.., columns j0.., panel
// columns k0.. (kb valid); on a diagonal tile (i0 == j0) only entries on
// or below the diagonal are written.
__device__ void update_tile(float* a, long long lda, int n, int i0, int j0,
                            int k0, int kb, float* smem) {
  constexpr int RS = THREADS / T, NS = T / RS;  // write-back rows a pass
  const int tid = threadIdx.x;
  const int wc = tid % T, wr = tid / T;
  // every load issued before any use: both panels, then the old values
  float pv[Stage::PER], qv_[Stage::PER], old[NS];
  Stage::load(a, lda, n, i0, k0, kb, pv);
  Stage::load(a, lda, n, j0, k0, kb, qv_);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int gi = i0 + wr + RS * s, gj = j0 + wc;
    old[s] = (gi < n && gj < n) ? __ldcg(at(a, lda, gi, gj)) : 0.0f;
  }
  float* Pt = smem;           // Pt[m][r] = L_ik[r][m]
  float* Qt = smem + T * LD2;  // Qt[m][c] = L_jk[c][m]
  Stage::store(pv, Pt);
  Stage::store(qv_, Qt);
  __syncthreads();
  const int tr = tid / 16, tc = tid % 16;
  float acc[MR][MR];
#pragma unroll
  for (int u = 0; u < MR; ++u)
#pragma unroll
    for (int v = 0; v < MR; ++v) acc[u][v] = 0.0f;
#pragma unroll 8
  for (int m = 0; m < T; ++m) {
    const float2 p2 = *reinterpret_cast<const float2*>(Pt + m * LD2 + 2 * tr);
    const float2 q2 = *reinterpret_cast<const float2*>(Qt + m * LD2 + 2 * tc);
    const float p[MR] = {p2.x, p2.y}, qv[MR] = {q2.x, q2.y};
#pragma unroll
    for (int u = 0; u < MR; ++u)
#pragma unroll
      for (int v = 0; v < MR; ++v)
        acc[u][v] = __fmaf_rn(p[u], qv[v], acc[u][v]);
  }
  __syncthreads();  // the panels are read; reuse their space for the sums
  float* Ct = smem;  // Ct[r][c], row stride LD2
#pragma unroll
  for (int u = 0; u < MR; ++u)
    *reinterpret_cast<float2*>(Ct + (MR * tr + u) * LD2 + MR * tc) =
        make_float2(acc[u][0], acc[u][1]);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = wr + RS * s;
    const int gi = i0 + r, gj = j0 + wc;
    if (gi < n && gj < n && (i0 != j0 || wc <= r))
      __stcg(at(a, lda, gi, gj), old[s] - Ct[r * LD2 + wc]);
  }
  __syncthreads();  // before the next tile's staging overwrites Ct
}

// A barrier over the CTAs that share a block: the whole grid (the
// cooperative route) or this CTA (the batch route).
template <bool BATCH>
__device__ __forceinline__ void step_barrier() {
  if constexpr (BATCH) __syncthreads();
  else cg::this_grid().sync();
}

// BATCH = false: the cooperative route, gridDim.x CTAs on each block in
// turn. BATCH = true: CTA b factors block b alone (G = 1).
template <bool BATCH>
__global__ void __launch_bounds__(THREADS)
potrf_kernel(float* a_base, long long lda, long long batch_stride, int n,
             int batch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ls = smem;
  float* colbuf = Ls + T * LD1;
  float* rinv = colbuf + 2 * T;
  const int nt = (n + T - 1) / T;
  const int ctas = BATCH ? 1 : gridDim.x, me = BATCH ? 0 : blockIdx.x;

  const int b0 = BATCH ? static_cast<int>(blockIdx.x) : 0;
  for (int b = b0; b < (BATCH ? b0 + 1 : batch); ++b) {
    float* a = a_base + b * batch_stride;
    for (int k = 0; k < nt; ++k) {
      const int k0 = k * T, kb = min(T, n - k0);
      const int panel = nt - k;  // tiles (k..nt-1, k)
      if (me < panel) {
        // this CTA's first panel tile is loaded before the diagonal
        // factor, so its latency hides behind it
        const int p0 = (me == 0) ? ctas : me;
        float xp[CPT], xd[CPT];
        if (p0 < panel)
          load_rows(a, lda, k0 + p0 * T, min(T, n - k0 - p0 * T), k0, kb,
                    false, xp);
        load_rows(a, lda, k0, kb, k0, kb, true, xd);
        factor_diag(xd, Ls, colbuf, rinv);
        for (int p = p0; p < panel; p += ctas) {
          const int i0 = k0 + p * T, ib = min(T, n - i0);
          if (p != p0) load_rows(a, lda, i0, ib, k0, kb, false, xp);
          solve_panel(xp, Ls, rinv, a, lda, i0, ib, k0, kb);
        }
      }
      if (k == nt - 1) {
        if (me == 0) write_diag(a, lda, k0, kb, Ls);
        break;
      }
      step_barrier<BATCH>();
      if (me == 0) {
        write_diag(a, lda, k0, kb, Ls);
        __syncthreads();
      }
      const int m = nt - k - 1;  // trailing tile rows
      for (int idx = me; idx < m * (m + 1) / 2; idx += ctas) {
        int ii = static_cast<int>((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
        while (ii * (ii + 1) / 2 > idx) --ii;
        while ((ii + 1) * (ii + 2) / 2 <= idx) ++ii;
        const int jj = idx - ii * (ii + 1) / 2;
        update_tile(a, lda, n, k0 + (ii + 1) * T, k0 + (jj + 1) * T, k0, kb,
                    smem);
      }
      step_barrier<BATCH>();
    }
    // zeros above the diagonal (never read by the steps)
    for (int r = me; r < n; r += ctas)
      for (int c = r + 1 + static_cast<int>(threadIdx.x); c < n; c += THREADS)
        __stcg(at(a, lda, r, c), 0.0f);
  }
}

// The batch route once batch >= SMs / BATCH_MIN_SM_SHARE: 9 blocks on an
// H100's 132 SMs. At n = 512 one CTA takes ~1.3 ms a block whatever the
// batch up to 64, the cooperative route ~0.16 ms a block one after
// another, so they cross between 8 and 16 blocks (1.2925 against 1.3309
// ms at 8, 2.5681 against 1.3231 at 16; H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 2).
constexpr int BATCH_MIN_SM_SHARE = 16;

enum Route { AUTO = 0, COOPERATIVE = 1, BATCHED = 2 };

}  // namespace

// The route cugp_potrf takes for batch blocks when asked for AUTO: 1 the
// cooperative route, 2 the batch route.
extern "C" int cugp_potrf_route(int batch, int* route) {
  int sms = 0;
  cudaError_t err = cugp::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  *route = batch > 1 && batch * BATCH_MIN_SM_SHARE >= sms ? BATCHED
                                                          : COOPERATIVE;
  return 0;
}

// The grid the cooperative route takes for an (n, n) block: min(co-resident
// CTAs, trailing tiles of step 0), at least 1.
extern "C" int cugp_potrf_grid(int n, int* grid) {
  int cap = 0;
  cudaError_t err =
      cugp::resident_ctas<potrf_kernel<false>, THREADS, SMEM_BYTES>(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = (n + T - 1) / T - 1;
  const int tiles = m * (m + 1) / 2;
  *grid = tiles < 1 ? 1 : (tiles < cap ? tiles : cap);
  return 0;
}

// a: batch blocks of (n, n) fp32, row-major with leading dimension lda,
// block b at a + b * batch_stride; factored in place (lower L, zeros above).
// route: 0 auto (cugp_potrf_route), 1 cooperative, 2 batch; both routes
// give the same bits.
extern "C" int cugp_potrf(float* a, long long lda, long long batch_stride,
                          int n, int batch, int route, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (n > MAXN || lda < n || route < AUTO || route > BATCHED)
    return cudaErrorInvalidValue;
  int err = 0;
  if (route == AUTO) {
    err = cugp_potrf_route(batch, &route);
    if (err != 0) return err;
  }
  void* args[] = {&a, &lda, &batch_stride, &n, &batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == BATCHED) {
    potrf_kernel<true><<<batch, THREADS, SMEM_BYTES, s>>>(a, lda, batch_stride,
                                                           n, batch);
    return static_cast<int>(cudaGetLastError());
  }
  int grid = 0;
  err = cugp_potrf_grid(n, &grid);
  if (err != 0) return err;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(potrf_kernel<false>), dim3(grid),
      dim3(THREADS), args, SMEM_BYTES, s));
}
