// Diagonal-block triangular solve (TRSM): op(L) X = B, op in {L, L^T}.
//
// Replaces cugp_tpu/ops/trsm_pallas.py::_trsm_kernel (trsm_pallas.py:35)
// together with its in-kernel helper chol_pallas.py::_trtri_tile
// (chol_pallas.py:54), the base case of the recursive blocked solves.
// L is lower (any n <= 1024, leading dimension ldl; only its lower
// triangle is read, since the Cholesky recursion hands over blocks with
// stale values above the diagonal). B is (n, k) with arbitrary row and
// column strides, and X overwrites it in place: a right-side solve
// X L^T = B is L X^T = B^T, the same call with B's strides swapped.
//
// A batch (chains as a leading dimension, the Pallas call under vmap) is
// one launch of each pass with the element as the grid's y index:
// element e's L, B and inverted tiles at fixed strides. Every CTA does
// the work it does in a 2-D call, so an element's result equals its own
// 2-D solve bitwise.
//
// The shape is the TPU kernel's: each T x T diagonal tile of L is
// inverted once (trtri pass), and every panel of the solve is a strip
// update R_p = B_p - op(L)[p, solved] X[solved] followed by the product
// X_p = op(L_pp)^{-1} R_p. Both steps are dense products, so no
// per-column substitution chain is left in the solve. The constants
// below (T, NARROW_MAX, the ring depths, the micro-tile) were chosen by
// A/B runs on an H100; PERF.md has the readings.
//
//   trtri pass   one CTA per diagonal tile (identity padded past n, the
//                strict upper part ignored), as 2 x 2 blocks of 32: the
//                two diagonal blocks by substitution, a warp per column
//                of each, pivots passed by shuffle; then the corner by
//                two 32 x 32 products. It writes W_p = op(L_pp)^{-1} into
//                a scratch of (ceil(n / T), T, T) floats. Latency-bound
//                (a 32-step chain), about 7 us.
//   narrow route k <= NARROW_MAX (the alpha solves, k = 1; the
//                preconditioner, k = 9). Bound by how fast one SM pulls
//                in the 2.2 MB of L's lower triangle and W (n = 1024):
//                FMAs are few and the load latency is hidden. One CTA
//                per column, so k columns use k SMs. No tile of L or W
//                depends on X, so they stream through a ring of
//                NARROW_STAGES tiles with cp.async, issued ahead of use
//                across panel boundaries. Each thread owns 4 rows x 4 m
//                of every tile and streams exactly those four 16-byte
//                pieces into its own slots, so a tile costs it four
//                cp.async and its own wait, and no block barrier (two a
//                panel remain). The panel's sums are reduced by shuffle
//                across the T / 4 lanes of a row group.
//   wide route   larger k (predict, the Cholesky panel solves, Murray's
//                backward). Bound by fp32 FMA issue. The grid runs over
//                slabs of W in {8, 16, 32} columns, the widest whose CTAs
//                still cover the SMs; each CTA keeps its (n, W) slab in
//                shared memory and walks the panels. Strip and diagonal
//                products are register-tiled: each thread owns an
//                MR x MICRO_COLS micro-tile of outputs fed by vector
//                shared-memory loads, and the next L tile's cp.async
//                overlaps this tile's FMAs (WIDE_STAGES deep ring).
//
// Determinism: each output's sums run in an order fixed by n and the
// route (tiles in ascending m, m ascending within a tile, explicit fmaf;
// the narrow route's shuffle tree is fixed too). No atomics, no split-k
// across CTAs: two launches agree bitwise, and in the wide route a
// column's result does not depend on the slab width W.
//
// Accuracy: applying inverted T x T tiles (as the TPU kernel and MAGMA
// do) has a forward error that grows with cond(L_pp), not cond(L).
//
// Alignment: cp.async of 16 bytes needs L and ldl 16-byte aligned; if
// they are not (a view with an odd leading dimension), or a tile row
// ends inside a 16-byte group at n, the same loop takes scalar loads.

#include <cuda_runtime.h>

#include "device_facts.cuh"

namespace {

constexpr int T = 64;                        // tile edge and panel height
constexpr int LDS = T + 4;                   // tile row stride in shared memory
constexpr int STAGE = T * LDS;               // floats a ring stage
constexpr int MAXN = 1024;
constexpr int NARROW_MAX = 16;               // k at or below: narrow route
constexpr int KG = T / 4;                    // narrow: lanes sharing a row group
constexpr int NARROW_THREADS = (T / 4) * KG;
constexpr int NARROW_STAGES = 4;             // narrow ring depth, in tiles
constexpr int WIDE_STAGES = 3;               // wide ring depth, in tiles
constexpr int TRTRI_THREADS = 1024;

constexpr int MICRO_ROWS = 4;     // wide micro-tile rows a thread, W >= 16
constexpr int MICRO_ROWS_W8 = 2;  // the same at W = 8
constexpr int MICRO_COLS = 2;     // wide micro-tile columns a thread

__host__ __device__ constexpr int wide_mr(int w) {
  return w >= 16 ? MICRO_ROWS : MICRO_ROWS_W8;
}
__host__ __device__ constexpr int wide_threads(int w) {
  return (T / wide_mr(w)) * (w / MICRO_COLS);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// shared-memory reads after it are not moved above it ("memory")
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive floats (N = 1, 2 or a multiple of 4) from / to shared
// memory in vector accesses
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    static_assert(N == 1, "N = 1, 2 or a multiple of 4");
    v[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    static_assert(N == 1, "N = 1, 2 or a multiple of 4");
    p[0] = v[0];
  }
}

// The 4 floats at (row, col) of a tile (rows x cols valid, zeros past
// them) into dst: one cp.async where vec and inside, else masked scalar
// loads.
__device__ __forceinline__ void load_piece(float4* dst, const float* src,
                                           long long ld, int row, int col,
                                           int rows, int cols, bool vec) {
  const float* s = src + static_cast<long long>(row) * ld + col;
  if (vec && row < rows && col + 4 <= cols) {
    cp_async16(reinterpret_cast<float*>(dst), s);
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (row < rows && col + j < cols) ? s[j] : 0.0f;
    st_vec<4>(reinterpret_cast<float*>(dst), v);
  }
}

// A T x T tile from src (leading dimension ld) into dst (row stride
// LDS), by the nthr threads of the block.
__device__ void load_tile(float* dst, const float* src, long long ld,
                          int rows, int cols, bool vec, int nthr) {
  for (int e = threadIdx.x; e < T * T / 4; e += nthr) {
    const int r = e / (T / 4), c = 4 * (e % (T / 4));
    load_piece(reinterpret_cast<float4*>(dst + r * LDS + c), src, ld, r, c,
               rows, cols, vec);
  }
}

// The tiles the solve uses, in order: panel by panel (forward for L,
// backward for L^T), first the t strip tiles of the t-th panel (in
// ascending m), then its W_p. issue(load, buf) hands the next one to
// load(buf, src, ld, rows, cols, vec, strip), buf being the ring slot,
// and commits one cp.async group.
template <bool TR>
struct Stream {
  const float* l;
  long long ldl;
  const float* winv;
  int n, nt;
  bool vec;
  int t = 0, q = 0;  // the next stage to issue

  template <typename Load>
  __device__ void issue(Load load, int buf) {
    if (t < nt) {
      const int p = TR ? nt - 1 - t : t;
      if (q < t) {
        // forward: L[p, q]; transpose: L[p + 1 + q, p], read as stored
        const int i0 = (TR ? p + 1 + q : p) * T, j0 = (TR ? p : q) * T;
        load(buf, l + static_cast<long long>(i0) * ldl + j0, ldl, n - i0,
             n - j0, vec, true);
      } else {
        load(buf, winv + static_cast<long long>(p) * T * T,
             static_cast<long long>(T), T, T, true, false);
      }
      if (++q > t) { ++t; q = 0; }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  }
};

// ---------------------------------------------------------------------------
// trtri pass: W_p = L_pp^{-1} (or its transpose), one CTA per tile.

__global__ void __launch_bounds__(TRTRI_THREADS)
trsm_trtri_kernel(const float* __restrict__ l, long long ldl, long long lbs,
                  int n, int transpose, float* __restrict__ winv,
                  long long wbs) {
  l += blockIdx.y * lbs;
  winv += blockIdx.y * wbs;
  // the tile as [[A, 0], [C, D]] with 32 x 32 blocks; its inverse is
  // [[A^{-1}, 0], [-D^{-1} C A^{-1}, D^{-1}]]
  static_assert(T == 64 && TRTRI_THREADS == 32 * 32, "2 x 2 blocks of 32");
  __shared__ float Ld[T][T + 1];  // the tile; C A^{-1} goes above its diagonal
  __shared__ float Xs[T][T + 1];  // the inverse
  __shared__ float rinv[T];
  const int p0 = blockIdx.x * T, pb = min(T, n - p0);
  for (int e = threadIdx.x; e < T * T; e += TRTRI_THREADS) {
    const int r = e / T, c = e % T;
    float v;
    if (r < pb && c < pb)
      v = (c <= r) ? l[static_cast<long long>(p0 + r) * ldl + p0 + c] : 0.0f;
    else
      v = (r == c) ? 1.0f : 0.0f;
    Ld[r][c] = v;
    if (r == c) rinv[r] = 1.0f / v;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  // column w of A^{-1} and of D^{-1} (two independent chains a warp):
  // right-looking, x_j = v_j (1 / L_jj) passed by shuffle, then
  // v_r -= L_rj x_j for r > j
  float val[2] = {lane == w ? 1.0f : 0.0f, lane == w ? 1.0f : 0.0f};
  for (int j = w; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jj = 32 * h + j;
      const float xj = __fmul_rn(__shfl_sync(0xffffffffu, val[h], j), rinv[jj]);
      const float upd = __fmaf_rn(-Ld[32 * h + lane][jj], xj, val[h]);
      val[h] = lane == j ? xj : (lane > j ? upd : val[h]);
    }
  }
  Xs[lane][w] = val[0];
  Xs[32 + lane][32 + w] = val[1];
  Xs[lane][32 + w] = 0.0f;
  __syncthreads();
  const int r = w, c = lane;
  float acc = 0.0f;  // (C A^{-1})[r][c]
#pragma unroll 8
  for (int m = 0; m < 32; ++m) acc = __fmaf_rn(Ld[32 + r][m], Xs[m][c], acc);
  Ld[r][32 + c] = acc;
  __syncthreads();
  acc = 0.0f;  // (D^{-1} C A^{-1})[r][c]
#pragma unroll 8
  for (int m = 0; m < 32; ++m) acc = __fmaf_rn(Xs[32 + r][32 + m], Ld[m][32 + c], acc);
  Xs[32 + r][c] = -acc;
  __syncthreads();
  float* out = winv + static_cast<long long>(blockIdx.x) * T * T;
  for (int e = threadIdx.x; e < T * T; e += TRTRI_THREADS) {
    const int i = e / T, k = e % T;
    out[e] = transpose ? Xs[k][i] : Xs[i][k];
  }
}

// ---------------------------------------------------------------------------
// Narrow route: one CTA per column, x in shared memory. Thread
// (row group, mg) uses rows r0..r0+3 and m in 4 mg..4 mg+3 of a tile (of
// L^T: m = mg + KG j, j < 4), and it streams exactly those four 16-byte
// pieces into its own ring slots, so a stage waits on its own cp.async
// groups and no block barrier; there are two a panel.

template <bool TR>
__global__ void __launch_bounds__(NARROW_THREADS)
trsm_narrow_kernel(const float* l, long long ldl, long long lbs,
                   const float* winv, long long wbs, float* b, long long bbs,
                   long long rs, long long cs, int n, int vec) {
  constexpr int NT = NARROW_THREADS;
  extern __shared__ float4 smem4[];
  float4* ring = smem4;  // piece j of stage s: ring[(4 s + j) NT + tid]
  const int nt = (n + T - 1) / T, np = nt * T;
  float* xs = reinterpret_cast<float*>(ring + NARROW_STAGES * 4 * NT);
  float* rsm = xs + np;  // R_p
  const int tid = threadIdx.x;
  const int mg = tid % KG, r0 = 4 * (tid / KG);
  l += blockIdx.y * lbs;
  winv += blockIdx.y * wbs;
  b += blockIdx.y * bbs + blockIdx.x * cs;

  for (int i = tid; i < np; i += NT) xs[i] = i < n ? b[i * rs] : 0.0f;

  Stream<TR> st{l, ldl, winv, n, nt, vec != 0};
  auto load = [=](int buf, const float* src, long long ld, int rows,
                  int cols, bool v, bool strip) {
    float4* slot = ring + 4 * buf * NT + tid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (TR && strip)
        load_piece(slot + j * NT, src, ld, mg + KG * j, r0, rows, cols, v);
      else
        load_piece(slot + j * NT, src, ld, r0 + j, 4 * mg, rows, cols, v);
    }
  };
  for (int buf = 0; buf < NARROW_STAGES - 1; ++buf) st.issue(load, buf);
  __syncthreads();  // x

  int s = 0;
  for (int t = 0; t < nt; ++t) {
    const int p = TR ? nt - 1 - t : t;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = 0; q <= t; ++q, ++s) {
      cp_async_wait<NARROW_STAGES - 2>();
      float a[4][4];  // this thread's pieces of stage s
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ld_vec<4>(reinterpret_cast<const float*>(
                      ring + (4 * (s % NARROW_STAGES) + j) * NT + tid), a[j]);
      st.issue(load, (s + NARROW_STAGES - 1) % NARROW_STAGES);
      if (q < t) {
        // strip: acc += op(L)[p rows, tile m] x[tile m]
        if (!TR) {
          float x[4];
          ld_vec<4>(xs + q * T + 4 * mg, x);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[u] = __fmaf_rn(a[u][j], x[j], acc[u]);
        } else {
          // a[j][u] = L[m0 + KG j][p T + r0 + u]
          const int m0 = (p + 1 + q) * T + mg;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = xs[m0 + KG * j];
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[u] = __fmaf_rn(a[j][u], x, acc[u]);
          }
        }
      } else {
        // r_p = b_p - strip, then x_p = W_p r_p; sums by shuffle across
        // the KG lanes of a row group, lane mg == u writes row r0 + u
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int off = KG / 2; off > 0; off /= 2)
            acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
          if (u == mg) rsm[r0 + u] = __fsub_rn(xs[p * T + r0 + u], acc[u]);
        }
        __syncthreads();
        float x[4];
        ld_vec<4>(rsm + 4 * mg, x);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float y = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) y = __fmaf_rn(a[u][j], x[j], y);
#pragma unroll
          for (int off = KG / 2; off > 0; off /= 2)
            y += __shfl_xor_sync(0xffffffffu, y, off);
          if (u == mg) xs[p * T + r0 + u] = y;
        }
        __syncthreads();  // x_p, before the next panel's strip reads it
      }
    }
  }
  cp_async_wait<0>();
  for (int i = tid; i < n; i += NT) b[i * rs] = xs[i];
}

// ---------------------------------------------------------------------------
// Wide route: one CTA per W-column slab; X in shared memory row-major.

template <int W, bool TR>
__global__ void __launch_bounds__(wide_threads(W))
trsm_wide_kernel(const float* l, long long ldl, long long lbs,
                 const float* winv, long long wbs, float* b, long long bbs,
                 long long rs, long long cs, int n, int k, int vec) {
  constexpr int MR = wide_mr(W), MC = MICRO_COLS, THR = wide_threads(W);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int nt = (n + T - 1) / T, np = nt * T;
  float* xs = ring + WIDE_STAGES * STAGE;  // xs[i * W + c]
  float* rsm = xs + np * W;                // rsm[r * W + c]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * W, kc = min(W, k - c0);
  l += blockIdx.y * lbs;
  winv += blockIdx.y * wbs;
  b += blockIdx.y * bbs;

  for (int e = tid; e < np * W; e += THR) {
    int i, c;
    if (rs == 1) { i = e % np; c = e / np; } else { c = e % W; i = e / W; }
    xs[i * W + c] = (i < n && c < kc) ? b[i * rs + (c0 + c) * cs] : 0.0f;
  }

  Stream<TR> st{l, ldl, winv, n, nt, vec != 0};
  auto load = [=](int buf, const float* src, long long ld, int rows,
                  int cols, bool v, bool) {
    load_tile(ring + buf * STAGE, src, ld, rows, cols, v, THR);
  };
  for (int buf = 0; buf < WIDE_STAGES - 1; ++buf) st.issue(load, buf);

  const int cc = MC * (tid % (W / MC)), r0 = MR * (tid / (W / MC));
  int s = 0;
  for (int t = 0; t < nt; ++t) {
    const int p = TR ? nt - 1 - t : t;
    float acc[MR][MC];
#pragma unroll
    for (int u = 0; u < MR; ++u)
#pragma unroll
      for (int v = 0; v < MC; ++v) acc[u][v] = 0.0f;
    for (int q = 0; q <= t; ++q, ++s) {
      cp_async_wait<WIDE_STAGES - 2>();
      __syncthreads();
      st.issue(load, (s + WIDE_STAGES - 1) % WIDE_STAGES);
      const float* tile = ring + (s % WIDE_STAGES) * STAGE;
      if (q < t) {
        const int m0 = (TR ? p + 1 + q : q) * T;
#pragma unroll 4
        for (int mb = 0; mb < T; mb += 4) {
          float x[4][MC], a[MR][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) ld_vec<MC>(xs + (m0 + mb + j) * W + cc, x[j]);
          if (!TR) {
#pragma unroll
            for (int u = 0; u < MR; ++u) ld_vec<4>(tile + (r0 + u) * LDS + mb, a[u]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float at[MR];
              ld_vec<MR>(tile + (mb + j) * LDS + r0, at);
#pragma unroll
              for (int u = 0; u < MR; ++u) a[u][j] = at[u];
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int u = 0; u < MR; ++u)
#pragma unroll
              for (int v = 0; v < MC; ++v)
                acc[u][v] = __fmaf_rn(a[u][j], x[j][v], acc[u][v]);
        }
      } else {
        // R_p = B_p - strip, then X_p = W_p R_p
#pragma unroll
        for (int u = 0; u < MR; ++u) {
          float bv[MC];
          ld_vec<MC>(xs + (p * T + r0 + u) * W + cc, bv);
#pragma unroll
          for (int v = 0; v < MC; ++v) bv[v] = __fsub_rn(bv[v], acc[u][v]);
          st_vec<MC>(rsm + (r0 + u) * W + cc, bv);
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < MR; ++u)
#pragma unroll
          for (int v = 0; v < MC; ++v) acc[u][v] = 0.0f;
#pragma unroll 4
        for (int mb = 0; mb < T; mb += 4) {
          float x[4][MC], a[MR][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) ld_vec<MC>(rsm + (mb + j) * W + cc, x[j]);
#pragma unroll
          for (int u = 0; u < MR; ++u) ld_vec<4>(tile + (r0 + u) * LDS + mb, a[u]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int u = 0; u < MR; ++u)
#pragma unroll
              for (int v = 0; v < MC; ++v)
                acc[u][v] = __fmaf_rn(a[u][j], x[j][v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < MR; ++u) st_vec<MC>(xs + (p * T + r0 + u) * W + cc, acc[u]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < np * W; e += THR) {
    int i, c;
    if (rs == 1) { i = e % np; c = e / np; } else { c = e % W; i = e / W; }
    if (i < n && c < kc) b[i * rs + (c0 + c) * cs] = xs[i * W + c];
  }
}

// ---------------------------------------------------------------------------
// Launchers. The dynamic shared-memory ceiling is raised once per device
// and kernel, at the size n = MAXN needs.

struct Args {
  const float* l;
  long long ldl, lbs;  // lbs, wbs, bbs: an element's stride in the batch
  const float* winv;
  long long wbs;
  float* b;
  long long bbs, rs, cs;
  int n, k, vec, batch;
  cudaStream_t stream;
};

size_t narrow_smem(int n) {
  const int np = (n + T - 1) / T * T;
  return static_cast<size_t>(NARROW_STAGES) * 4 * NARROW_THREADS * sizeof(float4) +
         static_cast<size_t>(np + T) * sizeof(float);
}

size_t wide_smem(int w, int n) {
  const int np = (n + T - 1) / T * T;
  return (static_cast<size_t>(WIDE_STAGES) * STAGE +
          static_cast<size_t>(w) * (np + T)) * sizeof(float);
}

template <bool TR>
cudaError_t launch_narrow(const Args& a) {
  cudaError_t err =
      cugp::raise_smem_once<trsm_narrow_kernel<TR>>(narrow_smem(MAXN));
  if (err != cudaSuccess) return err;
  trsm_narrow_kernel<TR><<<dim3(a.k, a.batch), NARROW_THREADS,
                           narrow_smem(a.n), a.stream>>>(
      a.l, a.ldl, a.lbs, a.winv, a.wbs, a.b, a.bbs, a.rs, a.cs, a.n, a.vec);
  return cudaGetLastError();
}

template <int W, bool TR>
cudaError_t launch_wide(const Args& a) {
  cudaError_t err =
      cugp::raise_smem_once<trsm_wide_kernel<W, TR>>(wide_smem(W, MAXN));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((a.k + W - 1) / W);
  trsm_wide_kernel<W, TR><<<dim3(grid, a.batch), wide_threads(W),
                            wide_smem(W, a.n), a.stream>>>(
      a.l, a.ldl, a.lbs, a.winv, a.wbs, a.b, a.bbs, a.rs, a.cs, a.n, a.k,
      a.vec);
  return cudaGetLastError();
}

// The widest slab whose CTAs (over the whole batch) still cover the SMs
// (all but 1/32 of them). A column's result does not depend on W.
template <bool TR>
cudaError_t launch_wide_for(const Args& a) {
  int sms = 0;
  cudaError_t err = cugp::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long need = sms - sms / 32;
  if (static_cast<long long>((a.k + 31) / 32) * a.batch >= need)
    return launch_wide<32, TR>(a);
  if (static_cast<long long>((a.k + 15) / 16) * a.batch >= need)
    return launch_wide<16, TR>(a);
  return launch_wide<8, TR>(a);
}

}  // namespace

// Floats of the scratch cugp_trsm needs for the inverted diagonal tiles
// of one (n, n) L (a batch takes this many an element).
extern "C" int cugp_trsm_scratch(int n) {
  return (n + T - 1) / T * T * T;
}

// A batch of solves: element e's L (n, n) lower at l + e * l_batch_stride,
// leading dimension ldl; its B (n, k), entry (i, j) at b[e *
// b_batch_stride + i * row_stride + j * col_stride], overwritten with
// op(L)^{-1} B. scratch: batch x cugp_trsm_scratch(n) floats on the
// device, 16-byte aligned. A 2-D solve is batch 1.
extern "C" int cugp_trsm(const float* l, long long ldl, float* b,
                         long long row_stride, long long col_stride, int n,
                         int k, int transpose, float* scratch, int batch,
                         long long l_batch_stride, long long b_batch_stride,
                         void* stream) {
  if (n <= 0 || k <= 0 || batch <= 0) return 0;
  if (n > MAXN || ldl < n || batch > 65535 ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (n + T - 1) / T;
  const long long wbs = cugp_trsm_scratch(n);
  trsm_trtri_kernel<<<dim3(nt, batch), TRTRI_THREADS, 0, s>>>(
      l, ldl, l_batch_stride, n, transpose, scratch, wbs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<size_t>(l) & 15) == 0 && ldl % 4 == 0 &&
                  (batch == 1 || l_batch_stride % 4 == 0);
  const Args a{l, ldl, l_batch_stride, scratch, wbs, b, b_batch_stride,
               row_stride, col_stride, n, k, vec, batch, s};
  if (k <= NARROW_MAX)
    err = transpose ? launch_narrow<true>(a) : launch_narrow<false>(a);
  else
    err = transpose ? launch_wide_for<true>(a) : launch_wide_for<false>(a);
  return static_cast<int>(err);
}
