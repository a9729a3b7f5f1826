// Fused covariance matvec: out = (K(X, X) + diag_add I) V, K never written.
//
// Replaces cugp_tpu/ops/cov_pallas.py::_cov_matvec_kernel (the Pallas
// kernel that builds a (512, 1024) tile of K in VMEM, masks it and
// contracts it with a 128-padded V on the MXU, accumulating across the
// column grid). Same function: the tile formulas of cov_epilogue.cuh on
// lengthscale-scaled rows, contracted with V, plus diag_add * V.
//
// What bounds it on the H100: fp32 instruction issue, not bytes. It reads
// X and V and writes the (n, r) output (a few MB), but each of the n^2
// entries of K costs the cross term (d FMAs), the epilogue and r
// contraction FMAs (n = 100k: 1e10 entries). Two routes, by r:
//
//   pre-pass     one small launch (its row code is cov_rows.cuh, shared
//                with cov.cu): the rows scaled (by sqrt(log2 e) for
//                rbf, so the cross term and the norms come out in log2
//                units), padded to a multiple of 4 features and of 128
//                rows; each row's half squared norm h = s / 2 (the cross
//                term's fmaf order, so cross_ii == s_i bitwise and the rbf
//                exponent on the diagonal is exactly 0); and V copied into
//                a contiguous zero-padded buffer (any strides in, 16-byte
//                aligned rows out). All three live in a scratch the
//                wrapper allocates. Padded columns have zero V rows, so
//                nothing in the main loops is masked.
//   narrow route r <= 32 (CG and Lanczos: r = 1, 9, 16, 17). K stays in
//                registers. A CTA of 256 threads owns BM = 32 R rows (R = 4
//                rows a lane for RC <= 12, else 2); warp w takes columns
//                [8w, 8w + 8) of each 64-column tile, so every shared load
//                is a warp-wide broadcast. Per entry: d cross FMAs, two
//                subtractions, one ex2 (rbf: 2^(cross - h_i - h_j), sf2
//                applied once per output) and RC contraction FMAs, where
//                RC is exact at the widths the paths use (1, 9, 16, 17)
//                and a multiple of 4 otherwise. The column features, the
//                half-norms and the V rows of each tile come through a
//                3-deep cp.async ring with one block barrier a tile.
//   wide route   r > 32 (the variance solve, r = 128). Each CTA builds each
//                K entry once: a 128 x 32 tile of K into shared memory
//                (where the cross term's partial sums over feature chunks
//                wait too, so no register holds them), then a
//                register-tiled product with the tile's V rows for 128
//                columns (8 x 8 accumulators a thread, 4 shared loads a 64
//                FMAs). Above 128 columns, 128-column chunks are a grid
//                axis, each rebuilding K once.
//
// A batch (chains of the samplers: X scaled by each element's lengthscales
// (B, n, d), V (B, n, r), each element its own sf2, diag_add and family
// scalar) is the same two launches with the element as a grid index: the
// pre-pass's y, the narrow route's y, the wide route's z. Each element has
// its own slice of the scratch and runs exactly the 2-D launch's code on
// it, so it equals its 2-D launch bitwise (a 2-D call is B = 1).
//
// Both routes: any d (32-feature chunks staged in turn), all six kinds
// (the five besides rbf keep cov_epilogue.cuh's formulas on the same
// hoisted norms), n and r unpadded at the interface, no atomics: each
// output is summed in a fixed order (tiles, then columns, then, in the
// narrow route, the 8 warps' partials in warp order), so a launch is
// bitwise reproducible, and in the narrow route a column's output does
// not depend on r. The ex2 is PTX's ex2.approx.ftz (exp2f's own rounding
// without its subnormal-result fixup: entries below 2^-126 sf2 flush to 0);
// the build keeps its flags (no --use_fast_math; cov.cu shares them).
//
// Measured on an H100 80GB HBM3 at 700 W, n = 100k, d = 4 (chip_smoke.py
// phase 2; PERF.md): the narrow route at r = 9 takes 8.9-9.1 ms against a
// 4.3 ms bound, issuing about 22 instructions an entry (16 of them the
// entry's arithmetic, the rest loads, staging and addresses) at about 73%
// of the card's issue rate; the wide route at r = 128 takes 60 ms against
// 39.9, its FMAs 83% of its instructions, at 64% of the fp32 peak.

#include <climits>

#include <cuda_runtime.h>

#include "cov_rows.cuh"
#include "device_facts.cuh"

using namespace cugp;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // 8
constexpr int STAGES = 3;            // cp.async ring depth, both routes
constexpr int DC = 32;               // features a staged chunk holds
constexpr int ROW_PAD = 128;         // rows padded to a multiple of this

// narrow route
constexpr int NARROW_MAX = 32;       // widest r it takes
constexpr int JW = 8;                // columns a warp takes from each tile
constexpr int NBN = WARPS * JW;      // 64 columns a tile

// wide route
constexpr int WBM = 128;             // rows a CTA
constexpr int WBN = 32;              // columns a K tile
constexpr int WVW = 128;             // V columns a CTA

// rows a lane owns in the narrow route (register budget: R * RC sums)
__host__ __device__ constexpr int narrow_rows(int rc) {
  return rc <= 12 ? 4 : 2;
}
// floats a V row takes in the narrow route's buffer and ring
__host__ __device__ constexpr int narrow_vstride(int rc) {
  return rc == 1 ? 1 : pad4(rc);
}

// V columns a narrow CTA holds for r: exact at the widths the matrix-free
// paths use (1: the mean solve; 9 and 17: CG with 8 or 16 probes; 16:
// Lanczos over 16 probes), else the next multiple of 4.
int narrow_rc(int r) {
  if (r == 1 || r == 9 || r == 16 || r == 17) return r;
  if (r <= 12) return pad4(r);
  return r <= 16 ? 16 : (r <= 24 ? 24 : 32);
}

// 16 bytes from global memory to the shared-memory byte address dst
__device__ __forceinline__ void cp_async16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The scratch the pre-pass writes: padded rows, half-norms, padded V.
struct Scratch {
  float* xs;  // (npad, dp)
  float* h;   // (npad,)
  float* vp;  // (npad, vw)
  // the same three arrays of batch element e, `floats` on per element
  __device__ __forceinline__ Scratch at(int e, long long floats) const {
    const long long o = e * floats;
    return Scratch{xs + o, h + o, vp + o};
  }
};

__global__ void __launch_bounds__(THREADS)
cov_matvec_prep(const float* __restrict__ x, const float* __restrict__ v,
                Scratch o, int n, int d, int dp, int npad, float scale,
                int r, int vw, long long xbs, long long vbs, long long vrs,
                long long vcs, long long sfloats) {
  // batch element blockIdx.y
  x += blockIdx.y * xbs;
  v += blockIdx.y * vbs;
  o = o.at(blockIdx.y, sfloats);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  for (long long i = first; i < npad; i += stride)
    prep_row(x, o.xs, o.h, i, n, d, dp, scale);
  for (long long e = first; e < static_cast<long long>(npad) * vw;
       e += stride) {
    const long long i = e / vw;
    const int c = static_cast<int>(e - i * vw);
    o.vp[e] = (i < n && c < r) ? v[i * vrs + c * vcs] : 0.0f;
  }
}

// A position in the ring's sequence of stages: tile t, feature chunk c of
// it (nc chunks a tile), ring slot k.
struct Cursor {
  int t = 0, c = 0, k = 0;
  __device__ __forceinline__ void next(int nc) {
    if (++c == nc) {
      c = 0;
      ++t;
    }
    if (++k == STAGES) k = 0;
  }
};

// The 16-byte pieces one thread copies into every stage of a BN-column
// tiling, fixed for the launch: THREADS / BN threads share a column, and
// the offsets (floats from the scratch's start, bytes into a slot) are
// computed once, so a stage only adds its tile's and chunk's offsets.
// A stage holds a feature chunk of the tile's columns (column-major, stride
// dch) and, with the last chunk, the tile's half-norms and V rows (VW
// floats each, from column col0 of the padded V).
template <int BN, int VW>
struct Loader {
  static constexpr int TPC = THREADS / BN;
  const float* base;  // the scratch
  int src_b, src_h, src_v;  // this thread's pieces of tile 0
  unsigned dst_b, dst_h, dst_v;
  int p0, dp, nc;
  long long vstride;

  __device__ Loader(const Scratch& g, int dp_, int dch, int nc_,
                    long long vstride_, int col0)
      : base(g.xs), dp(dp_), nc(nc_), vstride(vstride_) {
    const int tid = threadIdx.x, j = tid / TPC;
    p0 = tid % TPC;
    src_b = j * dp + 4 * p0;
    dst_b = 4 * (j * dch + 4 * p0);
    const int h0 = static_cast<int>(g.h - g.xs);
    const int v0 = static_cast<int>(g.vp - g.xs);
    src_h = h0 + 4 * tid;
    dst_h = 4 * (BN * dch + 4 * tid);
    if constexpr (VW % 4 == 0) {
      src_v = v0 + static_cast<int>(j * vstride) + col0 + 4 * p0;
      dst_v = 4 * (BN * (dch + 1) + j * VW + 4 * p0);
    } else {  // VW == 1: the tile's V is BN consecutive floats
      src_v = v0 + 4 * tid;
      dst_v = dst_h + 4 * BN;
    }
  }

  // Issue the stage at `at` into the slot at shared byte address `slot`.
  // Every thread commits one group, whether it loaded or not.
  __device__ __forceinline__ void issue(unsigned slot, Cursor at,
                                        int ntiles) const {
    if (at.t < ntiles) {
      const long long j0 = static_cast<long long>(at.t) * BN;
      const int q4 = min(DC, dp - at.c * DC) / 4;
      const float* b = base + src_b + j0 * dp + at.c * DC;
#pragma unroll
      for (int u = 0; u < (DC / 4 + TPC - 1) / TPC; ++u)
        if (p0 + u * TPC < q4) cp_async16(slot + dst_b + 16 * u * TPC,
                                          b + 4 * u * TPC);
      if (at.c == nc - 1) {
        if (threadIdx.x < BN / 4)
          cp_async16(slot + dst_h, base + src_h + j0);
        if constexpr (VW % 4 == 0) {
          const float* v = base + src_v + j0 * vstride;
#pragma unroll
          for (int u = 0; u < (VW / 4 + TPC - 1) / TPC; ++u)
            if ((VW / 4) % TPC == 0 || p0 + u * TPC < VW / 4)
              cp_async16(slot + dst_v + 16 * u * TPC, v + 4 * u * TPC);
        } else if (threadIdx.x < BN / 4) {
          cp_async16(slot + dst_v, base + src_v + j0);
        }
      }
    }
    cp_async_commit();
  }
};

// ---------------------------------------------------------------------------
// Narrow route: K in registers, RC columns of V.

// acc[q][c] += kv[q] v[c] for the RC floats of a V row at p, a float4 at a
// time (no row held in registers)
template <int R, int RC>
__device__ __forceinline__ void contract(const float* p, const float (&kv)[R],
                                         float (&acc)[R][RC]) {
#pragma unroll
  for (int c = 0; c + 4 <= RC; c += 4) {
    const float4 t = ld4(p + c);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      acc[q][c] = fmaf(kv[q], t.x, acc[q][c]);
      acc[q][c + 1] = fmaf(kv[q], t.y, acc[q][c + 1]);
      acc[q][c + 2] = fmaf(kv[q], t.z, acc[q][c + 2]);
      acc[q][c + 3] = fmaf(kv[q], t.w, acc[q][c + 3]);
    }
  }
#pragma unroll
  for (int c = RC / 4 * 4; c < RC; ++c) {
    const float t = p[c];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q][c] = fmaf(kv[q], t, acc[q][c]);
  }
}

template <int KIND, int RC>
__global__ void __launch_bounds__(THREADS, 2)
cov_matvec_narrow(Scratch g, const float* __restrict__ scal,
                  float* __restrict__ out, int n, int dp, int r,
                  long long ldo, long long obs, long long sfloats) {
  // batch element blockIdx.y: its scratch, scalars and output
  g = g.at(blockIdx.y, sfloats);
  scal += 3 * blockIdx.y;
  out += blockIdx.y * obs;
  constexpr int R = narrow_rows(RC);
  constexpr int BM = 32 * R;
  constexpr int VS = narrow_vstride(RC);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = blockIdx.x * BM;
  const int dch = min(dp, DC);
  const int nc = (dp + DC - 1) / DC;
  const int slot_floats = NBN * (dch + 1 + VS);
  const int ntiles = gridDim.x * BM / NBN;
  const float sf2 = scal[0], diag_add = scal[1], alpha = scal[2];

  float hi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) hi[q] = g.h[i0 + lane + 32 * q];
  float acc[R][RC];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[q][c] = 0.0f;
  float cr[R][JW];

  const Loader<NBN, VS> loader(g, dp, dch, nc, VS, 0);
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const float* arow = g.xs + static_cast<long long>(i0 + lane) * dp;
  Cursor load, use;
  for (int s = 0; s < STAGES - 1; ++s, load.next(nc))
    loader.issue(ring + 4 * load.k * slot_floats, load, ntiles);
  for (; use.t < ntiles; use.next(nc), load.next(nc)) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage has landed; the last one's slot is free
    loader.issue(ring + 4 * load.k * slot_floats, load, ntiles);
    const float* slot = smem + use.k * slot_floats;
    const int c = use.c;
    const int q4 = min(DC, dp - c * DC) / 4;
    for (int k4 = 0; k4 < q4; ++k4) {
      float4 a[R];
#pragma unroll
      for (int q = 0; q < R; ++q)
        a[q] = __ldg(reinterpret_cast<const float4*>(
            arow + 32 * q * dp + c * DC + 4 * k4));
      const float* bk = slot + warp * JW * dch + 4 * k4;
      if (c == 0 && k4 == 0) {  // the first features start the sums
#pragma unroll
        for (int jj = 0; jj < JW; ++jj) {
          const float4 b = ld4(bk + jj * dch);
#pragma unroll
          for (int q = 0; q < R; ++q) cr[q][jj] = start4(a[q], b);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < JW; ++jj) {
          const float4 b = ld4(bk + jj * dch);
#pragma unroll
          for (int q = 0; q < R; ++q) cr[q][jj] = fma4(a[q], b, cr[q][jj]);
        }
      }
    }
    if (c == nc - 1) {
      const float* h_s = slot + NBN * dch + warp * JW;
      const float* v_s = slot + NBN * (dch + 1) + warp * JW * VS;
      float hj[JW];
#pragma unroll
      for (int jj = 0; jj < JW; jj += 4) {
        const float4 t4 = ld4(h_s + jj);
        hj[jj] = t4.x;
        hj[jj + 1] = t4.y;
        hj[jj + 2] = t4.z;
        hj[jj + 3] = t4.w;
      }
#pragma unroll
      for (int jj = 0; jj < JW; ++jj) {
        float kv[R];
#pragma unroll
        for (int q = 0; q < R; ++q)
          kv[q] = entry<KIND>(cr[q][jj], hi[q], hj[jj], sf2, alpha);
        contract<R, RC>(v_s + jj * VS, kv, acc);
      }
    }
  }

  // add the 8 warps' partial sums in warp order, one row slot at a time
  const float scale = KIND == RBF ? sf2 : 1.0f;
  constexpr int RS = RC | 1;  // odd stride: no bank conflicts on the store
  float* red = smem;          // red[WARPS * 32][RS]
#pragma unroll
  for (int q = 0; q < R; ++q) {
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < RC; ++cc)
      red[(warp * 32 + lane) * RS + cc] = acc[q][cc];
    __syncthreads();
    for (int e = tid; e < 32 * r; e += THREADS) {
      const int l = e / r, cc = e - l * r;
      const int gi = i0 + 32 * q + l;
      if (gi >= n) continue;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * 32 + l) * RS + cc];
      out[static_cast<long long>(gi) * ldo + cc] = fmaf(
          diag_add, g.vp[static_cast<long long>(gi) * VS + cc], scale * s);
    }
  }
}

// ---------------------------------------------------------------------------
// Wide route: a K tile in shared memory, contracted with 128 columns of V.

template <int KIND>
__global__ void __launch_bounds__(THREADS, 2)
cov_matvec_wide(Scratch g, const float* __restrict__ scal,
                float* __restrict__ out, int n, int dp, int r, int rp,
                long long ldo, long long obs, long long sfloats) {
  // batch element blockIdx.z: its scratch, scalars and output
  g = g.at(blockIdx.z, sfloats);
  scal += 3 * blockIdx.z;
  out += blockIdx.z * obs;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * WBM;
  const int col0 = blockIdx.y * WVW;
  const int dch = min(dp, DC);
  const int nc = (dp + DC - 1) / DC;
  const int slot_floats = WBN * (dch + 1 + WVW);
  const int ntiles = gridDim.x * WBM / WBN;
  float* kt = smem + STAGES * slot_floats;  // kt[WBN][WBM]: K^T of a tile
  const float sf2 = scal[0], diag_add = scal[1], alpha = scal[2];

  // building: row ib of the tile, its columns [16 jh, 16 jh + 16)
  const int ib = tid % WBM, jh = tid / WBM;
  const long long row = i0 + ib;
  const float hi = g.h[row];
  // the product: rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns
  // 4 tx + {0..3} and 64 + 4 tx + {0..3} (conflict-free float4 loads)
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.0f;

  const Loader<WBN, WVW> loader(g, dp, dch, nc, rp, col0);
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  Cursor load, use;
  for (int s = 0; s < STAGES - 1; ++s, load.next(nc))
    loader.issue(ring + 4 * load.k * slot_floats, load, ntiles);
  for (; use.t < ntiles; use.next(nc), load.next(nc)) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage has landed; the last tile's product is done
    loader.issue(ring + 4 * load.k * slot_floats, load, ntiles);
    const float* slot = smem + use.k * slot_floats;
    const int c = use.c;
    const int q4 = min(DC, dp - c * DC) / 4;
    const float* bj = slot + 16 * jh * dch;         // this thread's columns
    const float* hj = slot + WBN * dch + 16 * jh;   // their half-norms
    float* kj = kt + 16 * jh * WBM + ib;            // their entries
    if (nc == 1 && q4 == 1) {  // d <= 4: one feature group, one pass
      const float4 a = __ldg(reinterpret_cast<const float4*>(g.xs + row * dp));
#pragma unroll
      for (int jj = 0; jj < 16; jj += 4) {
        const float4 h4 = ld4(hj + jj);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          kj[(jj + u) * WBM] = entry<KIND>(
              start4(a, ld4(bj + (jj + u) * dch)), hi, hv[u], sf2, alpha);
      }
    } else {  // the cross term's partial sums wait in the K tile
      for (int k4 = 0; k4 < q4; ++k4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(
            g.xs + row * dp + c * DC + 4 * k4));
        const bool first = c == 0 && k4 == 0;
        const bool last = c == nc - 1 && k4 == q4 - 1;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const float4 b = ld4(bj + jj * dch + 4 * k4);
          const float x = first ? start4(a, b) : fma4(a, b, kj[jj * WBM]);
          kj[jj * WBM] = last ? entry<KIND>(x, hi, hj[jj], sf2, alpha) : x;
        }
      }
    }
    if (c != nc - 1) continue;
    const float* v_s = slot + WBN * (dch + 1);
    __syncthreads();  // the K tile is built
#pragma unroll
    for (int k = 0; k < WBN; ++k) {
      const float4 a0 = ld4(kt + k * WBM + 4 * ty);
      const float4 a1 = ld4(kt + k * WBM + 64 + 4 * ty);
      const float4 b0 = ld4(v_s + k * WVW + 4 * tx);
      const float4 b1 = ld4(v_s + k * WVW + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          acc[m][cc] = fmaf(a[m], b[cc], acc[m][cc]);
    }
  }

  const float scale = KIND == RBF ? sf2 : 1.0f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int gi = i0 + (m < 4 ? 4 * ty + m : 60 + 4 * ty + m);
    if (gi >= n) continue;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int gc = col0 + (cc < 4 ? 4 * tx + cc : 60 + 4 * tx + cc);
      if (gc < r)
        out[static_cast<long long>(gi) * ldo + gc] = fmaf(
            diag_add, g.vp[static_cast<long long>(gi) * rp + gc],
            scale * acc[m][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers. The dynamic shared-memory ceiling is raised once per device
// and kernel, to what the widest chunk (DC features) needs.

struct Plan {
  int narrow;  // 1: narrow route, 0: wide
  int rc;      // narrow: V columns a CTA holds
  int vw;      // floats a row of the padded V takes
  int npad, dp;
};

Plan plan(int n, int d, int r) {
  Plan p;
  p.narrow = r <= NARROW_MAX;
  p.rc = p.narrow ? narrow_rc(r) : WVW;
  p.vw = p.narrow ? narrow_vstride(p.rc) : (r + WVW - 1) / WVW * WVW;
  p.npad = (n + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  p.dp = pad4(d);
  return p;
}

long long scratch_floats(const Plan& p) {
  return static_cast<long long>(p.npad) * (p.dp + 1 + p.vw);
}

struct Args {
  Scratch g;
  const float* scal;
  float* out;
  int n, dp, r, rp, npad, batch;
  long long ldo, obs, sfloats;
  cudaStream_t stream;
};

size_t narrow_smem(int rc, int dch) {
  const int ring = STAGES * NBN * (dch + 1 + narrow_vstride(rc));
  const int red = THREADS * (rc | 1);
  return static_cast<size_t>(ring > red ? ring : red) * sizeof(float);
}

size_t wide_smem(int dch) {
  return static_cast<size_t>(STAGES * WBN * (dch + 1 + WVW) + WBN * WBM) *
         sizeof(float);
}

template <int KIND, int RC>
cudaError_t launch_narrow(const Args& a) {
  cudaError_t err =
      raise_smem_once<cov_matvec_narrow<KIND, RC>>(narrow_smem(RC, DC));
  if (err != cudaSuccess) return err;
  const int bm = 32 * narrow_rows(RC);
  const int dch = a.dp < DC ? a.dp : DC;
  const dim3 grid(a.npad / bm, a.batch);
  cov_matvec_narrow<KIND, RC><<<grid, THREADS, narrow_smem(RC, dch),
                                a.stream>>>(a.g, a.scal, a.out, a.n, a.dp,
                                            a.r, a.ldo, a.obs, a.sfloats);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_wide(const Args& a) {
  cudaError_t err = raise_smem_once<cov_matvec_wide<KIND>>(wide_smem(DC));
  if (err != cudaSuccess) return err;
  const int dch = a.dp < DC ? a.dp : DC;
  const dim3 grid(a.npad / WBM, a.rp / WVW, a.batch);
  cov_matvec_wide<KIND><<<grid, THREADS, wide_smem(dch), a.stream>>>(
      a.g, a.scal, a.out, a.n, a.dp, a.r, a.rp, a.ldo, a.obs, a.sfloats);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(const Plan& p, const Args& a) {
  if (!p.narrow) return launch_wide<KIND>(a);
  switch (p.rc) {
    case 1: return launch_narrow<KIND, 1>(a);
    case 4: return launch_narrow<KIND, 4>(a);
    case 8: return launch_narrow<KIND, 8>(a);
    case 9: return launch_narrow<KIND, 9>(a);
    case 12: return launch_narrow<KIND, 12>(a);
    case 16: return launch_narrow<KIND, 16>(a);
    case 17: return launch_narrow<KIND, 17>(a);
    case 24: return launch_narrow<KIND, 24>(a);
    case 32: return launch_narrow<KIND, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// V columns a CTA holds for r: the narrow route's RC (r <= 32), else the
// wide route's 128.
extern "C" int cugp_cov_matvec_width(int r) {
  return r <= NARROW_MAX ? narrow_rc(r) : WVW;
}

// Floats of the scratch cugp_cov_matvec takes for one element of (n, d,
// r); -1 past INT_MAX.
extern "C" int cugp_cov_matvec_scratch(int n, int d, int r) {
  if (n <= 0 || d <= 0 || r <= 0) return 0;
  const long long f = scratch_floats(plan(n, d, r));
  return f > INT_MAX ? -1 : static_cast<int>(f);
}

// A batch of `batch` elements (1 for a 2-D call): element e has rows
// x + e xbs ((n, d) row-major fp32, already divided by its lengthscale),
// v + e vbs ((n, r) fp32 with element strides (vrs, vcs)), scalars
// scal + 3 e = [sf2, diag_add, alpha] on the device, and output out + e obs
// ((n, r) with leading dimension ldo). scratch: batch times
// cugp_cov_matvec_scratch(n, d, r) floats, 16-byte aligned. kind: 0 rbf,
// 1 matern12, 2 matern32, 3 matern52, 4 rq, 5 linear. Two launches: the
// pre-pass, then the route's kernel.
extern "C" int cugp_cov_matvec(const float* x, const float* v,
                               const float* scal, float* out, float* scratch,
                               int n, int d, int r, int batch, long long xbs,
                               long long vbs, long long vrs, long long vcs,
                               long long obs, long long ldo, int kind,
                               void* stream) {
  if (n <= 0 || r <= 0 || batch <= 0) return 0;
  if (d <= 0 || kind < RBF || kind > LINEAR || batch > 65535 ||
      (reinterpret_cast<size_t>(scratch) & 15) != 0)
    return cudaErrorInvalidValue;
  const Plan p = plan(n, d, r);
  if (scratch_floats(p) > INT_MAX || p.vw / WVW > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // each element's slice starts 16-byte aligned: npad is a multiple of 128
  const long long sfloats = scratch_floats(p);
  Scratch g;
  g.xs = scratch;
  g.h = g.xs + static_cast<long long>(p.npad) * p.dp;
  g.vp = g.h + p.npad;
  const long long work = static_cast<long long>(p.npad) *
                         (p.vw > p.dp ? p.vw : p.dp);
  const int blocks = static_cast<int>(
      work / THREADS + 1 < 2048 ? work / THREADS + 1 : 2048);
  cov_matvec_prep<<<dim3(blocks, batch), THREADS, 0, s>>>(
      x, v, g, n, d, p.dp, p.npad, kind == RBF ? SQRT_LOG2E : 1.0f, r, p.vw,
      xbs, vbs, vrs, vcs, sfloats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{g,     scal, out, n,       p.dp, r, p.vw,
               p.npad, batch, ldo, obs, sfloats, s};
  switch (kind) {
    case RBF: err = launch_kind<RBF>(p, a); break;
    case MATERN12: err = launch_kind<MATERN12>(p, a); break;
    case MATERN32: err = launch_kind<MATERN32>(p, a); break;
    case MATERN52: err = launch_kind<MATERN52>(p, a); break;
    case RQ: err = launch_kind<RQ>(p, a); break;
    default: err = launch_kind<LINEAR>(p, a); break;
  }
  return static_cast<int>(err);
}
