// The whole box-constrained Mehrotra PDIP of a batch of LTV-MPC problems, all
// iterations in one launch: the hand-written Hopper port of the Pallas
// kernel reak_tpu/ops/pdip_whole_pallas.py::make_whole_pdip, in its
// regulator, x_ref and x_ref + u_ref modes.
//
// Lanes layout, scenario last: A (H, n, n, B), Bm (H, n, m, B), c (H, n, B),
// [x_ref (H, n, B)], [u_ref (H, m, B)], x0 (n, B), Q/QN (n, n), R (m, m),
// lb/ub (m,) → u (H, m, B), xs (H, n, B).
//
// What bounds it on the H100: by the card's peaks, operations on its inputs
// and outputs alone (~0.9 ms at H = 50, B = 8192 in f32); as designed,
// bytes: an iteration reads A and B four times (fused reverse, affine
// forward, corrector reverse, corrector forward) and writes and re-reads
// the gains, the factors and the vectors, ~2.5 GB an iteration and ~20 GB
// a solve at that shape, ~6 ms at 3.35 TB/s.
//
// Design.  The TPU kernel keeps the whole horizon resident in VMEM per
// 128-lane tile (~130 KB a scenario in f32 at H = 50), which the 227 KB of
// shared memory of an H100 block holds for one scenario only.  So the
// working arrays — K (H, m, n), the packed Cholesky factors of the Schur
// blocks (H, m, m), u, sl, su, zl, zu, w1, w2 (H, m) and xs, dxs (H, n) —
// stay in one scratch buffer in device memory that the wrapper allocates,
// scenario last over the batch padded to whole tiles, with L2 (50 MB)
// catching the re-reads; the horizon has no cap.  Every pass runs on the
// tile of riccati_tile.cuh: TS scenarios × NB columns a block, widths at
// compile time, each stage's A, B, K, factor and vectors copied into shared
// memory by cp.async a stage ahead of their use.  Phase 1 is that header's
// reverse pass (it forms q, u_eff and D from the iterate and stores the
// packed factor); the forward, corrector reverse and rollout passes split
// their n (or m) rows over the columns; the centering and step-length
// phases split the (H, m) sweep over the columns and reduce per scenario
// through shared memory, so their sums run in another order than the plain
// version's.  The reductions run over (H, m) only, the division in the step
// rule is guarded, sigma = (mu_aff / max(mu, 1e-30))³, the last stage uses
// QN, and the affine and corrector passes share each stage's factor — as in
// the TPU kernel.  Instances: (12, 6), (24, 12), (32, 16), and padded
// (16, 8), (24, 12) and (32, 16) for every other width within (32, 16); past
// it, one runtime-width instance a type (REAK_RUNTIME), the same code on the
// tile's runtime policy (riccati_tile.cuh).
#include <cuda_runtime.h>

#include "riccati_tile.cuh"

namespace reak {
namespace {

template <typename T>
__device__ inline T max_step_term(T v, T dv) {
  // -v/dv where dv < 0 (guarded division), +inf elsewhere
  const bool neg = dv < T(0);
  return neg ? -v / (neg ? dv : T(-1)) : T(INFINITY);
}

template <typename T>
__device__ inline T step_length(const T (&t)[4], int a, int b) {
  return fmin(fmin(T(1), T(0.995) * t[a]), fmin(T(1), T(0.995) * t[b]));
}

// The iterate and the working arrays in the scratch buffer, scenario stride
// Bp (the batch padded to whole tiles).
template <typename T>
struct WholeScratch {
  TileArr<T> K, factor, u, sl, su, zl, zu, w1, w2, xs, dxs;
  __device__ WholeScratch(T* p, int H, int n, int m, long long Bp) {
    auto take = [&](int r, int c) {
      TileArr<T> a{p, r, c, Bp, Bp, true};
      p += static_cast<long long>(H) * r * c * Bp;
      return a;
    };
    K = take(m, n);
    factor = take(m, m);  // strict lower = L, diagonal = 1 / diag L
    u = take(m, 1);
    sl = take(m, 1);
    su = take(m, 1);
    zl = take(m, 1);
    zu = take(m, 1);
    w1 = take(m, 1);  // k_aff → du_aff
    w2 = take(m, 1);  // grad → corrector rhs → k2 → du
    xs = take(n, 1);  // tracked trajectory
    dxs = take(n, 1);
  }
};

// phase 1: what the reverse pass of riccati_tile.cuh reads and writes
template <typename T>
struct WholeIo {
  static constexpr bool kStageCost = true, kStoreG = false,
                        kStoreFactor = true;
  const WholeScratch<T>& w;
  TileArr<const T> xr, ur;  // p = nullptr: no reference
  const TileThread& th;
  __device__ T x_term(int h, int i) const {
    T e = w.xs.load(h, i, 0, th);
    if (xr.p != nullptr) e -= xr.load(h, i, 0, th);
    return e;
  }
  __device__ T u_eff(int h, int i) const {
    T e = w.u.load(h, i, 0, th);
    if (ur.p != nullptr) e -= ur.load(h, i, 0, th);
    return e;
  }
  __device__ T barrier(int h, int i) const {
    if (!w.sl.has(i, 0, th)) return T(0);
    const long long at = w.sl.at(h, i, 0, th);
    return w.zl.p[at] / w.sl.p[at] + w.zu.p[at] / w.su.p[at];
  }
  __device__ void store_grad(int h, int i, T v) const {
    w.w2.store(h, i, 0, th, v);
  }
  __device__ void store_K(int h, int i, int j, T v) const {
    w.K.store(h, i, j, th, v);
  }
  __device__ void store_G(int, int, int, T) const {}
  __device__ void store_factor(int h, int i, int j, T v) const {
    w.factor.store(h, i, j, th, v);
  }
  __device__ void store_k(int h, int i, T v) const {
    w.w1.store(h, i, 0, th, v);
  }
};

// Per scenario over the tile's columns: the sum of each column's share
// part(0, j) and the minima of its shares part(1..4, j), through the work
// area; every thread of a scenario gets the same results.
template <class W, typename T, class Part>
__device__ inline void tile_reduce(const W& w, const TileSmem<T>& sm,
                                   const TileThread& th, Part& part, T& sum,
                                   T (&mins)[4]) {
  const int NB = w.nb(), TS = w.ts();
  const int s = th.s;
  T* const red = sm.work;  // [5][NB]
  __syncthreads();
  w.for_cols(th, [&](int j) {
#pragma unroll
    for (int q = 0; q < 5; ++q) REAK_ROW(red, q * NB + j) = T(part(q, j));
  });
  __syncthreads();
  sum = T(0);
#pragma unroll
  for (int q = 0; q < 4; ++q) mins[q] = T(INFINITY);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    sum += REAK_ROW(red, k);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mins[q] = fmin(mins[q], REAK_ROW(red, (q + 1) * NB + k));
  }
}

// The whole solve of one tile of scenarios on the width policy W: each
// column takes the (H, m) elements j, j + NB, ... of the sweeps.
template <class W, typename T>
__device__ inline void pdip_whole_tile(
    const W& wd, const TileSmem<T>& sm, const TileThread& th, const T* A_,
    const T* Bm_, const T* c_, const T* xr_, const T* ur_, const T* x0_,
    const T* Q, const T* QN, const T* R, const T* lb, const T* ub, T* u_out_,
    T* xs_out_, T* scratch, int H, int n, int m, long long B, long long Bp,
    int iters, bool vec16) {
  const int NB = wd.nb();
  const ColSlots cs(NB, wd.mb());
  tile_setup(wd, sm, Q, QN, R, n, m, th);
  const TileLtv<T> ltv{{A_, n, n, B, B, vec16}, {Bm_, n, m, B, B, vec16}};
  const TileArr<const T> c{c_, n, 1, B, B, vec16};
  const TileArr<const T> x0{x0_, n, 1, B, B, vec16};
  const TileArr<T> u_out{u_out_, m, 1, B, B, vec16};
  const TileArr<T> xs_out{xs_out_, n, 1, B, B, vec16};
  const WholeScratch<T> w(scratch, H, n, m, Bp);
  WholeIo<T> io{w, {xr_, n, 1, B, B, vec16}, {ur_, m, 1, B, B, vec16}, th};
  const int HM = H * m;
  // element (h, i) of an (H, m) scratch array, this thread's scenario
  auto at = [&](int idx) { return static_cast<long long>(idx) * Bp + th.b; };
  // each column's shares of a reduction
  typename W::template Cols<typename W::Acc, 5> part(wd, cs.red);

  wd.for_cols(th, [&](int j) {
    for (int idx = j; idx < HM; idx += NB) {
      const int i = idx % m;
      const T mid = T(0.5) * (lb[i] + ub[i]);
      const T half = T(0.5) * (ub[i] - lb[i]);
      w.u.p[at(idx)] = mid;
      w.sl.p[at(idx)] = half;
      w.su.p[at(idx)] = half;
      w.zl.p[at(idx)] = T(1);
      w.zu.p[at(idx)] = T(1);
    }
  });
  rollout_pass(wd, sm, ltv, c, x0, w.u, w.xs, H, th);

  const T N2 = T(2.0 * H * m);
  const TileArr<const T>* const no_dx0 = nullptr;
  const TileArr<T>* const no_dx = nullptr;
  for (int it = 0; it < iters; ++it) {
    // ---- phase 1: fused reverse pass (adjoint + Riccati + affine rhs) ----
    reverse_pass(wd, sm, io, ltv, H, th);

    // ---- phase 2: affine forward (du_aff overwrites k_aff in w1) ---------
    forward_pass(wd, sm, ltv, w.K.in(), w.w1.in(), w.w1, no_dx0, no_dx, H,
                 th);

    // ---- phase 3: Mehrotra centering + corrector rhs ----------------------
    __syncthreads();  // du_aff of every column is there
    wd.for_cols(th, [&](int j) {
      T mu_j = T(0), t_j[4] = {T(INFINITY), T(INFINITY), T(INFINITY),
                               T(INFINITY)};
      for (int idx = j; idx < HM; idx += NB) {
        const long long e = at(idx);
        const T sl = w.sl.p[e], su = w.su.p[e], zl = w.zl.p[e],
                zu = w.zu.p[e];
        const T dua = w.w1.p[e];
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        mu_j += sl * zl + su * zu;
        t_j[0] = fmin(t_j[0], max_step_term(sl, dua));
        t_j[1] = fmin(t_j[1], max_step_term(su, -dua));
        t_j[2] = fmin(t_j[2], max_step_term(zl, dzla));
        t_j[3] = fmin(t_j[3], max_step_term(zu, dzua));
      }
      part(0, j) = mu_j;
#pragma unroll
      for (int q = 0; q < 4; ++q) part(q + 1, j) = t_j[q];
    });
    T mu_s, t[4];
    tile_reduce(wd, sm, th, part, mu_s, t);
    const T mu = mu_s / N2;
    T a_p = step_length(t, 0, 1), a_d = step_length(t, 2, 3);
    wd.for_cols(th, [&](int j) {
      T mua_j = T(0);
      for (int idx = j; idx < HM; idx += NB) {
        const long long e = at(idx);
        const T sl = w.sl.p[e], su = w.su.p[e], zl = w.zl.p[e],
                zu = w.zu.p[e];
        const T dua = w.w1.p[e];
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        mua_j += (sl + a_p * dua) * (zl + a_d * dzla) +
                 (su - a_p * dua) * (zu + a_d * dzua);
      }
      part(0, j) = mua_j;
#pragma unroll
      for (int q = 0; q < 4; ++q) part(q + 1, j) = t[q];
    });
    T mua_s;
    tile_reduce(wd, sm, th, part, mua_s, t);
    const T mu_aff = mua_s / N2;
    const T ratio = mu_aff / fmax(mu, T(1e-30));
    const T sigma = ratio * ratio * ratio;
    wd.for_cols(th, [&](int j) {
      for (int idx = j; idx < HM; idx += NB) {
        const long long e = at(idx);
        const T sl = w.sl.p[e], su = w.su.p[e], zl = w.zl.p[e],
                zu = w.zu.p[e];
        const T dua = w.w1.p[e];
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma * mu - dua * dzla - zl * sl;
        const T rc_u = sigma * mu + dua * dzua - zu * su;
        const T r_dual = w.w2.p[e] - zl + zu;
        w.w2.p[e] = r_dual - rc_l / sl + rc_u / su;
      }
    });

    // ---- phase 4: corrector reverse pass, reusing the stage factors ------
    vector_pass<W, false>(wd, sm, ltv, w.K.in(), w.factor.in(), w.w2.in(),
                          w.w2, H, th);

    // ---- phase 5: corrector forward (du overwrites k2; dxs stored) -------
    forward_pass(wd, sm, ltv, w.K.in(), w.w2.in(), w.w2, no_dx0, &w.dxs, H,
                 th);

    // ---- phase 6: step lengths + update (the trajectory is affine in u) --
    __syncthreads();  // du of every column is there
    wd.for_cols(th, [&](int j) {
      T t_j[4] = {T(INFINITY), T(INFINITY), T(INFINITY), T(INFINITY)};
      for (int idx = j; idx < HM; idx += NB) {
        const long long e = at(idx);
        const T sl = w.sl.p[e], su = w.su.p[e], zl = w.zl.p[e],
                zu = w.zu.p[e];
        const T dua = w.w1.p[e], dun = w.w2.p[e];
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma * mu - dua * dzla - zl * sl;
        const T rc_u = sigma * mu + dua * dzua - zu * su;
        const T dzl = (rc_l - zl * dun) / sl;
        const T dzu = (rc_u + zu * dun) / su;
        t_j[0] = fmin(t_j[0], max_step_term(sl, dun));
        t_j[1] = fmin(t_j[1], max_step_term(su, -dun));
        t_j[2] = fmin(t_j[2], max_step_term(zl, dzl));
        t_j[3] = fmin(t_j[3], max_step_term(zu, dzu));
      }
      part(0, j) = T(0);
#pragma unroll
      for (int q = 0; q < 4; ++q) part(q + 1, j) = t_j[q];
    });
    T none;
    tile_reduce(wd, sm, th, part, none, t);
    a_p = step_length(t, 0, 1);
    a_d = step_length(t, 2, 3);
    wd.for_cols(th, [&](int j) {
      for (int idx = j; idx < HM; idx += NB) {
        const long long e = at(idx);
        const T sl = w.sl.p[e], su = w.su.p[e], zl = w.zl.p[e],
                zu = w.zu.p[e];
        const T dua = w.w1.p[e], dun = w.w2.p[e];
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma * mu - dua * dzla - zl * sl;
        const T rc_u = sigma * mu + dua * dzua - zu * su;
        const T dzl = (rc_l - zl * dun) / sl;
        const T dzu = (rc_u + zu * dun) / su;
        w.u.p[e] = w.u.p[e] + a_p * dun;
        w.sl.p[e] = sl + a_p * dun;
        w.su.p[e] = su - a_p * dun;
        w.zl.p[e] = zl + a_d * dzl;
        w.zu.p[e] = zu + a_d * dzu;
      }
      if (j < n) {
        for (int h = 0; h < H; ++h) {
          const long long e = w.xs.at(h, j, 0, th);
          w.xs.p[e] = w.xs.p[e] + a_p * w.dxs.p[e];
        }
      }
    });
  }

  // ---- clip to the box + the final consistent rollout ---------------------
  __syncthreads();
  wd.for_cols(th, [&](int j) {
    for (int idx = j; idx < HM; idx += NB) {
      const int i = idx % m;
      const T uc = fmin(fmax(w.u.p[at(idx)], lb[i]), ub[i]);
      w.u.p[at(idx)] = uc;
      u_out.store(idx / m, i, 0, th, uc);
    }
  });
  rollout_pass(wd, sm, ltv, c, x0, w.u, xs_out, H, th);
}

// One block an SM by registers (168 at (12, 6) in f32): held to two, the
// vector phases spill to a 552 B stack and the solve gets no faster (16.81
// against 16.18 ms at H = 50, B = 8192 on an H100 at 700 W;
// ops/tile_shapes.py).
template <typename T, int NB, int MB, bool EXACT>
__global__ void __launch_bounds__(Tile<T, NB, MB, EXACT>::NT)
    pdip_whole_kernel(const T* A_, const T* Bm_, const T* c_, const T* xr_,
                      const T* ur_, const T* x0_, const T* Q, const T* QN,
                      const T* R, const T* lb, const T* ub, T* u_out_,
                      T* xs_out_, T* scratch, int H, int n_, int m_, int B_,
                      int iters, int vec16_) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  using TL = Tile<T, NB, MB, EXACT>;
  const TL wd{};
  const int n = EXACT ? NB : n_, m = EXACT ? MB : m_;
  const long long Bp = static_cast<long long>(gridDim.x) * TL::TS;
  const TileSmem<T> sm(wd, reinterpret_cast<T*>(tile_smem));
  pdip_whole_tile(wd, sm, tile_thread<TL>(), A_, Bm_, c_, xr_, ur_, x0_, Q,
                  QN, R, lb, ub, u_out_, xs_out_, scratch, H, n, m, B_, Bp,
                  iters, vec16_ != 0);
}

#ifdef REAK_RUNTIME
// The runtime-width instance: the grid walks the batch a tile at a time;
// `area` is the device-memory work area (riccati_tile.cuh, AnyBlock).
template <typename T>
__global__ void __launch_bounds__(ANY_THREADS)
    pdip_whole_any_kernel(const T* A_, const T* Bm_, const T* c_,
                          const T* xr_, const T* ur_, const T* x0_,
                          const T* Q, const T* QN, const T* R, const T* lb,
                          const T* ub, T* u_out_, T* xs_out_, T* scratch,
                          int H, int B_, int iters, AnyTile tl, T* area) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const AnyBlock<T> blk(tl, area);
  const AnyWidths<T> wd = blk.widths(threadIdx.x % tl.ts);
  const TileSmem<T> sm(wd, blk.rows(tile_smem));
  const int tiles = (B_ + tl.ts - 1) / tl.ts;
  const long long Bp = static_cast<long long>(tiles) * tl.ts;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the tile before has left the rows
    pdip_whole_tile(wd, sm, any_thread(tl, tile), A_, Bm_, c_, xr_, ur_, x0_,
                    Q, QN, R, lb, ub, u_out_, xs_out_, scratch, H, tl.n, tl.m,
                    B_, Bp, iters, false);
  }
}
#endif  // REAK_RUNTIME

// scratch values a scenario: K, the packed factors, seven (H, m) and two
// (H, n) arrays (ops/pdip_whole.py::scratch_values)
inline long long scratch_values(int H, int n, int m) {
  return static_cast<long long>(H) * (m * n + m * m + 7 * m + 2 * n);
}

template <typename T, int NB, int MB, bool EXACT>
int launch(const void* A, const void* Bm, const void* c, const void* xr,
           const void* ur, const void* x0, const void* Q, const void* QN,
           const void* R, const void* lb, const void* ub, void* u_out,
           void* xs_out, void* scratch, long long scratch_count, int H, int n,
           int m, int B, int iters, int smem_bytes, void* stream) {
  using TL = Tile<T, NB, MB, EXACT>;
  const int blocks = (B + TL::TS - 1) / TL::TS;
  // the wrapper's launch shape and scratch (ops/_tile.py) must be this
  // instance's
  if (smem_bytes != TL::SMEM ||
      scratch_count <
          scratch_values(H, n, m) * static_cast<long long>(blocks) * TL::TS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = pdip_whole_kernel<T, NB, MB, EXACT>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int vec16 = streams16<T>(B, {A, Bm, c, scratch});
  kernel<<<blocks, TL::NT, TL::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(c), static_cast<const T*>(xr),
      static_cast<const T*>(ur), static_cast<const T*>(x0),
      static_cast<const T*>(Q), static_cast<const T*>(QN),
      static_cast<const T*>(R), static_cast<const T*>(lb),
      static_cast<const T*>(ub), static_cast<T*>(u_out),
      static_cast<T*>(xs_out), static_cast<T*>(scratch), H, n, m, B, iters,
      vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace reak

#ifdef REAK_RUNTIME

extern "C" {

// The runtime-width entry point of this library's type (the library
// pdip_whole@any_<type>), reak_pdip_whole_any_<type>: any (n, m), with the
// tile, grid and work area of ops/_tile.py::tile_config.
#define REAK_PDIP_ANY_ENTRY(T, SUFFIX)                                       \
  int reak_pdip_whole_any_##SUFFIX(                                          \
      const void* A, const void* Bm, const void* c, const void* xr,          \
      const void* ur, const void* x0, const void* Q, const void* QN,         \
      const void* R, const void* lb, const void* ub, void* u_out,            \
      void* xs_out, void* scratch, long long scratch_count, void* work,      \
      long long work_count, int H, int n, int m, int B, int iters, int ts,   \
      int grid, int smem_bytes, void* stream) {                              \
    if (H < 1 || n < 1 || m < 1 || B < 1 || iters < 0)                       \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    const reak::AnyTile tl = reak::any_tile(n, m, int(sizeof(T)));           \
    const long long tiles = (B + tl.ts - 1) / tl.ts;                         \
    if (scratch_count < reak::scratch_values(H, n, m) * tiles * tl.ts)       \
      return static_cast<int>(cudaErrorInvalidConfiguration);                \
    return reak::any_launch(                                                 \
        reak::pdip_whole_any_kernel<T>, tl, B, ts, grid, work_count,         \
        smem_bytes, stream, static_cast<const T*>(A),                        \
        static_cast<const T*>(Bm), static_cast<const T*>(c),                 \
        static_cast<const T*>(xr), static_cast<const T*>(ur),                \
        static_cast<const T*>(x0), static_cast<const T*>(Q),                 \
        static_cast<const T*>(QN), static_cast<const T*>(R),                 \
        static_cast<const T*>(lb), static_cast<const T*>(ub),                \
        static_cast<T*>(u_out), static_cast<T*>(xs_out),                     \
        static_cast<T*>(scratch), H, B, iters, tl, static_cast<T*>(work));   \
  }
#define REAK_PDIP_ANY_ENTRY_OF(T, SUFFIX) REAK_PDIP_ANY_ENTRY(T, SUFFIX)

REAK_PDIP_ANY_ENTRY_OF(REAK_TYPE, REAK_SUFFIX)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#else
#if !defined(REAK_NMAX) || !defined(REAK_MMAX) || !defined(REAK_TYPE) || \
    !defined(REAK_SUFFIX)
#error "one bound and type a library: -DREAK_NMAX -DREAK_MMAX -DREAK_TYPE -DREAK_SUFFIX (ops/_build.py)"
#endif

extern "C" {

// The entry point of this library's bound and type,
// reak_pdip_whole_<NMAX>x<MMAX>_<type>: it takes the instance of the exact
// widths where (n, m) are just those, else the padded (NMAX, MMAX).
#define REAK_PDIP_ENTRY(NM, MM, T, SUFFIX)                                   \
  int reak_pdip_whole_##NM##x##MM##_##SUFFIX(                                \
      const void* A, const void* Bm, const void* c, const void* xr,          \
      const void* ur, const void* x0, const void* Q, const void* QN,         \
      const void* R, const void* lb, const void* ub, void* u_out,            \
      void* xs_out, void* scratch, long long scratch_count, int H, int n,    \
      int m, int B, int iters, int smem_bytes, void* stream) {               \
    constexpr int EN = reak::ExactWidths<NM, MM>::N,                         \
                  EM = reak::ExactWidths<NM, MM>::M;                         \
    if (H < 1 || n < 1 || n > NM || m < 1 || m > MM || B < 1 || iters < 0)   \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    if (n == EN && m == EM)                                                  \
      return reak::launch<T, EN, EM, true>(                                  \
          A, Bm, c, xr, ur, x0, Q, QN, R, lb, ub, u_out, xs_out, scratch,    \
          scratch_count, H, n, m, B, iters, smem_bytes, stream);             \
    return reak::launch<T, NM, MM, false>(                                   \
        A, Bm, c, xr, ur, x0, Q, QN, R, lb, ub, u_out, xs_out, scratch,      \
        scratch_count, H, n, m, B, iters, smem_bytes, stream);               \
  }
#define REAK_PDIP_ENTRY_OF(NM, MM, T, SUFFIX) REAK_PDIP_ENTRY(NM, MM, T, SUFFIX)

REAK_PDIP_ENTRY_OF(REAK_NMAX, REAK_MMAX, REAK_TYPE, REAK_SUFFIX)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // REAK_RUNTIME
