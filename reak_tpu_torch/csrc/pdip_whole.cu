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
// bytes: an iteration streams A and B four times (fused reverse, affine
// forward, corrector reverse, corrector forward) with each stage's gains,
// factor, slacks and duals, and sweeps the iterate twice, through a
// device-memory scratch (chip_smoke.py::k2_design_bytes).
//
// Design.  The TPU kernel keeps the whole horizon resident in VMEM per
// 128-lane tile (~130 KB a scenario in f32 at H = 50), which the 227 KB of
// shared memory of an H100 block holds for one scenario only.  So the
// working arrays — K (H, m, n), the packed Cholesky factors of the Schur
// blocks (H, m, m), u, sl, su, zl, zu, w1, w2 (H, m) and xs, dxs (H, n) —
// stay in one scratch buffer in device memory that the wrapper allocates,
// scenario last over the batch padded to whole tiles, with L2 (50 MB)
// catching the re-reads; the horizon has no cap.  A block takes TS
// scenarios × NB columns, thread (s, j) as on the tile of riccati_tile.cuh,
// and each pass walks the stages in order with the stage arithmetic of that
// header.
//
// On the compile-time widths the stages come through a TMA pipeline
// (hopper.cuh): one producer warp walks the consumers' passes in their
// order and keeps a ring of three stage slots full, each stage's A, B, K,
// packed factor and vectors loaded as boxes of TS scenarios by the tensor
// memory accelerator from 3- and 4-D tensor maps of the scenario-last
// arrays (so a padded width's rows past (n, m) and the scenarios past B
// load as zeros), completing on the slot's mbarrier; the consumers wait on
// that barrier alone, give the slot back through a second one, and meet
// among themselves at named barriers, never with the producer.  Before a
// pass the producer waits until every consumer has entered it, after their
// stores to the scratch and a proxy fence.  The producer warp gives its
// registers to the consumers (setmaxnreg) where they would not fit.  The
// interior-point sweeps are folded into the passes: μ and the affine
// step-length minima accumulate in the affine forward pass as each stage's
// du_aff appears, the corrector right-hand side is formed in the corrector
// reverse pass at its stage, and the corrector minima accumulate in the
// corrector forward pass, and the update is applied in the next
// iteration's reverse pass as each stage's iterate arrives (after the last
// iteration, in the clip); μ_aff, which needs the affine steps over the
// whole horizon, stays a sweep, loading SWEEP elements a column at once.  The per-scenario sums run over (H, m) only and in
// another order than the plain version's, the division in the step rule
// is guarded, sigma = (mu_aff / max(mu, 1e-30))³, the last stage uses QN,
// and the affine and corrector passes share each stage's factor — as in
// the TPU kernel.  Instances: (12, 6), (24, 12), (32, 16), and padded
// (16, 8), (24, 12) and (32, 16) for every other width within (32, 16).
// Past it, one runtime-width instance a type (REAK_RUNTIME) runs the passes
// of riccati_tile.cuh on the tile's runtime policy, one cp.async stage
// ahead, with the sweeps as phases of their own.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"
#include "riccati_tile.cuh"

// ops/k2_phases.py times the phases of a stamped copy; here they are empty
#ifndef REAK_K2_STAMPS
#define REAK_K2_BEGIN()
#define REAK_K2_STAMP(slot)
#define REAK_K2_SPAN_BEGIN(who)
#define REAK_K2_SPAN_END(who, slot)
#define REAK_K2_END()
#endif

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


#ifdef REAK_RUNTIME
// ---- the runtime-width instance: the passes of riccati_tile.cuh ---------

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

#else  // the compile-time instances

// ---- the compile-time instances: a TMA pipeline -----------------------------
//
// The launch shape of one instance, mirrored by ops/_tile.py::pipe_config.
// Consumers: TS scenarios × NB columns, thread (s, j) as on the tile of
// riccati_tile.cuh; the producer after them.  Shared memory, each
// region a whole number of 128 B: the mbarriers (BAR_BYTES); Q, QN, R; the
// work area (V, V·B, F, the Schur block; the reductions between passes);
// the block's vectors; RING stage slots, each A [NB][NB], Bm [NB][MB],
// K [MB][NB], the packed factor [MB][MB] and the stage vectors
// [3 NB + 8 MB], all in rows of TS values (SlotRows).  TS gives 128 B rows
// up to NB = 12 and 64 B above, halved while the block does not fit.  Where
// the consumers and a producer warp at 255 registers would not fit the
// SM's 65,536 and the consumers are whole warpgroups (setmaxnreg moves a
// warpgroup's registers at once), the producer is a whole warpgroup, one
// thread of which issues the loads, and gives its registers to the
// consumers: at (12, 6) in f32 they run at 160 (the tile design's 168 less
// a 1,024 margin), not the 128 a block of 512 threads enters with.
template <typename T, int NB_, int MB_>
struct Pipe {
  static_assert(MB_ <= NB_, "the pipeline takes m <= n");
  static constexpr int NB = NB_, MB = MB_;
  static constexpr int SIZE = int(sizeof(T));
  static constexpr int RING = 3;
  static constexpr int BAR_BYTES = 1024;
  static constexpr int SLOT_VEC = 3 * NB_ + 8 * MB_;
  static constexpr int SLOT_ROWS =
      NB_ * NB_ + 2 * NB_ * MB_ + MB_ * MB_ + SLOT_VEC;
  static constexpr int WORK_ROWS = NB_ * NB_ + 2 * NB_ * MB_ + MB_ * MB_;
  static constexpr int VEC_ROWS = 5 * NB_ + 2 * MB_;
  static constexpr int CONSTS = 2 * NB_ * NB_ + MB_ * MB_;
  static constexpr int CONST_BYTES = (CONSTS * SIZE + 127) / 128 * 128;
  static constexpr int ROWS = WORK_ROWS + VEC_ROWS + RING * SLOT_ROWS;
  static constexpr int TS =
      fit_rows((NB_ <= 12 ? 128 : 64) / SIZE,
               (MAX_SHARED_BYTES - BAR_BYTES - CONST_BYTES) / (ROWS * SIZE));
  static constexpr int ROW = TS * SIZE;
  static constexpr int NC = TS * NB_;
  static constexpr int SMEM = BAR_BYTES + CONST_BYTES + ROWS * ROW;
  static constexpr bool REALLOC = NC % 128 == 0 && (NC + 32) * 255 > 65536;
  static constexpr int PRODUCER = REALLOC ? 128 : 32;
  static constexpr int NT = NC + PRODUCER;
  // registers a thread at entry: ptxas gives each of the block's
  // warpgroups, a part one counted whole, an equal share of the SM's
  // 65,536 (a block of 416 threads entered with 128, as one of 512); the
  // producer warpgroup drops to PRODUCER_REGS and the consumers take what
  // it gives up, leaving 1,024 of the SM's spare
  static constexpr int ENTRY_REGS = 65536 / (128 * ((NT + 127) / 128)) / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      (65536 - 1024 - 128 * PRODUCER_REGS) / NC / 8 * 8 > 248
          ? 248
          : (65536 - 1024 - 128 * PRODUCER_REGS) / NC / 8 * 8;
  static_assert(!REALLOC || NC * (CONSUMER_REGS - ENTRY_REGS) <=
                                128 * (ENTRY_REGS - PRODUCER_REGS),
                "the consumers take no more than the producer gives up");
  static_assert(SMEM <= MAX_SHARED_BYTES, "over a block's shared memory");
  static_assert(NT <= 1024 && NC % 32 == 0, "whole warps, within a block");
  static_assert(ROW % 16 == 0, "a TMA box row is whole 16 B");
  static_assert((MB_ * ROW) % 128 == 0 && (NB_ * ROW) % 128 == 0 &&
                    ((WORK_ROWS + VEC_ROWS) * ROW) % 128 == 0 &&
                    (SLOT_ROWS * ROW) % 128 == 0,
                "every TMA destination 128 B aligned");
  static_assert(2 * RING + 1 <= BAR_BYTES / 8, "the mbarriers fit");

  // the policy of riccati_tile.cuh's factor and substitutions
  using Acc = T;
  template <typename X>
  using Factor = FactorRegs<X, MB_, TS>;
  __device__ static constexpr int nb() { return NB_; }
  __device__ static constexpr int mb() { return MB_; }
  __device__ static constexpr int ts() { return TS; }
};

// rows of a ring slot; the vectors of a stage by pass: the rollout's c (in
// xs' place) and u; the reverse pass's xs, x_ref, dx, u, u_ref (and the
// previous step's, to fold it in); every pass after the rollout the slacks
// and duals sl, su, zl, zu and w1, w2
template <int NB, int MB>
struct SlotRows {
  static constexpr int A = 0, BM = NB * NB, K = BM + NB * MB,
                       L = K + MB * NB, V = L + MB * MB;
  static constexpr int XS = V, XR = V + NB, DX = V + 2 * NB, C = V,
                       U = V + 3 * NB, UR = U + MB, SL = U + 2 * MB,
                       SU = SL + MB, ZL = SU + MB, ZU = ZL + MB,
                       W1 = ZU + MB, W2 = W1 + MB;
};

// the iterate's arrays in the scratch, one after another (WholeScratch):
// the map `it` takes them as one (7 H, m, Bp) array
enum IterArr { IT_U, IT_SL, IT_SU, IT_ZL, IT_ZU, IT_W1, IT_W2 };

template <class P, typename T>
struct PipeSmem {
  uint64_t *full, *empty, *pass;  // full[RING], empty[RING], pass
  T *Q, *QN, *R, *work, *vec;
  T* slots;
  __device__ explicit PipeSmem(unsigned char* p) {
    full = reinterpret_cast<uint64_t*>(p);
    empty = full + P::RING;
    pass = empty + P::RING;
    Q = reinterpret_cast<T*>(p + P::BAR_BYTES);
    QN = Q + P::NB * P::NB;
    R = QN + P::NB * P::NB;
    work = reinterpret_cast<T*>(p + P::BAR_BYTES + P::CONST_BYTES);
    vec = work + P::WORK_ROWS * P::TS;
    slots = vec + P::VEC_ROWS * P::TS;
  }
  __device__ T* slot(int k) const { return slots + k * P::SLOT_ROWS * P::TS; }
};

// what the kernel takes, by value in its parameter space: the tensor maps
// of the inputs and of the scratch, the rest as pointers
template <typename T>
struct PipeArgs {
  TmaMap A, Bm, c, xr, ur, K, L, it, xs, dx;
  const T *x0, *Q, *QN, *R, *lb, *ub;
  T *u_out, *xs_out, *scratch;
  long long Bp;
  int H, n, m, B, iters, has_xr, has_ur;
};

// A consumer's place in the ring: the g-th stage is fill g / RING of slot
// g % RING.  wait() returns the slot once its loads have landed;
// release() gives it back to the producer.
template <class P, typename T>
struct Ring {
  const PipeSmem<P, T>& sm;
  int g = 0;
  __device__ T* wait() {
    const int k = g % P::RING;
    REAK_K2_SPAN_BEGIN(threadIdx.x == 0);
    mbar_wait(&sm.full[k], (g / P::RING) & 1);
    REAK_K2_SPAN_END(threadIdx.x == 0, 11);
    return sm.slot(k);
  }
  __device__ void release() {
    mbar_arrive(&sm.empty[g % P::RING]);
    ++g;
  }
};

template <class P>
__device__ inline void csync() {
  named_sync(1, P::NC);
}

// Entering a pass: this thread's stores to the scratch are made visible to
// the tensor loads of the pass (the producer waits for every consumer),
// and the pass before has left the block's shared arrays.
template <class P, typename T>
__device__ inline void enter_pass(const PipeSmem<P, T>& sm) {
  fence_proxy_async_global();
  mbar_arrive(sm.pass);
  csync<P>();
}

// The producer: one thread walks the consumers' passes in their order and
// keeps the ring full.  Before a pass it waits until every consumer has
// entered it (so the scratch the pass reads is written); before a stage it
// waits until its slot is empty, tells the slot's barrier the bytes to
// expect and issues the loads, each a box of TS scenarios.
template <class P, typename T>
__device__ inline void pipe_produce(const PipeArgs<T>& a,
                                    const PipeSmem<P, T>& sm) {
  constexpr int NB = P::NB, MB = P::MB, TS = P::TS;
  constexpr uint32_t ROW = P::ROW;
  using S = SlotRows<NB, MB>;
  const int b0 = blockIdx.x * TS, H = a.H;
  int g = 0, passes = 0;
  T* St = nullptr;
  uint64_t* bar = nullptr;
  auto pass = [&] {
    mbar_wait(sm.pass, passes & 1);
    ++passes;
  };
  auto next = [&](uint32_t rows) {
    const int k = g % P::RING;
    if (g >= P::RING) mbar_wait(&sm.empty[k], ((g / P::RING) - 1) & 1);
    bar = &sm.full[k];
    mbar_arrive_expect_tx(bar, rows * ROW);
    St = sm.slot(k);
    ++g;
  };
  auto ab = [&](int h) {
    tma_load(St + S::A * TS, &a.A, bar, b0, 0, 0, h);
    tma_load(St + S::BM * TS, &a.Bm, bar, b0, 0, 0, h);
  };
  auto iter = [&](int row, int arr, int h) {
    tma_load(St + row * TS, &a.it, bar, b0, 0, arr * H + h);
  };
  auto rollout = [&] {
    pass();
    for (int h = 0; h < H; ++h) {
      next(NB * NB + NB * MB + NB + MB);
      ab(h);
      tma_load(St + S::C * TS, &a.c, bar, b0, 0, h);
      iter(S::U, IT_U, h);
    }
  };
  // a forward or corrector reverse stage: A, Bm, K, (the factor,) the
  // slacks, duals and w1, (and w2: all but the affine forward pass)
  auto gains = [&](int h, bool factor, bool w2) {
    next(NB * NB + 2 * NB * MB + (factor ? MB * MB : 0) + (w2 ? 6 : 5) * MB);
    ab(h);
    tma_load(St + S::K * TS, &a.K, bar, b0, 0, 0, h);
    if (factor) tma_load(St + S::L * TS, &a.L, bar, b0, 0, 0, h);
    iter(S::SL, IT_SL, h);
    iter(S::SU, IT_SU, h);
    iter(S::ZL, IT_ZL, h);
    iter(S::ZU, IT_ZU, h);
    iter(S::W1, IT_W1, h);
    if (w2) iter(S::W2, IT_W2, h);
  };
  rollout();
  for (int it = 0; it < a.iters; ++it) {
    pass();
    for (int h = H - 1; h >= 0; --h) {
      next(NB * NB + NB * MB + (a.has_xr ? 3 : 2) * NB +
           (a.has_ur ? 8 : 7) * MB);
      ab(h);
      tma_load(St + S::XS * TS, &a.xs, bar, b0, 0, h);
      if (a.has_xr) tma_load(St + S::XR * TS, &a.xr, bar, b0, 0, h);
      tma_load(St + S::DX * TS, &a.dx, bar, b0, 0, h);
      iter(S::U, IT_U, h);
      if (a.has_ur) tma_load(St + S::UR * TS, &a.ur, bar, b0, 0, h);
      iter(S::SL, IT_SL, h);
      iter(S::SU, IT_SU, h);
      iter(S::ZL, IT_ZL, h);
      iter(S::ZU, IT_ZU, h);
      iter(S::W1, IT_W1, h);
      iter(S::W2, IT_W2, h);
    }
    pass();
    for (int h = 0; h < H; ++h) gains(h, false, false);
    pass();
    for (int h = H - 1; h >= 0; --h) gains(h, true, true);
    pass();
    for (int h = 0; h < H; ++h) gains(h, false, true);
  }
  rollout();
}

// x_{h+1} = A_h x_h + B_h u_h + c_h from x0 into `dst` (H, n); column j owns
// row j
template <class P, typename T>
__device__ inline void pipe_rollout(const PipeSmem<P, T>& sm, Ring<P, T>& ring,
                                    const TileArr<const T>& x0,
                                    const TileArr<T>& dst, int H,
                                    const TileThread& th) {
  constexpr int NB = P::NB, MB = P::MB, TS = P::TS;
  using S = SlotRows<NB, MB>;
  const int s = th.s, j = th.j;
  T* const xv = sm.vec;  // [2][NB]
  enter_pass(sm);
  REAK_ROW(xv, j) = x0.load(0, j, 0, th);
  for (int h = 0; h < H; ++h) {
    const T* const St = ring.wait();
    const int cur = h & 1;
    const T* const x = xv + cur * NB * TS;
    csync<P>();  // x is there
    T a = T(0), bb = T(0);
#pragma unroll
    for (int k = 0; k < NB; ++k)
      a += REAK_ROW(St, S::A + j * NB + k) * REAK_ROW(x, k);
#pragma unroll
    for (int k = 0; k < MB; ++k)
      bb += REAK_ROW(St, S::BM + j * MB + k) * REAK_ROW(St, S::U + k);
    const T x1 = T(a + bb) + REAK_ROW(St, S::C + j);
    ring.release();
    REAK_ROW(xv, (cur ^ 1) * NB + j) = x1;
    dst.store(h, j, 0, th, x1);
  }
}

// The fused reverse pass (adjoint + Riccati + affine right-hand side) of
// riccati_tile.cuh::reverse_pass, its stage vectors from the slot: the cost
// term x − x_ref, u − u_ref and the barrier diagonal zl/sl + zu/su arrive
// with A and B instead of being loaded on the chain.  `fold`: the update
// of the iteration before (step lengths a_p, a_d, σμ) is applied here, as
// each stage's trajectory, input, slacks and duals arrive, and stored;
// no sweep of its own.  The last column factors the Schur block while the
// others form their column of Q + Aᵀ V A: on an H100 at 700 W the other
// columns waited 0.08 % of the solve at the barrier after it
// (ops/k2_phases.py), so it stays there; the last column's own column of
// Q + Aᵀ V A, which it formed before barrier (2) while the others waited,
// is now formed an element a column between (2) and (3).
template <class P, typename T>
__device__ inline void pipe_reverse(const PipeSmem<P, T>& sm, Ring<P, T>& ring,
                                    const WholeScratch<T>& w, bool has_xr,
                                    bool has_ur, bool fold, T a_p, T a_d,
                                    T sigma_mu, int m, int H,
                                    const TileThread& th) {
  constexpr int NB = P::NB, MB = P::MB, TS = P::TS;
  using S = SlotRows<NB, MB>;
  const P pol{};
  const int s = th.s, j = th.j;
  T* const V = sm.work;
  T* const VB = V + NB * NB * TS;
  T* const F = VB + NB * MB * TS;
  T* const L = F + MB * NB * TS;
  T* const ev = sm.vec;
  T* const lamf = ev + NB * TS;
  T* const vv = lamf + NB * TS;
  T* const uv = vv + NB * TS;
  T* const ws = uv + MB * TS;
  T* const val = ws + MB * TS;   // the last column of V A
  T* const vnl = val + NB * TS;  // the last column of Q + Aᵀ V A

  enter_pass(sm);
#pragma unroll
  for (int i = 0; i < NB; ++i) REAK_ROW(V, i * NB + j) = sm.QN[i * NB + j];
  REAK_ROW(vv, j) = T(0);
  T lam = T(0);

  for (int h = H - 1; h >= 0; --h) {
    T* const St = ring.wait();
    T* const As = St + S::A * TS;
    const T* const Bs = St + S::BM * TS;
    const T* const Qm = (h == H - 1) ? sm.QN : sm.Q;
    // the step before: the trajectory is affine in u
    T xj = REAK_ROW(St, S::XS + j);
    if (fold) {
      xj = xj + a_p * REAK_ROW(St, S::DX + j);
      w.xs.store(h, j, 0, th, xj);
    }
    REAK_ROW(ev, j) = has_xr ? xj - REAK_ROW(St, S::XR + j) : xj;
    if (j < MB) {
      T uj = REAK_ROW(St, S::U + j);
      if (fold && j < m) {
        const T sl = REAK_ROW(St, S::SL + j), su = REAK_ROW(St, S::SU + j),
                zl = REAK_ROW(St, S::ZL + j), zu = REAK_ROW(St, S::ZU + j);
        const T dua = REAK_ROW(St, S::W1 + j), dun = REAK_ROW(St, S::W2 + j);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma_mu - dua * dzla - zl * sl;
        const T rc_u = sigma_mu + dua * dzua - zu * su;
        const T dzl = (rc_l - zl * dun) / sl;
        const T dzu = (rc_u + zu * dun) / su;
        uj = uj + a_p * dun;
        const T sl1 = sl + a_p * dun, su1 = su - a_p * dun;
        const T zl1 = zl + a_d * dzl, zu1 = zu + a_d * dzu;
        // the barrier diagonal reads the slacks and duals from the slot
        REAK_ROW(St, S::SL + j) = sl1;
        REAK_ROW(St, S::SU + j) = su1;
        REAK_ROW(St, S::ZL + j) = zl1;
        REAK_ROW(St, S::ZU + j) = zu1;
        w.u.store(h, j, 0, th, uj);
        w.sl.store(h, j, 0, th, sl1);
        w.su.store(h, j, 0, th, su1);
        w.zl.store(h, j, 0, th, zl1);
        w.zu.store(h, j, 0, th, zu1);
      }
      REAK_ROW(uv, j) = has_ur ? uj - REAK_ROW(St, S::UR + j) : uj;
    }
    {
      REAK_K2_SPAN_BEGIN(th.tid == 0);
      csync<P>();  // (1) V, v and the stage vectors are there
      REAK_K2_SPAN_END(th.tid == 0, 10);
    }

    T va[NB], vnew[NB], f[MB], kcol[MB], wv[MB], y[MB];
    T btv, vnext;
    // column j of Q + Aᵀ (V A), beside the factor (every column but the
    // last, whose column the others form: vnl)
    auto ava = [&] {
#pragma unroll
      for (int i = 0; i < NB; ++i) vnew[i] = T(0);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const T vk = va[k];
#pragma unroll
        for (int i = 0; i < NB; ++i) vnew[i] += REAK_ROW(As, k * NB + i) * vk;
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) vnew[i] = sm.Q[i * NB + j] + vnew[i];
    };
    // column j of V A, row j of V B
#pragma unroll
    for (int i = 0; i < NB; ++i) va[i] = T(0);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const T akj = REAK_ROW(As, k * NB + j);
#pragma unroll
      for (int i = 0; i < NB; ++i) va[i] += REAK_ROW(V, i * NB + k) * akj;
    }
    {
      T vb[MB];
#pragma unroll
      for (int c = 0; c < MB; ++c) vb[c] = T(0);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const T vjk = REAK_ROW(V, j * NB + k);
#pragma unroll
        for (int c = 0; c < MB; ++c) vb[c] += vjk * REAK_ROW(Bs, k * MB + c);
      }
#pragma unroll
      for (int c = 0; c < MB; ++c) REAK_ROW(VB, j * MB + c) = vb[c];
    }
    if (j == NB - 1) {
#pragma unroll
      for (int k = 0; k < NB; ++k) REAK_ROW(val, k) = va[k];
    }
    {
      REAK_K2_SPAN_BEGIN(th.tid == 0);
      csync<P>();  // (2) V B is there
      REAK_K2_SPAN_END(th.tid == 0, 10);
    }

    // element j of the last column of Q + Aᵀ V A, summed as ava() sums it
    {
      T t = T(0);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        t += REAK_ROW(As, k * NB + j) * REAK_ROW(val, k);
      REAK_ROW(vnl, j) = sm.Q[j * NB + NB - 1] + t;
    }
    // λ_full = q + λ; column j of F = (V B)ᵀ A; G = R + diag(D) + Bᵀ V B
    {
      T q = T(0);
#pragma unroll
      for (int i = 0; i < NB; ++i) q += Qm[j * NB + i] * REAK_ROW(ev, i);
      REAK_ROW(lamf, j) = T(q + lam);
    }
#pragma unroll
    for (int a = 0; a < MB; ++a) f[a] = T(0);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const T akj = REAK_ROW(As, k * NB + j);
#pragma unroll
      for (int a = 0; a < MB; ++a) f[a] += REAK_ROW(VB, k * MB + a) * akj;
    }
#pragma unroll
    for (int a = 0; a < MB; ++a) REAK_ROW(F, a * NB + j) = f[a];
#pragma unroll
    for (int e0 = 0; e0 < MB * MB; e0 += NB) {
      const int e = e0 + j;
      if (e < MB * MB) {
        const int a = e / MB, b = e % MB;
        T t = T(0);
#pragma unroll
        for (int k = 0; k < NB; ++k)
          t += REAK_ROW(Bs, k * MB + a) * REAK_ROW(VB, k * MB + b);
        const T d = (a == b && a < m)
                        ? REAK_ROW(St, S::ZL + a) / REAK_ROW(St, S::SL + a) +
                              REAK_ROW(St, S::ZU + a) / REAK_ROW(St, S::SU + a)
                        : T(0);
        REAK_ROW(L, e) = (sm.R[e] + d) + t;
      }
    }
    {
      T bv = T(0);  // (Bᵀ v)_j
      if (j < MB) {
#pragma unroll
        for (int k = 0; k < NB; ++k)
          bv += REAK_ROW(Bs, k * MB + j) * REAK_ROW(vv, k);
      }
      btv = bv;
    }
    {
      REAK_K2_SPAN_BEGIN(th.tid == 0);
      csync<P>();  // (3) G, F and λ_full are there
      REAK_K2_SPAN_END(th.tid == 0, 10);
    }

    if (j == NB - 1) {
#pragma unroll
      for (int i = 0; i < NB; ++i) vnew[i] = REAK_ROW(vnl, i);
      REAK_K2_SPAN_BEGIN(s == 0);
      tile_chol_factor(pol, L, s);
      REAK_K2_SPAN_END(s == 0, 8);
    }
    // grad = R u_eff + Bᵀ λ_full; w = grad + Bᵀ v; λ ← Aᵀ λ_full
    if (j < MB) {
      T ru = T(0), bl = T(0);
#pragma unroll
      for (int b = 0; b < MB; ++b) ru += sm.R[j * MB + b] * REAK_ROW(uv, b);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        bl += REAK_ROW(Bs, k * MB + j) * REAK_ROW(lamf, k);
      const T g = T(ru + bl);
      w.w2.store(h, j, 0, th, g);
      REAK_ROW(ws, j) = g + btv;
    }
    {
      T lj = T(0);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        lj += REAK_ROW(As, k * NB + j) * REAK_ROW(lamf, k);
      lam = lj;
    }
    if (j != NB - 1) ava();
    {
      REAK_K2_SPAN_BEGIN(th.tid == 0);
      csync<P>();  // (4) the factor and w are there
      REAK_K2_SPAN_END(th.tid == 0, 9);
    }

    // column j of K = G⁻¹ F; the last column also solves k = G⁻¹ w
    tile_chol_apply(
        pol, L, [&](int a) -> T { return f[a]; },
        [&](int a) -> T& { return y[a]; }, [&](int a) -> T& { return kcol[a]; },
        s);
#pragma unroll
    for (int a = 0; a < MB; ++a) w.K.store(h, a, j, th, kcol[a]);
#pragma unroll
    for (int a = 0; a < MB; ++a) wv[a] = REAK_ROW(ws, a);
    if (j == NB - 1) {
      T kaff[MB];
      tile_chol_apply(
          pol, L, [&](int a) -> T { return wv[a]; },
          [&](int a) -> T& { return y[a]; },
          [&](int a) -> T& { return kaff[a]; }, s);
#pragma unroll
      for (int a = 0; a < MB; ++a) w.w1.store(h, a, 0, th, kaff[a]);
    }
#pragma unroll
    for (int e0 = 0; e0 < MB * MB; e0 += NB) {
      const int e = e0 + j;
      if (e < MB * MB && e % MB <= e / MB)
        w.factor.store(h, e / MB, e % MB, th, REAK_ROW(L, e));
    }
    // column j of Q + Aᵀ V A − Fᵀ K into the spent A buffer;
    // v ← Aᵀ v − Kᵀ w
    {
      T av = T(0), kw = T(0);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        av += REAK_ROW(As, k * NB + j) * REAK_ROW(vv, k);
#pragma unroll
      for (int a = 0; a < MB; ++a) kw += kcol[a] * wv[a];
      vnext = T(av - kw);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T fk = T(0);
#pragma unroll
      for (int a = 0; a < MB; ++a) fk += REAK_ROW(F, a * NB + i) * kcol[a];
      vnew[i] -= fk;
      REAK_ROW(As, i * NB + j) = vnew[i];
    }
    {
      REAK_K2_SPAN_BEGIN(th.tid == 0);
      csync<P>();  // (5) the unsymmetrized V is there, v has been read
      REAK_K2_SPAN_END(th.tid == 0, 10);
    }

    // V ← ½ (V + Vᵀ), column j
#pragma unroll
    for (int i = 0; i < NB; ++i)
      REAK_ROW(V, i * NB + j) = T(T(0.5) * (vnew[i] + REAK_ROW(As, j * NB + i)));
    REAK_ROW(vv, j) = vnext;
    ring.release();
  }
}

// The closed-loop forward pass du_h = −K_h dx − k_h, dx ← A_h dx + B_h du_h
// from dx = 0, with the sweeps of the step folded in: as each stage's du
// appears, column j < m takes its element of the step-length minima (and,
// in the affine pass, of μ; in the corrector pass from the affine step and
// σμ).  AFFINE: k is w1 and du goes to w1; else k is w2, du goes to w2 and
// dx to dxs.  `part` gets this column's share of μ and of the four minima.
template <bool AFFINE, class P, typename T>
__device__ inline void pipe_forward(const PipeSmem<P, T>& sm, Ring<P, T>& ring,
                                    const WholeScratch<T>& w, T sigma_mu,
                                    int m, int H, const TileThread& th,
                                    T (&part)[5]) {
  constexpr int NB = P::NB, MB = P::MB, TS = P::TS;
  using S = SlotRows<NB, MB>;
  const int s = th.s, j = th.j;
  T* const dxv = sm.vec;             // [2][NB]
  T* const duv = dxv + 2 * NB * TS;  // [MB]
  const TileArr<T>& du = AFFINE ? w.w1 : w.w2;
  enter_pass(sm);
  REAK_ROW(dxv, j) = T(0);
  T mu_j = T(0), t[4] = {T(INFINITY), T(INFINITY), T(INFINITY), T(INFINITY)};
  for (int h = 0; h < H; ++h) {
    const T* const St = ring.wait();
    const int cur = h & 1;
    const T* const dx = dxv + cur * NB * TS;
    csync<P>();  // (1) dx is there
    if (j < MB) {
      T t0 = T(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        t0 += REAK_ROW(St, S::K + j * NB + c) * REAK_ROW(dx, c);
      const T du_j = -T(t0) - REAK_ROW(St, (AFFINE ? S::W1 : S::W2) + j);
      REAK_ROW(duv, j) = du_j;
      du.store(h, j, 0, th, du_j);
      if (j < m) {
        const T sl = REAK_ROW(St, S::SL + j), su = REAK_ROW(St, S::SU + j),
                zl = REAK_ROW(St, S::ZL + j), zu = REAK_ROW(St, S::ZU + j);
        const T dua = AFFINE ? du_j : REAK_ROW(St, S::W1 + j);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        if (AFFINE) {
          mu_j += sl * zl + su * zu;
          t[0] = fmin(t[0], max_step_term(sl, dua));
          t[1] = fmin(t[1], max_step_term(su, -dua));
          t[2] = fmin(t[2], max_step_term(zl, dzla));
          t[3] = fmin(t[3], max_step_term(zu, dzua));
        } else {
          const T dun = du_j;
          const T rc_l = sigma_mu - dua * dzla - zl * sl;
          const T rc_u = sigma_mu + dua * dzua - zu * su;
          const T dzl = (rc_l - zl * dun) / sl;
          const T dzu = (rc_u + zu * dun) / su;
          t[0] = fmin(t[0], max_step_term(sl, dun));
          t[1] = fmin(t[1], max_step_term(su, -dun));
          t[2] = fmin(t[2], max_step_term(zl, dzl));
          t[3] = fmin(t[3], max_step_term(zu, dzu));
        }
      }
    }
    csync<P>();  // (2) du is there
    T a = T(0), bb = T(0);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      a += REAK_ROW(St, S::A + j * NB + c) * REAK_ROW(dx, c);
#pragma unroll
    for (int c = 0; c < MB; ++c)
      bb += REAK_ROW(St, S::BM + j * MB + c) * REAK_ROW(duv, c);
    ring.release();
    const T x1 = T(a + bb);
    REAK_ROW(dxv, (cur ^ 1) * NB + j) = x1;
    if (!AFFINE) w.dxs.store(h, j, 0, th, x1);
  }
  part[0] = mu_j;
#pragma unroll
  for (int q = 0; q < 4; ++q) part[q + 1] = t[q];
}

// The corrector's vector reverse pass on the stored gains and factors
// (riccati_tile.cuh::vector_pass), its right-hand side formed at its stage
// from the slacks, duals, the affine step (w1), the gradient (w2) and σμ:
// w = rhs_h + B_hᵀ v, k_h = G_h⁻¹ w into w2, v ← A_hᵀ v − K_hᵀ w.
template <class P, typename T>
__device__ inline void pipe_vector(const PipeSmem<P, T>& sm, Ring<P, T>& ring,
                                   const WholeScratch<T>& w, T sigma_mu, int m,
                                   int H, const TileThread& th) {
  constexpr int NB = P::NB, MB = P::MB, TS = P::TS;
  using S = SlotRows<NB, MB>;
  const P pol{};
  const int s = th.s, j = th.j;
  T* const vv = sm.vec;            // [2][NB]
  T* const ws = vv + 2 * NB * TS;  // [MB]
  enter_pass(sm);
  REAK_ROW(vv, ((H - 1) & 1) * NB + j) = T(0);
  for (int h = H - 1; h >= 0; --h) {
    const T* const St = ring.wait();
    const int cur = h & 1;
    const T* const v = vv + cur * NB * TS;
    csync<P>();  // (1) v is there
    if (j < MB) {
      T t = T(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        t += REAK_ROW(St, S::BM + c * MB + j) * REAK_ROW(v, c);
      T rhs = T(0);
      if (j < m) {
        const T sl = REAK_ROW(St, S::SL + j), su = REAK_ROW(St, S::SU + j),
                zl = REAK_ROW(St, S::ZL + j), zu = REAK_ROW(St, S::ZU + j);
        const T dua = REAK_ROW(St, S::W1 + j);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma_mu - dua * dzla - zl * sl;
        const T rc_u = sigma_mu + dua * dzua - zu * su;
        const T r_dual = REAK_ROW(St, S::W2 + j) - zl + zu;
        rhs = r_dual - rc_l / sl + rc_u / su;
      }
      REAK_ROW(ws, j) = rhs + T(t);
    }
    csync<P>();  // (2) w is there
    T wv[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) wv[a] = REAK_ROW(ws, a);
    T av = T(0), kw = T(0);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      av += REAK_ROW(St, S::A + c * NB + j) * REAK_ROW(v, c);
#pragma unroll
    for (int a = 0; a < MB; ++a)
      kw += REAK_ROW(St, S::K + a * NB + j) * wv[a];
    REAK_ROW(vv, (cur ^ 1) * NB + j) = T(av - kw);
    if (j == NB - 1) {
      T kh[MB], y[MB];
      tile_chol_apply(
          pol, St + S::L * TS, [&](int a) -> T { return wv[a]; },
          [&](int a) -> T& { return y[a]; }, [&](int a) -> T& { return kh[a]; },
          s);
#pragma unroll
      for (int a = 0; a < MB; ++a) w.w2.store(h, a, 0, th, kh[a]);
    }
    ring.release();
  }
}

// Per scenario over the columns: the sum of the columns' part[0] and the
// minima of their part[1..4], through the work area; every thread of a
// scenario gets the same results.
template <class P, typename T>
__device__ inline void pipe_reduce(const PipeSmem<P, T>& sm,
                                   const TileThread& th, const T (&part)[5],
                                   T& sum, T (&mins)[4]) {
  constexpr int NB = P::NB, TS = P::TS;
  const int s = th.s;
  T* const red = sm.work;  // [5][NB]
  csync<P>();
#pragma unroll
  for (int q = 0; q < 5; ++q) REAK_ROW(red, q * NB + th.j) = part[q];
  csync<P>();
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

// the μ_aff sweep over the (H, m) arrays loads SWEEP elements a column at
// once, then uses them in their order
constexpr int SWEEP = 8;

// The consumers: the whole solve of the block's TS scenarios.  Per
// iteration the fused reverse pass (the update of the iteration before
// folded in), the affine forward pass (μ and the affine minima folded in),
// one sweep for μ_aff, the corrector reverse pass (its right-hand side
// folded in) and the corrector forward pass (its minima folded in); the two
// rollouts around them.
template <class P, typename T>
__device__ inline void pipe_consume(const PipeArgs<T>& a,
                                    const PipeSmem<P, T>& sm, int n, int m) {
  constexpr int NB = P::NB, TS = P::TS;
  TileThread th;
  th.tid = threadIdx.x;
  th.s = th.tid % TS;
  th.j = th.tid / TS;
  th.b = static_cast<long long>(blockIdx.x) * TS + th.s;
  const int j = th.j, H = a.H;
  const long long Bp = a.Bp;
  const WholeScratch<T> w(a.scratch, H, n, m, Bp);
  const TileArr<const T> x0{a.x0, n, 1, a.B, a.B, false};
  const TileArr<T> u_out{a.u_out, m, 1, a.B, a.B, false};
  const TileArr<T> xs_out{a.xs_out, n, 1, a.B, a.B, false};
  Ring<P, T> ring{sm};
  const int HM = H * m;
  // element idx of an (H, m) scratch array, this thread's scenario
  auto at = [&](int idx) { return static_cast<long long>(idx) * Bp + th.b; };

  for (int idx = j; idx < HM; idx += NB) {
    const int i = idx % m;
    const T mid = T(0.5) * (a.lb[i] + a.ub[i]);
    const T half = T(0.5) * (a.ub[i] - a.lb[i]);
    w.u.p[at(idx)] = mid;
    w.sl.p[at(idx)] = half;
    w.su.p[at(idx)] = half;
    w.zl.p[at(idx)] = T(1);
    w.zu.p[at(idx)] = T(1);
  }
  pipe_rollout(sm, ring, x0, w.xs, H, th);
  REAK_K2_STAMP(0);

  const T N2 = T(2.0 * H * m);
  T part[5], t[4], sum;
  // the step of the iteration before, applied in the next reverse pass
  T a_p = T(0), a_d = T(0), sigma_mu = T(0);
  for (int it = 0; it < a.iters; ++it) {
    pipe_reverse(sm, ring, w, a.has_xr != 0, a.has_ur != 0, it > 0, a_p, a_d,
                 sigma_mu, m, H, th);
    REAK_K2_STAMP(1);

    pipe_forward<true>(sm, ring, w, T(0), m, H, th, part);
    pipe_reduce(sm, th, part, sum, t);
    const T mu = sum / N2;
    a_p = step_length(t, 0, 1);
    a_d = step_length(t, 2, 3);
    REAK_K2_STAMP(2);

    // μ_aff needs the affine step lengths over the whole horizon
    T mua_j = T(0);
    for (int i0 = j; i0 < HM; i0 += SWEEP * NB) {
      T sl[SWEEP], su[SWEEP], zl[SWEEP], zu[SWEEP], dua[SWEEP];
#pragma unroll
      for (int u = 0; u < SWEEP; ++u) {
        if (i0 + u * NB < HM) {
          const long long e = at(i0 + u * NB);
          sl[u] = w.sl.p[e];
          su[u] = w.su.p[e];
          zl[u] = w.zl.p[e];
          zu[u] = w.zu.p[e];
          dua[u] = w.w1.p[e];
        }
      }
#pragma unroll
      for (int u = 0; u < SWEEP; ++u) {
        if (i0 + u * NB < HM) {
          const T dzla = -zl[u] - (zl[u] / sl[u]) * dua[u];
          const T dzua = -zu[u] + (zu[u] / su[u]) * dua[u];
          mua_j += (sl[u] + a_p * dua[u]) * (zl[u] + a_d * dzla) +
                   (su[u] - a_p * dua[u]) * (zu[u] + a_d * dzua);
        }
      }
    }
    part[0] = mua_j;
#pragma unroll
    for (int q = 0; q < 4; ++q) part[q + 1] = T(INFINITY);
    T mua_s;
    pipe_reduce(sm, th, part, mua_s, t);
    const T mu_aff = mua_s / N2;
    const T ratio = mu_aff / fmax(mu, T(1e-30));
    const T sigma = ratio * ratio * ratio;
    sigma_mu = sigma * mu;
    REAK_K2_STAMP(3);

    pipe_vector(sm, ring, w, sigma_mu, m, H, th);
    REAK_K2_STAMP(4);

    pipe_forward<false>(sm, ring, w, sigma_mu, m, H, th, part);
    part[0] = T(0);
    pipe_reduce(sm, th, part, sum, t);
    a_p = step_length(t, 0, 1);
    a_d = step_length(t, 2, 3);
    REAK_K2_STAMP(5);
    // the update: in the next reverse pass (after the last, in the clip)
    REAK_K2_STAMP(6);
  }

  // the last step, clipped to the box; then the final consistent rollout
  for (int idx = j; idx < HM; idx += NB) {
    const int i = idx % m;
    T u = w.u.p[at(idx)];
    if (a.iters > 0) u = u + a_p * w.w2.p[at(idx)];
    const T uc = fmin(fmax(u, a.lb[i]), a.ub[i]);
    w.u.p[at(idx)] = uc;
    u_out.store(idx / m, i, 0, th, uc);
  }
  pipe_rollout(sm, ring, x0, xs_out, H, th);
  REAK_K2_STAMP(7);
  REAK_K2_END();
}

// Q, QN, R into shared memory, padded to (NB, MB) with zeros (ones on R's
// diagonal, so the padded Schur block stays positive definite)
template <class P, typename T>
__device__ inline void pipe_consts(const PipeSmem<P, T>& sm, const T* Q,
                                   const T* QN, const T* R, int n, int m) {
  constexpr int NB = P::NB, MB = P::MB;
  for (int e = threadIdx.x; e < NB * NB; e += P::NT) {
    const int i = e / NB, k = e % NB;
    const bool in = i < n && k < n;
    sm.Q[e] = in ? Q[i * n + k] : T(0);
    sm.QN[e] = in ? QN[i * n + k] : T(0);
  }
  for (int e = threadIdx.x; e < MB * MB; e += P::NT) {
    const int i = e / MB, k = e % MB;
    sm.R[e] = (i < m && k < m) ? R[i * m + k] : (i == k ? T(1) : T(0));
  }
}

template <typename T, int NB, int MB, bool EXACT>
__global__ void __launch_bounds__(Pipe<T, NB, MB>::NT, 1)
    pdip_pipe_kernel(const __grid_constant__ PipeArgs<T> a) {
  using P = Pipe<T, NB, MB>;
  extern __shared__ __align__(128) unsigned char pipe_smem[];
  const PipeSmem<P, T> sm(pipe_smem);
  const int n = EXACT ? NB : a.n, m = EXACT ? MB : a.m;
  if (threadIdx.x == 0) {
    for (int k = 0; k < P::RING; ++k) {
      mbar_init(&sm.full[k], 1);
      mbar_init(&sm.empty[k], P::NC);
    }
    mbar_init(sm.pass, P::NC);
    mbar_fence_init();
  }
  pipe_consts(sm, a.Q, a.QN, a.R, n, m);
  REAK_K2_BEGIN();
  __syncthreads();
  // the roles never meet again: no block-wide barrier after this
  if (threadIdx.x >= P::NC) {
    if constexpr (P::REALLOC) regs_dec<P::PRODUCER_REGS>();
    if (threadIdx.x == P::NC) pipe_produce(a, sm);
  } else {
    if constexpr (P::REALLOC) regs_inc<P::CONSUMER_REGS>();
    pipe_consume(a, sm, n, m);
  }
}

#endif  // REAK_RUNTIME

// scratch values a scenario: K, the packed factors, seven (H, m) and two
// (H, n) arrays (ops/pdip_whole.py::scratch_values)
inline long long scratch_values(int H, int n, int m) {
  return static_cast<long long>(H) * (m * n + m * m + 7 * m + 2 * n);
}

#ifndef REAK_RUNTIME
// The launch of a compile-time instance: the tensor maps of the inputs and
// of the scratch's arrays, then one block a tile of TS scenarios.  TMA takes
// 16 B aligned bases and rows, so a batch whose row of B values is not a
// whole number of 16 B is refused (ops/pdip_whole.py pads such a batch).
template <typename T, int NB, int MB, bool EXACT>
int launch(const void* A, const void* Bm, const void* c, const void* xr,
           const void* ur, const void* x0, const void* Q, const void* QN,
           const void* R, const void* lb, const void* ub, void* u_out,
           void* xs_out, void* scratch, long long scratch_count, int H, int n,
           int m, int B, int iters, int smem_bytes, void* stream) {
  using P = Pipe<T, NB, MB>;
  const int blocks = (B + P::TS - 1) / P::TS;
  const long long Bp = static_cast<long long>(blocks) * P::TS;
  // the wrapper's launch shape and scratch (ops/_tile.py) must be this
  // instance's
  if (smem_bytes != P::SMEM || scratch_count < scratch_values(H, n, m) * Bp)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (static_cast<long long>(B) * static_cast<long long>(sizeof(T)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p :
       std::initializer_list<const void*>{A, Bm, c, xr, ur, scratch})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  PipeArgs<T> a{};
  int rc = 0;
  // a map over a contiguous array of `dims` (innermost first), one box each
  auto map = [&](TmaMap* mp, const void* base, int rank,
                 std::initializer_list<long long> dims,
                 std::initializer_list<int> box) {
    uint64_t d[4], st[3];
    uint32_t bx[4];
    int i = 0;
    for (long long v : dims) d[i++] = static_cast<uint64_t>(v);
    i = 0;
    for (int v : box) bx[i++] = static_cast<uint32_t>(v);
    uint64_t stride = sizeof(T);
    for (int k = 0; k + 1 < rank; ++k) st[k] = stride *= d[k];
    if (rc == 0) rc = tma_encode(mp, base, rank, d, st, bx, int(sizeof(T)));
  };
  constexpr int TS = P::TS;
  map(&a.A, A, 4, {B, n, n, H}, {TS, NB, NB, 1});
  map(&a.Bm, Bm, 4, {B, m, n, H}, {TS, MB, NB, 1});
  map(&a.c, c, 3, {B, n, H}, {TS, NB, 1});
  if (xr != nullptr) map(&a.xr, xr, 3, {B, n, H}, {TS, NB, 1});
  if (ur != nullptr) map(&a.ur, ur, 3, {B, m, H}, {TS, MB, 1});
  T* const sc = static_cast<T*>(scratch);
  const long long hb = static_cast<long long>(H) * Bp;
  map(&a.K, sc, 4, {Bp, n, m, H}, {TS, NB, MB, 1});
  map(&a.L, sc + hb * m * n, 4, {Bp, m, m, H}, {TS, MB, MB, 1});
  map(&a.it, sc + hb * (m * n + m * m), 3, {Bp, m, 7LL * H}, {TS, MB, 1});
  map(&a.xs, sc + hb * (m * n + m * m + 7 * m), 3, {Bp, n, H}, {TS, NB, 1});
  map(&a.dx, sc + hb * (m * n + m * m + 7 * m + n), 3, {Bp, n, H},
      {TS, NB, 1});
  if (rc != 0) return rc;
  a.x0 = static_cast<const T*>(x0);
  a.Q = static_cast<const T*>(Q);
  a.QN = static_cast<const T*>(QN);
  a.R = static_cast<const T*>(R);
  a.lb = static_cast<const T*>(lb);
  a.ub = static_cast<const T*>(ub);
  a.u_out = static_cast<T*>(u_out);
  a.xs_out = static_cast<T*>(xs_out);
  a.scratch = sc;
  a.Bp = Bp;
  a.H = H;
  a.n = n;
  a.m = m;
  a.B = B;
  a.iters = iters;
  a.has_xr = xr != nullptr;
  a.has_ur = ur != nullptr;
  auto kernel = pdip_pipe_kernel<T, NB, MB, EXACT>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks, P::NT, P::SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#endif  // REAK_RUNTIME

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
