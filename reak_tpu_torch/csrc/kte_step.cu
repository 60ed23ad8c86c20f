// Rollout step + LTV linearization of a fixed-base KTE chain, one launch per
// step: the hand-written Hopper port of the Pallas kernel
// reak_tpu/ops/kte_core_pallas.py::make_step_lanes (K1) and, as the instance
// kCoreOnly = true of the same kernel, which stops before the series, of
// ::make_core_lanes (K5: x, u → q̈ (nv, B), ∂q̈/∂x (nv, n, B), M⁻¹ (nv, nv, B)).
//
// What it computes, per scenario b (lanes layout, scenario last):
//   x (n, B), u (nv, B) → Ad (n, n, B), Bd (n, nv, B), cd (n, B), x_new (n, B)
// with n = 2 nv: the mass matrix M and force f of the chain, their tangents
// along all n state directions, q̈ = M⁻¹(f + u), ∂q̈/∂x = M⁻¹(∂f − ∂M q̈),
// M⁻¹, and the order-`order` exponential-series discretization
//   S = Σ dt^k A^{k-1}/k!,  Ad = I + A S,  Bd = S B,  x_new = x + S f0,
//   cd = x_new − Ad x − Bd u.
// Every fixed-base chain: REVOLUTE, PRISMATIC and FIXED joints, offsets,
// springs, dampers, full inertia tensors; up to 16 joints at compile-time
// widths, past that on one runtime-width instance a type (at the end).
//
// What bounds it on the H100: latency.  A scenario reads 3 nv values and
// writes n² + n nv + 2n (K5: 18 in and 114 out at nv = 6), and evaluates the
// chain's kinematics in hyper-dual numbers along each of its n directions:
// a q direction's run is ~18,000 instructions at (6, 6) f32, which a warp
// issues at ~9 cycles each while the schedulers stay ~80 % idle
// (ops/k1_phases.py, PERF.md §6), so the time is that chain times
// the waves it takes.  Not memory, and not the arithmetic units.  The first
// port (one binary for every chain, widths known at run time) kept that
// state in local memory: 96 registers and a 3,840 B stack frame in f32,
// which spilled to device memory.
//
// Design.  The Pallas body takes its derivatives by jax.linearize/jax.jvp
// over an (8, 128) tile in ~24 MB of VMEM; a CUDA kernel has no autodiff and
// an SM has 227 KB.  So the kernel keeps the hyper-dual arithmetic
// (hyperdual.cuh) and goes after per-thread state, redundancy, idle warps
// and serial steps:
// - Widths at compile time.  The kernel is a template on (NJ, NV), the
//   joints and dofs of the chain; each (NJ, NV, type) is a library of its own
//   (ops/_build.py, kte_step@6x6_f32), built at first use.  Every chain loop
//   unrolls, so every per-joint array is indexed by constants and lives in
//   registers.  Arrays run over joints (a FIXED joint's column is zero and its
//   row of M is the identity's, which leaves the factor of the dofs' block
//   unchanged); the dof of a joint is a uniform run-time index of the loads
//   and stores.  Joint types and zero offsets stay table values: their
//   branches are uniform across the block.
// - The body loop is fused into the kinematics: body i joins M and f as soon
//   as its frame is known, so no COM or orientation of an earlier body is
//   kept, only the anchors and axes of the joints up to it.
// - Pair slots.  A block is a tile of TS = 16 scenarios × NV slots, and the
//   thread of slot j runs the q direction j, then the q̇ direction NV + j: a
//   q̇ direction moves no position, so it runs in HDq numbers and skips M,
//   and its run takes under half a q run.  Split over warps of their own,
//   the q̇ warps idled half of each tile (PERF.md §6); as pairs,
//   every warp carries the same work and runs one kind of direction at a
//   time (two slots of 16 a warp).  A (6, 6) f32 block of 3 warps runs four
//   to an SM at 168 registers, so B = 8192 is one wave, and each block's
//   one-slot primal phase overlaps the others' runs.  No barrier separates
//   the runs.
// - The split mode.  A grid under one wave (the 16-segment beam's B = 64,
//   a single scenario) is set by one block's latency, which pairs lengthen
//   by the q̇ run: there the wrapper launches kte_split_kernel, whose
//   block runs the q directions on the pair slots' warps and the q̇ ones
//   on as many warps more, a thread one direction (a q̇ one takes the
//   primal M's values on its run and factors it itself, so no barrier
//   hands the factor over), at one block an SM's registers.
// - The work every direction shares is done once per scenario.  A primal
//   phase (one slot: a spare one where the warps leave one) runs the
//   forward kinematics in Dual numbers (value and inner tangent) and leaves
//   those parts of every frame, axis, anchor and COM in shared memory,
//   scenario innermost; each direction takes v and e of them back
//   ("anchors"), so it carries only the outer parts (δ, εδ).  The q run
//   holds the primal M and f, so each thread factors M and solves for q̈ in
//   its own registers, and its q̇ run's column takes the same factor.
// - State.  Where they fit beside the rows, each thread's outer parts of the
//   joints' anchors and world axes live in its own column of shared memory
//   (12 values a joint) rather than in registers.
// - The chain's constants (axes, offsets, COMs, masses, inertias, springs,
//   dampers, gravity; ops/kte_step.py::chain_table packs them) are a kernel
//   parameter passed by value (__grid_constant__): with the loops unrolled,
//   every read is a constant-bank operand.
// - K1's series stays on the tile: the columns of ∂q̈/∂x and M⁻¹ into the
//   rows the anchors leave, column d of S by direction d, then row d of Ad,
//   Bd, cd and x_new, each step between block barriers with every thread
//   working.
// No setmaxnreg: every warp runs the same work, so no warpgroup has
// registers to give another.  Alternatives measured slower on the H100 and
// not kept (PERF.md §6): each direction computing the primal parts itself,
// one code for both kinds of direction, each direction starting at its own
// joint, and q and q̇ directions on warps of their own with a
// persistent block walking tiles, the next tile's primal phase in the q̇
// warps' slack (its loop over tiles cost the q chain spills and length).
// No tensor cores: every product is per-scenario scalar hyper-dual
// arithmetic with no operand shared across the batch, and TF32 would miss
// the f32 bar.  No fast math: sincos stays precise.
//
// K5 is the instance kCoreOnly = true: each direction writes its column of
// ∂q̈/∂x (and for d < nv a column of M⁻¹; direction 0 also q̈) straight to
// device memory in the TPU kernel's layout, before the series.
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>
#include <utility>

#include "hyperdual.cuh"

// ops/k1_phases.py times the phases of a stamped copy; here they are empty
#ifndef REAK_K1_STAMPS
#define REAK_K1_BEGIN(who)
#define REAK_K1_STAMP(slot)
#define REAK_K1_END()
#endif

namespace reak {
namespace {

// joints (= bodies) of the widest compile-time instance; a wider chain runs
// the runtime-width instance (REAK_RUNTIME, below)
constexpr int UNROLLED_JOINTS = 16;
// threads a block of the runtime-width instance, at most
constexpr int STEP_THREADS = 384;
// threads a block of a compile-time instance, at most
constexpr int TILE_THREADS = 384;
// shared memory a block, at most (an H100's 227 KB)
constexpr int STEP_SHARED = 232448;
// chain table: J_STRIDE values per joint, then gravity (3)
constexpr int J_TYPE = 0, J_AXIS = 1, J_OFFP = 4, J_OFFQ = 7, J_COM = 11,
              J_MASS = 14, J_INER = 15, J_STIFF = 24, J_REST = 25,
              J_DAMP = 26, J_STRIDE = 27;
constexpr int REVOLUTE = 0, PRISMATIC = 1, FIXED = 2;

// Anchored values of a joint (value and inner tangent each): the anchor
// (p after the offset) 3, Q after the offset 4, the world axis 3, sin and cos
// of the half angle 1 (values only), p after a prismatic joint 3, Q after a
// revolute joint 4, the COM 3.
constexpr int SLOTS = 21;
constexpr int S_ANC = 0, S_QOFF = 3, S_AXIS = 7, S_SC = 10, S_PPRI = 11,
              S_QREV = 14, S_COM = 18;

// The launch shape of a compile-time instance (ops/kte_step.py::
// launch_shape mirrors it).  A block is one tile of TS scenarios (a 64 B
// row in f32, 128 B in f64).  Its threads are NV pair slots of TS threads
// (whole warps; the slots past NV are spare): the thread of slot j runs the
// q direction j, then the q̇ direction NV + j, for its scenario, so every
// warp carries the same work and runs one kind of direction at a time.  The
// first spare slot, or else the last slot, runs the primal kinematics
// first.  A grid of at most one wave takes the split mode instead
// (kSplit): a block's latency, not the SMs' throughput, sets its time, so
// a thread runs one direction: the warps of the pair slots run the q
// directions, as many warps after them the q̇ ones (slot QD_SLOT + j runs
// q̇ direction NV + j, taking the primal M's values on its run and
// factoring M itself), so no warp holds both kinds; with every register
// its warps may take.
constexpr int warps_of(int threads) { return (threads + 31) / 32; }
// REG_WARPS_* (the warps an SM's registers are shared among: 12 gives 168
// registers a thread, 8 gives 255), TILE_THREADS and StepShape's TS0:
// ops/kte_variants.py re-measures them.
constexpr int REG_WARPS_NARROW = 12;  // f32 chains of at most six joints
constexpr int REG_WARPS_WIDE = 8;     // the others
// shared rows of TS values a tile: the primal kinematics' anchors, whose
// rows K1's ∂q̈/∂x, M⁻¹ and S reuse once every run is done
constexpr int tile_rows(int nj, int nv, bool core) {
  return core || 2 * SLOTS * nj >= 7 * nv * nv ? 2 * SLOTS * nj
                                               : 7 * nv * nv;
}
// TS0 halved until the block's threads (`copies` of the pair slots'
// warps) and rows fit
constexpr int fit_tile(int ts, int nj, int nv, int copies, bool core,
                       int size) {
  return ts == 1 ||
                 (copies * 32 * warps_of(ts * nv) <= TILE_THREADS &&
                  tile_rows(nj, nv, core) * ts * size <= STEP_SHARED)
             ? ts
             : fit_tile(ts / 2, nj, nv, copies, core, size);
}

template <typename T, int NJ, int NV, bool kCoreOnly, bool kSplit = false>
struct StepShape {
  static constexpr int N = 2 * NV;
  // the pair slots' warps, and in the split mode as many for the q̇ slots
  static constexpr int COPIES = kSplit ? 2 : 1;
  static constexpr int TS0 = 16;
  static constexpr int TS =
      fit_tile(TS0, NJ, NV, COPIES, kCoreOnly, int(sizeof(T)));
  static constexpr int Q_WARPS = warps_of(TS * NV);
  static constexpr int NT = 32 * Q_WARPS * COPIES;
  // the split mode's first q̇ slot (0 in the pair mode)
  static constexpr int QD_SLOT = kSplit ? 32 * Q_WARPS / TS : 0;
  // a spare slot of the q warps, or else the last direction slot
  static constexpr int PRIMAL_SLOT =
      32 * Q_WARPS / TS > NV ? NV : QD_SLOT + NV - 1;
  static constexpr int ROWS = tile_rows(NJ, NV, kCoreOnly);
  // the blocks an SM should hold: as many as the registers' warps allow;
  // one in the split mode, whose grid fills at most one wave
  static constexpr int REG_WARPS =
      int(sizeof(T)) == 4 && NJ <= 6 ? REG_WARPS_NARROW : REG_WARPS_WIDE;
  static constexpr int WANT_BLOCKS =
      !kSplit && REG_WARPS / (NT / 32) > 1 ? REG_WARPS / (NT / 32) : 1;
  // each thread's outer parts (δ, εδ) of the joints' anchors and world
  // axes, 12 values a joint, in shared memory where they fit for all of
  // those blocks
  static constexpr bool OUTER_SHARED =
      (ROWS * TS + 12 * NJ * NT) * int(sizeof(T)) * WANT_BLOCKS <=
      STEP_SHARED;
  static constexpr int SMEM =
      (ROWS * TS + (OUTER_SHARED ? 12 * NJ * NT : 0)) * int(sizeof(T));
  static constexpr int MIN_BLOCKS =
      STEP_SHARED / SMEM < WANT_BLOCKS ? STEP_SHARED / SMEM : WANT_BLOCKS;
};

// the chain table by value
template <typename T, int NJ>
struct Chain {
  T c[NJ * J_STRIDE + 3];
};

// ---- vector and quaternion helpers over a number type N (Dual or HD) ------
// a × b (a and b arrays, or rows of the runtime instance's work area)
template <class A3, class B3, typename N>
__device__ inline void cross_nn(const A3& a, const B3& b, N out[3]) {
  N x = a[1] * b[2] - a[2] * b[1];
  N y = a[2] * b[0] - a[0] * b[2];
  N z = a[0] * b[1] - a[1] * b[0];
  out[0] = x;
  out[1] = y;
  out[2] = z;
}

// a × b for a constant b
template <typename N, typename T>
__device__ inline void cross_nc(const N a[3], const T b[3], N out[3]) {
  N x = b[2] * a[1] - b[1] * a[2];
  N y = b[0] * a[2] - b[2] * a[0];
  N z = b[1] * a[0] - b[0] * a[1];
  out[0] = x;
  out[1] = y;
  out[2] = z;
}

// rotate a constant v by q: v + w t + qv × t with t = 2 qv × v
template <typename N, typename T, class O3>
__device__ inline void qrot_nc(const N q[4], const T v[3], O3&& out) {
  const N qv[3] = {q[1], q[2], q[3]};
  N t[3], u[3];
  cross_nc(qv, v, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = T(2) * t[i];
  cross_nn(qv, t, u);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = N(v[i]) + q[0] * t[i] + u[i];
}

// rotate v by q⁻¹
template <typename N, typename T, class V3>
__device__ inline void qrot_inv_nn(const N q[4], const V3& v, N out[3]) {
  const N qv[3] = {-q[1], -q[2], -q[3]};
  N t[3], u[3];
  cross_nn(qv, v, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = T(2) * t[i];
  cross_nn(qv, t, u);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * t[i] + u[i];
}

// q ← q ⊗ b for a constant b
template <typename N, typename T>
__device__ inline void qmul_nc(N q[4], const T b[4]) {
  N w = b[0] * q[0] - b[1] * q[1] - b[2] * q[2] - b[3] * q[3];
  N x = b[1] * q[0] + b[0] * q[1] + b[3] * q[2] - b[2] * q[3];
  N y = b[2] * q[0] - b[3] * q[1] + b[0] * q[2] + b[1] * q[3];
  N z = b[3] * q[0] + b[2] * q[1] - b[1] * q[2] + b[0] * q[3];
  q[0] = w;
  q[1] = x;
  q[2] = y;
  q[3] = z;
}

// q ⊗ (0, a) for a constant axis a
template <typename N, typename T>
__device__ inline void qmul_axis(const N q[4], const T a[3], N out[4]) {
  out[0] = -(a[0] * q[1] + a[1] * q[2] + a[2] * q[3]);
  out[1] = a[0] * q[0] + a[2] * q[2] - a[1] * q[3];
  out[2] = a[1] * q[0] - a[2] * q[1] + a[0] * q[3];
  out[3] = a[2] * q[0] + a[1] * q[1] - a[0] * q[2];
}

// ---- anchors: where the primal phase leaves the value and inner tangent of
// a chain quantity (slot-major rows of TS scenarios) and each direction
// takes them back; TS = 0: the runtime-width instance's `ts` ----------------
template <typename T, int TS>
struct KeepPrimal {  // the primal phase, in Dual numbers
  T* sm;
  int s;
  int ts = TS;
  __device__ int row(int r) const { return r * (TS > 0 ? TS : ts) + s; }
  __device__ void at(const Dual<T>& x, int slot) const {
    sm[row(2 * slot)] = x.v;
    sm[row(2 * slot + 1)] = x.t;
  }
  __device__ void sincos(const Dual<T>& a, Dual<T>& sn, Dual<T>& cs,
                         int slot) const {
    sincos_own(a, &sn, &cs);
    sm[row(2 * slot)] = sn.v;
    sm[row(2 * slot + 1)] = cs.v;
  }
};

template <class N, int NT>
struct OuterRef;

template <typename T, int TS>
struct TakePrimal {  // a direction, in HD or HDq numbers
  const T* sm;
  int s;
  int ts = TS;
  __device__ int row(int r) const { return r * (TS > 0 ? TS : ts) + s; }
  __device__ T v(int slot) const { return sm[row(2 * slot)]; }
  __device__ T e(int slot) const { return sm[row(2 * slot + 1)]; }
  template <class N>
  __device__ void at(N& x, int slot) const {
    x.v = v(slot);
    x.e = e(slot);
  }
  template <class N>
  __device__ void sincos(const N& a, N& sn, N& cs, int slot) const {
    sincos_of(a, v(slot), e(slot), &sn, &cs);
  }
  // an element of OuterJoints reads v and e from these rows itself
  template <class N, int NT>
  __device__ void at(const OuterRef<N, NT>&, int) const {}
};

// ---- a direction's joint anchors and world axes, outer parts in shared
// memory: element (k, c) keeps δ at o[0] and εδ at o[NT] (this thread's
// column of rows NT values long, so a warp's threads touch neighbouring
// words) and reads v and e from the primal phase's anchor rows, which hold
// what every direction would compute of them ------------------------------
template <typename T>
__device__ inline HD<T> with_outer(T v, T e, const T* o, int nt, HD<T>*) {
  return HD<T>(v, e, o[0], o[nt]);
}
template <typename T>
__device__ inline HDq<T> with_outer(T v, T e, const T* o, int nt, HDq<T>*) {
  return HDq<T>(v, e, o[nt]);
}
template <typename T>
__device__ inline void keep_outer(T* o, int nt, const HD<T>& x) {
  o[0] = x.d;
  o[nt] = x.ed;
}
template <typename T>
__device__ inline void keep_outer(T* o, int nt, const HDq<T>& x) {
  o[nt] = x.ed;  // an HDq number has no δ part
}

// the scalar type of a number type N (Dual, HD or HDq)
template <class N>
using value_of = std::remove_cv_t<
    std::remove_reference_t<decltype(std::declval<N&>().v)>>;

template <class N, int NT>
struct OuterRef {
  using T = value_of<N>;
  T* o;        // δ at o[0], εδ at o[NT]
  const T* a;  // v at a[0], e at a[ts]
  int ts;
  __device__ operator N() const {
    return with_outer(a[0], a[ts], o, NT, static_cast<N*>(nullptr));
  }
  __device__ const OuterRef& operator=(const N& x) const {
    keep_outer(o, NT, x);
    return *this;
  }
};

template <class N, int NT>
struct OuterJoints {
  using T = value_of<N>;
  T* o;           // this thread's word of the first row
  const T* anc;   // the tile's anchor rows at this thread's scenario
  int ts, which;  // which: 0 the anchors, 1 the world axes
  template <class W>
  __device__ OuterJoints(const W& w, int which_)
      : o(w.outer + which_ * 6 * W::NJ_ * NT), anc(w.anchors), ts(w.ts),
        which(which_) {}
  struct Row {
    T* o;
    const T* a;
    int ts;
    __device__ OuterRef<N, NT> operator[](int c) const {
      return {o + 2 * c * NT, a + 2 * c * ts, ts};
    }
  };
  __device__ Row operator[](int k) const {
    const int slot = k * SLOTS + (which == 0 ? S_ANC : S_AXIS);
    return {o + 6 * k * NT, anc + 2 * slot * ts, ts};
  }
};

// ---- directions: how each kind of direction seeds the joint coordinates --
// N: the number type of the chain's positions; V: of the bodies' velocities;
// kM: whether M has a tangent along the direction.  coord(i, q, q̇) is
// joint i's coordinate, rate(J, k, q̇) a Jacobian column J times its joint
// rate, seed(k, q) and seed_rate(k, q̇) joint k's q and q̇ with their outer
// tangents.
template <typename T>
struct AlongQ {  // the position direction of joint jd: q_jd moves
  using N = HD<T>;
  using V = HD<T>;
  static constexpr bool kM = true;
  int jd;
  __device__ N coord(int i, T q, T qd) const {
    return N(q, qd, T(i == jd), T(0));
  }
  __device__ V rate(const N& J, int, T qd) const { return qd * J; }
  __device__ Dual<T> seed(int k, T q) const { return Dual<T>(q, T(k == jd)); }
  __device__ Dual<T> seed_rate(int, T qd) const { return Dual<T>(qd); }
};

template <typename T, bool kPrimalM = false>
struct AlongQd {  // the velocity direction of joint jd: q̇_jd moves
  using N = HDq<T>;
  using V = HD<T>;
  // M does not depend on q̇: its tangent is 0, its values the primal M's,
  // which a run takes only where it factors M itself (the split mode)
  static constexpr bool kM = kPrimalM;
  int jd;
  __device__ N coord(int i, T q, T qd) const { return N(q, qd, T(i == jd)); }
  __device__ V rate(const N& J, int k, T qd) const {
    const T sd = T(k == jd);
    return V(J.v * qd, J.e * qd, J.v * sd, J.ed * qd + J.e * sd);
  }
  __device__ Dual<T> seed(int, T q) const { return Dual<T>(q); }
  __device__ Dual<T> seed_rate(int k, T qd) const {
    return Dual<T>(qd, T(k == jd));
  }
};

// One joint of the forward kinematics: its offset, the joint itself and its
// body's COM.  p, Q: the frame carried down the chain; anc, axg: the joint's
// anchor and world axis (arrays, or rows of the runtime instance's work
// area); com: the body's COM.  `ch` is the chain table: a Chain by value,
// or a ChainRows in device memory (the runtime-width instance).
template <typename N, class C, class A, class R3>
__device__ inline void fk_joint(const C& ch, int i, const N& qi, N p[3],
                                N Q[4], R3&& anc, R3&& axg, N com[3],
                                const A& an) {
  using T = std::remove_cv_t<std::remove_reference_t<decltype(ch.c[0])>>;
  const T* c = ch.c + i * J_STRIDE;
  const int sl = i * SLOTS;
  if (c[J_OFFP] != T(0) || c[J_OFFP + 1] != T(0) || c[J_OFFP + 2] != T(0)) {
    N r[3];
    qrot_nc(Q, c + J_OFFP, r);
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p[k] + r[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    an.at(p[k], sl + S_ANC + k);
    anc[k] = p[k];
  }
  if (c[J_OFFQ] != T(1) || c[J_OFFQ + 1] != T(0) || c[J_OFFQ + 2] != T(0) ||
      c[J_OFFQ + 3] != T(0))
    qmul_nc(Q, c + J_OFFQ);
#pragma unroll
  for (int k = 0; k < 4; ++k) an.at(Q[k], sl + S_QOFF + k);
  const int jt = static_cast<int>(c[J_TYPE]);
  if (jt == REVOLUTE || jt == PRISMATIC) {
    N ax[3];
    qrot_nc(Q, c + J_AXIS, ax);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      an.at(ax[k], sl + S_AXIS + k);
      axg[k] = ax[k];
    }
    if (jt == REVOLUTE) {
      N sn, cs, qa[4];
      an.sincos(T(0.5) * qi, sn, cs, sl + S_SC);
      // Q ⊗ (cos, axis sin) = cos Q + sin (Q ⊗ (0, axis))
      qmul_axis(Q, c + J_AXIS, qa);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Q[k] = cs * Q[k] + sn * qa[k];
        an.at(Q[k], sl + S_QREV + k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p[k] = p[k] + qi * ax[k];
        an.at(p[k], sl + S_PPRI + k);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) axg[k] = N(T(0));
  }
  if (c[J_COM] != T(0) || c[J_COM + 1] != T(0) || c[J_COM + 2] != T(0)) {
    N r[3];
    qrot_nc(Q, c + J_COM, r);
#pragma unroll
    for (int k = 0; k < 3; ++k) com[k] = p[k] + r[k];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) com[k] = p[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) an.at(com[k], sl + S_COM + k);
}

// ---- a direction's arrays ---------------------------------------------------
// At compile-time widths a thread runs one direction and its arrays are
// registers (Regs1, Regs2; once the loops unroll, every index is a
// constant).  The runtime-width instance keeps them in its work area
// (Slot, SlotRows, SlotUpper): element e of a (direction, scenario) slot's
// array lies `stride` values after element e − 1.
template <typename X, int N>
struct Regs1 {
  X v[N];
  __device__ X& operator[](int i) { return v[i]; }
};

template <typename X, int N, int M>
struct Regs2 {
  X v[N][M];
  Regs2() = default;
  template <class W>
  __device__ Regs2(const W&, int) {}  // fresh registers
  __device__ auto operator[](int i) -> X (&)[M] { return v[i]; }
};

template <typename X>
struct Slot {
  X* base;
  int stride;
  __device__ X& operator[](int e) const {
    return base[static_cast<long long>(e) * stride];
  }
};

// rows of `width` elements, each read as X from its storage S (an HDq number
// in an HD slot)
template <typename X, typename S = X>
struct SlotRows {
  S* base;
  int width, stride;
  struct Row {
    S* p;
    int stride;
    __device__ X& operator[](int c) const {
      return *reinterpret_cast<X*>(p + static_cast<long long>(c) * stride);
    }
  };
  __device__ SlotRows(S* base_, int width_, int stride_)
      : base(base_), width(width_), stride(stride_) {}
  // a per-joint array of three of the slot's work (W::rows3)
  template <class W>
  __device__ SlotRows(const W& w, int which)
      : base(w.template rows3<S>(which)), width(3), stride(w.slots) {}
  __device__ Row operator[](int k) const {
    return {base + static_cast<long long>(k) * width * stride, stride};
  }
};

// M above its diagonal, packed by rows: [k][l] for k <= l
template <typename X>
struct SlotUpper {
  X* base;
  int stride, nj;
  __device__ Slot<X> operator[](int k) const {
    return {base + static_cast<long long>(k * nj - k * (k + 1) / 2) * stride,
            stride};
  }
};

// One direction's arrays at compile-time widths: M (above its diagonal)
// and f in Dual numbers, the factor of the primal M (L, 1/diag) and q̈, the
// solves' vectors and the series' three.  Joints3<X>: a per-joint array of
// three, fresh for each run of the kinematics: the Jacobian columns in
// registers; the anchors and world axes in registers (OUTER_NT = 0) or
// their outer parts in rows of OUTER_NT values in shared memory
// (OuterJoints: `outer` at this thread's word, `anchors` the tile's anchor
// rows at its scenario, `ts` values a row).
template <typename T, int NJ, int N, int OUTER_NT = 0>
struct DirRegs {
  static constexpr int NJ_ = NJ;
  template <typename X>
  using Joints3 =
      std::conditional_t<OUTER_NT != 0 && !std::is_same_v<X, Dual<T>>,
                         OuterJoints<X, OUTER_NT>, Regs2<X, NJ, 3>>;
  Regs2<Dual<T>, NJ, NJ> M;
  Regs1<Dual<T>, NJ> f;
  Regs2<T, NJ, NJ> L;
  Regs1<T, NJ> qdd, rhs, y, invd;
  Regs1<T, N> Scol, term, tmp;
  T* outer = nullptr;
  const T* anchors = nullptr;
  int ts = 0;
};

// (M, f) of the chain and their outer tangents along the direction `dir`,
// the kinematics fused with the body loop: body i joins M and f as soon as
// its frame is known.  M is kept above its diagonal.  Every value and inner
// tangent of the chain is an anchor taken back from the primal phase, so
// what the run computes of them is dead code: a direction carries the outer
// parts.  jt, xq, xqd: each joint's type, q and q̇ (0 for a FIXED joint).
template <typename T, class W, class Ch, class Jt, class Xs, class Dir,
          class A>
__device__ inline void terms(const Ch& ch, int NJ, const Jt& jt, const Xs& xq,
                             const Xs& xqd, const Dir& dir, const A& an,
                             W& dw) {
  using N = typename Dir::N;
  using V = typename Dir::V;
  using D = Dual<T>;
  auto& M = dw.M;
  auto& f = dw.f;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    f[k] = D(T(0));
#pragma unroll
    for (int l = k; l < NJ; ++l) M[k][l] = D(T(0));
  }
  const T* grav = ch.c + NJ * J_STRIDE;
  N p[3] = {N(T(0)), N(T(0)), N(T(0))};
  N Q[4] = {N(T(1)), N(T(0)), N(T(0)), N(T(0))};
  typename W::template Joints3<N> anc(dw, 0), axg(dw, 1);
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const N qi = jt[i] != FIXED ? dir.coord(i, xq[i], xqd[i])
                                : N(T(0));
    N com[3];
    fk_joint(ch, i, qi, p, Q, anc[i], axg[i], com, an);

    // body i: its Jacobian columns (Jv world, Jw body frame) over the joints
    // up to i, its velocity and the J̇q̇ bias in the inner tangent
    typename W::template Joints3<D> jv(dw, 0), jw(dw, 1);
    V v[3] = {V(T(0)), V(T(0)), V(T(0))}, w[3] = {V(T(0)), V(T(0)), V(T(0))};
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      N Jv[3], Jw[3];
      if (jt[k] == FIXED) {
#pragma unroll
        for (int c = 0; c < 3; ++c) Jv[c] = Jw[c] = N(T(0));
      } else {
        if (k < i) {  // take the primal parts back where they are kept
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            an.at(anc[k][c], k * SLOTS + S_ANC + c);
            an.at(axg[k][c], k * SLOTS + S_AXIS + c);
          }
        }
        N ak[3], gk[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          ak[c] = anc[k][c];
          gk[c] = axg[k][c];
        }
        if (jt[k] == REVOLUTE) {
          N r[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) r[c] = com[c] - ak[c];
          cross_nn(gk, r, Jv);
          qrot_inv_nn<N, T>(Q, gk, Jw);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[c] = v[c] + dir.rate(Jv[c], k, xqd[k]);
            w[c] = w[c] + dir.rate(Jw[c], k, xqd[k]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            Jv[c] = gk[c];
            Jw[c] = N(T(0));
            v[c] = v[c] + dir.rate(Jv[c], k, xqd[k]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        jv[k][c] = outer_of_value(Jv[c]);
        jw[k][c] = outer_of_value(Jw[c]);
      }
    }
    const T* c = ch.c + i * J_STRIDE;
    const T mb = c[J_MASS];
    const T* I = c + J_INER;
    if constexpr (Dir::kM) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        if (jt[k] == FIXED) continue;
#pragma unroll
        for (int l = k; l <= i; ++l) {
          if (jt[l] == FIXED) continue;
          D term = mb * (jv[k][0] * jv[l][0] + jv[k][1] * jv[l][1] +
                         jv[k][2] * jv[l][2]);
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int cc = 0; cc < 3; ++cc)
              if (I[r * 3 + cc] != T(0))
                term = term + I[r * 3 + cc] * (jw[k][r] * jw[l][cc]);
          M[k][l] = M[k][l] + term;
        }
      }
    }
    // bias force: −m (J̇q̇ − g) on the COM, −(I α + ω × I ω) on the body
    D f_lin[3], wv[3], al[3], Iw[3], Ial[3], wxIw[3], f_ang[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f_lin[k] = -mb * (outer_of_inner(v[k]) - D(grav[k]));
      wv[k] = outer_of_value(w[k]);
      al[k] = outer_of_inner(w[k]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      Iw[r] = D(T(0));
      Ial[r] = D(T(0));
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        if (I[r * 3 + cc] != T(0)) {
          Iw[r] = Iw[r] + I[r * 3 + cc] * wv[cc];
          Ial[r] = Ial[r] + I[r * 3 + cc] * al[cc];
        }
      }
    }
    cross_nn(wv, Iw, wxIw);
#pragma unroll
    for (int k = 0; k < 3; ++k) f_ang[k] = -(Ial[k] + wxIw[k]);
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      if (jt[k] == FIXED) continue;
      f[k] = f[k] +
             (jv[k][0] * f_lin[0] + jv[k][1] * f_lin[1] +
              jv[k][2] * f_lin[2]) +
             (jw[k][0] * f_ang[0] + jw[k][1] * f_ang[1] + jw[k][2] * f_ang[2]);
    }
  }
  // the joints' springs and dampers
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    if (jt[k] == FIXED) continue;
    const T* c = ch.c + k * J_STRIDE;
    f[k] = f[k] - c[J_STIFF] * (dir.seed(k, xq[k]) - D(c[J_REST])) -
           c[J_DAMP] * dir.seed_rate(k, xqd[k]);
  }
}

// The primal phase: the kinematics in Dual numbers (value and inner
// tangent), each joint's and body's into the anchor rows through `keep`.
template <typename T, class Ch, class Jt, class Xs, class K>
__device__ inline void primal_phase(const Ch& ch, int NJ, const Jt& jt,
                                    const Xs& xq, const Xs& xqd,
                                    const K& keep) {
  using D = Dual<T>;
  D p[3] = {D(T(0)), D(T(0)), D(T(0))};
  D Q[4] = {D(T(1)), D(T(0)), D(T(0)), D(T(0))};
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    D anc[3], axg[3], com[3];
    const D qi = jt[i] == FIXED ? D(T(0)) : D(xq[i], xqd[i]);
    fk_joint(ch, i, qi, p, Q, anc, axg, com, keep);
  }
}

// The runtime-width instance's factor of the primal M and q̈ = M⁻¹(f + u),
// once per scenario (by direction 0, whose run holds every body's share of
// the primal M and f; the compile-time kernel's threads each factor their
// own, factor_own), into the scenario rows: L below the diagonal (row i·NJ + j), 1/diag at row
// NJ·NJ + i, q̈ in joint order at NJ·NJ + NJ + i and in dof order at
// NJ·NJ + 2NJ + dof.  A FIXED joint's row and column are the identity's.
// K5 also stores q̈.
template <bool kCoreOnly, typename T, class W, class Jt>
__device__ inline void factor_and_solve(int NJ, int TS, W& dw, const Jt& jt,
                                        const Jt& dof, const T* u, int B,
                                        int b, bool live, T* chol,
                                        T* qdd_out, int s) {
  const int R_INVD = NJ * NJ, R_QDD = NJ * NJ + NJ,
            R_QDOF = NJ * NJ + 2 * NJ;
  auto& M = dw.M;
  auto& f = dw.f;
  auto& L = dw.L;
  auto& rhs = dw.rhs;
  auto& y = dw.y;
  auto& qdd = dw.qdd;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    T sj = jt[j] == FIXED ? T(1) : M[j][j].v;
#pragma unroll
    for (int k = 0; k < j; ++k) sj -= L[j][k] * L[j][k];
    const T dj = T(1) / sqrt(sj);
    chol[(R_INVD + j) * TS + s] = dj;
    L[j][j] = sj * dj;
#pragma unroll
    for (int i = j + 1; i < NJ; ++i) {
      T t = M[j][i].v;
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * dj;
      chol[(i * NJ + j) * TS + s] = L[i][j];
    }
    rhs[j] = jt[j] == FIXED ? T(0) : f[j].v + u[dof[j] * B + b];
  }
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    T t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t * chol[(R_INVD + i) * TS + s];
  }
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < NJ; ++k) t -= L[k][i] * qdd[k];
    qdd[i] = t * chol[(R_INVD + i) * TS + s];
    chol[(R_QDD + i) * TS + s] = qdd[i];
    if (jt[i] != FIXED) {
      chol[(R_QDOF + dof[i]) * TS + s] = qdd[i];
      if constexpr (kCoreOnly)
        if (live) qdd_out[dof[i] * B + b] = qdd[i];
    }
  }
}

// one right-hand side through the factor in the scenario rows
template <typename T, class R, class Y, class O>
__device__ inline void chol_apply_shared(const T* chol, int s, int NJ, int TS,
                                         R& rhs, Y& y, O& out) {
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    T t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= chol[(i * NJ + k) * TS + s] * y[k];
    y[i] = t * chol[(NJ * NJ + i) * TS + s];
  }
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < NJ; ++k) t -= chol[(k * NJ + i) * TS + s] * out[k];
    out[i] = t * chol[(NJ * NJ + i) * TS + s];
  }
}

// Direction d's column of ∂q̈/∂x = M⁻¹(∂f − ∂M q̈), and for d < nv a column
// of M⁻¹, with the factor from the scenario rows (the runtime-width
// instance): into K1's series rows, or (K5) straight to device memory in
// the TPU kernel's layout.
template <bool kCoreOnly, typename T, class W, class Jt>
__device__ inline void dqdd_column(int d, int NJ, int NV, int TS, W& dw,
                                   const Jt& jt, const Jt& dof, const T* chol,
                                   T* ser, T* Ad, T* Bd, int B, int b,
                                   bool live, int s) {
  const int N = 2 * NV, R_QDD = NJ * NJ + NJ, R_MINV = NV * N;
  auto& M = dw.M;
  auto& f = dw.f;
  auto& rhs = dw.rhs;
  auto& col = dw.col;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    T t = f[k].t;
    if (d < NV) {  // M moves only along q
#pragma unroll
      for (int l = 0; l < NJ; ++l)
        t -= (k <= l ? M[k][l].t : M[l][k].t) * chol[(R_QDD + l) * TS + s];
    }
    rhs[k] = jt[k] == FIXED ? T(0) : t;
  }
  chol_apply_shared(chol, s, NJ, TS, rhs, dw.y, col);
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    if (jt[k] == FIXED) continue;
    if constexpr (kCoreOnly) {
      if (live) Ad[(dof[k] * N + d) * B + b] = col[k];
    } else {
      ser[(dof[k] * N + d) * TS + s] = col[k];
    }
  }
  if (d < NV) {
#pragma unroll
    for (int k = 0; k < NJ; ++k) rhs[k] = T(dof[k] == d);
    chol_apply_shared(chol, s, NJ, TS, rhs, dw.y, col);
#pragma unroll
    for (int k = 0; k < NJ; ++k) {
      if (jt[k] == FIXED) continue;
      if constexpr (kCoreOnly) {
        if (live) Bd[(dof[k] * NV + d) * B + b] = col[k];
      } else {
        ser[(R_MINV + dof[k] * NV + d) * TS + s] = col[k];
      }
    }
  }
}

// Column d of S = Σ_{k=1..order} dt^k A^{k-1}/k! into the series rows;
// A = [[0, I], [∂q̈/∂x]]: (A v)_i = v_{i+nv} on top, A_lo v below.
template <typename T, class W>
__device__ inline void series_column(int d, int NV, int TS, W& dw, double dt,
                                     int order, T* ser, int s) {
  const int N = 2 * NV, R_S = NV * N + NV * NV;
  auto& Scol = dw.Scol;
  auto& term = dw.term;
  auto& tmp = dw.tmp;
#pragma unroll
  for (int i = 0; i < N; ++i) Scol[i] = term[i] = (i == d) ? T(dt) : T(0);
  for (int k = 2; k <= order; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < NV) {
        tmp[i] = term[i + NV];
      } else {
        T t = T(0);
#pragma unroll
        for (int j = 0; j < N; ++j)
          t += ser[((i - NV) * N + j) * TS + s] * term[j];
        tmp[i] = t;
      }
    }
    const T ck = T(dt / k);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      term[i] = ck * tmp[i];
      Scol[i] += term[i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) ser[(R_S + i * N + d) * TS + s] = Scol[i];
}

// Row d of Ad = I + A S, Bd = S B, x_new = x + S f0, cd; xv, uv, f0: the
// scenario's x, u and f0 = (q̇, q̈) by index.
template <typename T, class Xv, class Uv, class F0>
__device__ inline void step_row(int d, int NV, int TS, const Xv& xv,
                                const Uv& uv, const F0& f0, const T* x,
                                const T* ser, T* Ad, T* Bd, T* cd, T* xn,
                                int B, int b, bool live, int s) {
  const int N = 2 * NV, R_MINV = NV * N, R_S = NV * N + NV * NV;
  T xnew = x[d * B + b], adx = T(0), bdu = T(0);
#pragma unroll
  for (int l = 0; l < N; ++l) xnew += ser[(R_S + d * N + l) * TS + s] * f0[l];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T a;
    if (d < NV) {
      a = ser[(R_S + (d + NV) * N + j) * TS + s];
    } else {
      a = T(0);
#pragma unroll
      for (int l = 0; l < N; ++l)
        a += ser[((d - NV) * N + l) * TS + s] * ser[(R_S + l * N + j) * TS + s];
    }
    if (j == d) a += T(1);
    adx += a * xv[j];
    if (live) Ad[(d * N + j) * B + b] = a;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    T a = T(0);
#pragma unroll
    for (int l = NV; l < N; ++l)
      a += ser[(R_S + d * N + l) * TS + s] *
           ser[(R_MINV + (l - NV) * NV + j) * TS + s];
    bdu += a * uv[j];
    if (live) Bd[(d * NV + j) * B + b] = a;
  }
  if (live) {
    xn[d * B + b] = xnew;
    cd[d * B + b] = xnew - adx - bdu;
  }
}

// ---- the compile-time kernel's own steps ----------------------------------
// scenario b's q and q̇ by joint (0 for a FIXED joint)
template <typename T, int NJ, int NV>
__device__ inline void load_state(const T* x, int B, int b,
                                  const int (&jt)[NJ], const int (&dof)[NJ],
                                  T (&xq)[NJ], T (&xqd)[NJ]) {
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    xq[i] = jt[i] == FIXED ? T(0) : x[dof[i] * B + b];
    xqd[i] = jt[i] == FIXED ? T(0) : x[(NV + dof[i]) * B + b];
  }
}

// the joint whose q (d < NV) or q̇ direction d moves
template <int NJ, int NV>
__device__ inline int joint_of(const int (&dof)[NJ], int d) {
  const int want = d < NV ? d : d - NV;
  int jd = 0;
#pragma unroll
  for (int i = 0; i < NJ; ++i)
    if (dof[i] == want) jd = i;
  return jd;
}

// The factor of the primal M and q̈ = M⁻¹(f + u) in this thread's registers,
// with factor_and_solve's arithmetic: a q direction's run holds the primal
// M and f (their values), so each thread factors its own.  K5's q̈ is
// stored by the thread of `store`.
template <bool kCoreOnly, typename T, class W, class Jt>
__device__ inline void factor_own(int NJ, W& dw, const Jt& jt, const Jt& dof,
                                  const T* u, int B, int b, bool store,
                                  T* qdd_out) {
  auto& M = dw.M;
  auto& f = dw.f;
  auto& L = dw.L;
  auto& rhs = dw.rhs;
  auto& y = dw.y;
  auto& qdd = dw.qdd;
  auto& invd = dw.invd;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    T sj = jt[j] == FIXED ? T(1) : M[j][j].v;
#pragma unroll
    for (int k = 0; k < j; ++k) sj -= L[j][k] * L[j][k];
    const T dj = T(1) / sqrt(sj);
    invd[j] = dj;
    L[j][j] = sj * dj;
#pragma unroll
    for (int i = j + 1; i < NJ; ++i) {
      T t = M[j][i].v;
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * dj;
    }
    rhs[j] = jt[j] == FIXED ? T(0) : f[j].v + u[dof[j] * B + b];
  }
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    T t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t * invd[i];
  }
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < NJ; ++k) t -= L[k][i] * qdd[k];
    qdd[i] = t * invd[i];
    if constexpr (kCoreOnly)
      if (store && jt[i] != FIXED) qdd_out[dof[i] * B + b] = qdd[i];
  }
}

// one right-hand side through this thread's factor
template <class W, class R, class Y, class O>
__device__ inline void chol_apply_own(int NJ, W& dw, R& rhs, Y& y, O& out) {
  using T = std::remove_reference_t<decltype(dw.invd[0])>;
  auto& L = dw.L;
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    T t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t * dw.invd[i];
  }
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < NJ; ++k) t -= L[k][i] * out[k];
    out[i] = t * dw.invd[i];
  }
}

// dqdd_column's arithmetic on this thread's factor and q̈: direction d's
// columns into `dq` and (a q direction, kQ) `mi`, by joint
template <bool kQ, typename T, class W, class Jt, class C>
__device__ inline void columns_own(int d, int NJ, W& dw, const Jt& jt,
                                   const Jt& dof, C& dq, C& mi) {
  auto& M = dw.M;
  auto& f = dw.f;
  auto& rhs = dw.rhs;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    T t = f[k].t;
    if constexpr (kQ) {  // M moves only along q
#pragma unroll
      for (int l = 0; l < NJ; ++l)
        t -= (k <= l ? M[k][l].t : M[l][k].t) * dw.qdd[l];
    }
    rhs[k] = jt[k] == FIXED ? T(0) : t;
  }
  chol_apply_own(NJ, dw, rhs, dw.y, dq);
  if constexpr (kQ) {
#pragma unroll
    for (int k = 0; k < NJ; ++k) rhs[k] = T(dof[k] == d);
    chol_apply_own(NJ, dw, rhs, dw.y, mi);
  }
}

// Direction d's columns by joint to K1's series rows (∂q̈/∂x, and M⁻¹ for
// d < NV) or K5's outputs in the TPU kernel's layout
template <bool kCoreOnly, typename T, class Jt, class C>
__device__ inline void store_columns(int d, int NJ, int NV, int TS,
                                     const Jt& jt, const Jt& dof, C& dq,
                                     C* mi, T* ser, T* Ad, T* Bd, int B,
                                     int b, bool live, int s) {
  const int N = 2 * NV, R_MINV = NV * N;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    if (jt[k] == FIXED) continue;
    if constexpr (kCoreOnly) {
      if (live) {
        Ad[(dof[k] * N + d) * B + b] = dq[k];
        if (mi) Bd[(dof[k] * NV + d) * B + b] = (*mi)[k];
      }
    } else {
      ser[(dof[k] * N + d) * TS + s] = dq[k];
      if (mi) ser[(R_MINV + dof[k] * NV + d) * TS + s] = (*mi)[k];
    }
  }
}

// The compile-time kernel: one block a tile of TS scenarios.  After the
// primal phase (one slot, once a tile), every thread runs, with no barrier
// between them: its q direction's M, f and tangents, its own factor of M
// and q̈, that direction's columns of ∂q̈/∂x and M⁻¹; then its q̇
// direction's run and column (kSplit: a thread runs one of the two, a q̇
// one taking the primal M on its run and factoring it).  K1 then writes
// the columns to the rows the anchors leave (a barrier before and after),
// takes its directions' columns of S, and their rows of Ad, Bd, cd and
// x_new, each step with every thread working.  kCoreOnly (K5) reuses the
// output pointers: Ad ← ∂q̈/∂x (nv, n, B), Bd ← M⁻¹ (nv, nv, B), cd ← q̈
// (nv, B); xn, dt and order are not read; it stores its columns as the
// runs end.
template <typename T, int NJ, int NV, bool kCoreOnly, bool kSplit>
__device__ __forceinline__ void step_tile(const T* __restrict__ x,
                                          const T* __restrict__ u,
                                          const Chain<T, NJ>& ch, double dt,
                                          int order, T* __restrict__ Ad,
                                          T* __restrict__ Bd,
                                          T* __restrict__ cd,
                                          T* __restrict__ xn, int B) {
  using Shape = StepShape<T, NJ, NV, kCoreOnly, kSplit>;
  constexpr int TS = Shape::TS, N = Shape::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const fk = reinterpret_cast<T*>(smem_raw);  // the anchors
  T* const ser = fk;  // the series' rows, once the anchors are spent
  T* const outer = fk + Shape::ROWS * TS;  // Shape::OUTER_SHARED only
  const int t = threadIdx.x;
  // pair slot j (q direction j, q̇ direction NV + j) or, kSplit, q
  // direction slot j or q̇ direction slot QD_SLOT + j
  const int slot = t / TS;
  const int s = t % TS;
  const bool in_qd = kSplit && slot >= Shape::QD_SLOT;
  const int j = in_qd ? slot - Shape::QD_SLOT : slot;  // its dof
  const bool has_dir = j < NV;
  const bool run_q = has_dir && !in_qd;
  const bool run_qd = has_dir && (in_qd || !kSplit);
  const int b_raw = blockIdx.x * TS + s;
  const bool live = b_raw < B;
  const int b = live ? b_raw : B - 1;  // the ragged edge computes, never stores
  REAK_K1_BEGIN(s == 0 && (has_dir || slot == Shape::PRIMAL_SLOT) ? slot
                                                                  : -1);

  // joint types and the dof of each joint (uniform); the state by joint
  int jt[NJ], dof[NJ];
  {
    int k = 0;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      jt[i] = static_cast<int>(ch.c[i * J_STRIDE + J_TYPE]);
      dof[i] = jt[i] == FIXED ? -1 : k;
      k += jt[i] == FIXED ? 0 : 1;
    }
  }
  T xq[NJ], xqd[NJ];
  load_state<T, NJ, NV>(x, B, b, jt, dof, xq, xqd);

  // ---- the primal phase: the kinematics' value and inner tangent --------
  if (slot == Shape::PRIMAL_SLOT) {
    const KeepPrimal<T, TS> keep{fk, s};
    primal_phase<T>(ch, NJ, jt, xq, xqd, keep);
  }
  REAK_K1_STAMP(0);
  __syncthreads();
  REAK_K1_STAMP(1);

  // ---- the q run, the factor, its columns; the q̇ run, its column --------
  DirRegs<T, NJ, N, Shape::OUTER_SHARED ? Shape::NT : 0> dw;
  dw.outer = outer + t;
  dw.anchors = fk + s;
  dw.ts = TS;
  const TakePrimal<T, TS> take{fk, s};
  Regs1<T, NJ> dq_q, mi_q, dq_qd;
  if (run_q) {
    terms<T>(ch, NJ, jt, xq, xqd, AlongQ<T>{joint_of<NJ, NV>(dof, j)}, take,
             dw);
    REAK_K1_STAMP(2);
    factor_own<kCoreOnly>(NJ, dw, jt, dof, u, B, b, live && slot == 0, cd);
    REAK_K1_STAMP(3);
    columns_own<true, T>(j, NJ, dw, jt, dof, dq_q, mi_q);
    if constexpr (kCoreOnly)
      store_columns<true, T>(j, NJ, NV, TS, jt, dof, dq_q, &mi_q, ser, Ad,
                             Bd, B, b, live, s);
    REAK_K1_STAMP(4);
  }
  if (run_qd) {
    const int jd = joint_of<NJ, NV>(dof, NV + j);
    if constexpr (kSplit) {
      terms<T>(ch, NJ, jt, xq, xqd, AlongQd<T, true>{jd}, take, dw);
      factor_own<kCoreOnly>(NJ, dw, jt, dof, u, B, b, false, cd);
    } else {
      terms<T>(ch, NJ, jt, xq, xqd, AlongQd<T>{jd}, take, dw);
    }
    REAK_K1_STAMP(5);
    columns_own<false, T>(NV + j, NJ, dw, jt, dof, dq_qd, dq_qd);
    if constexpr (kCoreOnly)
      store_columns<true, T>(NV + j, NJ, NV, TS, jt, dof, dq_qd,
                             static_cast<Regs1<T, NJ>*>(nullptr), ser,
                             Ad, Bd, B, b, live, s);
    REAK_K1_STAMP(6);
  }
  if constexpr (kCoreOnly) {
    REAK_K1_END();
    return;  // K5 ends here, no barrier follows
  }
  __syncthreads();  // every run is done with the anchors
  REAK_K1_STAMP(7);
  if (run_q)
    store_columns<false, T>(j, NJ, NV, TS, jt, dof, dq_q, &mi_q, ser, Ad,
                            Bd, B, b, live, s);
  if (run_qd)
    store_columns<false, T>(NV + j, NJ, NV, TS, jt, dof, dq_qd,
                            static_cast<Regs1<T, NJ>*>(nullptr), ser,
                            Ad, Bd, B, b, live, s);
  REAK_K1_STAMP(8);
  __syncthreads();
  REAK_K1_STAMP(9);

  // ---- its directions' columns of S -------------------------------------
  if (run_q) series_column(j, NV, TS, dw, dt, order, ser, s);
  if (run_qd) series_column(NV + j, NV, TS, dw, dt, order, ser, s);
  REAK_K1_STAMP(10);
  __syncthreads();
  REAK_K1_STAMP(11);

  // ---- its directions' rows of Ad, Bd, x_new, cd ------------------------
  if (has_dir) {
    T xv[N], uv[NV], f0[N];
#pragma unroll
    for (int k = 0; k < N; ++k) xv[k] = x[k * B + b];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      uv[k] = u[k * B + b];
      f0[k] = xv[NV + k];
      T q = T(0);  // q̈ of dof k, from this thread's q̈ by joint
#pragma unroll
      for (int i = 0; i < NJ; ++i)
        if (dof[i] == k) q = dw.qdd[i];
      f0[NV + k] = q;
    }
    if (run_q)
      step_row(j, NV, TS, xv, uv, f0, x, ser, Ad, Bd, cd, xn, B, b, live, s);
    if (run_qd)
      step_row(NV + j, NV, TS, xv, uv, f0, x, ser, Ad, Bd, cd, xn, B, b,
               live, s);
  }
  REAK_K1_STAMP(12);
  REAK_K1_END();
}

// the kernels of the two modes, each with its own launch bounds
template <typename T, int NJ, int NV, bool kCoreOnly>
__global__ void __launch_bounds__(StepShape<T, NJ, NV, kCoreOnly>::NT,
                                  StepShape<T, NJ, NV, kCoreOnly>::MIN_BLOCKS)
    kte_step_kernel(const T* __restrict__ x, const T* __restrict__ u,
                    const __grid_constant__ Chain<T, NJ> ch, double dt,
                    int order, T* __restrict__ Ad, T* __restrict__ Bd,
                    T* __restrict__ cd, T* __restrict__ xn, int B) {
  step_tile<T, NJ, NV, kCoreOnly, false>(x, u, ch, dt, order, Ad, Bd, cd, xn,
                                         B);
}

template <typename T, int NJ, int NV, bool kCoreOnly>
__global__ void __launch_bounds__(
    StepShape<T, NJ, NV, kCoreOnly, true>::NT,
    StepShape<T, NJ, NV, kCoreOnly, true>::MIN_BLOCKS)
    kte_split_kernel(const T* __restrict__ x, const T* __restrict__ u,
                     const __grid_constant__ Chain<T, NJ> ch, double dt,
                     int order, T* __restrict__ Ad, T* __restrict__ Bd,
                     T* __restrict__ cd, T* __restrict__ xn, int B) {
  step_tile<T, NJ, NV, kCoreOnly, true>(x, u, ch, dt, order, Ad, Bd, cd, xn,
                                        B);
}

// the table as the kernel parameter: chain_table's values, in order
template <typename T, int NJ>
inline Chain<T, NJ> chain_of(const void* table) {
  Chain<T, NJ> ch;
  std::memcpy(ch.c, table, sizeof(ch.c));
  return ch;
}

template <typename T, int NJ, int NV, bool kCoreOnly, bool kSplit>
int launch(const void* x, const void* u, const void* table, int nj, int nv,
           double dt, int order, void* Ad, void* Bd, void* cd, void* xn,
           int B, int smem_bytes, void* stream) {
  using Shape = StepShape<T, NJ, NV, kCoreOnly, kSplit>;
  // the wrapper's launch shape (ops/kte_step.py) must be this instance's
  if (nj != NJ || nv != NV || order < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes != Shape::SMEM)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = kSplit ? kte_split_kernel<T, NJ, NV, kCoreOnly>
                       : kte_step_kernel<T, NJ, NV, kCoreOnly>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int grid = (B + Shape::TS - 1) / Shape::TS;
  kernel<<<grid, Shape::NT, Shape::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(u),
      chain_of<T, NJ>(table), dt, order, static_cast<T*>(Ad),
      static_cast<T*>(Bd), static_cast<T*>(cd), static_cast<T*>(xn), B);
  return static_cast<int>(cudaGetLastError());
}

// blocks of the instance an SM holds at once
template <typename T, int NJ, int NV, bool kCoreOnly>
int occupancy(int* blocks) {
  using Shape = StepShape<T, NJ, NV, kCoreOnly>;
  auto kernel = kte_step_kernel<T, NJ, NV, kCoreOnly>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, Shape::NT, Shape::SMEM));
}

// the launch shape this library was built with: TS, NT, SMEM, PRIMAL_SLOT,
// OUTER_SHARED, MIN_BLOCKS (ops/kte_step.py::SHAPE_FIELDS)
template <typename T, int NJ, int NV, bool kCoreOnly, bool kSplit>
int shape_of(int* out) {
  using Shape = StepShape<T, NJ, NV, kCoreOnly, kSplit>;
  const int v[6] = {Shape::TS,          Shape::NT,
                    Shape::SMEM,        Shape::PRIMAL_SLOT,
                    Shape::OUTER_SHARED, Shape::MIN_BLOCKS};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

#ifdef REAK_RUNTIME
// ---- the runtime-width instance ---------------------------------------------
// Every fixed-base chain wider than the compile-time libraries, on the same
// functions: the joints and dofs are arguments, every loop runs at run time
// (no width is unrolled, so the stack stays bounded and the build takes as
// long as one narrow instance), and what the compile-time instances keep in
// registers and shared memory lies in a work area in device memory that the
// wrapper allocates (ops/kte_step.py::launch_shape mirrors its size).  A
// block's area holds its scenarios' rows (the shared rows of the
// compile-time instances: the factor of M, q̈, then the anchors or the
// series; TS values a row) and each (direction, scenario) slot's own
// arrays (DirWork): M above its diagonal and f in Dual numbers, the joints'
// anchors and world axes in hyper-dual numbers, the bodies' Jacobian
// columns in Dual numbers and the right-hand side, solution and series
// vectors; the factor and q̈ are read from the scenario rows.  Blocks walk
// the batch a tile at a time (the grid is capped, so the work area does not
// grow with B), and a thread takes every dy-th direction where TS × n would
// pass the block's threads.

// a chain table in device memory, read as the compile-time instances read
// theirs by value
template <typename T>
struct ChainRows {
  const T* c;
};

// each joint's type (col 0) or dof (col 1, −1 for a FIXED joint)
struct JointCol {
  const int* jinfo;
  int col;
  __device__ int operator[](int i) const { return jinfo[2 * i + col]; }
};

// each joint's q (off = 0) or q̇ (off = nv) of scenario b, 0 where FIXED
template <typename T>
struct JointX {
  const T* x;
  const int* jinfo;
  int off, B, b;
  __device__ T operator[](int i) const {
    return jinfo[2 * i] == FIXED ? T(0) : x[(off + jinfo[2 * i + 1]) * B + b];
  }
};

// row i of a (rows, B) array at scenario b
template <typename T>
struct ScenarioRows {
  const T* p;
  int B, b;
  __device__ T operator[](int i) const { return p[i * B + b]; }
};

// f0 = (q̇, q̈) of scenario b: q̇ from x, q̈ from the scenario rows
template <typename T>
struct F0Rows {
  const T* x;
  const T* qdof;  // the q̈-by-dof rows at this thread's scenario
  int NV, B, b, TS;
  __device__ T operator[](int l) const {
    return l < NV ? x[(NV + l) * B + b] : qdof[(l - NV) * TS];
  }
};

// The runtime launch shape (ops/kte_step.py::launch_shape mirrors it).
struct RtShape {
  int nj, nv, n;      // joints, dofs, directions
  int ts, dy;         // scenarios a tile; direction threads a scenario
  int chol_rows, rows;  // a scenario's rows: the factor, then all of them
  long long dir_values;  // a (direction, scenario) slot's values
  long long block_values;  // a block's work area: rows·TS + slots
};

// blocks a runtime launch takes at most: two an SM of an H100; blocks past
// the batch's tiles are not launched
constexpr int RT_GRID = 264;

inline RtShape rt_shape(int nj, int nv, int size, bool core) {
  RtShape r;
  r.nj = nj;
  r.nv = nv;
  r.n = 2 * nv;
  r.ts = size == 4 ? 32 : 16;
  while (r.ts > 1 && r.ts * r.n > STEP_THREADS) r.ts /= 2;
  r.dy = r.n < STEP_THREADS / r.ts ? r.n : STEP_THREADS / r.ts;
  r.chol_rows = nj * nj + 2 * nj + nv;
  const int fk = 2 * SLOTS * nj;
  const int series = core ? 0 : nv * r.n + nv * nv + r.n * r.n;
  r.rows = r.chol_rows + (fk > series ? fk : series);
  // M (nj (nj + 1) / 2) and f (nj) in Dual numbers, the anchors and axes
  // (3 nj each) in HD, the Jacobian columns (3 nj each) in Dual, the rhs, y
  // and column vectors (nj each) and the series' three (n each)
  r.dir_values = static_cast<long long>(nj) * (nj + 1) + 2 * nj + 24 * nj +
                 12 * nj + 3 * nj + 3 * r.n;
  r.block_values = static_cast<long long>(r.rows) * r.ts +
                   r.dir_values * r.n * r.ts;
  return r;
}

// One (direction, scenario) slot's arrays in the work area, the slots of a
// block side by side (`slots` apart), so a warp's threads touch neighbouring
// addresses; the factor and q̈ are the scenario rows'.
template <typename T>
struct DirWork {
  template <typename X>
  using Joints3 =
      SlotRows<X, std::conditional_t<std::is_same_v<X, Dual<T>>, Dual<T>,
                                     HD<T>>>;
  SlotUpper<Dual<T>> M;
  Slot<Dual<T>> f;
  SlotRows<T> L;
  Slot<T> qdd, rhs, y, col, Scol, term, tmp;
  HD<T>*anc, *axg;  // an HDq direction uses the first 3/4 of each
  Dual<T>*jv, *jw;
  int slots;
  // the slot `slot` of a block's `slots` at `p`; chol: the scenario rows at
  // this thread's scenario
  __device__ DirWork(T* p, int slot, int slots_, int nj, int n, T* chol,
                     int ts)
      : L(chol, nj, ts), slots(slots_) {
    auto dual = [&](int count) {
      Dual<T>* a = reinterpret_cast<Dual<T>*>(p) + slot;
      p += 2LL * count * slots;
      return a;
    };
    auto hd = [&](int count) {
      HD<T>* a = reinterpret_cast<HD<T>*>(p) + slot;
      p += 4LL * count * slots;
      return a;
    };
    auto vec = [&](int count) {
      Slot<T> a{p + slot, slots};
      p += static_cast<long long>(count) * slots;
      return a;
    };
    M = {dual(nj * (nj + 1) / 2), slots, nj};
    f = {dual(nj), slots};
    anc = hd(3 * nj);
    axg = hd(3 * nj);
    jv = dual(3 * nj);
    jw = dual(3 * nj);
    rhs = vec(nj);
    y = vec(nj);
    col = vec(nj);
    Scol = vec(n);
    term = vec(n);
    tmp = vec(n);
    qdd = {chol + (nj * nj + nj) * ts, ts};
  }
  // the anchors and world axes (HD storage) or the Jacobian columns
  template <typename S>
  __device__ S* rows3(int which) const {
    if constexpr (std::is_same_v<S, HD<T>>)
      return which == 0 ? anc : axg;
    else
      return which == 0 ? jv : jw;
  }
};

// kte_step_kernel at run-time widths; jinfo: each joint's type and dof
template <typename T, bool kCoreOnly>
__global__ void __launch_bounds__(STEP_THREADS)
    kte_step_rt_kernel(const T* __restrict__ x, const T* __restrict__ u,
                       const T* __restrict__ table,
                       const int* __restrict__ jinfo, RtShape sh, double dt,
                       int order, T* __restrict__ Ad, T* __restrict__ Bd,
                       T* __restrict__ cd, T* __restrict__ xn, int B,
                       T* __restrict__ work) {
  const int TS = sh.ts, N = sh.n, NV = sh.nv, NJ = sh.nj;
  const ChainRows<T> ch{table};
  const int R_QDOF = NJ * NJ + 2 * NJ;
  const int s = threadIdx.x;
  T* const chol = work + blockIdx.x * sh.block_values;
  T* const fk = chol + sh.chol_rows * TS;
  T* const ser = fk;  // the series' rows, once the anchors are spent
  T* const dirs = chol + static_cast<long long>(sh.rows) * TS;
  const JointCol jt{jinfo, 0}, dof{jinfo, 1};
  auto slot_of = [&](int d) {
    return DirWork<T>(dirs, d * TS + s, N * TS, NJ, N, chol + s, TS);
  };
  auto jd_of = [&](int d) {  // the joint a direction moves
    const int want = d < NV ? d : d - NV;
    int jd = 0;
    for (int i = 0; i < NJ; ++i)
      if (jt[i] != FIXED && dof[i] == want) jd = i;
    return jd;
  };
  const int tiles = (B + TS - 1) / TS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b_raw = tile * TS + s;
    const bool live = b_raw < B;
    const int b = live ? b_raw : B - 1;  // the ragged edge computes, never stores
    const JointX<T> xq{x, jinfo, 0, B, b}, xqd{x, jinfo, NV, B, b};

    // the primal phase, by the thread of the last direction
    if (threadIdx.y == (N - 1) % sh.dy) {
      const KeepPrimal<T, 0> keep{fk, s, TS};
      primal_phase<T>(ch, NJ, jt, xq, xqd, keep);
    }
    __syncthreads();
    const TakePrimal<T, 0> take{fk, s, TS};
    for (int d = threadIdx.y; d < N; d += sh.dy) {
      DirWork<T> dw = slot_of(d);
      if (d < NV)
        terms<T>(ch, NJ, jt, xq, xqd, AlongQ<T>{jd_of(d)}, take, dw);
      else
        terms<T>(ch, NJ, jt, xq, xqd, AlongQd<T>{jd_of(d)}, take, dw);
    }
    if (threadIdx.y == 0) {
      DirWork<T> dw = slot_of(0);
      factor_and_solve<kCoreOnly>(NJ, TS, dw, jt, dof, u, B, b, live, chol,
                                  cd, s);
    }
    __syncthreads();

    // ---- each direction's column of ∂q̈/∂x, and a column of M⁻¹ ----------
    for (int d = threadIdx.y; d < N; d += sh.dy) {
      DirWork<T> dw = slot_of(d);
      dqdd_column<kCoreOnly>(d, NJ, NV, TS, dw, jt, dof, chol, ser, Ad, Bd,
                             B, b, live, s);
    }
    __syncthreads();
    if constexpr (kCoreOnly) continue;  // K5 ends its tile here

    // ---- column d of S ----------------------------------------------------
    for (int d = threadIdx.y; d < N; d += sh.dy) {
      DirWork<T> dw = slot_of(d);
      series_column(d, NV, TS, dw, dt, order, ser, s);
    }
    __syncthreads();

    // ---- row d of Ad = I + A S, Bd = S B, x_new = x + S f0, cd -----------
    const ScenarioRows<T> xv{x, B, b}, uv{u, B, b};
    const F0Rows<T> f0{x, chol + R_QDOF * TS + s, NV, B, b, TS};
    for (int d = threadIdx.y; d < N; d += sh.dy)
      step_row(d, NV, TS, xv, uv, f0, x, ser, Ad, Bd, cd, xn, B, b, live, s);
    __syncthreads();  // the next tile's primal phase reuses the rows
  }
}

// The runtime launch: the wrapper's shape, grid and work area must be what
// rt_shape computes (ops/kte_step.py::launch_shape).
template <typename T, bool kCoreOnly>
int launch_rt(const void* x, const void* u, const void* table,
              const void* jinfo, int nj, int nv, double dt, int order,
              void* Ad, void* Bd, void* cd, void* xn, int B, int ts, int grid,
              void* work, long long work_values, void* stream) {
  if (nj < 1 || nv < 1 || nv > nj || order < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RtShape sh = rt_shape(nj, nv, int(sizeof(T)), kCoreOnly);
  const int tiles = (B + sh.ts - 1) / sh.ts;
  const int want_grid = tiles < RT_GRID ? tiles : RT_GRID;
  if (ts != sh.ts || grid != want_grid ||
      work_values != sh.block_values * grid)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 block(sh.ts, sh.dy);
  kte_step_rt_kernel<T, kCoreOnly>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(u),
          static_cast<const T*>(table), static_cast<const int*>(jinfo), sh,
          dt, order, static_cast<T*>(Ad), static_cast<T*>(Bd),
          static_cast<T*>(cd), static_cast<T*>(xn), B, static_cast<T*>(work));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kCoreOnly>
int occupancy_rt(int threads, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kte_step_rt_kernel<T, kCoreOnly>, threads, 0));
}
#endif  // REAK_RUNTIME

}  // namespace
}  // namespace reak

#if defined(REAK_RUNTIME) && defined(REAK_TYPE) && defined(REAK_SUFFIX)

extern "C" {

// The runtime-width entry points of this library's type (the library
// kte_step@any_<type>): reak_kte_step_any_<type> (K1),
// reak_kte_core_any_<type> (K5) and reak_kte_occupancy_any_<type>.
#define REAK_KTE_ANY_ENTRY(T, SUFFIX)                                        \
  int reak_kte_step_any_##SUFFIX(                                            \
      const void* x, const void* u, const void* table, const void* jinfo,    \
      int nj, int nv, double dt, int order, void* Ad, void* Bd, void* cd,    \
      void* xn, int B, int ts, int grid, void* work, long long work_values,  \
      void* stream) {                                                        \
    return reak::launch_rt<T, false>(x, u, table, jinfo, nj, nv, dt, order,  \
                                     Ad, Bd, cd, xn, B, ts, grid, work,      \
                                     work_values, stream);                   \
  }                                                                          \
  int reak_kte_core_any_##SUFFIX(                                            \
      const void* x, const void* u, const void* table, const void* jinfo,    \
      int nj, int nv, void* qdd, void* dqdd, void* minv, int B, int ts,      \
      int grid, void* work, long long work_values, void* stream) {           \
    return reak::launch_rt<T, true>(x, u, table, jinfo, nj, nv, 0.0, 1,      \
                                    dqdd, minv, qdd, nullptr, B, ts, grid,   \
                                    work, work_values, stream);              \
  }                                                                          \
  int reak_kte_occupancy_any_##SUFFIX(int core, int threads, int* blocks) {  \
    return core ? reak::occupancy_rt<T, true>(threads, blocks)               \
                : reak::occupancy_rt<T, false>(threads, blocks);             \
  }
#define REAK_KTE_ANY_ENTRY_OF(T, SUFFIX) REAK_KTE_ANY_ENTRY(T, SUFFIX)

REAK_KTE_ANY_ENTRY_OF(REAK_TYPE, REAK_SUFFIX)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#else
#if !defined(REAK_NMAX) || !defined(REAK_MMAX) || !defined(REAK_TYPE) || \
    !defined(REAK_SUFFIX)
#error "one chain width and type a library: -DREAK_NMAX (joints) -DREAK_MMAX (dofs) -DREAK_TYPE -DREAK_SUFFIX (ops/_build.py)"
#endif
static_assert(REAK_NMAX >= 1 && REAK_NMAX <= reak::UNROLLED_JOINTS && REAK_MMAX >= 1 &&
                  REAK_MMAX <= REAK_NMAX,
              "a fixed-base chain of 1..16 joints and 1..joints dofs");

extern "C" {

// The entry points of this library's chain width and type:
// reak_kte_step_<NJ>x<NV>_<type> (K1), reak_kte_core_<NJ>x<NV>_<type> (K5),
// their split modes reak_kte_step_split_… and reak_kte_core_split_…,
// reak_kte_occupancy_<NJ>x<NV>_<type> (blocks an SM of K1 or K5) and
// reak_kte_shape_<NJ>x<NV>_<type> (the launch shape of any of the four).
#define REAK_KTE_ENTRY(NJ, NV, T, SUFFIX)                                    \
  int reak_kte_step_##NJ##x##NV##_##SUFFIX(                                  \
      const void* x, const void* u, const void* table, int nj, int nv,       \
      double dt, int order, void* Ad, void* Bd, void* cd, void* xn, int B,   \
      int smem_bytes, void* stream) {                                        \
    return reak::launch<T, NJ, NV, false, false>(                            \
        x, u, table, nj, nv, dt, order, Ad, Bd, cd, xn, B, smem_bytes,       \
        stream);                                                             \
  }                                                                          \
  int reak_kte_core_##NJ##x##NV##_##SUFFIX(                                  \
      const void* x, const void* u, const void* table, int nj, int nv,       \
      void* qdd, void* dqdd, void* minv, int B, int smem_bytes,              \
      void* stream) {                                                        \
    return reak::launch<T, NJ, NV, true, false>(x, u, table, nj, nv, 0.0, 1, \
                                                dqdd, minv, qdd, nullptr, B, \
                                                smem_bytes, stream);         \
  }                                                                          \
  int reak_kte_step_split_##NJ##x##NV##_##SUFFIX(                            \
      const void* x, const void* u, const void* table, int nj, int nv,       \
      double dt, int order, void* Ad, void* Bd, void* cd, void* xn, int B,   \
      int smem_bytes, void* stream) {                                        \
    return reak::launch<T, NJ, NV, false, true>(                             \
        x, u, table, nj, nv, dt, order, Ad, Bd, cd, xn, B, smem_bytes,       \
        stream);                                                             \
  }                                                                          \
  int reak_kte_core_split_##NJ##x##NV##_##SUFFIX(                            \
      const void* x, const void* u, const void* table, int nj, int nv,       \
      void* qdd, void* dqdd, void* minv, int B, int smem_bytes,              \
      void* stream) {                                                        \
    return reak::launch<T, NJ, NV, true, true>(x, u, table, nj, nv, 0.0, 1,  \
                                               dqdd, minv, qdd, nullptr, B,  \
                                               smem_bytes, stream);          \
  }                                                                          \
  int reak_kte_occupancy_##NJ##x##NV##_##SUFFIX(int core, int* blocks) {     \
    return core ? reak::occupancy<T, NJ, NV, true>(blocks)                   \
                : reak::occupancy<T, NJ, NV, false>(blocks);                 \
  }                                                                          \
  int reak_kte_shape_##NJ##x##NV##_##SUFFIX(int core, int split, int* out) { \
    return core ? (split ? reak::shape_of<T, NJ, NV, true, true>(out)        \
                         : reak::shape_of<T, NJ, NV, true, false>(out))      \
                : (split ? reak::shape_of<T, NJ, NV, false, true>(out)       \
                         : reak::shape_of<T, NJ, NV, false, false>(out));    \
  }
#define REAK_KTE_ENTRY_OF(NJ, NV, T, SUFFIX) REAK_KTE_ENTRY(NJ, NV, T, SUFFIX)

REAK_KTE_ENTRY_OF(REAK_NMAX, REAK_MMAX, REAK_TYPE, REAK_SUFFIX)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // REAK_RUNTIME
