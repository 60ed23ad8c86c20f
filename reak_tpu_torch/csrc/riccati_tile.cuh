// The Riccati passes of the Mehrotra PDIP on a tile of scenarios per block:
// the code shared by the whole-solve kernel (pdip_whole.cu, the port of
// reak_tpu/ops/pdip_whole_pallas.py::make_whole_pdip) and the per-pass
// kernels (riccati_bwd.cu, the ports of
// reak_tpu/ops/riccati_bwd_pallas.py::make_fused_backward,
// ::make_vector_backward and ::make_forward).
//
// What bounds the passes on the H100: by the card's peaks, bytes (a stage of
// a scenario reads A and B once and does ~14k flops at n = 12, m = 6).  The
// first design (one thread per scenario, widths known at run time) was
// bound by latency instead: two warps per SM, every product loop indexing
// per-thread arrays in local memory and loading A and B from device memory
// on the dependent chain.
//
// Design.  A block takes a tile of TS neighbouring scenarios and NB columns:
// thread (s, j) is scenario s of the tile and column j of the n×n matrices
// (TS = 32 in f32 at n = 12: one warp per column, every row of the
// scenario-last layout one 128 B transaction).  The widths are template
// parameters, so every product loop unrolls and a thread's column of V·A,
// Aᵀ(VA), F and K lives in registers (NB or MB values each, never NB²).
// V, the stage's A_h and B_h, V·B, F and the Schur block sit in shared
// memory, scenario innermost ([i][k][TS]): lane s reads its own scenario,
// so no bank conflicts and no broadcasts.  The stages are streamed: while
// stage h computes, cp.async copies A_{h−1}, B_{h−1} (and, in the vector
// and forward passes, K, the factor or the Schur block and the stage's
// vectors) into a second buffer, 16 B a thread, so each stage is read from
// device memory once a pass and never on the dependent chain.  The m×m
// Schur block is factored once a stage by the threads of the last column,
// in registers, with the recurrence of the plain _chol_solve_lanes
// (d = 1/√s, multiply by d); the n columns of K = G⁻¹F are then solved one
// per column thread.  Columns exchange V·B, F, the factor and the vectors
// through shared memory, five __syncthreads() a reverse stage.
//
// A padded instance (EXACT = false) takes any n ≤ NB, m ≤ MB: loads beyond
// (n, m) give 0 (1 on R's and G's diagonal), which leaves the true block's
// arithmetic unchanged, and stores are predicated.  Scenarios past B (the
// ragged edge) load zeros and store nothing but reach every barrier.
//
// Widths.  Every pass is written once over a width policy W.  The
// compile-time policy is Tile<T, NB, MB, EXACT>: the widths are constants,
// a thread takes one column, its values (a column of V·A, F, K, ...) are
// registers (Regs), and every product loop unrolls.  Past the widest bound
// (32, 16) the runtime policy AnyWidths<T> takes (n, m) as arguments, built
// once a type (pdip_whole@any_<type>, riccati_bwd@any_<type>): a block takes
// TS scenarios × nc column threads, a thread every nc-th column
// (for_cols), NB = max(n, m) (m > n is padded as in the padded instances),
// the loops stay rolled, and a column's values lie in a device-memory work
// area that the wrapper allocates (ColRows, scenario innermost).  The
// block's rows lie in shared memory where they fit at some TS >= 1 (TS
// halved from a 64 B row), else in that work area, where cp.async has no
// target and the stages are copied with plain loads; a grid of at most
// ANY_GRID blocks walks the batch a tile at a time.  The recurrences, their
// order and the barriers are the same; the runtime policy sums float32 data
// in float64 (Acc, rounding once a value): at its widths a sum runs over 33
// or more terms in order, and in float32 K4a's gradient at (33, 17), H = 4,
// lost more than twice the plain version's error (whose reductions sum as a
// tree) on an H100 at 700 W.  ops/_tile.py::tile_config mirrors Tile and
// any_tile.
//
// Tensor cores are not used: each scenario multiplies its own 12×12
// operands, so no operand is shared across the batch for wgmma's 64-row
// tile, and TF32 would break the f32 bar (no more than twice the plain f32
// path's error).  The arithmetic is FFMA/DFMA.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace reak {

// an H100 block's dynamic shared memory
constexpr int MAX_SHARED_BYTES = 232448;

// ts, halved until it is no more than `most`
constexpr int fit_rows(int ts, int most) {
  return ts <= most ? ts : fit_rows(ts / 2, most);
}

// 1 where the streamed arrays can be copied 16 B a thread: every base a
// multiple of 16 B, and so a scenario-last row of B values
template <typename T>
inline int streams16(long long B, std::initializer_list<const void*> bases) {
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return (B * static_cast<long long>(sizeof(T))) % 16 == 0;
}

struct TileThread {
  int tid, s, j;  // thread of the block, scenario of the tile, first column
  long long b;    // scenario of the batch (may lie past its end)
};

// row r of a shared array, this thread's scenario
#define REAK_ROW(p, r) (p)[(r) * TS + s]

// ---- a column thread's values -----------------------------------------------
// Element (i, j) of one of column j's arrays: a register array at
// compile-time widths (a thread has one column, j is not read), rows of the
// device-memory work area at run-time widths.
template <typename X, int N>
struct Regs {
  X v[N];
  template <class W>
  __device__ Regs(const W&, int) {}
  __device__ X& operator()(int i, int) { return v[i]; }
};

template <typename X>
struct ColRows {
  X* p;
  long long row;  // values a row: NB columns × TS scenarios
  int col;        // TS
  template <class W>
  __device__ ColRows(const W& w, int slot)
      : p(w.cols + static_cast<long long>(slot) * w.nb() * w.ts() + w.s),
        row(static_cast<long long>(w.nb()) * w.ts()),
        col(w.ts()) {}
  __device__ X& operator()(int i, int j) const { return p[i * row + j * col]; }
};

// The m×m factor's working values: G's lower triangle and 1 / diag L.  At
// compile-time widths they are registers, loaded from the rows L and stored
// back; at run-time widths the factor runs in place on the rows (the
// diagonal of column c is read before it becomes 1 / diag L).
template <typename X, int MB, int TS>
struct FactorRegs {
  X l_[MB * (MB + 1) / 2], inv_d_[MB];
  template <class W>
  __device__ FactorRegs(const W&, const X* L, int s) {
#pragma unroll
    for (int a = 0; a < MB; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b)
        l_[a * (a + 1) / 2 + b] = REAK_ROW(L, a * MB + b);
  }
  __device__ X& l(int a, int b) { return l_[a * (a + 1) / 2 + b]; }
  __device__ X& inv_d(int c) { return inv_d_[c]; }
  __device__ void store(X* L, int s) {
#pragma unroll
    for (int a = 0; a < MB; ++a) {
#pragma unroll
      for (int b = 0; b < a; ++b) REAK_ROW(L, a * MB + b) = l(a, b);
      REAK_ROW(L, a * MB + a) = inv_d_[a];
    }
  }
};

template <typename X>
struct FactorRows {
  X* L;
  int mb, ts, s;
  template <class W>
  __device__ FactorRows(const W& w, X* L_, int s_)
      : L(L_), mb(w.mb()), ts(w.ts()), s(s_) {}
  __device__ X& l(int a, int b) const { return L[(a * mb + b) * ts + s]; }
  __device__ X& inv_d(int c) const { return l(c, c); }
  __device__ void store(X*, int) const {}
};

// ---- the compile-time policy --------------------------------------------------
// The launch shape of one instance, mirrored by ops/_tile.py: TS scenarios
// × NB columns a block; shared memory in rows of TS values: two A+B stage
// buffers, the work area (V, V·B, F, the Schur block; the other passes put
// their K and factor buffers and the reductions there), the vectors, and
// Q, QN, R once a block.  TS gives 128 B rows up to NB = 12 and 64 B rows
// above, halved while the rows do not fit a block's shared memory (the
// (32, 16) bound: 32 B rows).
template <typename T, int NB_, int MB_, bool EXACT_>
struct Tile {
  static_assert(MB_ <= NB_, "the tile takes m <= n");
  static constexpr int NB = NB_, MB = MB_;
  static constexpr bool EXACT = EXACT_;
  static constexpr int AB_ROWS = NB_ * NB_ + NB_ * MB_;
  static constexpr int WORK_ROWS = NB_ * NB_ + 2 * NB_ * MB_ + MB_ * MB_;
  static constexpr int VEC_ROWS = 4 * NB_ + 4 * MB_;
  static constexpr int ROWS = 2 * AB_ROWS + WORK_ROWS + VEC_ROWS;
  static constexpr int CONSTS = 2 * NB_ * NB_ + MB_ * MB_;
  static constexpr int TS = fit_rows((NB_ <= 12 ? 128 : 64) / int(sizeof(T)),
      (MAX_SHARED_BYTES / int(sizeof(T)) - CONSTS) / ROWS);
  static constexpr int NT = TS * NB_;
  static constexpr int SMEM = int(sizeof(T)) * (ROWS * TS + CONSTS);
  // two blocks an SM where their shared memory (and 1 KB each that the
  // system takes) fits the SM's 228 KB
  static constexpr int BLOCKS_PER_SM = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(SMEM <= MAX_SHARED_BYTES, "over a block's shared memory");
  static_assert(NT <= 1024, "over a block's threads");
  static_assert(TS * int(sizeof(T)) % 16 == 0, "a row is whole 16 B copies");

  // the width policy
  using Acc = T;
  template <typename X, int N>
  using Cols = Regs<X, N>;
  template <typename X>
  using ColN = Regs<X, NB_>;
  template <typename X>
  using ColM = Regs<X, MB_>;
  template <typename X>
  using Factor = FactorRegs<X, MB_, TS>;
  __device__ static constexpr int nb() { return NB_; }
  __device__ static constexpr int mb() { return MB_; }
  __device__ static constexpr int ts() { return TS; }
  __device__ static constexpr int nt() { return NT; }
  __device__ static constexpr bool exact() { return EXACT_; }
  __device__ static constexpr bool shared() { return true; }
  __device__ static constexpr bool copies16() { return true; }
  // the thread's one column
  template <class F>
  __device__ void for_cols(const TileThread& th, F&& f) const {
    f(th.j);
  }
  template <class F>
  __device__ void for_cols_under(const TileThread& th, int end, F&& f) const {
    if (th.j < end) f(th.j);
  }
  __device__ static bool owns(const TileThread& th, int j) { return th.j == j; }
};

// The widths an entry point named by the bound (NMAX, MMAX) runs on an
// instance of their own (ops/_tile.py::EXACT): the bound itself, but (12, 6)
// under (16, 8).
template <int NMAX, int MMAX>
struct ExactWidths {
  static constexpr int N = NMAX, M = MMAX;
};
template <>
struct ExactWidths<16, 8> {
  static constexpr int N = 12, M = 6;
};

template <class TL>
__device__ inline TileThread tile_thread() {
  TileThread th;
  th.tid = threadIdx.x;
  th.s = th.tid % TL::TS;
  th.j = th.tid / TL::TS;
  th.b = static_cast<long long>(blockIdx.x) * TL::TS + th.s;
  return th;
}

// ---- the runtime policy ---------------------------------------------------------
// the accumulator of the runtime policy's sums: float64 for float32 data
template <typename T>
using AnyAcc = std::conditional_t<std::is_same_v<T, float>, double, T>;

// blocks of a runtime-width launch, at most: two an SM of an H100
constexpr int ANY_GRID = 264;
// threads a block, at most
constexpr int ANY_THREADS = 1024;

// The launch shape of the runtime-width instance for (n, m) and a type of
// `size` bytes.  A column's values: its V·A and Q + Aᵀ V A columns (NB
// each), its F, K, w, k, y and V·B rows (MB each), λ, Bᵀv and the next v,
// and its five shares of a reduction, in Acc values.
struct AnyTile {
  int n, m;    // the problem's widths
  int nb, mb;  // columns max(n, m) and inputs m
  int ts;      // scenarios a tile
  int nc, nt;  // column threads a scenario; threads a block (ts · nc)
  int shared;  // 1: the block's rows in shared memory, 0: in device memory
  long long rows, consts;  // rows of ts values; Q, QN, R
  int col_rows;            // a column's own rows of ts Acc values
  long long block_values;  // a block's work area, in values of the type:
                           // its columns' rows, then its rows and
                           // constants where they are in device memory,
                           // rounded up to 16 B
  int smem_bytes;
};

inline AnyTile any_tile(int n, int m, int size) {
  AnyTile t;
  t.n = n;
  t.m = m;
  t.nb = n > m ? n : m;
  t.mb = m;
  const long long nb = t.nb, mb = t.mb;
  t.rows = 2 * (nb * nb + nb * mb) + (nb * nb + 2 * nb * mb + mb * mb) +
           4 * nb + 4 * mb;
  t.consts = 2 * nb * nb + mb * mb;
  int ts = (t.nb <= 12 ? 128 : 64) / size;
  while (ts > 1 && static_cast<long long>(ts) * nb > ANY_THREADS) ts /= 2;
  int fit = ts;
  while (fit > 1 && size * (t.rows * fit + t.consts) > MAX_SHARED_BYTES)
    fit /= 2;
  t.shared = size * (t.rows * fit + t.consts) <= MAX_SHARED_BYTES;
  t.ts = t.shared ? fit : ts;
  t.nc = t.nb < ANY_THREADS / t.ts ? t.nb : ANY_THREADS / t.ts;
  t.nt = t.ts * t.nc;
  t.col_rows = 2 * t.nb + 6 * t.mb + 8;
  t.smem_bytes =
      t.shared ? static_cast<int>(size * (t.rows * t.ts + t.consts)) : 0;
  t.block_values = (static_cast<long long>(t.col_rows) * nb * t.ts *
                        (size == 4 ? 2 : 1) +
                    (t.shared ? 0 : t.rows * t.ts + t.consts) + 16 / size -
                    1) /
                   (16 / size) * (16 / size);
  return t;
}

template <typename T>
struct AnyWidths {
  using Acc = AnyAcc<T>;
  template <typename X, int N>
  using Cols = ColRows<X>;
  template <typename X>
  using ColN = ColRows<X>;
  template <typename X>
  using ColM = ColRows<X>;
  template <typename X>
  using Factor = FactorRows<X>;
  AnyTile tl;
  Acc* cols;  // the block's column rows
  int s;      // this thread's scenario of the tile
  __device__ int nb() const { return tl.nb; }
  __device__ int mb() const { return tl.mb; }
  __device__ int ts() const { return tl.ts; }
  __device__ int nt() const { return tl.nt; }
  __device__ static constexpr bool exact() { return false; }
  __device__ bool shared() const { return tl.shared != 0; }
  // whether rows of TS values can take 16 B copies
  __device__ bool copies16() const {
    return tl.shared && tl.ts * int(sizeof(T)) % 16 == 0;
  }
  // the thread's columns: j, j + nc, ...
  template <class F>
  __device__ void for_cols(const TileThread& th, F&& f) const {
    for (int j = th.j; j < tl.nb; j += tl.nc) f(j);
  }
  template <class F>
  __device__ void for_cols_under(const TileThread& th, int end, F&& f) const {
    for (int j = th.j; j < end; j += tl.nc) f(j);
  }
  __device__ bool owns(const TileThread& th, int j) const {
    return th.j == j % tl.nc;
  }
};

// this thread's place in a tile of the runtime-width instance: scenario s,
// first column j
__device__ inline TileThread any_thread(const AnyTile& tl, int tile) {
  TileThread th;
  th.tid = threadIdx.x;
  th.s = th.tid % tl.ts;
  th.j = th.tid / tl.ts;
  th.b = static_cast<long long>(tile) * tl.ts + th.s;
  return th;
}

// ---- the block's rows ---------------------------------------------------------
template <typename T>
struct TileSmem {
  T* ab[2];  // stage buffers: A [NB][NB][TS] then B [NB][MB][TS]
  T* work;
  T* vec;
  T *Q, *QN, *R;  // [NB][NB], [NB][NB], [MB][MB], padded
  template <class W>
  __device__ TileSmem(const W& w, T* p) {
    const int NB = w.nb(), MB = w.mb(), TS = w.ts();
    const int ab_rows = NB * NB + NB * MB;
    const int work_rows = NB * NB + 2 * NB * MB + MB * MB;
    ab[0] = p;
    ab[1] = p + ab_rows * TS;
    work = p + 2 * ab_rows * TS;
    vec = work + work_rows * TS;
    Q = vec + (4 * NB + 4 * MB) * TS;
    QN = Q + NB * NB;
    R = QN + NB * NB;
  }
};

// ---- asynchronous copies into shared memory --------------------------------

// 16 B, or nothing but zeros where src_bytes = 0
__device__ inline void cp_async_16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one value (4 or 8 B), or zeros where src_bytes = 0
template <int BYTES>
__device__ inline void cp_async_value(void* dst, const void* src,
                                      int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8, "a float or a double");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage h of a per-scenario (H, r, c) array in lanes layout (scenario stride
// `stride`, scenarios < `limit` exist) → dst[(i * CB + k) * TS + s] for the
// tile's scenarios; the others become zeros.  vec16: the base and the
// stride are multiples of 16 B, so a thread copies 16 B at a time where the
// rows take it.  Rows in device memory (the runtime policy's device branch)
// are copied with plain loads and stores.
template <class W, typename T>
__device__ inline void stream_stage(const W& w, T* dst, const T* src, int h,
                                    int r, int c, int CB, long long stride,
                                    long long limit, bool vec16,
                                    const TileThread& th) {
  const int TS = w.ts();
  const long long b0 = th.b - th.s;
  const T* const base = src + static_cast<long long>(h) * r * c * stride;
  if (w.copies16() && vec16) {
    constexpr int VEC = 16 / int(sizeof(T));
    const int CPR = TS / VEC;  // copies a row
    const int items = r * c * CPR;
    for (int it = th.tid; it < items; it += w.nt()) {
      const int row = it / CPR, ch = it - row * CPR;
      const int i = row / c, k = row - i * c;
      const long long b = b0 + ch * VEC;
      const bool in = b < limit;
      cp_async_16(dst + (i * CB + k) * TS + ch * VEC,
                  in ? base + row * stride + b : src, in ? 16 : 0);
    }
  } else {
    const int items = r * c * TS;
    for (int it = th.tid; it < items; it += w.nt()) {
      const int row = it / TS, sc = it - row * TS;
      const int i = row / c, k = row - i * c;
      const long long b = b0 + sc;
      const bool in = b < limit;
      T* const d = dst + (i * CB + k) * TS + sc;
      if (w.shared())
        cp_async_value<int(sizeof(T))>(d, in ? base + row * stride + b : src,
                                       in ? int(sizeof(T)) : 0);
      else
        *d = in ? base[row * stride + b] : T(0);
    }
  }
}

// A per-scenario (H, r, c) array in lanes layout: scenario stride `stride`,
// scenarios < `limit` exist (the batch for an input or an output, the
// padded batch for the whole-solve kernel's scratch).
template <typename T>
struct TileArr {
  T* p;
  int r, c;
  long long stride, limit;
  bool vec16;  // base and stride are multiples of 16 B
  __device__ long long at(int h, int i, int k, const TileThread& th) const {
    return ((static_cast<long long>(h) * r + i) * c + k) * stride + th.b;
  }
  __device__ bool has(int i, int k, const TileThread& th) const {
    return i < r && k < c && th.b < limit;
  }
  // 0 beyond (r, c) and for a scenario that does not exist
  __device__ T load(int h, int i, int k, const TileThread& th) const {
    return has(i, k, th) ? p[at(h, i, k, th)] : T(0);
  }
  template <typename U>
  __device__ void store(int h, int i, int k, const TileThread& th,
                        U value) const {
    if (has(i, k, th)) p[at(h, i, k, th)] = value;
  }
  // the same array, read only
  __device__ TileArr<const T> in() const {
    return {p, r, c, stride, limit, vec16};
  }
};

template <class W, typename T>
__device__ inline void stream_arr(const W& w, std::remove_const_t<T>* dst,
                                  const TileArr<T>& a, int h, int CB,
                                  const TileThread& th) {
  stream_stage(w, dst, static_cast<const std::remove_const_t<T>*>(a.p), h,
               a.r, a.c, CB, a.stride, a.limit, a.vec16, th);
}

// The inputs A (H, n, n, B) and Bm (H, n, m, B) of every pass.
template <typename T>
struct TileLtv {
  TileArr<const T> A, Bm;
};

template <class W, typename T>
__device__ inline void stream_ab(const W& w, T* buf, const TileLtv<T>& ltv,
                                 int h, const TileThread& th) {
  stream_arr(w, buf, ltv.A, h, w.nb(), th);
  stream_arr(w, buf + w.nb() * w.nb() * w.ts(), ltv.Bm, h, w.mb(), th);
}

// A padded instance clears the stage buffers, whose slots beyond (n, m) no
// copy ever writes; a barrier must follow before they are read.
template <class W, typename T>
__device__ inline void tile_clear_stages(const W& w, const TileSmem<T>& sm,
                                         const TileThread& th) {
  if (!w.exact())
    for (int e = th.tid; e < 2 * (w.nb() * w.nb() + w.nb() * w.mb()) * w.ts();
         e += w.nt())
      sm.ab[0][e] = T(0);
}

// Q, QN, R into shared memory, padded to (NB, MB) with zeros (ones on R's
// diagonal, so the padded Schur block stays positive definite), and the
// stage buffers cleared.
template <class W, typename T>
__device__ inline void tile_setup(const W& w, const TileSmem<T>& sm,
                                  const T* Q, const T* QN, const T* R, int n,
                                  int m, const TileThread& th) {
  const int NB = w.nb(), MB = w.mb();
  for (int e = th.tid; e < NB * NB; e += w.nt()) {
    const int i = e / NB, k = e % NB;
    const bool in = i < n && k < n;
    sm.Q[e] = in ? Q[i * n + k] : T(0);
    sm.QN[e] = in ? QN[i * n + k] : T(0);
  }
  for (int e = th.tid; e < MB * MB; e += w.nt()) {
    const int i = e / MB, k = e % MB;
    sm.R[e] = (i < m && k < m) ? R[i * m + k] : (i == k ? T(1) : T(0));
  }
  tile_clear_stages(w, sm, th);
  __syncthreads();
}

// The rows of a column's values in the runtime policy's work area (NB, MB
// or a few rows each; unread at compile-time widths, where they are
// registers).
struct ColSlots {
  int va, vnew, f, kcol, wv, kaff, y, vb, lam, btv, vnext, red;
  __device__ ColSlots(int NB, int MB)
      : va(0),
        vnew(NB),
        f(2 * NB),
        kcol(2 * NB + MB),
        wv(2 * NB + 2 * MB),
        kaff(2 * NB + 3 * MB),
        y(2 * NB + 4 * MB),
        vb(2 * NB + 5 * MB),
        lam(2 * NB + 6 * MB),
        btv(2 * NB + 6 * MB + 1),
        vnext(2 * NB + 6 * MB + 2),
        red(2 * NB + 6 * MB + 3) {}
};

// out = G⁻¹ rhs for this thread's scenario, from the packed factor in shared
// memory (strict lower triangle L, diagonal 1 / diag L); rhs(a) gives a
// value, y(a) and out(a) a place
template <class W, typename T, class Rhs, class Y, class Out>
__device__ inline void tile_chol_apply(const W& w, const T* L, Rhs&& rhs,
                                       Y&& y, Out&& out, int s) {
  using A = typename W::Acc;
  const int MB = w.mb(), TS = w.ts();
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    A t = rhs(i);
#pragma unroll
    for (int k = 0; k < i; ++k) t -= A(REAK_ROW(L, i * MB + k)) * y(k);
    y(i) = T(t) * REAK_ROW(L, i * MB + i);
  }
#pragma unroll
  for (int i = MB - 1; i >= 0; --i) {
    A t = y(i);
#pragma unroll
    for (int k = i + 1; k < MB; ++k)
      t -= A(REAK_ROW(L, k * MB + i)) * out(k);
    out(i) = T(t) * REAK_ROW(L, i * MB + i);
  }
}

// G (lower triangle read) → its packed factor, in place in shared memory,
// by the recurrence of the plain _chol_solve_lanes (d = 1/√s, multiply by d)
template <class W, typename T>
__device__ inline void tile_chol_factor(const W& w, T* L, int s) {
  using A = typename W::Acc;
  const int MB = w.mb();
  typename W::template Factor<T> f(w, L, s);
#pragma unroll
  for (int c = 0; c < MB; ++c) {
    A d = f.l(c, c);
#pragma unroll
    for (int k = 0; k < c; ++k) d -= A(f.l(c, k)) * f.l(c, k);
    const T dc = T(1) / sqrt(T(d));
    f.inv_d(c) = dc;
#pragma unroll
    for (int a = c + 1; a < MB; ++a) {
      A t = f.l(a, c);
#pragma unroll
      for (int k = 0; k < c; ++k) t -= A(f.l(a, k)) * f.l(c, k);
      f.l(a, c) = T(t) * dc;
    }
  }
  f.store(L, s);
}

// The fused reverse pass over the horizon: the cost-gradient adjoint, the
// Riccati matrix recursion and the affine vector recursion, with the
// carries V (shared), λ and v (one element a column).  `Io` gives the
// stage's cost term, input and barrier diagonal and takes its results:
//   kStageCost   x_term is x − x_ref, to be weighted by Q (QN at the last
//                stage); otherwise x_term is the stage cost gradient q itself
//   kStoreG      the Schur block G goes out unfactored (store_G)
//   kStoreFactor the packed factor goes out (store_factor)
template <class W, typename T, class Io>
__device__ inline void reverse_pass(const W& w, const TileSmem<T>& sm, Io& io,
                                    const TileLtv<T>& ltv, int H,
                                    const TileThread& th) {
  using A = typename W::Acc;
  const int NB = w.nb(), MB = w.mb(), TS = w.ts();
  const int s = th.s;
  const ColSlots cs(NB, MB);
  T* const V = sm.work;
  T* const VB = V + NB * NB * TS;
  T* const F = VB + NB * MB * TS;
  T* const L = F + MB * NB * TS;
  T* const ev = sm.vec;
  T* const lamf = ev + NB * TS;
  T* const vv = lamf + NB * TS;
  T* const uv = vv + NB * TS;
  T* const ws = uv + MB * TS;

  __syncthreads();  // the pass before has left the shared arrays
  typename W::template Cols<A, 1> lam(w, cs.lam);
  w.for_cols(th, [&](int j) {
#pragma unroll
    for (int i = 0; i < NB; ++i) REAK_ROW(V, i * NB + j) = sm.QN[i * NB + j];
    REAK_ROW(vv, j) = T(0);
    lam(0, j) = A(0);
  });
  stream_ab(w, sm.ab[(H - 1) & 1], ltv, H - 1, th);
  cp_async_commit();

  for (int h = H - 1; h >= 0; --h) {
    T* const As = sm.ab[h & 1];
    T* const Bs = As + NB * NB * TS;
    const T* const Qm = (h == H - 1) ? sm.QN : sm.Q;
    w.for_cols(th, [&](int j) {
      REAK_ROW(ev, j) = io.x_term(h, j);
      if (j < MB) REAK_ROW(uv, j) = io.u_eff(h, j);
    });
    cp_async_wait_all();
    __syncthreads();  // (1) A_h, B_h, V, v and the stage vectors are there
    if (h > 0) stream_ab(w, sm.ab[(h - 1) & 1], ltv, h - 1, th);
    cp_async_commit();

    typename W::template ColN<A> va(w, cs.va), vnew(w, cs.vnew);
    typename W::template ColM<A> f(w, cs.f), kcol(w, cs.kcol), wv(w, cs.wv),
        y(w, cs.y);
    typename W::template Cols<A, 1> btv(w, cs.btv), vnext(w, cs.vnext);
    // column j of Q + Aᵀ (V A); the factor column does it ahead of its
    // factorization, the others beside it
    auto ava = [&](int j) {
#pragma unroll
      for (int i = 0; i < NB; ++i) vnew(i, j) = A(0);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const A vk = va(k, j);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          vnew(i, j) += A(REAK_ROW(As, k * NB + i)) * vk;
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) vnew(i, j) = sm.Q[i * NB + j] + vnew(i, j);
    };
    // column j of V A, row j of V B
    w.for_cols(th, [&](int j) {
#pragma unroll
      for (int i = 0; i < NB; ++i) va(i, j) = A(0);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const A akj = REAK_ROW(As, k * NB + j);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          va(i, j) += A(REAK_ROW(V, i * NB + k)) * akj;
      }
      {
        typename W::template ColM<A> vb(w, cs.vb);
#pragma unroll
        for (int c = 0; c < MB; ++c) vb(c, j) = A(0);
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const A vjk = REAK_ROW(V, j * NB + k);
#pragma unroll
          for (int c = 0; c < MB; ++c)
            vb(c, j) += vjk * REAK_ROW(Bs, k * MB + c);
        }
#pragma unroll
        for (int c = 0; c < MB; ++c) REAK_ROW(VB, j * MB + c) = T(vb(c, j));
      }
      if (j == NB - 1) ava(j);
    });
    __syncthreads();  // (2) V B is there

    // λ_full = q + λ; column j of F = (V B)ᵀ A; G = R + diag(D) + Bᵀ V B
    w.for_cols(th, [&](int j) {
      A q;
      if (Io::kStageCost) {
        q = A(0);
#pragma unroll
        for (int i = 0; i < NB; ++i) q += A(Qm[j * NB + i]) * REAK_ROW(ev, i);
      } else {
        q = REAK_ROW(ev, j);
      }
      const T lam_full = T(q + lam(0, j));
      REAK_ROW(lamf, j) = lam_full;
#pragma unroll
      for (int a = 0; a < MB; ++a) f(a, j) = A(0);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const A akj = REAK_ROW(As, k * NB + j);
#pragma unroll
        for (int a = 0; a < MB; ++a)
          f(a, j) += A(REAK_ROW(VB, k * MB + a)) * akj;
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) REAK_ROW(F, a * NB + j) = T(f(a, j));
#pragma unroll
      for (int e0 = 0; e0 < MB * MB; e0 += NB) {
        const int e = e0 + j;
        if (e < MB * MB) {
          const int a = e / MB, b = e % MB;
          A t = A(0);
#pragma unroll
          for (int k = 0; k < NB; ++k)
            t += A(REAK_ROW(Bs, k * MB + a)) * REAK_ROW(VB, k * MB + b);
          const T g = (sm.R[e] + (a == b ? io.barrier(h, a) : T(0))) + T(t);
          REAK_ROW(L, e) = g;
          if (Io::kStoreG) io.store_G(h, a, b, g);
        }
      }
      A bv = A(0);  // (Bᵀ v)_j
      if (j < MB) {
#pragma unroll
        for (int k = 0; k < NB; ++k)
          bv += A(REAK_ROW(Bs, k * MB + j)) * REAK_ROW(vv, k);
      }
      btv(0, j) = bv;
    });
    __syncthreads();  // (3) G, F and λ_full are there

    if (w.owns(th, NB - 1)) tile_chol_factor(w, L, s);
    // grad = R u_eff + Bᵀ λ_full; w = grad + Bᵀ v; λ ← Aᵀ λ_full
    w.for_cols(th, [&](int j) {
      if (j < MB) {
        A ru = A(0), bl = A(0);
#pragma unroll
        for (int b = 0; b < MB; ++b)
          ru += A(sm.R[j * MB + b]) * REAK_ROW(uv, b);
#pragma unroll
        for (int k = 0; k < NB; ++k)
          bl += A(REAK_ROW(Bs, k * MB + j)) * REAK_ROW(lamf, k);
        const T g = T(ru + bl);
        io.store_grad(h, j, g);
        REAK_ROW(ws, j) = g + T(btv(0, j));
      }
      A lj = A(0);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        lj += A(REAK_ROW(As, k * NB + j)) * REAK_ROW(lamf, k);
      lam(0, j) = lj;
      if (j != NB - 1) ava(j);
    });
    __syncthreads();  // (4) the factor and w are there

    // column j of K = G⁻¹ F; the last column also solves k = G⁻¹ w
    w.for_cols(th, [&](int j) {
      auto yj = [&](int a) -> A& { return y(a, j); };
      tile_chol_apply(
          w, L, [&](int a) -> A { return f(a, j); }, yj,
          [&](int a) -> A& { return kcol(a, j); }, s);
#pragma unroll
      for (int a = 0; a < MB; ++a) io.store_K(h, a, j, T(kcol(a, j)));
#pragma unroll
      for (int a = 0; a < MB; ++a) wv(a, j) = REAK_ROW(ws, a);
      if (j == NB - 1) {
        typename W::template ColM<A> kaff(w, cs.kaff);
        tile_chol_apply(
            w, L, [&](int a) -> A { return wv(a, j); }, yj,
            [&](int a) -> A& { return kaff(a, j); }, s);
#pragma unroll
        for (int a = 0; a < MB; ++a) io.store_k(h, a, T(kaff(a, j)));
      }
      if (Io::kStoreFactor) {
#pragma unroll
        for (int e0 = 0; e0 < MB * MB; e0 += NB) {
          const int e = e0 + j;
          if (e < MB * MB && e % MB <= e / MB)
            io.store_factor(h, e / MB, e % MB, REAK_ROW(L, e));
        }
      }
      // column j of Q + Aᵀ V A − Fᵀ K into the spent A buffer;
      // v ← Aᵀ v − Kᵀ w
      A av = A(0), kw = A(0);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        av += A(REAK_ROW(As, k * NB + j)) * REAK_ROW(vv, k);
#pragma unroll
      for (int a = 0; a < MB; ++a) kw += kcol(a, j) * wv(a, j);
      vnext(0, j) = T(av - kw);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        A fk = A(0);
#pragma unroll
        for (int a = 0; a < MB; ++a)
          fk += A(REAK_ROW(F, a * NB + i)) * kcol(a, j);
        vnew(i, j) -= fk;
        REAK_ROW(As, i * NB + j) = T(vnew(i, j));
      }
    });
    __syncthreads();  // (5) the unsymmetrized V is there, v has been read

    // V ← ½ (V + Vᵀ), column j
    w.for_cols(th, [&](int j) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
        REAK_ROW(V, i * NB + j) =
            T(T(0.5) * (vnew(i, j) + REAK_ROW(As, j * NB + i)));
      REAK_ROW(vv, j) = T(vnext(0, j));
    });
  }
}

// The other passes of the whole-solve kernel put their streamed K and factor
// stages in the work area: K [MB][NB][TS] twice, then the packed factor
// [MB][MB][TS] twice.
template <class W, typename T>
__device__ inline T* tile_k_buffer(const W& w, const TileSmem<T>& sm,
                                   int buf) {
  return sm.work + buf * (w.mb() * w.nb() * w.ts());
}

template <class W, typename T>
__device__ inline T* tile_factor_buffer(const W& w, const TileSmem<T>& sm,
                                        int buf) {
  return sm.work +
         (2 * w.mb() * w.nb() + buf * w.mb() * w.mb()) * w.ts();
}

// Entering a pass that streams into the work area and the vectors: wait
// until the pass before has left them; a padded instance clears them, since
// no copy writes their slots beyond (n, m).
template <class W, typename T>
__device__ inline void tile_enter(const W& w, const TileSmem<T>& sm,
                                  const TileThread& th) {
  __syncthreads();
  if (!w.exact()) {
    const int NB = w.nb(), MB = w.mb();
    for (int e = th.tid;
         e < ((NB * NB + 2 * NB * MB + MB * MB) + (4 * NB + 4 * MB)) * w.ts();
         e += w.nt())
      sm.work[e] = T(0);
    __syncthreads();
  }
}

// The closed-loop forward pass: du_h = −K_h dx − k_h, dx ← A_h dx + B_h du_h
// from dx_0 = `dx0` (n), or 0 where that is not given.  k (H, m) is read,
// du (H, m) written (the whole-solve kernel hands the same array as both);
// dx goes to `dx_out` (H, n) where that is given.  Column j owns row j of
// du (j < m) and of dx; A, B, K and k are streamed a stage ahead.
template <class W, typename T>
__device__ inline void forward_pass(const W& w, const TileSmem<T>& sm,
                                    const TileLtv<T>& ltv,
                                    const TileArr<const T>& K,
                                    const TileArr<const T>& k,
                                    const TileArr<T>& du,
                                    const TileArr<const T>* dx0,
                                    const TileArr<T>* dx_out, int H,
                                    const TileThread& th) {
  using A = typename W::Acc;
  const int NB = w.nb(), MB = w.mb(), TS = w.ts();
  const int s = th.s;
  T* const dxv = sm.vec;             // [2][NB]
  T* const duv = dxv + 2 * NB * TS;  // [MB]
  T* const kb = duv + MB * TS;       // [2][MB]
  auto stream = [&](int h) {
    const int buf = h & 1;
    stream_ab(w, sm.ab[buf], ltv, h, th);
    stream_arr(w, tile_k_buffer(w, sm, buf), K, h, NB, th);
    stream_arr(w, kb + buf * MB * TS, k, h, 1, th);
    cp_async_commit();
  };
  tile_enter(w, sm, th);
  w.for_cols(th, [&](int j) {
    REAK_ROW(dxv, j) = dx0 != nullptr ? dx0->load(0, j, 0, th) : T(0);
  });
  stream(0);
  for (int h = 0; h < H; ++h) {
    const int cur = h & 1;
    const T* const As = sm.ab[cur];
    const T* const Bs = As + NB * NB * TS;
    const T* const Ks = tile_k_buffer(w, sm, cur);
    const T* const dx = dxv + cur * NB * TS;
    cp_async_wait_all();
    __syncthreads();  // (1) stage h and dx are there
    if (h + 1 < H) stream(h + 1);
    w.for_cols_under(th, MB, [&](int j) {
      A t = A(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        t += A(REAK_ROW(Ks, j * NB + c)) * REAK_ROW(dx, c);
      const T du_j = -T(t) - REAK_ROW(kb, cur * MB + j);
      REAK_ROW(duv, j) = du_j;
      du.store(h, j, 0, th, du_j);
    });
    __syncthreads();  // (2) du is there
    w.for_cols(th, [&](int j) {
      A a = A(0), bb = A(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        a += A(REAK_ROW(As, j * NB + c)) * REAK_ROW(dx, c);
#pragma unroll
      for (int c = 0; c < MB; ++c)
        bb += A(REAK_ROW(Bs, j * MB + c)) * REAK_ROW(duv, c);
      const T x1 = T(a + bb);
      REAK_ROW(dxv, (cur ^ 1) * NB + j) = x1;
      if (dx_out != nullptr) dx_out->store(h, j, 0, th, x1);
    });
  }
}

// The corrector's vector reverse pass on stored gains: w = rhs_h + B_hᵀ v,
// k_h = G_h⁻¹ w, v ← A_hᵀ v − K_hᵀ w.  rhs (H, m) is read, k (H, m) written
// (the whole-solve kernel hands the same array as both).  kFactor: `G`
// holds the Schur blocks unfactored, and the last column factors each in
// shared memory while the columns of w form it (the per-pass kernel, which
// factors G again each stage as the TPU kernel does); else `G` holds the
// packed factors of the reverse pass (strict lower triangle L, diagonal
// 1 / diag L).  Column j owns element j of w (j < m) and of v; the last
// column does the factor and the substitutions, off the chain that carries
// v.
template <class W, bool kFactor, typename T>
__device__ inline void vector_pass(const W& w, const TileSmem<T>& sm,
                                   const TileLtv<T>& ltv,
                                   const TileArr<const T>& K,
                                   const TileArr<const T>& G,
                                   const TileArr<const T>& rhs,
                                   const TileArr<T>& k, int H,
                                   const TileThread& th) {
  using A = typename W::Acc;
  const int NB = w.nb(), MB = w.mb(), TS = w.ts();
  const int s = th.s;
  const ColSlots cs(NB, MB);
  T* const vv = sm.vec;            // [2][NB]
  T* const ws = vv + 2 * NB * TS;  // [MB]
  T* const rb = ws + MB * TS;      // [2][MB]
  auto stream = [&](int h) {
    const int buf = h & 1;
    stream_ab(w, sm.ab[buf], ltv, h, th);
    stream_arr(w, tile_k_buffer(w, sm, buf), K, h, NB, th);
    stream_arr(w, tile_factor_buffer(w, sm, buf), G, h, MB, th);
    stream_arr(w, rb + buf * MB * TS, rhs, h, 1, th);
    cp_async_commit();
  };
  tile_enter(w, sm, th);
  w.for_cols(th,
             [&](int j) { REAK_ROW(vv, ((H - 1) & 1) * NB + j) = T(0); });
  stream(H - 1);
  for (int h = H - 1; h >= 0; --h) {
    const int cur = h & 1;
    const T* const As = sm.ab[cur];
    const T* const Bs = As + NB * NB * TS;
    const T* const Ks = tile_k_buffer(w, sm, cur);
    T* const L = tile_factor_buffer(w, sm, cur);
    const T* const v = vv + cur * NB * TS;
    cp_async_wait_all();
    __syncthreads();  // (1) stage h and v are there
    if (h > 0) stream(h - 1);
    if (kFactor && w.owns(th, NB - 1)) {
      // a padded block's diagonal beyond m is 1, so its factor stays I
      if (!w.exact())
        for (int a = G.r; a < MB; ++a) REAK_ROW(L, a * MB + a) = T(1);
      tile_chol_factor(w, L, s);
    }
    w.for_cols_under(th, MB, [&](int j) {
      A t = A(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        t += A(REAK_ROW(Bs, c * MB + j)) * REAK_ROW(v, c);
      REAK_ROW(ws, j) = REAK_ROW(rb, cur * MB + j) + T(t);
    });
    __syncthreads();  // (2) w and the factor are there
    w.for_cols(th, [&](int j) {
      typename W::template ColM<A> wv(w, cs.wv);
#pragma unroll
      for (int a = 0; a < MB; ++a) wv(a, j) = REAK_ROW(ws, a);
      A av = A(0), kw = A(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        av += A(REAK_ROW(As, c * NB + j)) * REAK_ROW(v, c);
#pragma unroll
      for (int a = 0; a < MB; ++a)
        kw += A(REAK_ROW(Ks, a * NB + j)) * wv(a, j);
      REAK_ROW(vv, (cur ^ 1) * NB + j) = T(av - kw);
      if (j == NB - 1) {
        typename W::template ColM<A> kh(w, cs.kcol), y(w, cs.y);
        tile_chol_apply(
            w, L, [&](int a) -> A { return wv(a, j); },
            [&](int a) -> A& { return y(a, j); },
            [&](int a) -> A& { return kh(a, j); }, s);
#pragma unroll
        for (int a = 0; a < MB; ++a) k.store(h, a, 0, th, T(kh(a, j)));
      }
    });
  }
}

// x_{h+1} = A_h x_h + B_h u_h + c_h from x0 (n, B) into `dst` (H, n); column
// j owns row j.  A, B, c and u are streamed a stage ahead.
template <class W, typename T>
__device__ inline void rollout_pass(const W& w, const TileSmem<T>& sm,
                                    const TileLtv<T>& ltv,
                                    const TileArr<const T>& c,
                                    const TileArr<const T>& x0,
                                    const TileArr<T>& u,
                                    const TileArr<T>& dst, int H,
                                    const TileThread& th) {
  using A = typename W::Acc;
  const int NB = w.nb(), MB = w.mb(), TS = w.ts();
  const int s = th.s;
  T* const xv = sm.vec;            // [2][NB]
  T* const cb = xv + 2 * NB * TS;  // [2][NB]
  T* const ub = cb + 2 * NB * TS;  // [2][MB]
  auto stream = [&](int h) {
    const int buf = h & 1;
    stream_ab(w, sm.ab[buf], ltv, h, th);
    stream_arr(w, cb + buf * NB * TS, c, h, 1, th);
    stream_arr(w, ub + buf * MB * TS, u, h, 1, th);
    cp_async_commit();
  };
  tile_enter(w, sm, th);
  w.for_cols(th, [&](int j) { REAK_ROW(xv, j) = x0.load(0, j, 0, th); });
  stream(0);
  for (int h = 0; h < H; ++h) {
    const int cur = h & 1;
    const T* const As = sm.ab[cur];
    const T* const Bs = As + NB * NB * TS;
    const T* const x = xv + cur * NB * TS;
    cp_async_wait_all();
    __syncthreads();  // stage h and x are there
    if (h + 1 < H) stream(h + 1);
    w.for_cols(th, [&](int j) {
      A a = A(0), bb = A(0);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        a += A(REAK_ROW(As, j * NB + k)) * REAK_ROW(x, k);
#pragma unroll
      for (int k = 0; k < MB; ++k)
        bb += A(REAK_ROW(Bs, j * MB + k)) * REAK_ROW(ub, cur * MB + k);
      const T x1 = T(a + bb) + REAK_ROW(cb, cur * NB + j);
      REAK_ROW(xv, (cur ^ 1) * NB + j) = x1;
      dst.store(h, j, 0, th, x1);
    });
  }
}

// ---- the runtime-width launch -------------------------------------------------
// The runtime policy of one block: the column rows at the head of its work
// area, its rows in shared memory or after them in the area.
template <typename T>
struct AnyBlock {
  AnyTile tl;
  T* area;  // this block's work area
  __device__ AnyBlock(const AnyTile& tl_, T* work)
      : tl(tl_), area(work + blockIdx.x * tl_.block_values) {}
  __device__ AnyWidths<T> widths(int s) const {
    return {tl, reinterpret_cast<AnyAcc<T>*>(area), s};
  }
  __device__ T* rows(unsigned char* smem) const {
    return tl.shared ? reinterpret_cast<T*>(smem)
                     : area + static_cast<long long>(tl.col_rows) * tl.nb *
                                  tl.ts * (sizeof(AnyAcc<T>) / sizeof(T));
  }
};

// The launch of a runtime-width kernel: the wrapper's tile, grid, shared
// memory and work area (ops/_tile.py) must be what any_tile computes.
template <class Kernel, class... Args>
int any_launch(Kernel kernel, const AnyTile& tl, int B, int ts, int grid,
               long long work_count, int smem_bytes, void* stream,
               Args... args) {
  const int tiles = (B + tl.ts - 1) / tl.ts;
  const int want_grid = tiles < ANY_GRID ? tiles : ANY_GRID;
  if (ts != tl.ts || grid != want_grid || smem_bytes != tl.smem_bytes ||
      work_count != tl.block_values * grid)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tl.smem_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, tl.nt, tl.smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace reak
