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

struct TileThread {
  int tid, s, j;  // thread of the block, scenario of the tile, column
  long long b;    // scenario of the batch (may lie past its end)
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

template <class TL, typename T>
struct TileSmem {
  T* ab[2];  // stage buffers: A [NB][NB][TS] then B [NB][MB][TS]
  T* work;
  T* vec;
  T *Q, *QN, *R;  // [NB][NB], [NB][NB], [MB][MB], padded
  __device__ explicit TileSmem(unsigned char* raw) {
    T* p = reinterpret_cast<T*>(raw);
    ab[0] = p;
    ab[1] = p + TL::AB_ROWS * TL::TS;
    work = p + 2 * TL::AB_ROWS * TL::TS;
    vec = work + TL::WORK_ROWS * TL::TS;
    Q = vec + TL::VEC_ROWS * TL::TS;
    QN = Q + TL::NB * TL::NB;
    R = QN + TL::NB * TL::NB;
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
// stride are multiples of 16 B, so a thread copies 16 B at a time.
template <class TL, typename T>
__device__ inline void stream_stage(T* dst, const T* src, int h, int r, int c,
                                    int CB, long long stride, long long limit,
                                    bool vec16, const TileThread& th) {
  constexpr int TS = TL::TS;
  const long long b0 = th.b - th.s;
  const T* const base = src + static_cast<long long>(h) * r * c * stride;
  if (vec16) {
    constexpr int VEC = 16 / int(sizeof(T));
    constexpr int CPR = TS / VEC;  // copies a row
    const int items = r * c * CPR;
    for (int it = th.tid; it < items; it += TL::NT) {
      const int row = it / CPR, ch = it - row * CPR;
      const int i = row / c, k = row - i * c;
      const long long b = b0 + ch * VEC;
      const bool in = b < limit;
      cp_async_16(dst + (i * CB + k) * TS + ch * VEC,
                  in ? base + row * stride + b : src, in ? 16 : 0);
    }
  } else {
    const int items = r * c * TS;
    for (int it = th.tid; it < items; it += TL::NT) {
      const int row = it / TS, sc = it - row * TS;
      const int i = row / c, k = row - i * c;
      const long long b = b0 + sc;
      const bool in = b < limit;
      cp_async_value<int(sizeof(T))>(dst + (i * CB + k) * TS + sc,
                                     in ? base + row * stride + b : src,
                                     in ? int(sizeof(T)) : 0);
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

template <class TL, typename T>
__device__ inline void stream_arr(std::remove_const_t<T>* dst,
                                  const TileArr<T>& a, int h, int CB,
                                  const TileThread& th) {
  stream_stage<TL>(dst, a.p, h, a.r, a.c, CB, a.stride, a.limit, a.vec16, th);
}

// The inputs A (H, n, n, B) and Bm (H, n, m, B) of every pass.
template <typename T>
struct TileLtv {
  TileArr<const T> A, Bm;
};

template <class TL, typename T>
__device__ inline void stream_ab(T* buf, const TileLtv<T>& ltv, int h,
                                 const TileThread& th) {
  stream_arr<TL>(buf, ltv.A, h, TL::NB, th);
  stream_arr<TL>(buf + TL::NB * TL::NB * TL::TS, ltv.Bm, h, TL::MB, th);
}

// A padded instance clears the stage buffers, whose slots beyond (n, m) no
// copy ever writes; a barrier must follow before they are read.
template <class TL, typename T>
__device__ inline void tile_clear_stages(const TileSmem<TL, T>& sm,
                                         const TileThread& th) {
  if (!TL::EXACT)
    for (int e = th.tid; e < 2 * TL::AB_ROWS * TL::TS; e += TL::NT)
      sm.ab[0][e] = T(0);
}

// Q, QN, R into shared memory, padded to (NB, MB) with zeros (ones on R's
// diagonal, so the padded Schur block stays positive definite), and the
// stage buffers cleared.
template <class TL, typename T>
__device__ inline void tile_setup(const TileSmem<TL, T>& sm, const T* Q,
                                  const T* QN, const T* R, int n, int m,
                                  const TileThread& th) {
  constexpr int NB = TL::NB, MB = TL::MB;
  for (int e = th.tid; e < NB * NB; e += TL::NT) {
    const int i = e / NB, k = e % NB;
    const bool in = i < n && k < n;
    sm.Q[e] = in ? Q[i * n + k] : T(0);
    sm.QN[e] = in ? QN[i * n + k] : T(0);
  }
  for (int e = th.tid; e < MB * MB; e += TL::NT) {
    const int i = e / MB, k = e % MB;
    sm.R[e] = (i < m && k < m) ? R[i * m + k] : (i == k ? T(1) : T(0));
  }
  tile_clear_stages<TL>(sm, th);
  __syncthreads();
}

// row r of a shared array, this thread's scenario
#define REAK_ROW(p, r) (p)[(r) * TS + s]

// out = G⁻¹ rhs for this thread's scenario, from the packed factor in shared
// memory (strict lower triangle L, diagonal 1 / diag L)
template <class TL, typename T>
__device__ inline void tile_chol_apply(const T* L, const T (&rhs)[TL::MB],
                                       T (&out)[TL::MB], int s) {
  constexpr int MB = TL::MB, TS = TL::TS;
  T y[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    T t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= REAK_ROW(L, i * MB + k) * y[k];
    y[i] = t * REAK_ROW(L, i * MB + i);
  }
#pragma unroll
  for (int i = MB - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < MB; ++k) t -= REAK_ROW(L, k * MB + i) * out[k];
    out[i] = t * REAK_ROW(L, i * MB + i);
  }
}

// G (lower triangle read) → its packed factor, in place in shared memory;
// the recurrence runs in registers
template <class TL, typename T>
__device__ inline void tile_chol_factor(T* L, int s) {
  constexpr int MB = TL::MB, TS = TL::TS;
  T l[MB * (MB + 1) / 2], inv_d[MB];
#define REAK_TRI(a, b) l[(a) * ((a) + 1) / 2 + (b)]
#pragma unroll
  for (int a = 0; a < MB; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) REAK_TRI(a, b) = REAK_ROW(L, a * MB + b);
#pragma unroll
  for (int c = 0; c < MB; ++c) {
    T d = REAK_TRI(c, c);
#pragma unroll
    for (int k = 0; k < c; ++k) d -= REAK_TRI(c, k) * REAK_TRI(c, k);
    const T dc = T(1) / sqrt(d);
    inv_d[c] = dc;
#pragma unroll
    for (int a = c + 1; a < MB; ++a) {
      T t = REAK_TRI(a, c);
#pragma unroll
      for (int k = 0; k < c; ++k) t -= REAK_TRI(a, k) * REAK_TRI(c, k);
      REAK_TRI(a, c) = t * dc;
    }
  }
#pragma unroll
  for (int a = 0; a < MB; ++a) {
#pragma unroll
    for (int b = 0; b < a; ++b) REAK_ROW(L, a * MB + b) = REAK_TRI(a, b);
    REAK_ROW(L, a * MB + a) = inv_d[a];
  }
#undef REAK_TRI
}

// The fused reverse pass over the horizon: the cost-gradient adjoint, the
// Riccati matrix recursion and the affine vector recursion, with the
// carries V (shared), λ and v (one element a column thread).  `Io` gives
// the stage's cost term, input and barrier diagonal and takes its results:
//   kStageCost   x_term is x − x_ref, to be weighted by Q (QN at the last
//                stage); otherwise x_term is the stage cost gradient q itself
//   kStoreG      the Schur block G goes out unfactored (store_G)
//   kStoreFactor the packed factor goes out (store_factor)
template <class TL, typename T, class Io>
__device__ inline void reverse_pass(const TileSmem<TL, T>& sm, Io& io,
                                    const TileLtv<T>& ltv, int H,
                                    const TileThread& th) {
  constexpr int NB = TL::NB, MB = TL::MB, TS = TL::TS;
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
  const bool factor_column = j == NB - 1;

  __syncthreads();  // the pass before has left the shared arrays
#pragma unroll
  for (int i = 0; i < NB; ++i) REAK_ROW(V, i * NB + j) = sm.QN[i * NB + j];
  REAK_ROW(vv, j) = T(0);
  T lam = T(0);
  stream_ab<TL>(sm.ab[(H - 1) & 1], ltv, H - 1, th);
  cp_async_commit();

  for (int h = H - 1; h >= 0; --h) {
    T* const As = sm.ab[h & 1];
    T* const Bs = As + NB * NB * TS;
    const T* const Qm = (h == H - 1) ? sm.QN : sm.Q;
    REAK_ROW(ev, j) = io.x_term(h, j);
    if (j < MB) REAK_ROW(uv, j) = io.u_eff(h, j);
    cp_async_wait_all();
    __syncthreads();  // (1) A_h, B_h, V, v and the stage vectors are there
    if (h > 0) stream_ab<TL>(sm.ab[(h - 1) & 1], ltv, h - 1, th);
    cp_async_commit();

    // column j of V A, row j of V B
    T va[NB], vnew[NB];
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
    // column j of Q + Aᵀ (V A); the factor column does it here, ahead of
    // its factorization, the others beside it
    auto ava = [&]() {
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
    if (factor_column) ava();
    __syncthreads();  // (2) V B is there

    // λ_full = q + λ; column j of F = (V B)ᵀ A; G = R + diag(D) + Bᵀ V B
    T q;
    if (Io::kStageCost) {
      q = T(0);
#pragma unroll
      for (int i = 0; i < NB; ++i) q += Qm[j * NB + i] * REAK_ROW(ev, i);
    } else {
      q = REAK_ROW(ev, j);
    }
    const T lam_full = q + lam;
    REAK_ROW(lamf, j) = lam_full;
    T f[MB];
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
        const T g = (sm.R[e] + (a == b ? io.barrier(h, a) : T(0))) + t;
        REAK_ROW(L, e) = g;
        if (Io::kStoreG) io.store_G(h, a, b, g);
      }
    }
    T btv = T(0);  // (Bᵀ v)_j
    if (j < MB) {
#pragma unroll
      for (int k = 0; k < NB; ++k)
        btv += REAK_ROW(Bs, k * MB + j) * REAK_ROW(vv, k);
    }
    __syncthreads();  // (3) G, F and λ_full are there

    if (factor_column) tile_chol_factor<TL>(L, s);
    // grad = R u_eff + Bᵀ λ_full; w = grad + Bᵀ v; λ ← Aᵀ λ_full
    if (j < MB) {
      T ru = T(0), bl = T(0);
#pragma unroll
      for (int b = 0; b < MB; ++b) ru += sm.R[j * MB + b] * REAK_ROW(uv, b);
#pragma unroll
      for (int k = 0; k < NB; ++k)
        bl += REAK_ROW(Bs, k * MB + j) * REAK_ROW(lamf, k);
      const T g = ru + bl;
      io.store_grad(h, j, g);
      REAK_ROW(ws, j) = g + btv;
    }
    lam = T(0);
#pragma unroll
    for (int k = 0; k < NB; ++k)
      lam += REAK_ROW(As, k * NB + j) * REAK_ROW(lamf, k);
    if (!factor_column) ava();
    __syncthreads();  // (4) the factor and w are there

    // column j of K = G⁻¹ F; the last column also solves k = G⁻¹ w
    T kcol[MB];
    tile_chol_apply<TL>(L, f, kcol, s);
#pragma unroll
    for (int a = 0; a < MB; ++a) io.store_K(h, a, j, kcol[a]);
    T w[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) w[a] = REAK_ROW(ws, a);
    if (factor_column) {
      T kaff[MB];
      tile_chol_apply<TL>(L, w, kaff, s);
#pragma unroll
      for (int a = 0; a < MB; ++a) io.store_k(h, a, kaff[a]);
    }
    if (Io::kStoreFactor) {
#pragma unroll
      for (int e0 = 0; e0 < MB * MB; e0 += NB) {
        const int e = e0 + j;
        if (e < MB * MB && e % MB <= e / MB)
          io.store_factor(h, e / MB, e % MB, REAK_ROW(L, e));
      }
    }
    // column j of Q + Aᵀ V A − Fᵀ K into the spent A buffer; v ← Aᵀ v − Kᵀ w
    T av = T(0), kw = T(0);
#pragma unroll
    for (int k = 0; k < NB; ++k)
      av += REAK_ROW(As, k * NB + j) * REAK_ROW(vv, k);
#pragma unroll
    for (int a = 0; a < MB; ++a) kw += kcol[a] * w[a];
    const T v_next = av - kw;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T fk = T(0);
#pragma unroll
      for (int a = 0; a < MB; ++a) fk += REAK_ROW(F, a * NB + i) * kcol[a];
      vnew[i] -= fk;
      REAK_ROW(As, i * NB + j) = vnew[i];
    }
    __syncthreads();  // (5) the unsymmetrized V is there, v has been read

    // V ← ½ (V + Vᵀ), column j
#pragma unroll
    for (int i = 0; i < NB; ++i)
      REAK_ROW(V, i * NB + j) =
          T(0.5) * (vnew[i] + REAK_ROW(As, j * NB + i));
    REAK_ROW(vv, j) = v_next;
  }
}

// The other passes of the whole-solve kernel put their streamed K and factor
// stages in the work area: K [MB][NB][TS] twice, then the packed factor
// [MB][MB][TS] twice.
template <class TL, typename T>
__device__ inline T* tile_k_buffer(const TileSmem<TL, T>& sm, int buf) {
  return sm.work + buf * (TL::MB * TL::NB * TL::TS);
}

template <class TL, typename T>
__device__ inline T* tile_factor_buffer(const TileSmem<TL, T>& sm, int buf) {
  return sm.work + (2 * TL::MB * TL::NB + buf * TL::MB * TL::MB) * TL::TS;
}

// Entering a pass that streams into the work area and the vectors: wait
// until the pass before has left them; a padded instance clears them, since
// no copy writes their slots beyond (n, m).
template <class TL, typename T>
__device__ inline void tile_enter(const TileSmem<TL, T>& sm,
                                  const TileThread& th) {
  __syncthreads();
  if (!TL::EXACT) {
    for (int e = th.tid; e < (TL::WORK_ROWS + TL::VEC_ROWS) * TL::TS;
         e += TL::NT)
      sm.work[e] = T(0);
    __syncthreads();
  }
}

// The closed-loop forward pass: du_h = −K_h dx − k_h, dx ← A_h dx + B_h du_h
// from dx_0 = `dx0` (n), or 0 where that is not given.  k (H, m) is read,
// du (H, m) written (the whole-solve kernel hands the same array as both);
// dx goes to `dx_out` (H, n) where that is given.  Thread j owns row j of
// du (j < m) and of dx; A, B, K and k are streamed a stage ahead.
template <class TL, typename T>
__device__ inline void forward_pass(const TileSmem<TL, T>& sm,
                                    const TileLtv<T>& ltv,
                                    const TileArr<const T>& K,
                                    const TileArr<const T>& k,
                                    const TileArr<T>& du,
                                    const TileArr<const T>* dx0,
                                    const TileArr<T>* dx_out, int H,
                                    const TileThread& th) {
  constexpr int NB = TL::NB, MB = TL::MB, TS = TL::TS;
  const int s = th.s, j = th.j;
  T* const dxv = sm.vec;             // [2][NB]
  T* const duv = dxv + 2 * NB * TS;  // [MB]
  T* const kb = duv + MB * TS;       // [2][MB]
  auto stream = [&](int h) {
    const int buf = h & 1;
    stream_ab<TL>(sm.ab[buf], ltv, h, th);
    stream_arr<TL>(tile_k_buffer(sm, buf), K, h, NB, th);
    stream_arr<TL>(kb + buf * MB * TS, k, h, 1, th);
    cp_async_commit();
  };
  tile_enter<TL>(sm, th);
  REAK_ROW(dxv, j) = dx0 != nullptr ? dx0->load(0, j, 0, th) : T(0);
  stream(0);
  for (int h = 0; h < H; ++h) {
    const int cur = h & 1;
    const T* const As = sm.ab[cur];
    const T* const Bs = As + NB * NB * TS;
    const T* const Ks = tile_k_buffer(sm, cur);
    const T* const dx = dxv + cur * NB * TS;
    cp_async_wait_all();
    __syncthreads();  // (1) stage h and dx are there
    if (h + 1 < H) stream(h + 1);
    if (j < MB) {
      T t = T(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        t += REAK_ROW(Ks, j * NB + c) * REAK_ROW(dx, c);
      const T du_j = -t - REAK_ROW(kb, cur * MB + j);
      REAK_ROW(duv, j) = du_j;
      du.store(h, j, 0, th, du_j);
    }
    __syncthreads();  // (2) du is there
    T a = T(0), bb = T(0);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      a += REAK_ROW(As, j * NB + c) * REAK_ROW(dx, c);
#pragma unroll
    for (int c = 0; c < MB; ++c)
      bb += REAK_ROW(Bs, j * MB + c) * REAK_ROW(duv, c);
    const T x1 = a + bb;
    REAK_ROW(dxv, (cur ^ 1) * NB + j) = x1;
    if (dx_out != nullptr) dx_out->store(h, j, 0, th, x1);
  }
}

// The corrector's vector reverse pass on stored gains: w = rhs_h + B_hᵀ v,
// k_h = G_h⁻¹ w, v ← A_hᵀ v − K_hᵀ w.  rhs (H, m) is read, k (H, m) written
// (the whole-solve kernel hands the same array as both).  kFactor: `G`
// holds the Schur blocks unfactored, and the last column factors each in
// shared memory while the columns of w form it (the per-pass kernel, which
// factors G again each stage as the TPU kernel does); else `G` holds the
// packed factors of the reverse pass (strict lower triangle L, diagonal
// 1 / diag L).  Thread j owns element j of w (j < m) and of v; the last
// column does the factor and the substitutions, off the chain that carries
// v.
template <class TL, bool kFactor, typename T>
__device__ inline void vector_pass(const TileSmem<TL, T>& sm,
                                   const TileLtv<T>& ltv,
                                   const TileArr<const T>& K,
                                   const TileArr<const T>& G,
                                   const TileArr<const T>& rhs,
                                   const TileArr<T>& k, int H,
                                   const TileThread& th) {
  constexpr int NB = TL::NB, MB = TL::MB, TS = TL::TS;
  const int s = th.s, j = th.j;
  const bool factor_column = j == NB - 1;
  T* const vv = sm.vec;            // [2][NB]
  T* const ws = vv + 2 * NB * TS;  // [MB]
  T* const rb = ws + MB * TS;      // [2][MB]
  auto stream = [&](int h) {
    const int buf = h & 1;
    stream_ab<TL>(sm.ab[buf], ltv, h, th);
    stream_arr<TL>(tile_k_buffer(sm, buf), K, h, NB, th);
    stream_arr<TL>(tile_factor_buffer(sm, buf), G, h, MB, th);
    stream_arr<TL>(rb + buf * MB * TS, rhs, h, 1, th);
    cp_async_commit();
  };
  tile_enter<TL>(sm, th);
  REAK_ROW(vv, ((H - 1) & 1) * NB + j) = T(0);
  stream(H - 1);
  for (int h = H - 1; h >= 0; --h) {
    const int cur = h & 1;
    const T* const As = sm.ab[cur];
    const T* const Bs = As + NB * NB * TS;
    const T* const Ks = tile_k_buffer(sm, cur);
    T* const L = tile_factor_buffer(sm, cur);
    const T* const v = vv + cur * NB * TS;
    cp_async_wait_all();
    __syncthreads();  // (1) stage h and v are there
    if (h > 0) stream(h - 1);
    if (kFactor && factor_column) {
      // a padded block's diagonal beyond m is 1, so its factor stays I
      if (!TL::EXACT)
        for (int a = G.r; a < MB; ++a) REAK_ROW(L, a * MB + a) = T(1);
      tile_chol_factor<TL>(L, s);
    }
    if (j < MB) {
      T t = T(0);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        t += REAK_ROW(Bs, c * MB + j) * REAK_ROW(v, c);
      REAK_ROW(ws, j) = REAK_ROW(rb, cur * MB + j) + t;
    }
    __syncthreads();  // (2) w and the factor are there
    T w[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) w[a] = REAK_ROW(ws, a);
    T av = T(0), kw = T(0);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      av += REAK_ROW(As, c * NB + j) * REAK_ROW(v, c);
#pragma unroll
    for (int a = 0; a < MB; ++a) kw += REAK_ROW(Ks, a * NB + j) * w[a];
    REAK_ROW(vv, (cur ^ 1) * NB + j) = av - kw;
    if (factor_column) {
      T kh[MB];
      tile_chol_apply<TL>(L, w, kh, s);
#pragma unroll
      for (int a = 0; a < MB; ++a) k.store(h, a, 0, th, kh[a]);
    }
  }
}

// x_{h+1} = A_h x_h + B_h u_h + c_h from x0 (n, B) into `dst` (H, n); thread
// j owns row j.  A, B, c and u are streamed a stage ahead.
template <class TL, typename T>
__device__ inline void rollout_pass(const TileSmem<TL, T>& sm,
                                    const TileLtv<T>& ltv,
                                    const TileArr<const T>& c,
                                    const TileArr<const T>& x0,
                                    const TileArr<T>& u,
                                    const TileArr<T>& dst, int H,
                                    const TileThread& th) {
  constexpr int NB = TL::NB, MB = TL::MB, TS = TL::TS;
  const int s = th.s, j = th.j;
  T* const xv = sm.vec;            // [2][NB]
  T* const cb = xv + 2 * NB * TS;  // [2][NB]
  T* const ub = cb + 2 * NB * TS;  // [2][MB]
  auto stream = [&](int h) {
    const int buf = h & 1;
    stream_ab<TL>(sm.ab[buf], ltv, h, th);
    stream_arr<TL>(cb + buf * NB * TS, c, h, 1, th);
    stream_arr<TL>(ub + buf * MB * TS, u, h, 1, th);
    cp_async_commit();
  };
  tile_enter<TL>(sm, th);
  REAK_ROW(xv, j) = x0.load(0, j, 0, th);
  stream(0);
  for (int h = 0; h < H; ++h) {
    const int cur = h & 1;
    const T* const As = sm.ab[cur];
    const T* const Bs = As + NB * NB * TS;
    const T* const x = xv + cur * NB * TS;
    cp_async_wait_all();
    __syncthreads();  // stage h and x are there
    if (h + 1 < H) stream(h + 1);
    T a = T(0), bb = T(0);
#pragma unroll
    for (int k = 0; k < NB; ++k)
      a += REAK_ROW(As, j * NB + k) * REAK_ROW(x, k);
#pragma unroll
    for (int k = 0; k < MB; ++k)
      bb += REAK_ROW(Bs, j * MB + k) * REAK_ROW(ub, cur * MB + k);
    const T x1 = a + bb + REAK_ROW(cb, cur * NB + j);
    REAK_ROW(xv, (cur ^ 1) * NB + j) = x1;
    dst.store(h, j, 0, th, x1);
  }
}

}  // namespace reak
