// The per-pass kernels of the scan-fused Mehrotra PDIP, one launch per
// horizon pass: the hand-written Hopper port of the Pallas kernels
// reak_tpu/ops/riccati_bwd_pallas.py::make_fused_backward (K4a),
// ::make_vector_backward (K4b) and ::make_forward (K4c).
//
// Lanes layout, scenario last (H stages, state n, input m, B scenarios):
//   K4a  A (H,n,n,B), Bm (H,n,m,B), q (H,n,B), u_eff (H,m,B), D (H,m,B),
//        Q, QN (n,n), R (m,m) → grad (H,m,B), K (H,m,n,B), G (H,m,m,B),
//        k (H,m,B): the cost-gradient adjoint, the Riccati matrix recursion
//        and the affine vector recursion in one reverse pass over the
//        stages, with the carries V (n,n), λ (n), v (n);
//   K4b  A, Bm, rhs (H,m,B), K, G → k (H,m,B): the corrector's vector
//        reverse pass, carry v (n);
//   K4c  A, Bm, K, k, dx0 (n,B) → du (H,m,B), dx (H,n,B): the closed-loop
//        forward pass du = −K dx − k, dx' = A dx + B du, carry dx (n).
//
// What bounds them on the H100: by the card's peaks, bytes.  Each stage of
// a scenario reads A and B (216 values at n = 12, m = 6) and a few vectors
// and writes its gains: in f32 K4a moves 1,440 B per stage and scenario
// against ~14k flops, K4b 1,344 B, K4c 1,248 B, so at H = 256, B = 8192 one
// pass moves 2.6-3.0 GB, 0.8-0.9 ms at 3.35 TB/s.  The stages of a scenario
// form a chain (each needs the carry of the stage before it), so what a
// kernel reaches depends on how it hides the latency along that chain.
//
// Design.  The TPU kernels' grid walks the stages in order and keeps the
// carries in VMEM scratch from one grid step to the next; the blocks of a
// CUDA grid run in no order, so every kernel loops over the stages itself.
// K4a runs the reverse pass of riccati_tile.cuh: a tile of scenarios per
// block, a warp per matrix column, the widths at compile time, V and the
// stage's A and B in shared memory, the next stage copied in by cp.async
// while this one computes (see that header).  It takes q, u_eff and D as
// they come and writes G unfactored.  Its instances: (12, 6) for the
// fixed-base arms and the satellite, (24, 12) for the floating arm's
// tangent, and padded (16, 8) and (24, 12) ones for every other width.
// K4b and K4c keep the first design: one thread per scenario with its
// carries in its own arrays, NMAX, MMAX sizing them, instances (16, 8) and
// (24, 12); K4b factors each G again, as the TPU kernel does, by the
// recurrence of the plain _chol_solve_lanes (d = 1/√s, L_jj = s·d,
// off-diagonals and both substitutions multiply by d), so f64 agrees with
// it to rounding.  Any B >= 1 is taken (the TPU's B % 512 is a tile rule).
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "lanes.cuh"
#include "riccati_tile.cuh"

namespace reak {
namespace {

// G (m×m, row-major in L, lower triangle read) → the Cholesky factor in the
// strict lower triangle of L, inv_d = 1 / its diagonal
template <typename T>
__device__ inline void chol_factor(T* L, T* inv_d, int m) {
  for (int j = 0; j < m; ++j) {
    T s = L[j * m + j];
    for (int kk = 0; kk < j; ++kk) s -= L[j * m + kk] * L[j * m + kk];
    const T dj = T(1) / sqrt(s);
    inv_d[j] = dj;
    L[j * m + j] = s * dj;
    for (int i = j + 1; i < m; ++i) {
      T t = L[i * m + j];
      for (int kk = 0; kk < j; ++kk) t -= L[i * m + kk] * L[j * m + kk];
      L[i * m + j] = t * dj;
    }
  }
}

// out = G⁻¹ rhs from the factor of chol_factor; y is scratch of length m
template <typename T>
__device__ inline void chol_apply(const T* L, const T* inv_d, const T* rhs,
                                  T* y, T* out, int m) {
  for (int i = 0; i < m; ++i) {
    T t = rhs[i];
    for (int kk = 0; kk < i; ++kk) t -= L[i * m + kk] * y[kk];
    y[i] = t * inv_d[i];
  }
  for (int i = m - 1; i >= 0; --i) {
    T t = y[i];
    for (int kk = i + 1; kk < m; ++kk) t -= L[kk * m + i] * out[kk];
    out[i] = t * inv_d[i];
  }
}

// K4a: what the reverse pass of riccati_tile.cuh reads and writes a stage
template <typename T>
struct FusedBackwardIo {
  static constexpr bool kStageCost = false, kStoreG = true,
                        kStoreFactor = false;
  TileArr<const T> q, u, D;
  TileArr<T> grad, K, G, k;
  const TileThread& th;
  __device__ T x_term(int h, int i) const { return q.load(h, i, 0, th); }
  __device__ T u_eff(int h, int i) const { return u.load(h, i, 0, th); }
  __device__ T barrier(int h, int i) const { return D.load(h, i, 0, th); }
  __device__ void store_grad(int h, int i, T v) const {
    grad.store(h, i, 0, th, v);
  }
  __device__ void store_K(int h, int i, int j, T v) const {
    K.store(h, i, j, th, v);
  }
  __device__ void store_G(int h, int i, int j, T v) const {
    G.store(h, i, j, th, v);
  }
  __device__ void store_factor(int, int, int, T) const {}
  __device__ void store_k(int h, int i, T v) const { k.store(h, i, 0, th, v); }
};

// Registers are held to two blocks an SM where two fit its shared memory:
// measured at (12, 6) in f32, 80 registers and a 144 B stack with 24 warps
// an SM beat 168 registers with 12 (3.70 against 4.31 ms at H = 256,
// B = 8192 on an H100 at 700 W; ops/tile_shapes.py).
template <typename T, int NB, int MB, bool EXACT>
__global__ void __launch_bounds__(Tile<T, NB, MB, EXACT>::NT,
                                  Tile<T, NB, MB, EXACT>::BLOCKS_PER_SM)
    fused_backward_kernel(const T* A_, const T* Bm_, const T* q_, const T* u_,
                          const T* D_, const T* Q, const T* QN, const T* R,
                          T* grad_, T* K_, T* G_, T* k_, int H, int n_, int m_,
                          int B_, int vec16_) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  using TL = Tile<T, NB, MB, EXACT>;
  const int n = EXACT ? NB : n_, m = EXACT ? MB : m_;
  const long long B = B_;
  const bool vec16 = vec16_ != 0;
  const TileThread th = tile_thread<TL>();
  const TileSmem<TL, T> sm(tile_smem);
  tile_setup<TL>(sm, Q, QN, R, n, m, th);
  const TileLtv<T> ltv{{A_, n, n, B, B, vec16}, {Bm_, n, m, B, B, vec16}};
  FusedBackwardIo<T> io{{q_, n, 1, B, B, vec16},    {u_, m, 1, B, B, vec16},
                        {D_, m, 1, B, B, vec16},    {grad_, m, 1, B, B, vec16},
                        {K_, m, n, B, B, vec16},    {G_, m, m, B, B, vec16},
                        {k_, m, 1, B, B, vec16},    th};
  reverse_pass<TL>(sm, io, ltv, H, th);
}

// every pointer a multiple of 16 B
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename T, int NB, int MB, bool EXACT>
int launch_fused_backward(const void* A, const void* Bm, const void* q,
                          const void* u, const void* D, const void* Q,
                          const void* QN, const void* R, void* grad, void* K,
                          void* G, void* k, int H, int n, int m, int B,
                          int smem_bytes, void* stream) {
  using TL = Tile<T, NB, MB, EXACT>;
  // the wrapper's launch shape (ops/_tile.py) must be this instance's
  if (smem_bytes != TL::SMEM)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = fused_backward_kernel<T, NB, MB, EXACT>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int vec16 = aligned16({A, Bm}) &&
                    (static_cast<long long>(B) * sizeof(T)) % 16 == 0;
  kernel<<<(B + TL::TS - 1) / TL::TS, TL::NT, TL::SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(q), static_cast<const T*>(u),
      static_cast<const T*>(D), static_cast<const T*>(Q),
      static_cast<const T*>(QN), static_cast<const T*>(R),
      static_cast<T*>(grad), static_cast<T*>(K), static_cast<T*>(G),
      static_cast<T*>(k), H, n, m, B, vec16);
  return static_cast<int>(cudaGetLastError());
}

// K4b
template <typename T, int NMAX, int MMAX>
__global__ void vector_backward_kernel(
    const T* __restrict__ A_, const T* __restrict__ Bm_,
    const T* __restrict__ rhs_, const T* __restrict__ K_,
    const T* __restrict__ G_, T* __restrict__ k_, int H, int n, int m,
    int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Lanes<const T> A{A_, n, n, B}, Bm{Bm_, n, m, B}, rhs{rhs_, m, 1, B},
      Ks{K_, m, n, B}, Gs{G_, m, m, B};
  const Lanes<T> ks{k_, m, 1, B};
  T L[MMAX * MMAX], inv_d[MMAX], y[MMAX], w[MMAX], k[MMAX], v[NMAX],
      vn[NMAX];
  for (int i = 0; i < n; ++i) v[i] = T(0);
  for (int h = H - 1; h >= 0; --h) {
    for (int i = 0; i < m; ++i)
      for (int j = 0; j <= i; ++j) L[i * m + j] = Gs(h, i, j, b);
    chol_factor(L, inv_d, m);
    for (int i = 0; i < m; ++i) {
      T t = T(0);
      for (int kk = 0; kk < n; ++kk) t += Bm(h, kk, i, b) * v[kk];
      w[i] = rhs(h, i, 0, b) + t;
    }
    chol_apply(L, inv_d, w, y, k, m);
    for (int i = 0; i < n; ++i) {
      T av = T(0), kw = T(0);
      for (int kk = 0; kk < n; ++kk) av += A(h, kk, i, b) * v[kk];
      for (int kk = 0; kk < m; ++kk) kw += Ks(h, kk, i, b) * w[kk];
      vn[i] = av - kw;
    }
    for (int i = 0; i < n; ++i) v[i] = vn[i];
    for (int i = 0; i < m; ++i) ks(h, i, 0, b) = k[i];
  }
}

// K4c
template <typename T, int NMAX, int MMAX>
__global__ void forward_kernel(const T* __restrict__ A_,
                               const T* __restrict__ Bm_,
                               const T* __restrict__ K_,
                               const T* __restrict__ k_,
                               const T* __restrict__ dx0,
                               T* __restrict__ du_, T* __restrict__ dx_,
                               int H, int n, int m, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Lanes<const T> A{A_, n, n, B}, Bm{Bm_, n, m, B}, Ks{K_, m, n, B},
      ks{k_, m, 1, B};
  const Lanes<T> du_out{du_, m, 1, B}, dx_out{dx_, n, 1, B};
  T dx[NMAX], x1[NMAX], du[MMAX];
  for (int i = 0; i < n; ++i) dx[i] = dx0[static_cast<long long>(i) * B + b];
  for (int h = 0; h < H; ++h) {
    for (int i = 0; i < m; ++i) {
      T t = T(0);
      for (int j = 0; j < n; ++j) t += Ks(h, i, j, b) * dx[j];
      du[i] = -t - ks(h, i, 0, b);
    }
    for (int i = 0; i < n; ++i) {
      T a = T(0), bb = T(0);
      for (int j = 0; j < n; ++j) a += A(h, i, j, b) * dx[j];
      for (int j = 0; j < m; ++j) bb += Bm(h, i, j, b) * du[j];
      x1[i] = a + bb;
    }
    for (int i = 0; i < m; ++i) du_out(h, i, 0, b) = du[i];
    for (int i = 0; i < n; ++i) {
      dx[i] = x1[i];
      dx_out(h, i, 0, b) = x1[i];
    }
  }
}

constexpr int kThreads = 32;  // one warp per block spreads B=8192 over 256

template <int NMAX, int MMAX>
bool shape_ok(int H, int n, int m, int B) {
  return H >= 1 && n >= 1 && n <= NMAX && m >= 1 && m <= MMAX && B >= 1;
}

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

}  // namespace
}  // namespace reak

#if !defined(REAK_NMAX) || !defined(REAK_MMAX) || !defined(REAK_TYPE) || \
    !defined(REAK_SUFFIX)
#error "one bound and type a library: -DREAK_NMAX -DREAK_MMAX -DREAK_TYPE -DREAK_SUFFIX (ops/_build.py)"
#endif

extern "C" {

// The entry points of this library's bound and type, one per pass:
// reak_riccati_<pass>_<NMAX>x<MMAX>_<type>.  K4a's takes the instance of
// the exact widths where (n, m) are just those, else the padded
// (NMAX, MMAX).
#define REAK_RICCATI_ENTRIES(NM, MM, T, SUFFIX)                               \
  int reak_riccati_fused_backward_##NM##x##MM##_##SUFFIX(                     \
      const void* A, const void* Bm, const void* q, const void* u,            \
      const void* D, const void* Q, const void* QN, const void* R,            \
      void* grad, void* K, void* G, void* k, int H, int n, int m, int B,      \
      int smem_bytes, void* stream) {                                         \
    constexpr int EN = reak::exact_width(NM), EM = reak::exact_width(MM);     \
    if (!reak::shape_ok<NM, MM>(H, n, m, B))                                  \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    if (n == EN && m == EM)                                                   \
      return reak::launch_fused_backward<T, EN, EM, true>(                    \
          A, Bm, q, u, D, Q, QN, R, grad, K, G, k, H, n, m, B, smem_bytes,    \
          stream);                                                            \
    return reak::launch_fused_backward<T, NM, MM, false>(                     \
        A, Bm, q, u, D, Q, QN, R, grad, K, G, k, H, n, m, B, smem_bytes,      \
        stream);                                                              \
  }                                                                           \
  int reak_riccati_vector_backward_##NM##x##MM##_##SUFFIX(                    \
      const void* A, const void* Bm, const void* rhs, const void* K,          \
      const void* G, void* k, int H, int n, int m, int B, void* stream) {     \
    if (!reak::shape_ok<NM, MM>(H, n, m, B))                                  \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    reak::vector_backward_kernel<T, NM, MM>                                   \
        <<<reak::grid_for(B), reak::kThreads, 0,                              \
           static_cast<cudaStream_t>(stream)>>>(                              \
            static_cast<const T*>(A), static_cast<const T*>(Bm),              \
            static_cast<const T*>(rhs), static_cast<const T*>(K),             \
            static_cast<const T*>(G), static_cast<T*>(k), H, n, m, B);        \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  int reak_riccati_forward_##NM##x##MM##_##SUFFIX(                            \
      const void* A, const void* Bm, const void* K, const void* k,            \
      const void* dx0, void* du, void* dx, int H, int n, int m, int B,        \
      void* stream) {                                                         \
    if (!reak::shape_ok<NM, MM>(H, n, m, B))                                  \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    reak::forward_kernel<T, NM, MM>                                           \
        <<<reak::grid_for(B), reak::kThreads, 0,                              \
           static_cast<cudaStream_t>(stream)>>>(                              \
            static_cast<const T*>(A), static_cast<const T*>(Bm),              \
            static_cast<const T*>(K), static_cast<const T*>(k),               \
            static_cast<const T*>(dx0), static_cast<T*>(du),                  \
            static_cast<T*>(dx), H, n, m, B);                                 \
    return static_cast<int>(cudaGetLastError());                              \
  }

#define REAK_RICCATI_ENTRIES_OF(NM, MM, T, SUFFIX) \
  REAK_RICCATI_ENTRIES(NM, MM, T, SUFFIX)

REAK_RICCATI_ENTRIES_OF(REAK_NMAX, REAK_MMAX, REAK_TYPE, REAK_SUFFIX)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
