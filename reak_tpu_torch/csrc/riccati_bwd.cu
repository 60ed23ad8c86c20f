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
// What bounds it on the H100: by the card's peaks, bytes.  Each stage of a
// scenario reads A and B (216 values at n = 12, m = 6) and a few vectors and
// writes its gains: in f32 K4a moves 1,440 B per stage and scenario against
// ~14k flops, K4b 1,344 B, K4c 1,248 B, so at H = 256, B = 8192 one pass
// moves 2.6-3.0 GB, 0.8-0.9 ms at 3.35 TB/s.  In this first design,
// latency: the stages of a scenario form a chain (each needs the carry of
// the stage before it), so the parallelism is the batch — one thread per
// scenario, about two warps per SM at B = 8192, far too few to hide the
// latency of the loads and of the dependent multiply-adds.
//
// Design: the TPU kernel's grid walks the stages in order and keeps the
// carries in VMEM scratch from one grid step to the next; the blocks of a
// CUDA grid run in no order, so each thread loops over the stages itself
// and keeps its carries in its own arrays (registers, spilling V, V·A, V·B,
// F and K to L1-cached local memory at n = 12).  Neighbouring threads take
// neighbouring scenarios, so every load and store of the scenario-last
// layout coalesces.  The Schur blocks G are factored by the recurrence of
// the plain _chol_solve_lanes (d = 1/√s, L_jj = s·d, off-diagonals and both
// substitutions multiply by d), so f64 agrees with it to rounding; K4b
// factors each G again, as the TPU kernel does, rather than storing the
// factor.  NMAX, MMAX size the per-thread arrays; the instances are the
// whole-solve kernel's, (16, 8) and (24, 12).  Any B >= 1 is taken (the
// TPU's B % 512 is a tile rule): the ragged edge returns.
#include <cuda_runtime.h>

#include "lanes.cuh"

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

// K4a
template <typename T, int NMAX, int MMAX>
__global__ void fused_backward_kernel(
    const T* __restrict__ A_, const T* __restrict__ Bm_,
    const T* __restrict__ q_, const T* __restrict__ u_,
    const T* __restrict__ D_, const T* __restrict__ Q,
    const T* __restrict__ QN, const T* __restrict__ R,
    T* __restrict__ grad_, T* __restrict__ K_, T* __restrict__ G_,
    T* __restrict__ k_, int H, int n, int m, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // the ragged edge: scenarios are independent
  const Lanes<const T> A{A_, n, n, B}, Bm{Bm_, n, m, B}, q{q_, n, 1, B},
      u{u_, m, 1, B}, D{D_, m, 1, B};
  const Lanes<T> grad{grad_, m, 1, B}, Ks{K_, m, n, B}, Gs{G_, m, m, B},
      ks{k_, m, 1, B};
  T V[NMAX * NMAX], VA[NMAX * NMAX], VB[NMAX * MMAX], F[MMAX * NMAX],
      K[MMAX * NMAX], L[MMAX * MMAX], inv_d[MMAX], y[MMAX];
  T lam[NMAX], lam_full[NMAX], v[NMAX], vn[NMAX], g[MMAX], w[MMAX], k[MMAX];
  for (int i = 0; i < n; ++i) {
    lam[i] = T(0);
    v[i] = T(0);
    for (int j = 0; j < n; ++j) V[i * n + j] = QN[i * n + j];
  }
  for (int h = H - 1; h >= 0; --h) {
    // grad_t = R u_eff + Bᵀ (q_t + λ)
    for (int i = 0; i < n; ++i) lam_full[i] = q(h, i, 0, b) + lam[i];
    for (int i = 0; i < m; ++i) {
      T ru = T(0), bl = T(0);
      for (int j = 0; j < m; ++j) ru += R[i * m + j] * u(h, j, 0, b);
      for (int kk = 0; kk < n; ++kk) bl += Bm(h, kk, i, b) * lam_full[kk];
      g[i] = ru + bl;
    }
    // VB = V B, VA = V A, G = R + diag(D) + Bᵀ V B, F = (V B)ᵀ A
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < m; ++j) {
        T t = T(0);
        for (int kk = 0; kk < n; ++kk) t += V[i * n + kk] * Bm(h, kk, j, b);
        VB[i * m + j] = t;
      }
      for (int j = 0; j < n; ++j) {
        T t = T(0);
        for (int kk = 0; kk < n; ++kk) t += V[i * n + kk] * A(h, kk, j, b);
        VA[i * n + j] = t;
      }
    }
    for (int i = 0; i < m; ++i) {
      const T Dt = D(h, i, 0, b);
      for (int j = 0; j < m; ++j) {
        T t = T(0);
        for (int kk = 0; kk < n; ++kk) t += Bm(h, kk, i, b) * VB[kk * m + j];
        L[i * m + j] = (R[i * m + j] + (i == j ? Dt : T(0))) + t;
        Gs(h, i, j, b) = L[i * m + j];
      }
      for (int j = 0; j < n; ++j) {
        T t = T(0);
        for (int kk = 0; kk < n; ++kk) t += VB[kk * m + i] * A(h, kk, j, b);
        F[i * n + j] = t;
      }
    }
    // K = G⁻¹ F column by column; k = G⁻¹ (grad + Bᵀ v)
    chol_factor(L, inv_d, m);
    for (int j = 0; j < n; ++j) {
      T fc[MMAX], kc[MMAX];
      for (int i = 0; i < m; ++i) fc[i] = F[i * n + j];
      chol_apply(L, inv_d, fc, y, kc, m);
      for (int i = 0; i < m; ++i) K[i * n + j] = kc[i];
    }
    for (int i = 0; i < m; ++i) {
      T t = T(0);
      for (int kk = 0; kk < n; ++kk) t += Bm(h, kk, i, b) * v[kk];
      w[i] = g[i] + t;
    }
    chol_apply(L, inv_d, w, y, k, m);
    // V ← sym(Q + Aᵀ V A − Fᵀ K); v ← Aᵀ v − Kᵀ w; λ ← Aᵀ λ_full
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        T a = T(0), fk = T(0);
        for (int kk = 0; kk < n; ++kk) a += A(h, kk, i, b) * VA[kk * n + j];
        for (int kk = 0; kk < m; ++kk) fk += F[kk * n + i] * K[kk * n + j];
        V[i * n + j] = Q[i * n + j] + a - fk;
      }
    }
    for (int i = 0; i < n; ++i) {
      for (int j = i + 1; j < n; ++j) {
        const T sym = T(0.5) * (V[i * n + j] + V[j * n + i]);
        V[i * n + j] = sym;
        V[j * n + i] = sym;
      }
    }
    for (int i = 0; i < n; ++i) {
      T av = T(0), kw = T(0), al = T(0);
      for (int kk = 0; kk < n; ++kk) {
        av += A(h, kk, i, b) * v[kk];
        al += A(h, kk, i, b) * lam_full[kk];
      }
      for (int kk = 0; kk < m; ++kk) kw += K[kk * n + i] * w[kk];
      vn[i] = av - kw;
      lam[i] = al;
    }
    for (int i = 0; i < n; ++i) v[i] = vn[i];
    for (int i = 0; i < m; ++i) {
      for (int j = 0; j < n; ++j) Ks(h, i, j, b) = K[i * n + j];
      grad(h, i, 0, b) = g[i];
      ks(h, i, 0, b) = k[i];
    }
  }
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

extern "C" {

// One entry point per (pass, bound, type):
// reak_riccati_<pass>_<NMAX>x<MMAX>_<type>.
#define REAK_RICCATI_ENTRIES(NM, MM, T, SUFFIX)                               \
  int reak_riccati_fused_backward_##NM##x##MM##_##SUFFIX(                     \
      const void* A, const void* Bm, const void* q, const void* u,            \
      const void* D, const void* Q, const void* QN, const void* R,            \
      void* grad, void* K, void* G, void* k, int H, int n, int m, int B,      \
      void* stream) {                                                         \
    if (!reak::shape_ok<NM, MM>(H, n, m, B))                                  \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    reak::fused_backward_kernel<T, NM, MM>                                    \
        <<<reak::grid_for(B), reak::kThreads, 0,                              \
           static_cast<cudaStream_t>(stream)>>>(                              \
            static_cast<const T*>(A), static_cast<const T*>(Bm),              \
            static_cast<const T*>(q), static_cast<const T*>(u),               \
            static_cast<const T*>(D), static_cast<const T*>(Q),               \
            static_cast<const T*>(QN), static_cast<const T*>(R),              \
            static_cast<T*>(grad), static_cast<T*>(K), static_cast<T*>(G),    \
            static_cast<T*>(k), H, n, m, B);                                  \
    return static_cast<int>(cudaGetLastError());                              \
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

REAK_RICCATI_ENTRIES(16, 8, float, f32)
REAK_RICCATI_ENTRIES(16, 8, double, f64)
REAK_RICCATI_ENTRIES(24, 12, float, f32)
REAK_RICCATI_ENTRIES(24, 12, double, f64)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
