// The whole box-constrained Mehrotra PDIP of a batch of LTV-MPC problems, all
// iterations in one launch: the hand-written Hopper port of the Pallas
// kernel reak_tpu/ops/pdip_whole_pallas.py::make_whole_pdip, in its
// regulator, x_ref and x_ref + u_ref modes.
//
// Lanes layout, scenario last: A (H, n, n, B), Bm (H, n, m, B), c (H, n, B),
// [x_ref (H, n, B)], [u_ref (H, m, B)], x0 (n, B), Q/QN (n, n), R (m, m),
// lb/ub (m,) → u (H, m, B), xs (H, n, B).
//
// What bounds it on the H100: per-thread latency.  The algorithm is a chain
// of small dependent recurrences per scenario (each stage of the reverse
// pass needs the V of the stage after it), so the parallelism is the batch:
// at B = 8192 one thread per scenario fills about two warps per SM.  Each
// iteration reads A and B four times (fused reverse, affine forward,
// corrector reverse, corrector forward) and the gains twice; at the
// flagship shape that is ~4.6 KB of A+B per stage per scenario in f32.
//
// Design: the TPU kernel keeps the whole horizon resident in VMEM per
// 128-lane tile (~33k values per scenario at H=50, n=12, m=6, ~130 KB in
// f32), which cannot live in the 227 KB of shared memory of an H100 block
// for more than one scenario.  So this kernel keeps the working arrays — K
// (H, m, n), the packed Cholesky factors of the Schur blocks (H, m, m),
// u, sl, su, zl, zu, w1, w2 (H, m) and xs, dxs (H, n) — in one scratch
// buffer in device memory that the wrapper allocates, laid out scenario
// last so neighbouring threads touch neighbouring addresses (every access
// coalesces), with L2 (50 MB) catching the re-reads.  Because nothing
// lives in on-chip memory, the horizon has no cap.  One thread runs one
// scenario through every iteration and every stage.  The reverse pass
// holds V (n, n), V·A, V·B, F, K and G per stage: at n = 12, m = 6 that is
// far over 255 registers, so those arrays spill to local memory (L1-cached).
// That is accepted in this first version.  Two instances are built: (16, 8)
// for the fixed-base arms (n = 12, m = 6) and (24, 12) for the floating arm's
// tangent (n = 24, m = 12), whose arrays come to ~2.4k values per thread
// (~9.6 KB in f32, ~19 KB in f64) of local memory.  The per-scenario reductions (mu,
// mu_aff, the step lengths) run over (H, m) only, the division in the step
// rule is guarded, sigma = (mu_aff / max(mu, 1e-30))³, the last stage uses
// QN, and the affine and corrector passes share each stage's factor — as
// in the TPU kernel.
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace reak {
namespace {

template <typename T>
__device__ inline T max_step_term(T v, T dv) {
  // -v/dv where dv < 0 (guarded division), +inf elsewhere
  const bool neg = dv < T(0);
  return neg ? -v / (neg ? dv : T(-1)) : T(INFINITY);
}

// NMAX, MMAX bound the state and input widths: they size the per-thread
// arrays of the reverse pass (V, V·A, V·B, F, K, the factor), so each
// instance is built for one bound and the wrapper picks the smallest that
// holds (n, m).
template <typename T, int NMAX, int MMAX>
__global__ void pdip_whole_kernel(
    const T* __restrict__ A_, const T* __restrict__ Bm_,
    const T* __restrict__ c_, const T* __restrict__ xr_,
    const T* __restrict__ ur_, const T* __restrict__ x0,
    const T* __restrict__ Q, const T* __restrict__ QN,
    const T* __restrict__ R, const T* __restrict__ lb,
    const T* __restrict__ ub, T* __restrict__ u_out_, T* __restrict__ xs_out_,
    T* __restrict__ scratch, int H, int n, int m, int B, int iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // the ragged edge: scenarios are independent
  const Lanes<T> A{const_cast<T*>(A_), n, n, B};
  const Lanes<T> Bm{const_cast<T*>(Bm_), n, m, B};
  const Lanes<T> c{const_cast<T*>(c_), n, 1, B};
  const Lanes<T> xr{const_cast<T*>(xr_), n, 1, B};
  const Lanes<T> ur{const_cast<T*>(ur_), m, 1, B};
  const Lanes<T> u_out{u_out_, m, 1, B};
  const Lanes<T> xs_out{xs_out_, n, 1, B};
  // scratch: K, G, u, sl, su, zl, zu, w1, w2, xs, dxs
  T* sp = scratch;
  const long long HB = static_cast<long long>(H) * B;
  const Lanes<T> Ks{sp, m, n, B};
  sp += HB * m * n;
  const Lanes<T> Gs{sp, m, m, B};  // strict lower = L, diagonal = 1/diag
  sp += HB * m * m;
  const Lanes<T> us{sp, m, 1, B};
  sp += HB * m;
  const Lanes<T> sls{sp, m, 1, B};
  sp += HB * m;
  const Lanes<T> sus{sp, m, 1, B};
  sp += HB * m;
  const Lanes<T> zls{sp, m, 1, B};
  sp += HB * m;
  const Lanes<T> zus{sp, m, 1, B};
  sp += HB * m;
  const Lanes<T> w1{sp, m, 1, B};  // k_aff → du_aff
  sp += HB * m;
  const Lanes<T> w2{sp, m, 1, B};  // grad → corrector rhs → k2 → du
  sp += HB * m;
  const Lanes<T> xss{sp, n, 1, B};  // tracked trajectory
  sp += HB * n;
  const Lanes<T> dxs{sp, n, 1, B};
  const bool with_xref = xr_ != nullptr, with_uref = ur_ != nullptr;

  for (int h = 0; h < H; ++h) {
    for (int i = 0; i < m; ++i) {
      const T mid = T(0.5) * (lb[i] + ub[i]);
      const T half = T(0.5) * (ub[i] - lb[i]);
      us(h, i, 0, b) = mid;
      sls(h, i, 0, b) = half;
      sus(h, i, 0, b) = half;
      zls(h, i, 0, b) = T(1);
      zus(h, i, 0, b) = T(1);
    }
  }

  T x[NMAX], x1[NMAX];
  // x_{h+1} = A_h x_h + B_h u_h + c_h from x0, into `dst`
  auto rollout = [&](const Lanes<T>& dst) {
    for (int i = 0; i < n; ++i) x[i] = x0[i * B + b];
    for (int h = 0; h < H; ++h) {
      for (int i = 0; i < n; ++i) {
        T a = T(0), bb = T(0);
        for (int k = 0; k < n; ++k) a += A(h, i, k, b) * x[k];
        for (int k = 0; k < m; ++k) bb += Bm(h, i, k, b) * us(h, k, 0, b);
        x1[i] = a + bb + c(h, i, 0, b);
      }
      for (int i = 0; i < n; ++i) {
        x[i] = x1[i];
        dst(h, i, 0, b) = x1[i];
      }
    }
  };
  rollout(xss);

  const T N2 = T(2.0 * H * m);
  T V[NMAX * NMAX], VA[NMAX * NMAX], VB[NMAX * MMAX], F[MMAX * NMAX],
      K[MMAX * NMAX], L[MMAX * MMAX], inv_d[MMAX];
  T lam[NMAX], lam_full[NMAX], v[NMAX], vn[NMAX], grad[MMAX], w[MMAX],
      k[MMAX], y[MMAX], dx[NMAX], du[MMAX];

  // substitution with the factor of stage h: G⁻¹ rhs, rhs and out of length m
  auto chol_apply = [&](const T* Lf, const T* id, const T* rhs, T* out) {
    for (int i = 0; i < m; ++i) {
      T t = rhs[i];
      for (int kk = 0; kk < i; ++kk) t -= Lf[i * m + kk] * y[kk];
      y[i] = t * id[i];
    }
    for (int i = m - 1; i >= 0; --i) {
      T t = y[i];
      for (int kk = i + 1; kk < m; ++kk) t -= Lf[kk * m + i] * out[kk];
      out[i] = t * id[i];
    }
  };
  // closed-loop forward pass du = −K dx − k, dx' = A dx + B du
  auto forward = [&](const Lanes<T>& kk_du, bool store_dx) {
    for (int i = 0; i < n; ++i) dx[i] = T(0);
    for (int h = 0; h < H; ++h) {
      for (int i = 0; i < m; ++i) {
        T t = T(0);
        for (int j = 0; j < n; ++j) t += Ks(h, i, j, b) * dx[j];
        du[i] = -t - kk_du(h, i, 0, b);
      }
      for (int i = 0; i < n; ++i) {
        T a = T(0), bb = T(0);
        for (int j = 0; j < n; ++j) a += A(h, i, j, b) * dx[j];
        for (int j = 0; j < m; ++j) bb += Bm(h, i, j, b) * du[j];
        x1[i] = a + bb;
      }
      for (int i = 0; i < m; ++i) kk_du(h, i, 0, b) = du[i];
      for (int i = 0; i < n; ++i) {
        dx[i] = x1[i];
        if (store_dx) dxs(h, i, 0, b) = x1[i];
      }
    }
  };

  for (int it = 0; it < iters; ++it) {
    // ---- phase 1: fused reverse pass (adjoint + Riccati + affine rhs) ----
    for (int i = 0; i < n; ++i) {
      lam[i] = T(0);
      v[i] = T(0);
      for (int j = 0; j < n; ++j) V[i * n + j] = QN[i * n + j];
    }
    for (int h = H - 1; h >= 0; --h) {
      const T lastf = (h == H - 1) ? T(1) : T(0);
      // q_t = Qm (x_h − x_ref,h), Qm = QN at the last stage
      for (int i = 0; i < n; ++i) {
        T t = T(0);
        for (int j = 0; j < n; ++j) {
          const T qm = Q[i * n + j] + (QN[i * n + j] - Q[i * n + j]) * lastf;
          T e = xss(h, j, 0, b);
          if (with_xref) e -= xr(h, j, 0, b);
          t += qm * e;
        }
        lam_full[i] = t + lam[i];
      }
      // grad_t = R (u − u_ref) + Bᵀ λ
      for (int i = 0; i < m; ++i) {
        T ru = T(0), bl = T(0);
        for (int j = 0; j < m; ++j) {
          T e = us(h, j, 0, b);
          if (with_uref) e -= ur(h, j, 0, b);
          ru += R[i * m + j] * e;
        }
        for (int kk = 0; kk < n; ++kk) bl += Bm(h, kk, i, b) * lam_full[kk];
        grad[i] = ru + bl;
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
        const T Dt = zls(h, i, 0, b) / sls(h, i, 0, b) +
                     zus(h, i, 0, b) / sus(h, i, 0, b);
        for (int j = 0; j < m; ++j) {
          T t = T(0);
          for (int kk = 0; kk < n; ++kk) t += Bm(h, kk, i, b) * VB[kk * m + j];
          L[i * m + j] = (R[i * m + j] + (i == j ? Dt : T(0))) + t;
        }
        for (int j = 0; j < n; ++j) {
          T t = T(0);
          for (int kk = 0; kk < n; ++kk) t += VB[kk * m + i] * A(h, kk, j, b);
          F[i * n + j] = t;
        }
      }
      // factor G in place (lower triangle of L), once per stage
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
      // K = G⁻¹ F column by column; k = G⁻¹ (grad + Bᵀ v)
      for (int j = 0; j < n; ++j) {
        T fc[MMAX], kc[MMAX];
        for (int i = 0; i < m; ++i) fc[i] = F[i * n + j];
        chol_apply(L, inv_d, fc, kc);
        for (int i = 0; i < m; ++i) K[i * n + j] = kc[i];
      }
      for (int i = 0; i < m; ++i) {
        T t = T(0);
        for (int kk = 0; kk < n; ++kk) t += Bm(h, kk, i, b) * v[kk];
        w[i] = grad[i] + t;
      }
      chol_apply(L, inv_d, w, k);
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
        for (int j = 0; j < m; ++j)
          Gs(h, i, j, b) = j < i ? L[i * m + j] : (j == i ? inv_d[i] : T(0));
        w2(h, i, 0, b) = grad[i];
        w1(h, i, 0, b) = k[i];
      }
    }

    // ---- phase 2: affine forward (du_aff overwrites k_aff in w1) ---------
    forward(w1, false);

    // ---- phase 3: Mehrotra centering + corrector rhs ----------------------
    T mu_s = T(0), t1 = T(INFINITY), t2 = T(INFINITY), t3 = T(INFINITY),
      t4 = T(INFINITY);
    for (int h = 0; h < H; ++h) {
      for (int i = 0; i < m; ++i) {
        const T sl = sls(h, i, 0, b), su = sus(h, i, 0, b);
        const T zl = zls(h, i, 0, b), zu = zus(h, i, 0, b);
        const T dua = w1(h, i, 0, b);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        mu_s += sl * zl + su * zu;
        t1 = fmin(t1, max_step_term(sl, dua));
        t2 = fmin(t2, max_step_term(su, -dua));
        t3 = fmin(t3, max_step_term(zl, dzla));
        t4 = fmin(t4, max_step_term(zu, dzua));
      }
    }
    const T mu = mu_s / N2;
    T a_p = fmin(fmin(T(1), T(0.995) * t1), fmin(T(1), T(0.995) * t2));
    T a_d = fmin(fmin(T(1), T(0.995) * t3), fmin(T(1), T(0.995) * t4));
    T mua_s = T(0);
    for (int h = 0; h < H; ++h) {
      for (int i = 0; i < m; ++i) {
        const T sl = sls(h, i, 0, b), su = sus(h, i, 0, b);
        const T zl = zls(h, i, 0, b), zu = zus(h, i, 0, b);
        const T dua = w1(h, i, 0, b);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        mua_s += (sl + a_p * dua) * (zl + a_d * dzla) +
                 (su - a_p * dua) * (zu + a_d * dzua);
      }
    }
    const T mu_aff = mua_s / N2;
    const T ratio = mu_aff / fmax(mu, T(1e-30));
    const T sigma = ratio * ratio * ratio;
    for (int h = 0; h < H; ++h) {
      for (int i = 0; i < m; ++i) {
        const T sl = sls(h, i, 0, b), su = sus(h, i, 0, b);
        const T zl = zls(h, i, 0, b), zu = zus(h, i, 0, b);
        const T dua = w1(h, i, 0, b);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma * mu - dua * dzla - zl * sl;
        const T rc_u = sigma * mu + dua * dzua - zu * su;
        const T r_dual = w2(h, i, 0, b) - zl + zu;
        w2(h, i, 0, b) = r_dual - rc_l / sl + rc_u / su;
      }
    }

    // ---- phase 4: corrector reverse pass, reusing the stage factors ------
    for (int i = 0; i < n; ++i) v[i] = T(0);
    for (int h = H - 1; h >= 0; --h) {
      for (int i = 0; i < m; ++i) {
        T t = T(0);
        for (int kk = 0; kk < n; ++kk) t += Bm(h, kk, i, b) * v[kk];
        w[i] = w2(h, i, 0, b) + t;
        for (int j = 0; j < i; ++j) L[i * m + j] = Gs(h, i, j, b);
        inv_d[i] = Gs(h, i, i, b);
      }
      chol_apply(L, inv_d, w, k);
      for (int i = 0; i < n; ++i) {
        T av = T(0), kw = T(0);
        for (int kk = 0; kk < n; ++kk) av += A(h, kk, i, b) * v[kk];
        for (int kk = 0; kk < m; ++kk) kw += Ks(h, kk, i, b) * w[kk];
        vn[i] = av - kw;
      }
      for (int i = 0; i < n; ++i) v[i] = vn[i];
      for (int i = 0; i < m; ++i) w2(h, i, 0, b) = k[i];
    }

    // ---- phase 5: corrector forward (du overwrites k2; dxs stored) -------
    forward(w2, true);

    // ---- phase 6: step lengths + update (the trajectory is affine in u) --
    t1 = t2 = t3 = t4 = T(INFINITY);
    for (int h = 0; h < H; ++h) {
      for (int i = 0; i < m; ++i) {
        const T sl = sls(h, i, 0, b), su = sus(h, i, 0, b);
        const T zl = zls(h, i, 0, b), zu = zus(h, i, 0, b);
        const T dua = w1(h, i, 0, b), dun = w2(h, i, 0, b);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma * mu - dua * dzla - zl * sl;
        const T rc_u = sigma * mu + dua * dzua - zu * su;
        const T dzl = (rc_l - zl * dun) / sl;
        const T dzu = (rc_u + zu * dun) / su;
        t1 = fmin(t1, max_step_term(sl, dun));
        t2 = fmin(t2, max_step_term(su, -dun));
        t3 = fmin(t3, max_step_term(zl, dzl));
        t4 = fmin(t4, max_step_term(zu, dzu));
      }
    }
    a_p = fmin(fmin(T(1), T(0.995) * t1), fmin(T(1), T(0.995) * t2));
    a_d = fmin(fmin(T(1), T(0.995) * t3), fmin(T(1), T(0.995) * t4));
    for (int h = 0; h < H; ++h) {
      for (int i = 0; i < m; ++i) {
        const T sl = sls(h, i, 0, b), su = sus(h, i, 0, b);
        const T zl = zls(h, i, 0, b), zu = zus(h, i, 0, b);
        const T dua = w1(h, i, 0, b), dun = w2(h, i, 0, b);
        const T dzla = -zl - (zl / sl) * dua;
        const T dzua = -zu + (zu / su) * dua;
        const T rc_l = sigma * mu - dua * dzla - zl * sl;
        const T rc_u = sigma * mu + dua * dzua - zu * su;
        const T dzl = (rc_l - zl * dun) / sl;
        const T dzu = (rc_u + zu * dun) / su;
        us(h, i, 0, b) = us(h, i, 0, b) + a_p * dun;
        sls(h, i, 0, b) = sl + a_p * dun;
        sus(h, i, 0, b) = su - a_p * dun;
        zls(h, i, 0, b) = zl + a_d * dzl;
        zus(h, i, 0, b) = zu + a_d * dzu;
      }
      for (int i = 0; i < n; ++i)
        xss(h, i, 0, b) = xss(h, i, 0, b) + a_p * dxs(h, i, 0, b);
    }
  }

  // ---- clip to the box + the final consistent rollout ---------------------
  for (int h = 0; h < H; ++h) {
    for (int i = 0; i < m; ++i) {
      const T uc = fmin(fmax(us(h, i, 0, b), lb[i]), ub[i]);
      us(h, i, 0, b) = uc;
      u_out(h, i, 0, b) = uc;
    }
  }
  rollout(xs_out);
}

template <typename T, int NMAX, int MMAX>
int launch(const void* A, const void* Bm, const void* c, const void* xr,
           const void* ur, const void* x0, const void* Q, const void* QN,
           const void* R, const void* lb, const void* ub, void* u_out,
           void* xs_out, void* scratch, int H, int n, int m, int B, int iters,
           void* stream) {
  if (H < 1 || n < 1 || n > NMAX || m < 1 || m > MMAX || B < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32;  // one warp per block spreads B=8192 over 256 blocks
  pdip_whole_kernel<T, NMAX, MMAX><<<(B + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(c), static_cast<const T*>(xr),
      static_cast<const T*>(ur), static_cast<const T*>(x0),
      static_cast<const T*>(Q), static_cast<const T*>(QN),
      static_cast<const T*>(R), static_cast<const T*>(lb),
      static_cast<const T*>(ub), static_cast<T*>(u_out),
      static_cast<T*>(xs_out), static_cast<T*>(scratch), H, n, m, B, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace reak

extern "C" {

// One entry point per (bound, type): reak_pdip_whole_<NMAX>x<MMAX>_<type>.
#define REAK_PDIP_ENTRY(NM, MM, T, SUFFIX)                                   \
  int reak_pdip_whole_##NM##x##MM##_##SUFFIX(                                \
      const void* A, const void* Bm, const void* c, const void* xr,          \
      const void* ur, const void* x0, const void* Q, const void* QN,         \
      const void* R, const void* lb, const void* ub, void* u_out,            \
      void* xs_out, void* scratch, int H, int n, int m, int B, int iters,    \
      void* stream) {                                                        \
    return reak::launch<T, NM, MM>(A, Bm, c, xr, ur, x0, Q, QN, R, lb, ub,   \
                                   u_out, xs_out, scratch, H, n, m, B,       \
                                   iters, stream);                           \
  }

REAK_PDIP_ENTRY(16, 8, float, f32)
REAK_PDIP_ENTRY(16, 8, double, f64)
REAK_PDIP_ENTRY(24, 12, float, f32)
REAK_PDIP_ENTRY(24, 12, double, f64)

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
