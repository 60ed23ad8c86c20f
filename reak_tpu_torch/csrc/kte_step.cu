// Rollout step + LTV linearization of a fixed-base KTE chain, one launch per
// step: the hand-written Hopper port of the Pallas kernel
// reak_tpu/ops/kte_core_pallas.py::make_step_lanes (K1) and, as a second
// instance of the same kernel that stops before the series, of
// ::make_core_lanes (K5: x, u → q̈ (nv, B), ∂q̈/∂x (nv, n, B), M⁻¹ (nv, nv, B)).
//
// What it computes, per scenario b (lanes layout, scenario last):
//   x (n, B), u (nv, B) → Ad (n, n, B), Bd (n, nv, B), cd (n, B), x_new (n, B)
// with n = 2 nv: the mass matrix M and force f of the chain, their tangents
// along all n state directions, q̈ = M⁻¹(f + u), ∂q̈/∂x = M⁻¹(∂f − ∂M q̈),
// M⁻¹, and the order-`order` exponential-series discretization
//   S = Σ dt^k A^{k-1}/k!,  Ad = I + A S,  Bd = S B,  x_new = x + S f0,
//   cd = x_new − Ad x − Bd u.
//
// What bounds it on the H100: arithmetic and per-thread state, not memory.
// Each scenario reads 3 nv values and writes n² + n nv + 2n, but evaluates
// the chain's kinematics n times in hyper-dual arithmetic.
//
// Design: the Pallas body takes its derivatives by jax.linearize/jax.jvp; a
// CUDA kernel has no autodiff.  So each block holds S scenarios × n
// threads; thread (s, d) evaluates (M, f) in hyper-dual numbers
// (hyperdual.cuh): the inner tangent ε carries the J̇q̇ jvp along q̇, the
// outer tangent δ the unit state direction e_d.  Each thread then factors
// the primal M itself (nv ≤ 8, cheaper than a barrier), solves for q̈ and
// for its own column of ∂q̈/∂x (and, for d < nv, column d of M⁻¹), and puts
// them in shared memory.  After a barrier, thread d builds column d of S by
// the series, and after a second barrier row d of Ad, Bd, cd and x_new.
// Consecutive threads of a warp are consecutive scenarios, so every global
// load and store is coalesced.  Chain constants (axes, offsets, COMs,
// masses, inertias, springs, dampers, gravity) are read from a small table
// (ops/kte_step.py::chain_table) rather than folded into the code as the
// TPU trace did, so one binary serves every fixed-base chain up to MAXJ
// joints.  The per-joint kinematics in hyper-dual form does not fit in
// registers and spills to local memory (L1-cached); making that fast is
// later work.
//
// K5 is the instance kCoreOnly = true: thread (s, d) writes its column of
// ∂q̈/∂x (and, for d < nv, column d of M⁻¹; thread d = 0 also q̈) straight
// to device memory in the TPU kernel's layout and returns before the
// series, with no shared memory and no barrier.  It moves 18 values in and
// 114 out per scenario (528 B in f32) and, like K1, is bound by the
// arithmetic of the n hyper-dual evaluations.
#include <cuda_runtime.h>

#include "hyperdual.cuh"

namespace reak {
namespace {

constexpr int MAXJ = 8;  // joints (= bodies) and dofs per chain
// chain table: J_STRIDE values per joint, then gravity (3)
constexpr int J_TYPE = 0, J_AXIS = 1, J_OFFP = 4, J_OFFQ = 7, J_COM = 11,
              J_MASS = 14, J_INER = 15, J_STIFF = 24, J_REST = 25,
              J_DAMP = 26, J_STRIDE = 27;
constexpr int REVOLUTE = 0, PRISMATIC = 1;  // 2 = FIXED: a link, no dof

template <typename S>
__device__ inline void cross3(const S a[3], const S b[3], S out[3]) {
  S x = a[1] * b[2] - a[2] * b[1];
  S y = a[2] * b[0] - a[0] * b[2];
  S z = a[0] * b[1] - a[1] * b[0];
  out[0] = x;
  out[1] = y;
  out[2] = z;
}

template <typename S>
__device__ inline void qmul(const S a[4], const S b[4], S out[4]) {
  S w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  S x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  S y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  S z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  out[0] = w;
  out[1] = x;
  out[2] = y;
  out[3] = z;
}

// rotate v by q: v + w t + qv × t with t = 2 qv × v; `conj` rotates by q⁻¹
template <typename S>
__device__ inline void qrot(const S q[4], const S v[3], S out[3], bool conj) {
  S qv[3] = {q[1], q[2], q[3]};
  if (conj) {
    qv[0] = -qv[0];
    qv[1] = -qv[1];
    qv[2] = -qv[2];
  }
  S t[3], u[3];
  cross3(qv, v, t);
  for (int i = 0; i < 3; ++i) t[i] = S(2) * t[i];
  cross3(qv, t, u);
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * t[i] + u[i];
}

// Cholesky of the primal M (rsqrt of the pivot, as the lanes recurrence),
// then substitution for one right-hand side.
template <typename T>
__device__ inline void chol_factor(T M[MAXJ][MAXJ], int p,
                                   T L[MAXJ][MAXJ], T inv_d[MAXJ]) {
  for (int j = 0; j < p; ++j) {
    T s = M[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    T dj = T(1) / sqrt(s);
    inv_d[j] = dj;
    L[j][j] = s * dj;
    for (int i = j + 1; i < p; ++i) {
      T t = M[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * dj;
    }
  }
}

template <typename T>
__device__ inline void chol_apply(T L[MAXJ][MAXJ], const T inv_d[MAXJ],
                                  int p, const T rhs[MAXJ], T out[MAXJ]) {
  T y[MAXJ];
  for (int i = 0; i < p; ++i) {
    T t = rhs[i];
    for (int k = 0; k < i; ++k) t -= L[i][k] * y[k];
    y[i] = t * inv_d[i];
  }
  for (int i = p - 1; i >= 0; --i) {
    T t = y[i];
    for (int k = i + 1; k < p; ++k) t -= L[k][i] * out[k];
    out[i] = t * inv_d[i];
  }
}

// kCoreOnly (K5) reuses the output pointers: Ad ← ∂q̈/∂x (nv, n, B),
// Bd ← M⁻¹ (nv, nv, B), cd ← q̈ (nv, B); xn, dt and order are not read.
template <typename T, bool kCoreOnly>
__global__ void kte_step_kernel(const T* __restrict__ x,
                                const T* __restrict__ u,
                                const T* __restrict__ chain, int nj, int nv,
                                double dt, int order, T* __restrict__ Ad,
                                T* __restrict__ Bd, T* __restrict__ cd,
                                T* __restrict__ xn, int B) {
  using H = HD<T>;
  using D = D1<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ns = blockDim.x;  // scenarios per block
  const int s = threadIdx.x;
  const int d = threadIdx.y;  // outer tangent direction, 0..n-1
  const int n = 2 * nv;
  const int b_raw = blockIdx.x * ns + s;
  const bool live = b_raw < B;
  const int b = live ? b_raw : B - 1;  // the ragged edge computes, never stores
  // shared regions, scenario index fastest: A_lo (nv, n) = ∂q̈/∂x,
  // Minv (nv, nv), Smat (n, n)
  const int off_minv = nv * n, off_s = nv * n + nv * nv;
  auto SM = [&](int e) -> T& { return sm[e * ns + s]; };

  T xv[2 * MAXJ], uv[MAXJ];
  for (int i = 0; i < n; ++i) xv[i] = x[i * B + b];
  for (int i = 0; i < nv; ++i) uv[i] = u[i * B + b];

  // ---- (M, f) and their outer tangent along e_d, in hyper-dual numbers --
  H q[MAXJ], qdh[MAXJ];
  for (int k = 0; k < nv; ++k) {
    q[k] = H(xv[k], xv[nv + k], T(d == k), T(d == nv + k));
    qdh[k] = H(xv[nv + k], T(0), T(d == nv + k), T(0));
  }
  H anc[MAXJ][3], axg[MAXJ][3], com[MAXJ][3], quat[MAXJ][4];
  int jt[MAXJ], jidx[MAXJ];
  {
    H p[3] = {H(T(0)), H(T(0)), H(T(0))};
    H Q[4] = {H(T(1)), H(T(0)), H(T(0)), H(T(0))};
    int ci = 0;
    for (int i = 0; i < nj; ++i) {
      const T* c = chain + i * J_STRIDE;
      jt[i] = static_cast<int>(c[J_TYPE]);
      H off[3] = {H(c[J_OFFP]), H(c[J_OFFP + 1]), H(c[J_OFFP + 2])};
      if (c[J_OFFP] != T(0) || c[J_OFFP + 1] != T(0) || c[J_OFFP + 2] != T(0)) {
        H r[3];
        qrot(Q, off, r, false);
        for (int k = 0; k < 3; ++k) p[k] = p[k] + r[k];
      }
      if (c[J_OFFQ] != T(1) || c[J_OFFQ + 1] != T(0) ||
          c[J_OFFQ + 2] != T(0) || c[J_OFFQ + 3] != T(0)) {
        H oq[4] = {H(c[J_OFFQ]), H(c[J_OFFQ + 1]), H(c[J_OFFQ + 2]),
                   H(c[J_OFFQ + 3])};
        qmul(Q, oq, Q);
      }
      H ax[3] = {H(c[J_AXIS]), H(c[J_AXIS + 1]), H(c[J_AXIS + 2])};
      for (int k = 0; k < 3; ++k) anc[i][k] = p[k];
      if (jt[i] == REVOLUTE || jt[i] == PRISMATIC) {
        jidx[ci] = i;
        qrot(Q, ax, axg[i], false);
        if (jt[i] == REVOLUTE) {
          H sn, cs;
          hd_sincos(T(0.5) * q[ci], &sn, &cs);
          H qj[4] = {cs, c[J_AXIS] * sn, c[J_AXIS + 1] * sn,
                     c[J_AXIS + 2] * sn};
          qmul(Q, qj, Q);
        } else {
          for (int k = 0; k < 3; ++k) p[k] = p[k] + q[ci] * axg[i][k];
        }
        ++ci;
      } else {
        for (int k = 0; k < 3; ++k) axg[i][k] = H(T(0));
      }
      if (c[J_COM] != T(0) || c[J_COM + 1] != T(0) || c[J_COM + 2] != T(0)) {
        H cm[3] = {H(c[J_COM]), H(c[J_COM + 1]), H(c[J_COM + 2])};
        H r[3];
        qrot(Q, cm, r, false);
        for (int k = 0; k < 3; ++k) com[i][k] = p[k] + r[k];
      } else {
        for (int k = 0; k < 3; ++k) com[i][k] = p[k];
      }
      for (int k = 0; k < 4; ++k) quat[i][k] = Q[k];
    }
  }

  const T* grav = chain + nj * J_STRIDE;
  D M[MAXJ][MAXJ], f[MAXJ];
  for (int k = 0; k < nv; ++k) {
    f[k] = D(T(0));
    for (int l = 0; l < nv; ++l) M[k][l] = D(T(0));
  }
  for (int bb = 0; bb < nj; ++bb) {
    // Jacobian columns of body bb: Jv world, Jw body frame
    D jv[MAXJ][3], jw[MAXJ][3];
    H v[3] = {H(T(0)), H(T(0)), H(T(0))}, w[3] = {H(T(0)), H(T(0)), H(T(0))};
    for (int k = 0; k < nv; ++k) {
      const int i = jidx[k];
      H Jv[3], Jw[3];
      if (i > bb) {
        for (int c = 0; c < 3; ++c) Jv[c] = Jw[c] = H(T(0));
      } else if (jt[i] == REVOLUTE) {
        H r[3];
        for (int c = 0; c < 3; ++c) r[c] = com[bb][c] - anc[i][c];
        cross3(axg[i], r, Jv);
        qrot(quat[bb], axg[i], Jw, true);
      } else {
        for (int c = 0; c < 3; ++c) {
          Jv[c] = axg[i][c];
          Jw[c] = H(T(0));
        }
      }
      for (int c = 0; c < 3; ++c) {
        v[c] = v[c] + Jv[c] * qdh[k];
        w[c] = w[c] + Jw[c] * qdh[k];
        jv[k][c] = outer_of_value(Jv[c]);
        jw[k][c] = outer_of_value(Jw[c]);
      }
    }
    const T* c = chain + bb * J_STRIDE;
    const T mb = c[J_MASS];
    const T* I = c + J_INER;
    for (int k = 0; k < nv; ++k) {
      for (int l = k; l < nv; ++l) {
        D term = mb * (jv[k][0] * jv[l][0] + jv[k][1] * jv[l][1] +
                       jv[k][2] * jv[l][2]);
        for (int r = 0; r < 3; ++r)
          for (int cc = 0; cc < 3; ++cc)
            if (I[r * 3 + cc] != T(0))
              term = term + I[r * 3 + cc] * (jw[k][r] * jw[l][cc]);
        M[k][l] = M[k][l] + term;
      }
    }
    // bias force: −m (J̇q̇ − g) on the COM, −(I α + ω × I ω) on the body
    D f_lin[3], wv[3], al[3], Iw[3], Ial[3], wxIw[3], f_ang[3];
    for (int k = 0; k < 3; ++k) {
      f_lin[k] = -mb * (outer_of_inner(v[k]) - D(grav[k]));
      wv[k] = outer_of_value(w[k]);
      al[k] = outer_of_inner(w[k]);
    }
    for (int r = 0; r < 3; ++r) {
      Iw[r] = D(T(0));
      Ial[r] = D(T(0));
      for (int cc = 0; cc < 3; ++cc) {
        if (I[r * 3 + cc] != T(0)) {
          Iw[r] = Iw[r] + I[r * 3 + cc] * wv[cc];
          Ial[r] = Ial[r] + I[r * 3 + cc] * al[cc];
        }
      }
    }
    cross3(wv, Iw, wxIw);
    for (int k = 0; k < 3; ++k) f_ang[k] = -(Ial[k] + wxIw[k]);
    for (int k = 0; k < nv; ++k) {
      f[k] = f[k] + (jv[k][0] * f_lin[0] + jv[k][1] * f_lin[1] +
                     jv[k][2] * f_lin[2]) +
             (jw[k][0] * f_ang[0] + jw[k][1] * f_ang[1] + jw[k][2] * f_ang[2]);
    }
  }
  for (int k = 0; k < nv; ++k) {
    for (int l = 0; l < k; ++l) M[k][l] = M[l][k];
    const T* c = chain + jidx[k] * J_STRIDE;
    const D qk(xv[k], T(d == k)), qdk(xv[nv + k], T(d == nv + k));
    f[k] = f[k] - c[J_STIFF] * (qk - D(c[J_REST])) - c[J_DAMP] * qdk;
  }

  // ---- q̈, this direction's column of ∂q̈/∂x, and a column of M⁻¹ --------
  T Mv[MAXJ][MAXJ], L[MAXJ][MAXJ], inv_d[MAXJ], rhs[MAXJ], qdd[MAXJ],
      col[MAXJ];
  for (int k = 0; k < nv; ++k)
    for (int l = 0; l < nv; ++l) Mv[k][l] = M[k][l].v;
  chol_factor(Mv, nv, L, inv_d);
  for (int k = 0; k < nv; ++k) rhs[k] = f[k].v + uv[k];
  chol_apply(L, inv_d, nv, rhs, qdd);
  for (int k = 0; k < nv; ++k) {
    T t = f[k].d;
    for (int l = 0; l < nv; ++l) t -= M[k][l].d * qdd[l];
    rhs[k] = t;
  }
  chol_apply(L, inv_d, nv, rhs, col);
  if constexpr (kCoreOnly) {
    if (live) {
      for (int k = 0; k < nv; ++k) Ad[(k * n + d) * B + b] = col[k];
      if (d == 0)
        for (int k = 0; k < nv; ++k) cd[k * B + b] = qdd[k];
    }
    if (d < nv) {
      for (int k = 0; k < nv; ++k) rhs[k] = T(k == d);
      chol_apply(L, inv_d, nv, rhs, col);
      if (live)
        for (int k = 0; k < nv; ++k) Bd[(k * nv + d) * B + b] = col[k];
    }
    return;
  }
  for (int k = 0; k < nv; ++k) SM(k * n + d) = col[k];
  if (d < nv) {
    for (int k = 0; k < nv; ++k) rhs[k] = T(k == d);
    chol_apply(L, inv_d, nv, rhs, col);
    for (int k = 0; k < nv; ++k) SM(off_minv + k * nv + d) = col[k];
  }
  __syncthreads();

  // ---- column d of S = Σ_{k=1..order} dt^k A^{k-1}/k! --------------------
  // A = [[0, I], [∂q̈/∂x]]: (A v)_i = v_{i+nv} on top, A_lo v below
  {
    T Scol[2 * MAXJ], term[2 * MAXJ], tmp[2 * MAXJ];
    for (int i = 0; i < n; ++i) Scol[i] = term[i] = (i == d) ? T(dt) : T(0);
    for (int k = 2; k <= order; ++k) {
      for (int i = 0; i < n; ++i) {
        if (i < nv) {
          tmp[i] = term[i + nv];
        } else {
          T t = T(0);
          for (int j = 0; j < n; ++j) t += SM((i - nv) * n + j) * term[j];
          tmp[i] = t;
        }
      }
      const T ck = T(dt / k);
      for (int i = 0; i < n; ++i) {
        term[i] = ck * tmp[i];
        Scol[i] += term[i];
      }
    }
    for (int i = 0; i < n; ++i) SM(off_s + i * n + d) = Scol[i];
  }
  __syncthreads();

  // ---- row d of Ad = I + A S, Bd = S B, x_new = x + S f0, cd -------------
  T f0[2 * MAXJ];
  for (int i = 0; i < nv; ++i) {
    f0[i] = xv[nv + i];
    f0[nv + i] = qdd[i];
  }
  T xnew = xv[d], adx = T(0), bdu = T(0);
  for (int l = 0; l < n; ++l) xnew += SM(off_s + d * n + l) * f0[l];
  for (int j = 0; j < n; ++j) {
    T a;
    if (d < nv) {
      a = SM(off_s + (d + nv) * n + j);
    } else {
      a = T(0);
      for (int l = 0; l < n; ++l)
        a += SM((d - nv) * n + l) * SM(off_s + l * n + j);
    }
    if (j == d) a += T(1);
    adx += a * xv[j];
    if (live) Ad[(d * n + j) * B + b] = a;
  }
  for (int j = 0; j < nv; ++j) {
    T a = T(0);
    for (int l = nv; l < n; ++l)
      a += SM(off_s + d * n + l) * SM(off_minv + (l - nv) * nv + j);
    bdu += a * uv[j];
    if (live) Bd[(d * nv + j) * B + b] = a;
  }
  if (live) {
    xn[d * B + b] = xnew;
    cd[d * B + b] = xnew - adx - bdu;
  }
}

template <typename T>
int launch(const void* x, const void* u, const void* chain, int nj, int nv,
           double dt, int order, void* Ad, void* Bd, void* cd, void* xn,
           int B, void* stream) {
  if (nj < 1 || nj > MAXJ || nv < 1 || nv > nj || order < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = 2 * nv;
  const size_t per = static_cast<size_t>(nv * n + nv * nv + n * n) * sizeof(T);
  int ns = 16;
  while (ns > 1 && per * ns > 48 * 1024) ns /= 2;
  dim3 block(ns, n);
  dim3 grid((B + ns - 1) / ns);
  kte_step_kernel<T, false><<<grid, block, per * ns,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(u),
      static_cast<const T*>(chain), nj, nv, dt, order, static_cast<T*>(Ad),
      static_cast<T*>(Bd), static_cast<T*>(cd), static_cast<T*>(xn), B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_core(const void* x, const void* u, const void* chain, int nj,
                int nv, void* qdd, void* dqdd, void* minv, int B,
                void* stream) {
  if (nj < 1 || nj > MAXJ || nv < 1 || nv > nj || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ns = 16;
  dim3 block(ns, 2 * nv);
  dim3 grid((B + ns - 1) / ns);
  kte_step_kernel<T, true><<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(u),
      static_cast<const T*>(chain), nj, nv, 0.0, 1, static_cast<T*>(dqdd),
      static_cast<T*>(minv), static_cast<T*>(qdd), nullptr, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace reak

extern "C" {

int reak_kte_step_f32(const void* x, const void* u, const void* chain, int nj,
                      int nv, double dt, int order, void* Ad, void* Bd,
                      void* cd, void* xn, int B, void* stream) {
  return reak::launch<float>(x, u, chain, nj, nv, dt, order, Ad, Bd, cd, xn,
                             B, stream);
}

int reak_kte_step_f64(const void* x, const void* u, const void* chain, int nj,
                      int nv, double dt, int order, void* Ad, void* Bd,
                      void* cd, void* xn, int B, void* stream) {
  return reak::launch<double>(x, u, chain, nj, nv, dt, order, Ad, Bd, cd, xn,
                              B, stream);
}

int reak_kte_core_f32(const void* x, const void* u, const void* chain, int nj,
                      int nv, void* qdd, void* dqdd, void* minv, int B,
                      void* stream) {
  return reak::launch_core<float>(x, u, chain, nj, nv, qdd, dqdd, minv, B,
                                  stream);
}

int reak_kte_core_f64(const void* x, const void* u, const void* chain, int nj,
                      int nv, void* qdd, void* dqdd, void* minv, int B,
                      void* stream) {
  return reak::launch_core<double>(x, u, chain, nj, nv, qdd, dqdd, minv, B,
                                   stream);
}

const char* reak_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
