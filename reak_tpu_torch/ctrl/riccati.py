"""Riccati-recursion MPC solver, batch first (port of
``reak_tpu/ctrl/riccati.py``).

The same box-constrained LTV-MPC problem as ``ctrl/riccati_soa.py``, with
the scenario batch FIRST: the JAX functions are written per scenario and run
under ``jax.vmap``; these take optional leading batch axes instead (A_seq
(..., H, n, n), B_seq (..., H, n, m), x0 (..., n)), loop over the horizon in
Python, and make each m×m Schur solve one ``ops/chol_lanes.chol_solve_auto``
over the whole batch — on CUDA tensors the batched Cholesky kernels K3a (one
right-hand side) and K3b (several), on CPU tensors the plain unrolled
solve.  A reduction over the horizon (the step lengths, the centering) is
taken per scenario, as under vmap: scenarios never mix.

The JAX package ties its iterate inits to traced data for ``shard_map``
(``V0 = QN + 0·A``, zero carries ``zeros_like``); torch needs none of it and
the values are the same.  One side effect is kept on purpose: the PDIP's
``vary0 = 0·Σx0`` makes every output of a scenario whose x0 is not finite
NaN, per scenario, as the reference does.

(Reference lineage: the finite-horizon DARE recursion of mat_are_solver.hpp;
the barrier handling of the Mehrotra QP, mehrotra_method.hpp:269.)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.ops.chol_lanes import chol_solve_auto


class LQRBackward(NamedTuple):
    Ks: torch.Tensor  # (..., H, m, n) feedback gains
    Fs: torch.Tensor  # (..., H, m, n) cached B'V A
    Gs: torch.Tensor  # (..., H, m, m) cached input-space Schur complements


def _mv(M, v):
    """(..., i, k) @ (..., k) → (..., i)."""
    return (M @ v[..., None])[..., 0]


def _mTv(M, v):
    """(..., k, i)ᵀ @ (..., k) → (..., i)."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def lqr_backward(A_seq, B_seq, Q, QN, R_seq):
    """Matrix backward Riccati pass with per-step input cost R_seq
    (..., H, m, m): the gains and the cached per-step matrices, so several
    right-hand sides are solved by vector passes alone.  Each stage's m×m
    Schur solve is one ``chol_solve_auto`` over the batch (n right-hand
    sides: K3b on CUDA tensors)."""
    H = A_seq.shape[-3]
    V = QN + torch.zeros_like(A_seq[..., 0, :, :])
    Ks, Fs, Gs = [None] * H, [None] * H, [None] * H
    for t in reversed(range(H)):
        At, Bt, Rt = A_seq[..., t, :, :], B_seq[..., t, :, :], R_seq[..., t, :, :]
        VB = V @ Bt  # (n, m)
        G = Rt + Bt.transpose(-1, -2) @ VB  # (m, m)
        F = VB.transpose(-1, -2) @ At  # (m, n) = B'V A
        K = chol_solve_auto(G, F)  # (m, n)
        Vn = Q + At.transpose(-1, -2) @ V @ At - F.transpose(-1, -2) @ K
        V = 0.5 * (Vn + Vn.transpose(-1, -2))
        Ks[t], Fs[t], Gs[t] = K, F, G
    stack = lambda xs: torch.stack(xs, dim=-3)
    return LQRBackward(Ks=stack(Ks), Fs=stack(Fs), Gs=stack(Gs))


def lqr_solve_rhs(bw: LQRBackward, A_seq, B_seq, r_seq, x0):
    """Vector pass: the equality-constrained Newton system
    min Σ ½δxᵀQδx + ½δuᵀR̃δu + r_tᵀδu_t  s.t. δx⁺ = Aδx + Bδu, δx₀ = x0,
    on the cached matrix pass.  Backward k_t = G_t⁻¹(r_t + B_tᵀ v_{t+1}),
    v_t = A_tᵀ v_{t+1} − K_tᵀ(r_t + B_tᵀ v_{t+1}); forward
    δu_t = −K_t δx_t − k_t.  Returns δu (..., H, m); each stage's solve is
    one ``chol_solve_auto`` with one right-hand side (K3a on CUDA
    tensors)."""
    H, n = A_seq.shape[-3], A_seq.shape[-1]
    v = torch.zeros(r_seq.shape[:-2] + (n,), dtype=r_seq.dtype,
                    device=r_seq.device)
    ks = [None] * H
    for t in reversed(range(H)):
        At, Bt = A_seq[..., t, :, :], B_seq[..., t, :, :]
        K, G = bw.Ks[..., t, :, :], bw.Gs[..., t, :, :]
        w = r_seq[..., t, :] + _mTv(Bt, v)  # (m,)
        ks[t] = chol_solve_auto(G, w[..., None])[..., 0]
        v = _mTv(At, v) - _mTv(K, w)
    dx = x0
    dus = [None] * H
    for t in range(H):
        At, Bt = A_seq[..., t, :, :], B_seq[..., t, :, :]
        du = -_mv(bw.Ks[..., t, :, :], dx) - ks[t]
        dx = _mv(At, dx) + _mv(Bt, du)
        dus[t] = du
    return torch.stack(dus, dim=-2)


def rollout_affine(A_seq, B_seq, c_seq, x0, us):
    """Linear-model rollout x_{t+1} = A x_t + B u_t + c; returns
    (..., H, n)."""
    x = x0
    xs = []
    for t in range(A_seq.shape[-3]):
        x = (_mv(A_seq[..., t, :, :], x) + _mv(B_seq[..., t, :, :],
                                                us[..., t, :])
             + c_seq[..., t, :])
        xs.append(x)
    return torch.stack(xs, dim=-2)


def qp_gradient(A_seq, B_seq, c_seq, Q, QN, R, x0, us, x_ref=None,
                u_ref=None):
    """∇J(U) of the MPC objective by one rollout and one adjoint pass;
    returns (grad (..., H, m), xs (..., H, n))."""
    xs = rollout_affine(A_seq, B_seq, c_seq, x0, us)
    dx = xs if x_ref is None else xs - x_ref
    # stage state-cost gradients (the terminal one uses QN)
    qs = torch.cat([dx[..., :-1, :] @ Q.T, dx[..., -1:, :] @ QN.T], dim=-2)
    lam = torch.zeros_like(xs[..., 0, :])
    H = A_seq.shape[-3]
    grad = [None] * H
    for t in reversed(range(H)):
        At, Bt = A_seq[..., t, :, :], B_seq[..., t, :, :]
        lam_full = qs[..., t, :] + lam
        grad[t] = us[..., t, :] @ R.T + _mTv(Bt, lam_full)
        lam = _mTv(At, lam_full)
    grad = torch.stack(grad, dim=-2)
    if u_ref is not None:
        grad = grad - u_ref @ R.T
    return grad, xs


def _max_step(v, dv):
    """min(1, 0.995 · the largest step along dv keeping v > 0), per
    scenario over its (H, m), shaped (..., 1, 1)."""
    neg = dv < 0
    t = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                    torch.full_like(v, float("inf")))
    tmin = torch.amin(t, dim=(-2, -1), keepdim=True)
    return torch.minimum(torch.ones_like(tmin), 0.995 * tmin)


def solve_box_mpc_riccati(A_seq, B_seq, c_seq, Q, QN, R, x0, lb, ub,
                          x_ref=None, u_ref=None, iters: int = 8):
    """Box-constrained LTV-MPC by the primal-dual interior point with
    Riccati KKT solves (Mehrotra predictor-corrector, a fixed iteration
    count), batch first.  lb/ub: (m,) per-step bounds.  Returns
    (us (..., H, m), xs (..., H, n))."""
    dtype, device = A_seq.dtype, A_seq.device
    cast = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Q, QN, R, lb, ub = map(cast, (Q, QN, R, lb, ub))
    x_ref = None if x_ref is None else cast(x_ref)
    u_ref = None if u_ref is None else cast(u_ref)
    H, m = A_seq.shape[-3], B_seq.shape[-1]
    LB = lb.expand(H, m)
    UB = ub.expand(H, m)
    N = H * m

    # the reference's vary0 = 0·Σx0: per scenario, NaN where x0 is not
    # finite
    vary0 = (0.0 * torch.sum(x0, dim=-1))[..., None, None]
    u = 0.5 * (LB + UB) + vary0
    sl = u - LB
    su = UB - u
    zl = torch.ones((H, m), dtype=dtype, device=device) + vary0
    zu = torch.ones((H, m), dtype=dtype, device=device) + vary0
    total = lambda a: torch.sum(a, dim=(-2, -1), keepdim=True)

    for _ in range(iters):
        grad, _ = qp_gradient(A_seq, B_seq, c_seq, Q, QN, R, x0, u, x_ref,
                              u_ref)
        r_dual = grad - zl + zu
        mu = (total(sl * zl) + total(su * zu)) / (2 * N)
        D = zl / sl + zu / su  # (H, m) barrier diagonal

        R_seq = R + torch.diag_embed(D)
        bw = lqr_backward(A_seq, B_seq, Q, QN, R_seq)
        dx0 = torch.zeros_like(x0)

        # affine (predictor): rhs = grad
        du_aff = lqr_solve_rhs(bw, A_seq, B_seq, grad, dx0)
        dzl_aff = -zl - (zl / sl) * du_aff
        dzu_aff = -zu + (zu / su) * du_aff

        a_p = torch.minimum(_max_step(sl, du_aff), _max_step(su, -du_aff))
        a_d = torch.minimum(_max_step(zl, dzl_aff), _max_step(zu, dzu_aff))
        mu_aff = (total((sl + a_p * du_aff) * (zl + a_d * dzl_aff))
                  + total((su - a_p * du_aff) * (zu + a_d * dzu_aff))) \
            / (2 * N)
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # corrector: the same gains, a new right-hand side
        rc_l = sigma * mu - du_aff * dzl_aff - zl * sl
        rc_u = sigma * mu + du_aff * dzu_aff - zu * su
        rhs = r_dual - rc_l / sl + rc_u / su
        du = lqr_solve_rhs(bw, A_seq, B_seq, rhs, dx0)
        dzl = (rc_l - zl * du) / sl
        dzu = (rc_u + zu * du) / su

        a_p = torch.minimum(_max_step(sl, du), _max_step(su, -du))
        a_d = torch.minimum(_max_step(zl, dzl), _max_step(zu, dzu))

        u = u + a_p * du
        sl = sl + a_p * du
        su = su - a_p * du
        zl = zl + a_d * dzl
        zu = zu + a_d * dzu

    u = torch.minimum(torch.maximum(u, LB), UB)
    xs = rollout_affine(A_seq, B_seq, c_seq, x0, u)
    return u, xs
