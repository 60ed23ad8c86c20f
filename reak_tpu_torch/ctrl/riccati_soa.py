"""Batch-in-lanes (SoA) Riccati interior-point MPC (port of
``reak_tpu/ctrl/riccati_soa.py``).

Every array keeps the scenario batch as its LAST axis: A (H, n, n, B),
B (H, n, m, B), c (H, n, B), x0 (n, B).  This module holds the one copy of
the lanes small-matrix algebra (``_mm``, ``_mTm``, ``_mv``, ``_mTv``,
``_chol_solve_lanes``) that the plain paths use; the JAX package keeps three
copies of it.

``solve_box_mpc_riccati_soa_fused`` dispatches on the device of its inputs:
a CUDA tensor goes to the whole-solve kernel (``ops/pdip_whole.py``), a CPU
tensor to the plain scan below, which is also the kernel's plain version.
The scan's three horizon passes (``fused_backward_plain``,
``vector_backward_plain``, ``forward_plain``) are the plain versions of the
per-pass kernels (``ops/riccati_bwd.py``) that ``use_kernels="passes"``
launches.  The unfused solver ``solve_box_mpc_riccati_soa`` and its passes
(``lqr_backward_soa``, ``lqr_solve_rhs_soa``, ``qp_gradient_soa``) solve
their Schur blocks through the batched Cholesky kernel
(``ops/chol_lanes.solve_lanes_multi``) on CUDA tensors.

(Reference lineage: finite-horizon DARE recursion of mat_are_solver.hpp +
Mehrotra barrier handling of core/optimization/mehrotra_method.hpp:269.)
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# lanes-last small-matrix algebra: operands (i, k, B), batch on the last axis
# ---------------------------------------------------------------------------


def _mm(X, Y):
    """(i, k, B) @ (k, j, B) → (i, j, B)."""
    return torch.sum(X[:, :, None, :] * Y[None, :, :, :], dim=1)


def _mTm(X, Y):
    """Xᵀ Y: (k, i, B), (k, j, B) → (i, j, B)."""
    return torch.sum(X[:, :, None, :] * Y[:, None, :, :], dim=0)


def _mv(X, v):
    """(i, k, B) @ (k, B) → (i, B)."""
    return torch.sum(X * v[None, :, :], dim=1)


def _mTv(X, v):
    """Xᵀ v: (k, i, B), (k, B) → (i, B)."""
    return torch.sum(X * v[:, None, :], dim=0)


def _chol_solve_lanes(G, rhs):
    """SPD solve in lanes layout: G (n, n, B), rhs (n, k, B) → (n, k, B).

    The unrolled Cholesky recurrence of the JAX package (rsqrt of the
    pivot, inverse-diagonal substitution), as tensor ops."""
    n = G.shape[0]
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        s = G[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.rsqrt(s)
        inv_d[j] = d
        L[j][j] = s * d
        for i in range(j + 1, n):
            t = G[i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * d
    ys = [None] * n
    for i in range(n):
        t = rhs[i]
        for k in range(i):
            t = t - L[i][k][None] * ys[k]
        ys[i] = t * inv_d[i][None]
    xs = [None] * n
    for i in reversed(range(n)):
        t = ys[i]
        for k in range(i + 1, n):
            t = t - L[k][i][None] * xs[k]
        xs[i] = t * inv_d[i][None]
    return torch.stack(xs, dim=0)


# ---------------------------------------------------------------------------
# PDIP, lanes layout
# ---------------------------------------------------------------------------


def rollout_affine_soa(A_seq, B_seq, c_seq, x0, us):
    """x_{t+1} = A_t x_t + B_t u_t + c_t → xs (H, n, B) = x_1..x_H."""
    xs = []
    x = x0
    for t in range(A_seq.shape[0]):
        x = _mv(A_seq[t], x) + _mv(B_seq[t], us[t]) + c_seq[t]
        xs.append(x)
    return torch.stack(xs, dim=0)


def _max_step(v, dv):
    """Largest step in (0, 1] keeping v + a·dv ≥ 0 (×0.995), per scenario:
    reduces over (H, m) only.  The division is guarded where dv ≥ 0."""
    neg = dv < 0
    t = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                    torch.full_like(dv, float("inf")))
    return torch.clamp(0.995 * torch.amin(t, dim=(0, 1)), max=1.0)


def _stage_q(Q, QN, xs, x_ref):
    """Pointwise stage-cost gradients q_t = Q (x_t − x_ref,t), QN at the last
    stage: xs (H, n, B) → (H, n, B)."""
    dx = xs if x_ref is None else xs - x_ref
    qs = torch.einsum("ij,hjb->hib", Q, dx[:-1])
    qN = torch.einsum("ij,jb->ib", QN, dx[-1])
    return torch.cat([qs, qN[None]], dim=0)


# ---------------------------------------------------------------------------
# the three horizon passes of one PDIP iteration: the plain versions of the
# per-pass kernels (ops/riccati_bwd.py), with the contracts of the JAX
# package's ops/riccati_bwd_pallas.py
# ---------------------------------------------------------------------------


def fused_backward_plain(A_seq, B_seq, qs, u_eff, D, Q, QN, R):
    """One reverse pass: cost-gradient adjoint + Riccati matrix recursion +
    affine vector recursion.  A (H,n,n,B), B (H,n,m,B), qs (H,n,B),
    u_eff (H,m,B), D (H,m,B), Q/QN (n,n), R (m,m) → (grad (H,m,B),
    K (H,m,n,B), G (H,m,m,B), k (H,m,B)); the carries V (n,n), λ (n) and
    v (n) go from stage to stage."""
    H, n = A_seq.shape[0], A_seq.shape[1]
    m = B_seq.shape[2]
    Bl = A_seq.shape[-1]
    dtype, device = A_seq.dtype, A_seq.device
    Rb = R[..., None]
    eye_m = torch.eye(m, dtype=dtype, device=device)[..., None]
    lam = torch.zeros(n, Bl, dtype=dtype, device=device)
    v = torch.zeros(n, Bl, dtype=dtype, device=device)
    V = QN[..., None].expand(n, n, Bl)
    grad, Ks, Gs, ks = [None] * H, [None] * H, [None] * H, [None] * H
    for t in reversed(range(H)):
        At, Bt = A_seq[t], B_seq[t]
        lam_full = qs[t] + lam
        grad_t = torch.sum(Rb * u_eff[t][None], dim=1) + _mTv(Bt, lam_full)
        VB = _mm(V, Bt)
        G = (Rb + eye_m * D[t][:, None, :]) + _mTm(Bt, VB)
        F = _mTm(VB, At)
        K = _chol_solve_lanes(G, F)
        w = grad_t + _mTv(Bt, v)
        k = _chol_solve_lanes(G, w[:, None, :])[:, 0]
        Vn = Q[..., None] + _mTm(At, _mm(V, At)) - _mTm(F, K)
        V = 0.5 * (Vn + Vn.transpose(0, 1))
        v = _mTv(At, v) - _mTv(K, w)
        lam = _mTv(At, lam_full)
        grad[t], Ks[t], Gs[t], ks[t] = grad_t, K, G, k
    return tuple(torch.stack(seq, dim=0) for seq in (grad, Ks, Gs, ks))


def _vector_pass(A_seq, B_seq, rhs, Ks, Gs, solve):
    """k_t = G_t⁻¹ (r_t + B_tᵀ v), v ← A_tᵀ v − K_tᵀ (r_t + B_tᵀ v), reverse
    over the horizon; ``solve(G (m,m,B), rhs (m,1,B))`` does the Schur
    solves."""
    H, n, Bl = A_seq.shape[0], A_seq.shape[1], A_seq.shape[-1]
    v = torch.zeros(n, Bl, dtype=A_seq.dtype, device=A_seq.device)
    ks = [None] * H
    for t in reversed(range(H)):
        w = rhs[t] + _mTv(B_seq[t], v)
        ks[t] = solve(Gs[t], w[:, None, :])[:, 0]
        v = _mTv(A_seq[t], v) - _mTv(Ks[t], w)
    return torch.stack(ks, dim=0)


def vector_backward_plain(A_seq, B_seq, rhs, Ks, Gs):
    """The corrector's vector reverse pass, reusing K and G and factoring
    each G again: A, B, rhs (H,m,B), K (H,m,n,B), G (H,m,m,B) → k (H,m,B);
    the carry is v (n)."""
    return _vector_pass(A_seq, B_seq, rhs, Ks, Gs, _chol_solve_lanes)


def forward_plain(A_seq, B_seq, Ks, ks, dx0):
    """The closed-loop forward pass du = −K dx − k, dx' = A dx + B du:
    A, B, K (H,m,n,B), k (H,m,B), dx0 (n,B) → (du (H,m,B), dx (H,n,B)),
    dx = dx_1..dx_H."""
    dx = dx0
    dus, dxs = [], []
    for t in range(A_seq.shape[0]):
        du = -_mv(Ks[t], dx) - ks[t]
        dx = _mv(A_seq[t], dx) + _mv(B_seq[t], du)
        dus.append(du)
        dxs.append(dx)
    return torch.stack(dus, dim=0), torch.stack(dxs, dim=0)


PLAIN_PASSES = (fused_backward_plain, vector_backward_plain, forward_plain)


def _fused_scan(A_seq, B_seq, c_seq, Q, QN, R, x0, lb, ub, x_ref=None,
                u_ref=None, iters: int = 8, passes=PLAIN_PASSES):
    """The scan path of ``reak_tpu/ctrl/riccati_soa.
    solve_box_mpc_riccati_soa_fused``: per iteration the fused reverse pass,
    the affine forward pass, the corrector's vector reverse pass and the
    corrector forward pass, in that order.  ``passes`` = (fused_backward,
    vector_backward, forward) runs them: the plain functions above (the
    plain version of the whole-solve kernel) or the per-pass kernels'
    wrappers.  Same arguments as the public solver; Q/QN/R/lb/ub already on
    A's device and dtype."""
    fused_backward, vector_backward, forward = passes
    H, n = A_seq.shape[0], A_seq.shape[1]
    m = B_seq.shape[2]
    Bl = A_seq.shape[-1]
    dtype, device = A_seq.dtype, A_seq.device
    LB = lb[None, :, None].expand(H, m, Bl)
    UB = ub[None, :, None].expand(H, m, Bl)
    N = H * m
    dx0 = torch.zeros(n, Bl, dtype=dtype, device=device)

    u = 0.5 * (LB + UB)
    sl = u - LB
    su = UB - u
    zl = torch.ones_like(u)
    zu = torch.ones_like(u)

    xs = rollout_affine_soa(A_seq, B_seq, c_seq, x0, u)
    for _ in range(iters):
        qs = _stage_q(Q, QN, xs, x_ref)
        D = zl / sl + zu / su
        u_eff = u if u_ref is None else u - u_ref

        # one fused reverse pass: adjoint + Riccati backward + affine rhs
        grad, Ks, Gs, ks_aff = fused_backward(A_seq, B_seq, qs, u_eff, D, Q,
                                              QN, R)
        r_dual = grad - zl + zu
        mu = (torch.sum(sl * zl, dim=(0, 1)) + torch.sum(su * zu, dim=(0, 1))) \
            / (2 * N)

        # affine forward step
        du_aff, _ = forward(A_seq, B_seq, Ks, ks_aff, dx0)
        dzl_aff = -zl - (zl / sl) * du_aff
        dzu_aff = -zu + (zu / su) * du_aff
        a_p = torch.minimum(_max_step(sl, du_aff), _max_step(su, -du_aff))
        a_d = torch.minimum(_max_step(zl, dzl_aff), _max_step(zu, dzu_aff))
        mu_aff = (
            torch.sum((sl + a_p * du_aff) * (zl + a_d * dzl_aff), dim=(0, 1))
            + torch.sum((su - a_p * du_aff) * (zu + a_d * dzu_aff), dim=(0, 1))
        ) / (2 * N)
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        rc_l = sigma * mu - du_aff * dzl_aff - zl * sl
        rc_u = sigma * mu + du_aff * dzu_aff - zu * su
        rhs = r_dual - rc_l / sl + rc_u / su

        # corrector vector backward, reusing the cached K and G
        ks2 = vector_backward(A_seq, B_seq, rhs, Ks, Gs)

        # corrector forward: du and the trajectory delta dxs
        du, dxs = forward(A_seq, B_seq, Ks, ks2, dx0)
        dzl = (rc_l - zl * du) / sl
        dzu = (rc_u + zu * du) / su
        a_p = torch.minimum(_max_step(sl, du), _max_step(su, -du))
        a_d = torch.minimum(_max_step(zl, dzl), _max_step(zu, dzu))

        u = u + a_p * du
        xs = xs + a_p * dxs  # trajectory is affine in u: no re-rollout
        sl = sl + a_p * du
        su = su - a_p * du
        zl = zl + a_d * dzl
        zu = zu + a_d * dzu
    u = torch.minimum(torch.maximum(u, LB), UB)
    xs = rollout_affine_soa(A_seq, B_seq, c_seq, x0, u)
    return u, xs


def solve_box_mpc_riccati_soa_fused(A_seq, B_seq, c_seq, Q, QN, R, x0, lb,
                                    ub, x_ref=None, u_ref=None,
                                    iters: int = 8, use_kernels: str = "auto"):
    """Box-constrained LTV-MPC by the scan-fused Mehrotra PDIP, lanes layout:
    A_seq (H, n, n, B), B_seq (H, n, m, B), c_seq (H, n, B), x0 (n, B),
    Q/QN (n, n), R (m, m), lb/ub (m,), optional x_ref (H, n, B|1) and
    u_ref (H, m, B|1) → (us (H, m, B), xs (H, n, B)).

    ``use_kernels``:
      - "auto" (default): the whole-solve CUDA kernel for CUDA tensors, the
        plain scan for CPU tensors.  The whole-solve kernel keeps its
        working set in device memory, so it has no horizon cap and "auto"
        takes it at every horizon;
      - "whole": the whole-solve kernel's wrapper, which itself takes the
        plain scan only for CPU tensors;
      - "passes": the same iteration with its three passes on the per-pass
        kernels (``ops/riccati_bwd.py``: fused backward, vector backward,
        closed-loop forward, launched in the JAX package's order); their
        wrappers take the plain passes for CPU tensors.  x_ref and u_ref
        stay outside the kernels (the stage costs and u_eff);
      - "never": the plain scan on any device (the kernels' reference)."""
    if use_kernels not in ("auto", "whole", "passes", "never"):
        raise ValueError(f"use_kernels={use_kernels!r}: expected 'auto', "
                         "'whole', 'passes' or 'never'")
    dtype, device = A_seq.dtype, A_seq.device
    cast = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Q, QN, R, lb, ub = map(cast, (Q, QN, R, lb, ub))
    x_ref = None if x_ref is None else cast(x_ref)
    u_ref = None if u_ref is None else cast(u_ref)
    if use_kernels == "whole" or (use_kernels == "auto" and A_seq.is_cuda):
        from reak_tpu_torch.ops import pdip_whole

        H, n, m = A_seq.shape[0], A_seq.shape[1], B_seq.shape[2]
        whole = pdip_whole.make_whole_pdip(
            H, n, m, iters, with_xref=x_ref is not None,
            with_uref=u_ref is not None)
        refs = [r for r in (x_ref, u_ref) if r is not None]
        return whole(A_seq, B_seq, c_seq, *refs, x0, Q, QN, R, lb, ub)
    passes = PLAIN_PASSES
    if use_kernels == "passes":
        from reak_tpu_torch.ops import riccati_bwd

        passes = (riccati_bwd.fused_backward, riccati_bwd.vector_backward,
                  riccati_bwd.forward)
    return _fused_scan(A_seq, B_seq, c_seq, Q, QN, R, x0, lb, ub,
                       x_ref=x_ref, u_ref=u_ref, iters=iters, passes=passes)


# ---------------------------------------------------------------------------
# the unfused PDIP and its passes (7 horizon scans per iteration): the JAX
# package's cross-check of the fused solver
# ---------------------------------------------------------------------------


def _schur_solve(G, rhs):
    """The Schur solves of the unfused passes, G (m,m,B), rhs (m,k,B): the
    batched Cholesky kernel K3b (``ops/chol_lanes.solve_lanes_multi``) on
    CUDA tensors, its plain version on CPU tensors — the call sites that the
    JAX package sends to its Pallas kernel on a TPU."""
    from reak_tpu_torch.ops import chol_lanes

    return chol_lanes.solve_lanes_multi(G, rhs)


def lqr_backward_soa(A_seq, B_seq, Q, QN, R_seq):
    """Matrix backward pass.  A_seq (H, n, n, B), B_seq (H, n, m, B),
    Q/QN (n, n), R_seq (H, m, m, B) → (Ks (H, m, n, B), Gs (H, m, m, B))."""
    H = A_seq.shape[0]
    Qb = Q[..., None]
    V = QN[..., None] + torch.zeros_like(A_seq[0])
    Ks, Gs = [None] * H, [None] * H
    for t in reversed(range(H)):
        At, Bt = A_seq[t], B_seq[t]
        VB = _mm(V, Bt)
        G = R_seq[t] + _mTm(Bt, VB)
        F = _mTm(VB, At)
        K = _schur_solve(G, F)
        Vn = Qb + _mTm(At, _mm(V, At)) - _mTm(F, K)
        V = 0.5 * (Vn + Vn.transpose(0, 1))
        Ks[t], Gs[t] = K, G
    return torch.stack(Ks, dim=0), torch.stack(Gs, dim=0)


def lqr_solve_rhs_soa(Ks, Gs, A_seq, B_seq, r_seq, x0):
    """Vector pass reusing the cached gains.  r_seq (H, m, B), x0 (n, B)
    → δu (H, m, B)."""
    ks = _vector_pass(A_seq, B_seq, r_seq, Ks, Gs, _schur_solve)
    return forward_plain(A_seq, B_seq, Ks, ks, x0)[0]


def qp_gradient_soa(A_seq, B_seq, c_seq, Q, QN, R, x0, us, x_ref=None,
                    u_ref=None):
    """∇J(U): one rollout + one adjoint pass, lanes layout.  us (H, m, B)
    → (grad (H, m, B), xs (H, n, B))."""
    xs = rollout_affine_soa(A_seq, B_seq, c_seq, x0, us)
    qs = _stage_q(Q, QN, xs, x_ref)
    Rb = R[..., None]
    lam = torch.zeros_like(xs[0])
    grad = [None] * A_seq.shape[0]
    for t in reversed(range(A_seq.shape[0])):
        lam_full = qs[t] + lam
        grad[t] = torch.sum(Rb * us[t][None], dim=1) + _mTv(B_seq[t],
                                                            lam_full)
        lam = _mTv(A_seq[t], lam_full)
    grad = torch.stack(grad, dim=0)
    if u_ref is not None:
        grad = grad - torch.einsum("ij,hjb->hib", R, u_ref)
    return grad, xs


def solve_box_mpc_riccati_soa(A_seq, B_seq, c_seq, Q, QN, R, x0, lb, ub,
                              x_ref=None, u_ref=None, iters: int = 8):
    """Box-constrained LTV-MPC, lanes layout, by the unfused Mehrotra PDIP:
    the gradient, the Riccati matrix pass and two vector passes per
    iteration.  Same arguments and result as
    ``solve_box_mpc_riccati_soa_fused``, which it cross-checks."""
    dtype, device = A_seq.dtype, A_seq.device
    cast = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Q, QN, R, lb, ub = map(cast, (Q, QN, R, lb, ub))
    x_ref = None if x_ref is None else cast(x_ref)
    u_ref = None if u_ref is None else cast(u_ref)
    H, m, Bl = A_seq.shape[0], B_seq.shape[2], A_seq.shape[-1]
    LB = lb[None, :, None].expand(H, m, Bl)
    UB = ub[None, :, None].expand(H, m, Bl)
    N = H * m
    eye_m = torch.eye(m, dtype=dtype, device=device)[..., None]
    dx0 = torch.zeros_like(x0)

    u = 0.5 * (LB + UB)
    sl = u - LB
    su = UB - u
    zl = torch.ones_like(u)
    zu = torch.ones_like(u)
    for _ in range(iters):
        grad, _ = qp_gradient_soa(A_seq, B_seq, c_seq, Q, QN, R, x0, u,
                                  x_ref, u_ref)
        r_dual = grad - zl + zu
        mu = (torch.sum(sl * zl, dim=(0, 1)) + torch.sum(su * zu, dim=(0, 1))) \
            / (2 * N)
        D = zl / sl + zu / su

        R_seq = R[None, :, :, None] + eye_m[None] * D[:, :, None, :]
        Ks, Gs = lqr_backward_soa(A_seq, B_seq, Q, QN, R_seq)

        du_aff = lqr_solve_rhs_soa(Ks, Gs, A_seq, B_seq, grad, dx0)
        dzl_aff = -zl - (zl / sl) * du_aff
        dzu_aff = -zu + (zu / su) * du_aff
        a_p = torch.minimum(_max_step(sl, du_aff), _max_step(su, -du_aff))
        a_d = torch.minimum(_max_step(zl, dzl_aff), _max_step(zu, dzu_aff))
        mu_aff = (
            torch.sum((sl + a_p * du_aff) * (zl + a_d * dzl_aff), dim=(0, 1))
            + torch.sum((su - a_p * du_aff) * (zu + a_d * dzu_aff), dim=(0, 1))
        ) / (2 * N)
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        rc_l = sigma * mu - du_aff * dzl_aff - zl * sl
        rc_u = sigma * mu + du_aff * dzu_aff - zu * su
        rhs = r_dual - rc_l / sl + rc_u / su
        du = lqr_solve_rhs_soa(Ks, Gs, A_seq, B_seq, rhs, dx0)
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
    xs = rollout_affine_soa(A_seq, B_seq, c_seq, x0, u)
    return u, xs
