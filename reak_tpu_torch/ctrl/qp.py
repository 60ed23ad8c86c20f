"""Dense convex QP solvers with fixed iteration counts (port of
``reak_tpu/ctrl/qp.py``; ref: core/optimization/quadratic_programs.hpp:77
null-space method, :313 projected CG, mehrotra_method.hpp:269 Mehrotra
predictor-corrector).

The workhorse is a Mehrotra primal-dual interior point for box-constrained
QPs, the condensed-MPC core.  Each Newton system is one dense SPD solve
through ``math/linalg.solve_pd`` (``torch.linalg.cholesky_ex``); the JAX
package computes it outside any Pallas kernel as well.  The QP's data may
carry leading batch axes; its reductions are taken per problem.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.ctrl.riccati import _mv
from reak_tpu_torch.math.linalg import solve_pd


class QPResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    gap: torch.Tensor  # final complementarity gap


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def solve_box_qp(H, g, lb, ub, iters: int = 15, reg: float = 1e-9) -> QPResult:
    """min ½xᵀHx + gᵀx  s.t.  lb ≤ x ≤ ub, via the Mehrotra
    predictor-corrector PDIP (ref: mehrotra_method.hpp:269).

    A fixed number ``iters`` of Newton rounds; each solves one SPD system
    (H + Σ λ/s) Δx = r by Cholesky.  Use float64 for 1e-6 accuracy."""
    n = H.shape[-1]
    dtype, device = H.dtype, H.device
    Hr = H + reg * torch.eye(n, dtype=dtype, device=device)
    lb, ub = torch.broadcast_tensors(lb, ub)
    shape = torch.broadcast_shapes(g.shape, lb.shape)

    # strictly-interior start
    x = torch.clamp(torch.zeros(shape, dtype=dtype, device=device),
                    lb + 0.1 * (ub - lb), ub - 0.1 * (ub - lb))
    sl = x - lb
    su = ub - x
    zl = torch.ones(shape, dtype=dtype, device=device)
    zu = torch.ones(shape, dtype=dtype, device=device)
    inf = torch.tensor(float("inf"), dtype=dtype, device=device)

    def newton_dx(d, rhs):
        return solve_pd(Hr + torch.diag_embed(d), rhs)

    def max_step(v, dv):
        """Largest α ≤ 1 with v + α·dv ≥ 0, times 0.995
        (fraction-to-boundary)."""
        neg = dv < 0
        t = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        inf)
        return torch.clamp(0.995 * torch.amin(t, dim=-1, keepdim=True),
                           max=1.0)

    for _ in range(iters):
        grad = _mv(Hr, x) + g
        r_dual = grad - zl + zu
        mu = ((_dot(sl, zl) + _dot(su, zu)) / (2 * n))[..., None]
        d = zl / sl + zu / su

        # affine (predictor) step: rhs = −(Hx + g)
        dx_aff = newton_dx(d, -grad)
        dzl_aff = -zl - (zl / sl) * dx_aff
        dzu_aff = -zu + (zu / su) * dx_aff

        a_p = torch.minimum(max_step(sl, dx_aff), max_step(su, -dx_aff))
        a_d = torch.minimum(max_step(zl, dzl_aff), max_step(zu, dzu_aff))
        mu_aff = ((_dot(sl + a_p * dx_aff, zl + a_d * dzl_aff)
                   + _dot(su - a_p * dx_aff, zu + a_d * dzu_aff))
                  / (2 * n))[..., None]
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # corrector with centering: targets σμ − ds_aff∘dz_aff − z∘s
        rc_l = sigma * mu - dx_aff * dzl_aff - zl * sl
        rc_u = sigma * mu + dx_aff * dzu_aff - zu * su
        rhs = -r_dual + rc_l / sl - rc_u / su
        dx = newton_dx(d, rhs)
        dzl = (rc_l - zl * dx) / sl
        dzu = (rc_u + zu * dx) / su

        a_p = torch.minimum(max_step(sl, dx), max_step(su, -dx))
        a_d = torch.minimum(max_step(zl, dzl), max_step(zu, dzu))

        x = x + a_p * dx
        sl = sl + a_p * dx
        su = su - a_p * dx
        zl = zl + a_d * dzl
        zu = zu + a_d * dzu

    gap = (_dot(sl, zl) + _dot(su, zu)) / (2 * n)
    return QPResult(x=torch.minimum(torch.maximum(x, lb), ub),
                    iters=torch.tensor(iters), gap=gap)


def solve_eq_qp(H, g, A, b, reg: float = 1e-10):
    """Equality-constrained QP  min ½xᵀHx + gᵀx  s.t. Ax = b  by the
    range-space method (ref: quadratic_programs.hpp:77).  Returns (x, λ)."""
    Hr = H + reg * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    Hi_g = solve_pd(Hr, g)
    Hi_At = solve_pd(Hr, A.transpose(-1, -2))
    S = A @ Hi_At  # Schur complement (m × m), SPD for full-rank A
    lam = solve_pd(S, -(_mv(A, Hi_g) + b))
    x = -Hi_g - _mv(Hi_At, lam)
    return x, lam


def project_box(x, lb, ub):
    return torch.minimum(torch.maximum(x, lb), ub)


def solve_box_qp_pg(H, g, lb, ub, iters: int = 200):
    """Accelerated projected gradient, a fixed number of iterations — the
    simple, robust fallback (ref: quadratic_programs.hpp:313).  Linear
    convergence; prefer :func:`solve_box_qp` for tight tolerances."""
    # Lipschitz estimate by power iteration (a fixed count)
    v = torch.ones_like(g)
    for _ in range(12):
        v = _mv(H, v)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    L = _dot(v, _mv(H, v))[..., None]
    step = 1.0 / L

    x = project_box(torch.zeros_like(g), lb, ub)
    y = x
    t = torch.tensor(1.0, dtype=H.dtype, device=H.device)
    for _ in range(iters):
        x_new = project_box(y - step * (_mv(H, y) + g), lb, ub)
        t_new = 0.5 * (1 + torch.sqrt(1 + 4 * t * t))
        y = x_new + (t - 1) / t_new * (x_new - x)
        x, t = x_new, t_new
    return QPResult(x=x, iters=torch.tensor(iters),
                    gap=torch.tensor(float("nan"), dtype=H.dtype,
                                     device=H.device))
