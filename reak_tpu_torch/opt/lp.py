"""Linear programming: Mehrotra predictor-corrector interior point (port of
``reak_tpu/opt/lp.py``).

The reference ships two LP solvers — primal-dual simplex
(ref: core/optimization/simplex_method.hpp) and a Mehrotra interior-point
(ref: core/optimization/mehrotra_method.hpp) — and its own README flags BOTH
as broken ("the LP solvers don't work", ref: README:301-303).  This module
is a *working* replacement: a standard-form Mehrotra predictor-corrector
with the normal-equations solve as a dense Cholesky (``math/linalg.
solve_pd``), a fixed iteration budget (a Python loop; ``lax.scan`` in JAX),
and the classic Mehrotra starting-point heuristic.  Validated against
scipy.optimize.linprog in tests/test_lp.py and tests/test_torch_opt.py.

Standard form:  min cᵀx  s.t.  A x = b,  x ≥ 0.
``solve_lp_inequality`` converts  min cᵀx  s.t.  G x ≤ h, x free  via
slacks and a free-variable split.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.math.linalg import solve_pd
from reak_tpu_torch.opt.line_search import _float, _like


class LPResult(NamedTuple):
    x: torch.Tensor          # primal solution
    y: torch.Tensor          # equality duals
    s: torch.Tensor          # reduced costs (duals of x ≥ 0)
    obj: torch.Tensor        # cᵀx
    gap: torch.Tensor        # final complementarity μ
    primal_res: torch.Tensor
    dual_res: torch.Tensor


def _starting_point(A, b, c, reg):
    """Mehrotra's least-squares starting point (the standard heuristic:
    x̃ = Aᵀ(AAᵀ)⁻¹b, ỹ = (AAᵀ)⁻¹Ac, s̃ = c − Aᵀỹ, then shift positive)."""
    m = A.shape[0]
    AAt = A @ A.mT + reg * torch.eye(m, dtype=A.dtype, device=A.device)
    x = A.mT @ solve_pd(AAt, b)
    y = solve_pd(AAt, A @ c)
    s = c - A.mT @ y
    x = x + torch.clamp(-1.5 * torch.amin(x), min=0.0)
    s = s + torch.clamp(-1.5 * torch.amin(s), min=0.0)
    xs = torch.dot(x, s)
    dx2 = 0.5 * xs / torch.clamp(torch.sum(s), min=1e-30)
    ds2 = 0.5 * xs / torch.clamp(torch.sum(x), min=1e-30)
    return x + dx2 + 1e-1, y, s + ds2 + 1e-1


def _max_step(v, dv):
    t = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), torch.inf)
    return torch.clamp(0.995 * torch.amin(t), max=1.0)


def solve_lp(A, b, c, iters: int = 30, reg: float = 1e-10) -> LPResult:
    """min cᵀx  s.t.  Ax = b, x ≥ 0  (Mehrotra predictor-corrector).

    A (m, n) with m ≤ n and full row rank.  Fixed ``iters`` interior-point
    iterations (each: one normal-equations Cholesky + two back-solves).
    ``torch.func.vmap``-compatible.
    """
    A = _float(A, b)
    b, c = _like(b, A), _like(c, A)
    m, n = A.shape
    x, y, s = _starting_point(A, b, c, reg)
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)

    for _ in range(iters):
        rp = b - A @ x                    # primal residual
        rd = c - A.mT @ y - s             # dual residual
        mu = torch.dot(x, s) / n
        s_safe = torch.clamp(s, min=1e-30)
        d2 = x / s_safe                   # diag(X/S)
        M = (A * d2[None, :]) @ A.mT + reg * eye_m

        def solve_dirs(rc):
            # rc = XSe − target (so the Newton row reads S dx + X ds = −rc);
            # eliminating (dx, ds) gives  A D² Aᵀ dy = rp + A(D² rd + rc/s)
            dy = solve_pd(M, rp + A @ (d2 * rd + rc / s_safe))
            ds = rd - A.mT @ dy
            dx = -(rc / s_safe) - d2 * ds
            return dx, dy, ds

        # predictor (affine scaling)
        dx_a, dy_a, ds_a = solve_dirs(x * s)
        a_p = _max_step(x, dx_a)
        a_d = _max_step(s, ds_a)
        mu_aff = torch.dot(x + a_p * dx_a, s + a_d * ds_a) / n
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # corrector
        dx, dy, ds = solve_dirs(x * s + dx_a * ds_a - sigma * mu)
        a_p = _max_step(x, dx)
        a_d = _max_step(s, ds)
        x_n, y_n, s_n = x + a_p * dx, y + a_d * dy, s + a_d * ds
        # freeze once converged: running a fixed budget past optimality
        # makes diag(X/S) blow up and the normal equations go singular
        done = (mu < 1e-13) | ~(
            torch.all(torch.isfinite(x_n)) & torch.all(torch.isfinite(y_n))
            & torch.all(torch.isfinite(s_n)))
        x, y, s = (torch.where(done, x, x_n), torch.where(done, y, y_n),
                   torch.where(done, s, s_n))
    return LPResult(
        x=x, y=y, s=s, obj=torch.dot(c, x), gap=torch.dot(x, s) / n,
        primal_res=torch.linalg.vector_norm(A @ x - b),
        dual_res=torch.linalg.vector_norm(A.mT @ y + s - c))


def solve_lp_inequality(c, G, h, iters: int = 30,
                        reg: float = 1e-10) -> LPResult:
    """min cᵀx  s.t.  G x ≤ h  with x free — converted to standard form via
    the split x = x⁺ − x⁻ and slack variables w:  min [c, −c, 0]ᵀ[x⁺,x⁻,w]
    s.t. [G, −G, I][x⁺,x⁻,w] = h, all ≥ 0.  Returns the solution with
    ``x`` already recombined."""
    G = _float(G, h)
    c, h = _like(c, G), _like(h, G)
    m, n = G.shape
    A = torch.cat([G, -G, torch.eye(m, dtype=G.dtype, device=G.device)],
                  dim=1)
    cc = torch.cat([c, -c, torch.zeros(m, dtype=G.dtype, device=G.device)])
    res = solve_lp(A, h, cc, iters=iters, reg=reg)
    x = res.x[:n] - res.x[n:2 * n]
    return LPResult(x=x, y=res.y, s=res.s, obj=torch.dot(c, x), gap=res.gap,
                    primal_res=res.primal_res, dual_res=res.dual_res)
