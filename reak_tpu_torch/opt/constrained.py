"""Constrained NLP: augmented Lagrangian, equality SQP, log-barrier IP
(port of ``reak_tpu/opt/constrained.py``).

Equivalents of the reference's constrained solvers
(ref: core/optimization/augmented_lagrangian_methods.hpp,
sequential_qp_methods.hpp:196 Byrd–Omojokun SQP,
nl_interior_points_methods.hpp:1215 interior-point LS/TR).

Conventions: minimize f(x) subject to ce(x) = 0 and ci(x) ≥ 0.
All outer/inner loops have static budgets (Python loops); the inner solves
are damped-Newton steps on ``torch.func`` derivatives.  The KKT solve of
``sqp_equality`` goes through ``math/linalg._solve`` and the PD shifts
through ``opt.nlp.pd_shift``: a singular or non-finite problem comes out
NaN without stopping the batch's others.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from reak_tpu_torch.math.linalg import _solve, solve_pd
from reak_tpu_torch.opt.line_search import _float, _vdot, backtracking_armijo
from reak_tpu_torch.opt.nlp import pd_shift


class ConstrainedResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    eq_violation: torch.Tensor
    ineq_violation: torch.Tensor


def _finalize(f, ce, ci, x) -> ConstrainedResult:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ev = torch.linalg.vector_norm(ce(x)) if ce is not None else zero
    iv = (torch.linalg.vector_norm(torch.clamp(ci(x), max=0.0))
          if ci is not None else zero)
    return ConstrainedResult(x, f(x), ev, iv)


def _eye(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


def _newton_steps(obj, x, iters, ls_iters, guard=False):
    """``iters`` damped Newton steps on ``obj`` from x: the PD-shifted AD
    Hessian, Armijo backtracking; with ``guard`` a step whose value is not
    finite is refused."""
    grad = torch.func.grad(obj)
    hess = torch.func.hessian(obj)
    eye = _eye(x)
    fx, gx = obj(x), grad(x)
    for _ in range(iters):
        H = hess(x)
        d = -solve_pd(H + pd_shift(H) * eye, gx)
        a, fn = backtracking_armijo(obj, x, d, fx, gx, iters=ls_iters)
        xn = x + a * d
        if guard:
            ok = torch.isfinite(fn)
            x, fx, gx = (torch.where(ok, xn, x), torch.where(ok, fn, fx),
                         torch.where(ok, grad(xn), gx))
        else:
            x, fx, gx = xn, fn, grad(xn)
    return x


def augmented_lagrangian(f: Callable, x0, ce: Optional[Callable] = None,
                         ci: Optional[Callable] = None,
                         outer_iters: int = 12, inner_iters: int = 25,
                         mu0: float = 10.0, mu_growth: float = 4.0
                         ) -> ConstrainedResult:
    """Augmented-Lagrangian method (ref: augmented_lagrangian_methods.hpp).

    Inequalities handled via the standard clipped form:
    L = f − λᵀce + μ/2‖ce‖² + 1/(2μ) Σ (max(0, σ − μ ci)² − σ²).
    Inner minimization: damped Newton on the AL with AD derivatives.
    """
    x = _float(x0)
    n_e = ce(x).shape[-1] if ce is not None else 0
    n_i = ci(x).shape[-1] if ci is not None else 0
    lam = torch.zeros(n_e, dtype=x.dtype, device=x.device)
    sig = torch.zeros(n_i, dtype=x.dtype, device=x.device)
    mu = torch.tensor(mu0, dtype=x.dtype, device=x.device)

    def al(x, lam, sig, mu):
        v = f(x)
        if ce is not None:
            c = ce(x)
            v = v - _vdot(lam, c) + 0.5 * mu * _vdot(c, c)
        if ci is not None:
            g = ci(x)
            t = torch.clamp(sig - mu * g, min=0.0)
            v = v + torch.sum(t * t - sig * sig) / (2.0 * mu)
        return v

    for _ in range(outer_iters):
        x = _newton_steps(lambda y, lam=lam, sig=sig, mu=mu:
                          al(y, lam, sig, mu), x, inner_iters, 20)
        if ce is not None:
            lam = lam - mu * ce(x)
        if ci is not None:
            sig = torch.clamp(sig - mu * ci(x), min=0.0)
        mu = mu * mu_growth
    return _finalize(f, ce, ci, x)


def sqp_equality(f: Callable, ce: Callable, x0, iters: int = 30,
                 reg: float = 1e-8, merit_mu: float = 10.0
                 ) -> ConstrainedResult:
    """Equality-constrained SQP via damped KKT-Newton steps with an ℓ1-merit
    backtracking search (ref: sequential_qp_methods.hpp:196 — the
    Byrd–Omojokun normal/tangential decomposition collapses to one KKT solve
    in the equality-only case)."""
    x = _float(x0)
    n = x.shape[-1]
    m = ce(x).shape[-1]
    lam = torch.zeros(m, dtype=x.dtype, device=x.device)

    def lagrangian(x, lam):
        return f(x) - _vdot(lam, ce(x))

    def merit(x):
        return f(x) + merit_mu * torch.sum(torch.abs(ce(x)))

    grad_f = torch.func.grad(f)
    jac_c = torch.func.jacfwd(ce)
    hess_L = torch.func.hessian(lagrangian, argnums=0)
    grad_merit = torch.func.grad(merit)
    zeros_mm = torch.zeros(m, m, dtype=x.dtype, device=x.device)
    eye_nm = torch.eye(n + m, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        g = grad_f(x)
        A = jac_c(x)
        cx = ce(x)
        H = hess_L(x, lam)
        # convexify H (exact PD shift)
        H = H + pd_shift(H, reg) * _eye(x)
        # KKT system [H Aᵀ; A 0][dx; -lam⁺] = [-g; -c]
        K = torch.cat([torch.cat([H, A.mT], dim=-1),
                       torch.cat([A, zeros_mm], dim=-1)], dim=-2)
        sol = _solve(K + reg * eye_nm, torch.cat([-g, -cx]))
        dx, lam = sol[:n], -sol[n:]
        # ℓ1-merit backtracking
        a, _ = backtracking_armijo(merit, x, dx, merit(x), grad_merit(x),
                                   iters=20)
        x = x + a * dx
    return _finalize(f, ce, None, x)


def log_barrier(f: Callable, ci: Callable, x0, ce: Optional[Callable] = None,
                outer_iters: int = 10, inner_iters: int = 20,
                t0: float = 1.0, t_growth: float = 4.0) -> ConstrainedResult:
    """Log-barrier interior point for ci(x) ≥ 0 (+ optional equalities via
    quadratic penalty) — the fixed-μ-schedule analog of the reference's
    nl_interior_points_methods.hpp:1215 path-following methods.

    ``x0`` must be strictly feasible (ci(x0) > 0)."""
    x = _float(x0)

    def barrier(x, t):
        g = ci(x)
        v = t * f(x) - torch.sum(torch.log(torch.clamp(g, min=1e-300)))
        if ce is not None:
            c = ce(x)
            v = v + 0.5 * t * 100.0 * _vdot(c, c)
        # infeasible iterates get +inf so the line search rejects them
        return torch.where(torch.all(g > 0), v, torch.inf)

    t = torch.tensor(t0, dtype=x.dtype, device=x.device)
    for _ in range(outer_iters):
        x = _newton_steps(lambda y, t=t: barrier(y, t), x, inner_iters, 25,
                          guard=True)
        t = t * t_growth
    return _finalize(f, ce, ci, x)
