"""Unconstrained NLP solvers: Nelder–Mead, BFGS, SR1-TR, nonlinear CG,
Newton (port of ``reak_tpu/opt/nlp.py``).

Equivalents of the reference's NLP family
(ref: core/optimization/nelder_mead_method.hpp, quasi_newton_methods.hpp
bfgs_method / sr1_tr_method, nonlin_conjugate_gradient_methods.hpp,
newton_methods.hpp, trust_region_search.hpp, hessian_update.hpp).

Gradients/Hessians come from ``torch.func`` (``grad``, ``hessian``).  All
solvers run their static iteration budgets as Python loops with
branch-free accept/reject selects, so ``torch.func.vmap`` maps them across
problem batches (e.g. per-scenario posture optimization); no step writes in
place.  ``pd_shift``'s eigenvalues go through ``math/linalg._eigvalsh``: a
non-finite Hessian makes its own problem NaN and leaves the batch's others
as they are.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from reak_tpu_torch.math.linalg import _eigvalsh, solve_pd
from reak_tpu_torch.opt.line_search import (_float, _vdot,
                                            backtracking_armijo)


class NLPResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    grad_norm: torch.Tensor


def pd_shift(H, reg: float = 1e-8):
    """Shift making a symmetric H positive definite: max(0, −λ_min) + reg.
    Exact (eigvalsh) — these solvers run at small n where this is cheap and
    a Gershgorin bound would cripple the Newton step.  NaN for a non-finite
    H."""
    lam_min = _eigvalsh(0.5 * (H + H.mT))[..., 0]
    return torch.clamp(-lam_min, min=0.0) + reg


def _eye(x):
    n = x.shape[-1]
    return torch.eye(n, dtype=x.dtype, device=x.device)


def _norm(v):
    return torch.linalg.vector_norm(v)


def _result(f, x):
    g = torch.func.grad(f)(x)
    return NLPResult(x, f(x), _norm(g))


def nelder_mead(f: Callable, x0, iters: int = 200, init_scale: float = 0.25,
                alpha: float = 1.0, gamma: float = 2.0, rho: float = 0.5,
                sigma: float = 0.5) -> NLPResult:
    """Nelder–Mead simplex (ref: nelder_mead_method.hpp).

    The simplex lives as one (n+1, n) tensor; each iteration sorts it (a
    stable sort, as JAX's ``argsort``) and applies
    reflection/expansion/contraction/shrink via masked selects.  ``f`` is
    evaluated via ``torch.func.vmap`` over simplex vertices.
    """
    x0 = _float(x0)
    fv = torch.func.vmap(f)
    simplex = torch.cat([x0[None], x0[None] + init_scale * _eye(x0)], dim=0)
    fs = fv(simplex)

    for _ in range(iters):
        order = torch.argsort(fs, stable=True)
        simplex, fs = simplex[order], fs[order]
        best, worst = simplex[0], simplex[-1]
        f_best, f_second, f_worst = fs[0], fs[-2], fs[-1]
        centroid = torch.mean(simplex[:-1], dim=0)

        xr = centroid + alpha * (centroid - worst)
        fr = f(xr)
        xe = centroid + gamma * (xr - centroid)
        fe = f(xe)
        xc = centroid + rho * (worst - centroid)
        fc = f(xc)

        # choose replacement for the worst vertex
        reflect = (fr >= f_best) & (fr < f_second)
        expand = fr < f_best
        contract = (~reflect & ~expand) & (fc < f_worst)
        use_e = expand & (fe < fr)
        new_pt = torch.where(use_e, xe,
                             torch.where(expand | reflect, xr,
                                         torch.where(contract, xc, worst)))
        new_f = torch.where(use_e, fe,
                            torch.where(expand | reflect, fr,
                                        torch.where(contract, fc, f_worst)))
        shrink = ~reflect & ~expand & ~contract

        replaced = torch.cat([simplex[:-1], new_pt[None]], dim=0)
        replaced_f = torch.cat([fs[:-1], new_f[None]], dim=0)
        shrunk = best[None] + sigma * (simplex - best[None])
        shrunk_f = fv(shrunk)
        simplex = torch.where(shrink, shrunk, replaced)
        fs = torch.where(shrink, shrunk_f, replaced_f)

    i = torch.argmin(fs)
    return _result(f, torch.index_select(simplex, 0, i[None])[0])


def bfgs(f: Callable, x0, iters: int = 60, ls_iters: int = 20) -> NLPResult:
    """BFGS with Armijo backtracking (ref: quasi_newton_methods.hpp
    bfgs_method).  Maintains the inverse Hessian; curvature-guarded update."""
    x = _float(x0)
    eye = _eye(x)
    grad = torch.func.grad(f)
    fx, gx, Hinv = f(x), grad(x), eye
    for _ in range(iters):
        d = -(Hinv @ gx)
        # ensure descent; fall back to steepest descent
        d = torch.where(_vdot(gx, d) < 0, d, -gx)
        a, fn = backtracking_armijo(f, x, d, fx, gx, iters=ls_iters)
        xn = x + a * d
        gn = grad(xn)
        s, y = xn - x, gn - gx
        sy = _vdot(s, y)
        ok = sy > 1e-12
        rho_ = 1.0 / torch.where(ok, sy, 1.0)
        V = eye - rho_ * torch.outer(s, y)
        Hn = V @ Hinv @ V.mT + rho_ * torch.outer(s, s)
        Hinv = torch.where(ok, Hn, Hinv)
        x, fx, gx = xn, fn, gn
    return NLPResult(x, fx, _norm(gx))


def sr1_trust_region(f: Callable, x0, iters: int = 60, tr0: float = 1.0,
                     eta: float = 0.1) -> NLPResult:
    """SR1 quasi-Newton in a trust region with dogleg steps
    (ref: quasi_newton_methods.hpp sr1_tr_method + trust_region_search.hpp)."""
    x = _float(x0)
    eye = _eye(x)
    grad = torch.func.grad(f)

    def dogleg(B, g, radius):
        # Newton point (PD-shifted — raw SR1 B may be indefinite) and Cauchy
        # point; blend to the boundary
        B = B + pd_shift(B) * eye
        pN = -solve_pd(B, g)
        gBg = _vdot(g, B @ g)
        tau = _vdot(g, g) / torch.clamp(gBg, min=1e-30)
        pC = -tau * g
        nN, nC = _norm(pN), _norm(pC)
        use_N = nN <= radius
        scale_C = radius / torch.clamp(nC, min=1e-30)
        p_boundary = pC * torch.clamp(scale_C, max=1.0)
        # single-segment dogleg: if Cauchy inside, walk toward Newton
        d = pN - pC
        dd = _vdot(d, d)
        pc_d = _vdot(pC, d)
        disc = torch.clamp(pc_d ** 2 - dd * (nC ** 2 - radius ** 2), min=0.0)
        t = (-pc_d + torch.sqrt(disc)) / torch.clamp(dd, min=1e-30)
        p_dog = pC + torch.clamp(t, 0.0, 1.0) * d
        return torch.where(use_N, pN,
                           torch.where(nC >= radius, p_boundary, p_dog))

    fx, gx = f(x), grad(x)
    B, radius = eye, torch.full_like(fx, tr0)
    for _ in range(iters):
        p = dogleg(B, gx, radius)
        xn = x + p
        fn = f(xn)
        Bpd = B + pd_shift(B) * eye
        pred = -(_vdot(gx, p) + 0.5 * _vdot(p, Bpd @ p))
        ratio = (fx - fn) / torch.clamp(pred, min=1e-30)
        accept = ratio > eta
        radius = torch.where(ratio > 0.75, radius * 2.0,
                             torch.where(ratio < 0.25, radius * 0.25, radius))
        radius = torch.clamp(radius, 1e-8, 1e8)
        gn = grad(xn)
        y = gn - gx
        r_ = y - B @ p
        rp = _vdot(r_, p)
        # SR1 safeguard (skip near-singular updates)
        ok = torch.abs(rp) > 1e-8 * _norm(r_) * _norm(p)
        B = B + torch.where(ok, 1.0 / torch.where(ok, rp, 1.0),
                            0.0) * torch.outer(r_, r_)
        x = torch.where(accept, xn, x)
        fx = torch.where(accept, fn, fx)
        gx = torch.where(accept, gn, gx)
    return NLPResult(x, fx, _norm(gx))


def nonlinear_cg(f: Callable, x0, iters: int = 100, ls_iters: int = 25,
                 variant: str = "pr") -> NLPResult:
    """Nonlinear conjugate gradient, Polak–Ribière+ or Fletcher–Reeves
    (ref: nonlin_conjugate_gradient_methods.hpp)."""
    x = _float(x0)
    grad = torch.func.grad(f)
    gx, fx = grad(x), f(x)
    d, a_prev = -gx, torch.ones_like(fx)
    for _ in range(iters):
        # warm-started trial step: keep the previous accepted step's scale
        # (standard CG heuristic — a fixed α₀=1 stalls on narrow valleys)
        a0 = torch.clamp(2.0 * a_prev, 1e-6, 4.0)
        a, fn = backtracking_armijo(f, x, d, fx, gx, alpha0=a0,
                                    iters=ls_iters)
        xn = x + a * d
        gn = grad(xn)
        gg = _vdot(gx, gx)
        if variant == "fr":
            beta = _vdot(gn, gn) / torch.clamp(gg, min=1e-30)
        else:  # PR+
            beta = torch.clamp(_vdot(gn, gn - gx)
                               / torch.clamp(gg, min=1e-30), min=0.0)
        dn = -gn + beta * d
        # restart with steepest descent if not a descent direction
        d = torch.where(_vdot(gn, dn) < 0, dn, -gn)
        x, gx, fx, a_prev = xn, gn, fn, a
    return NLPResult(x, fx, _norm(gx))


def newton_method(f: Callable, x0, iters: int = 30, ls_iters: int = 20,
                  reg: float = 1e-8) -> NLPResult:
    """Damped (line-searched) Newton with Levenberg regularization of the AD
    Hessian (ref: newton_methods.hpp line-search Newton)."""
    x = _float(x0)
    eye = _eye(x)
    grad = torch.func.grad(f)
    hess = torch.func.hessian(f)
    fx, gx = f(x), grad(x)
    for _ in range(iters):
        H = hess(x)
        d = -solve_pd(H + pd_shift(H, reg) * eye, gx)
        a, fn = backtracking_armijo(f, x, d, fx, gx, iters=ls_iters)
        x = x + a * d
        fx, gx = fn, grad(x)
    return NLPResult(x, fx, _norm(gx))
