"""1-D line searches as straight-line batched programs (port of
``reak_tpu/opt/line_search.py``).

Equivalents of the reference's line-search family
(ref: core/optimization/line_search.hpp — dichotomous, golden-section,
Fibonacci, backtracking, expand-and-zoom).  Each runs a *fixed* number of
shrink steps, a Python loop of that length (``lax.fori_loop`` in JAX) whose
selects are ``torch.where``, so ``torch.func.vmap`` maps it over a batch of
problems: the interval contracts geometrically, so ``iters≈40`` already
reaches f64 resolution.  Plain torch on the device and in the type of the
inputs.
"""
from __future__ import annotations

import torch

_GOLD = 0.6180339887498949  # 1/phi


def _float(x, other=None):
    """x as a floating tensor: a floating tensor as it is, an integer one in
    float64 (the JAX package's ``jnp.result_type(float)`` with x64); numbers
    and numpy arrays in float64 on the device of ``other`` where that is a
    tensor (the other end of a bracket), else on the card — a caller that
    wants the CPU passes CPU tensors."""
    if torch.is_tensor(x):
        return x if x.is_floating_point() else x.to(torch.float64)
    device = other.device if torch.is_tensor(other) else "cuda"
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _like(x, ref):
    """x in the type and on the device of ``ref``."""
    if torch.is_tensor(x):
        return x.to(dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _vdot(a, b):
    """Σ a·b over every element (``jnp.vdot`` of real arrays)."""
    return torch.sum(a * b)


def golden_section(f, lo, hi, iters: int = 48):
    """Minimize unimodal ``f`` on [lo, hi] (ref: line_search.hpp golden-section).

    ``f`` must be elementwise-vectorized; lo/hi may be tensors (batched
    search).  Returns the interval midpoint after ``iters`` contractions.
    """
    lo = _float(lo, hi)
    hi = _like(hi, lo)
    x1 = hi - _GOLD * (hi - lo)
    x2 = lo + _GOLD * (hi - lo)
    f1, f2 = f(x1), f(x2)
    for _ in range(iters):
        shrink_hi = f1 < f2  # keep [lo, x2]
        nhi = torch.where(shrink_hi, x2, hi)
        nlo = torch.where(shrink_hi, lo, x1)
        nx1 = torch.where(shrink_hi, nhi - _GOLD * (nhi - nlo), x2)
        nx2 = torch.where(shrink_hi, x1, nlo + _GOLD * (nhi - nlo))
        nf = f(torch.where(shrink_hi, nx1, nx2))
        nf1 = torch.where(shrink_hi, nf, f2)
        nf2 = torch.where(shrink_hi, f1, nf)
        lo, hi, x1, x2, f1, f2 = nlo, nhi, nx1, nx2, nf1, nf2
    return 0.5 * (lo + hi)


def dichotomous_search(f, lo, hi, iters: int = 48, delta_frac: float = 1e-3):
    """Dichotomous interval shrink (ref: line_search.hpp dichotomous_search)."""
    lo = _float(lo, hi)
    hi = _like(hi, lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        d = delta_frac * (hi - lo)
        keep_left = f(mid - d) < f(mid + d)
        lo, hi = (torch.where(keep_left, lo, mid - d),
                  torch.where(keep_left, mid + d, hi))
    return 0.5 * (lo + hi)


def backtracking_armijo(f, x, d, fx, gx, alpha0=1.0, rho: float = 0.5,
                        c1: float = 1e-4, iters: int = 20):
    """Armijo backtracking along direction ``d`` from ``x``
    (ref: line_search.hpp backtracking_search).

    Runs all ``iters`` shrinks as straight-line code, keeping the *first*
    step length that satisfies the Armijo condition — equivalent to the
    sequential early-exit loop but branch-free for vmap.
    Returns (alpha, f(x + alpha d)).
    """
    slope = _vdot(gx, d)
    alpha0 = _like(alpha0, fx)
    alpha_best, f_best = torch.zeros_like(alpha0), fx
    found = torch.zeros_like(fx, dtype=torch.bool)
    for i in range(iters):
        a = alpha0 * rho ** i
        fa = f(x + a * d)
        ok = (fa <= fx + c1 * a * slope) & ~found
        alpha_best = torch.where(ok, a, alpha_best)
        f_best = torch.where(ok, fa, f_best)
        found = found | ok
    # if nothing satisfied Armijo, take the smallest trial step anyway
    a_min = alpha0 * rho ** (iters - 1)
    a = torch.where(found, alpha_best, a_min)
    fa = torch.where(found, f_best, f(x + a * d))
    return a, fa


def wolfe_zoom(f_and_grad, x, d, fx, gx, alpha_max: float = 4.0,
               c1: float = 1e-4, c2: float = 0.9,
               expand_iters: int = 8, zoom_iters: int = 16):
    """Strong-Wolfe expand-then-zoom search
    (ref: line_search.hpp expand_and_zoom_search).

    ``f_and_grad(x) -> (f, g)``.  Bracket by geometric expansion, then bisect
    with Armijo/curvature selects.  Fixed budgets; returns (alpha, f_new).
    """
    slope0 = _vdot(gx, d)

    def phi(a):
        fv, gv = f_and_grad(x + a * d)
        return fv, _vdot(gv, d)

    # -- expansion: find [a_lo, a_hi] bracketing a Wolfe point
    a_lo = torch.zeros_like(fx)
    a_hi = torch.full_like(fx, alpha_max / 2.0 ** expand_iters)
    done = torch.zeros_like(fx, dtype=torch.bool)
    for _ in range(expand_iters):
        a = torch.clamp(a_hi * 2.0, max=alpha_max)
        fa, _ = phi(a)
        viol = fa > fx + c1 * a * slope0  # passed the minimum
        a_hi = torch.where(done, a_hi, a)
        a_lo = torch.where(done | viol, a_lo, a)
        done = done | viol

    # -- zoom: bisection keeping the Armijo-satisfying side
    a_best, f_best = torch.zeros_like(fx), fx
    for _ in range(zoom_iters):
        a = 0.5 * (a_lo + a_hi)
        fa, ga = phi(a)
        armijo = fa <= fx + c1 * a * slope0
        curv = torch.abs(ga) <= c2 * torch.abs(slope0)
        better = armijo & curv & (fa < f_best)
        a_best = torch.where(better, a, a_best)
        f_best = torch.where(better, fa, f_best)
        # standard zoom interval update
        hi_to_a = ~armijo | (armijo & (ga * (a_hi - a_lo) >= 0))
        a_lo, a_hi = (torch.where(hi_to_a, a_lo, a),
                      torch.where(hi_to_a, a, a_hi))
    # fall back to the final midpoint if no strict Wolfe point was kept
    a_mid = 0.5 * (a_lo + a_hi)
    f_mid, _ = phi(a_mid)
    use_mid = (a_best == 0.0) | (f_mid < f_best)
    return (torch.where(use_mid, a_mid, a_best),
            torch.where(use_mid, f_mid, f_best))
