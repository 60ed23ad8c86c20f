"""Scalar and vector root finders, batched with static iteration budgets
(port of ``reak_tpu/opt/root_finders.py``).

Equivalents of the reference's `core/root_finders`
(ref: bisection_method.hpp:58 bisection_method, secant_method.hpp:249
secant/Illinois/Ford-3/Brent/Ridders family, newton_raphson_method.hpp:63,
broyden_method.hpp).  Scalar finders take an elementwise-vectorized ``f``
and tensor-shaped brackets, so one call solves a whole batch of root
problems — the regime the SVP/SAP interpolators need (one root per DoF per
segment, ref: ctrl/interpolation/sustained_velocity_pulse_Ndof_detail.cpp).
Each iteration count is a Python loop of that length (``lax.fori_loop`` in
JAX); the selects are ``torch.where``.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.math.linalg import _inv
from reak_tpu_torch.opt.line_search import _float, _like, _vdot


def _safe(x, tiny=1e-300):
    """x where |x| > tiny, else 1 (a divisor that cannot be 0)."""
    return torch.where(torch.abs(x) > tiny, x, 1.0)


def bisection(f, lo, hi, iters: int = 60):
    """Bisection on a sign-changing bracket (ref: bisection_method.hpp:58)."""
    lo = _float(lo, hi)
    hi = _like(hi, lo)
    flo = f(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        left = torch.sign(fm) == torch.sign(flo)
        lo, hi, flo = (torch.where(left, mid, lo), torch.where(left, hi, mid),
                       torch.where(left, fm, flo))
    return 0.5 * (lo + hi)


def secant(f, x0, x1, iters: int = 40):
    """Plain secant iteration (ref: secant_method.hpp secant_method)."""
    x0 = _float(x0, x1)
    x1 = _like(x1, x0)
    f0, f1 = f(x0), f(x1)
    for _ in range(iters):
        denom = f1 - f0
        x2 = torch.where(torch.abs(denom) > 1e-300,
                         x1 - f1 * (x1 - x0) / _safe(denom), x1)
        x0, x1, f0, f1 = x1, x2, f1, f(x2)
    return x1


def illinois(f, lo, hi, iters: int = 40):
    """Illinois-weighted regula falsi on a bracket
    (ref: secant_method.hpp illinois weighting)."""
    lo = _float(lo, hi)
    hi = _like(hi, lo)
    flo, fhi = f(lo), f(hi)
    for _ in range(iters):
        x = hi - fhi * (hi - lo) / _safe(fhi - flo)
        fx = f(x)
        same_side = torch.sign(fx) == torch.sign(fhi)
        # replace the endpoint on the same side; halve the stale one (Illinois)
        lo, flo = (torch.where(same_side, lo, hi),
                   torch.where(same_side, 0.5 * flo, fhi))
        hi, fhi = x, fx
    return hi


def ridders(f, lo, hi, iters: int = 30):
    """Ridders' exponential-fit bracketed method
    (ref: secant_method.hpp ridders_method)."""
    lo = _float(lo, hi)
    hi = _like(hi, lo)
    flo, fhi = f(lo), f(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        s = torch.sqrt(torch.clamp(fm * fm - flo * fhi, min=0.0))
        x = mid + (mid - lo) * torch.sign(flo - fhi) * fm / _safe(s)
        x = torch.where(s > 1e-300, x, mid)
        fx = f(x)
        # rebuild the tightest sign-changing bracket from {lo, mid, x, hi}
        use_mx = torch.sign(fm) != torch.sign(fx)
        use_lx = torch.sign(flo) != torch.sign(fx)
        nlo = torch.where(use_mx, torch.minimum(mid, x),
                          torch.where(use_lx, lo, x))
        nhi = torch.where(use_mx, torch.maximum(mid, x),
                          torch.where(use_lx, x, hi))
        nflo = torch.where(use_mx, torch.where(mid < x, fm, fx),
                           torch.where(use_lx, flo, fx))
        nfhi = torch.where(use_mx, torch.where(mid < x, fx, fm),
                           torch.where(use_lx, fx, fhi))
        lo, hi, flo, fhi = nlo, nhi, nflo, nfhi
    return torch.where(torch.abs(flo) < torch.abs(fhi), lo, hi)


def brent(f, lo, hi, iters: int = 40):
    """Brent-style bracketed method: inverse-quadratic / secant step with a
    bisection safeguard (ref: secant_method.hpp brent_method).

    Branch-free reformulation: each iteration computes the interpolated
    candidate, rejects it for the midpoint whenever it leaves the bracket,
    then updates the sign-changing bracket — same convergence class as
    classical Brent with static control flow.
    """
    a = _float(lo, hi)
    b = _like(hi, a)
    fa, fb = f(a), f(b)
    for _ in range(iters):
        # inverse quadratic through (a, fa), (b, fb), (m, fm)
        m = 0.5 * (a + b)
        fm = f(m)
        d0, d1, d2 = fa - fb, fb - fm, fm - fa
        x_iq = (a * fb * fm / _safe(d0 * -d2)
                + b * fa * fm / _safe(-d0 * d1)
                + m * fa * fb / _safe(d2 * d1))
        inside = (x_iq > torch.minimum(a, b)) & (x_iq < torch.maximum(a, b))
        x = torch.where(inside & torch.isfinite(x_iq), x_iq, m)
        fx = f(x)
        # keep the sign-changing half among {a,m,x,b}, collapsing toward x
        lo_, hi_ = torch.minimum(a, b), torch.maximum(a, b)
        flo_ = torch.where(a < b, fa, fb)
        fhi_ = torch.where(a < b, fb, fa)
        left = torch.sign(flo_) != torch.sign(fx)
        a, fa = torch.where(left, lo_, x), torch.where(left, flo_, fx)
        b, fb = torch.where(left, x, hi_), torch.where(left, fx, fhi_)
    return torch.where(torch.abs(fa) < torch.abs(fb), a, b)


def newton_raphson(f, x0, iters: int = 25, df=None):
    """Newton–Raphson (ref: newton_raphson_method.hpp:63).  Derivative via
    forward-mode AD (``torch.func.jvp``) unless ``df`` is given;
    elementwise over batched x0."""
    x = _float(x0)
    if df is None:
        def df(x):
            _, d = torch.func.jvp(f, (x,), (torch.ones_like(x),))
            return d

    for _ in range(iters):
        fx, dfx = f(x), df(x)
        x = x - fx / _safe(dfx)
    return x


def broyden(f, x0, iters: int = 50, J0=None):
    """Broyden's good method for vector roots f: R^n → R^n
    (ref: secant_method.hpp broyden_method analog for systems).

    Maintains an approximate inverse Jacobian via Sherman–Morrison; the
    inverse of ``J0`` goes through ``math/linalg._inv`` (NaN for a singular
    ``J0``, no host read).
    """
    x = _float(x0)
    n = x.shape[-1]
    fx = f(x)
    Jinv = (torch.eye(n, dtype=x.dtype, device=x.device) if J0 is None
            else _inv(_like(J0, x)))
    for _ in range(iters):
        dx = -(Jinv @ fx)
        xn = x + dx
        fn = f(xn)
        Jdf = Jinv @ (fn - fx)
        denom = _vdot(dx, Jdf)
        upd = torch.outer(dx - Jdf, dx @ Jinv) / _safe(denom, 1e-30)
        Jinv = torch.where(torch.abs(denom) > 1e-30, Jinv + upd, Jinv)
        x, fx = xn, fn
    return x
