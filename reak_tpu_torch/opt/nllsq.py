"""Nonlinear least squares: Gauss–Newton, Levenberg–Marquardt, J-transpose
(port of ``reak_tpu/opt/nllsq.py``).

Equivalents of the reference's NLLSQ solvers
(ref: core/optimization/gauss_newton_method.hpp gauss_newton_nllsq,
levenberg_marquardt_method.hpp:57 levenberg_marquardt_nllsq,
jacobian_transpose_method.hpp).  Jacobians come from forward-mode AD
(``torch.func.jacfwd``) rather than user callbacks; every solver is a
fixed-iteration Python loop (LM accept/reject is a select, not a branch) so
the whole fit ``torch.func.vmap``s over batches — e.g. batched IK across
scenario goals (ref consumer: ctrl/kte_models/manip_clik_calculator.hpp:209).
The normal equations go through ``math/linalg.solve_pd`` (its Cholesky NaN
for a matrix that is not positive definite, no host read).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from reak_tpu_torch.math.linalg import solve_pd
from reak_tpu_torch.opt.line_search import _float, _vdot


class NLLSQResult(NamedTuple):
    x: torch.Tensor
    residual_norm: torch.Tensor
    grad_norm: torch.Tensor


def _jac(r, x):
    return torch.func.jacfwd(r)(x)


def _final(r, x):
    rx = r(x)
    J = _jac(r, x)
    return NLLSQResult(x, torch.linalg.vector_norm(rx),
                       torch.linalg.vector_norm(J.mT @ rx))


def gauss_newton(r: Callable, x0, iters: int = 20, damping: float = 1e-9,
                 step_clip: float | None = None) -> NLLSQResult:
    """Damped Gauss–Newton (ref: gauss_newton_method.hpp).

    ``r(x) -> (m,)`` residual vector; minimizes ½‖r(x)‖².
    """
    x = _float(x0)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        rx = r(x)
        J = _jac(r, x)
        dx = -solve_pd(J.mT @ J + damping * eye, J.mT @ rx)
        if step_clip is not None:
            nrm = torch.linalg.vector_norm(dx)
            dx = dx * torch.clamp(step_clip / torch.clamp(nrm, min=1e-30),
                                  max=1.0)
        x = x + dx
    return _final(r, x)


def levenberg_marquardt(r: Callable, x0, iters: int = 30, lam0: float = 1e-2,
                        lam_up: float = 4.0, lam_down: float = 0.25,
                        lam_min: float = 1e-12, lam_max: float = 1e8
                        ) -> NLLSQResult:
    """Levenberg–Marquardt with multiplicative damping adaptation
    (ref: levenberg_marquardt_method.hpp:57 — same accept/reject policy,
    expressed as selects so the iteration count is static)."""
    x = _float(x0)
    r0 = r(x)
    cost = 0.5 * _vdot(r0, r0)
    lam = torch.full_like(cost, lam0)
    for _ in range(iters):
        rx = r(x)
        J = _jac(r, x)
        g = J.mT @ rx
        H = J.mT @ J
        scale = torch.diag_embed(torch.clamp(
            torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
        dx = -solve_pd(H + lam * scale, g)
        xn = x + dx
        rn = r(xn)
        cn = 0.5 * _vdot(rn, rn)
        accept = cn < cost
        x = torch.where(accept, xn, x)
        cost = torch.where(accept, cn, cost)
        lam = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up),
                          lam_min, lam_max)
    return _final(r, x)


def jacobian_transpose(r: Callable, x0, iters: int = 200,
                       rate: float | None = None) -> NLLSQResult:
    """Jacobian-transpose descent (ref: jacobian_transpose_method.hpp).
    Step size per iteration from the exact 1-D minimizer along Jᵀr."""
    x = _float(x0)
    for _ in range(iters):
        rx = r(x)
        J = _jac(r, x)
        g = J.mT @ rx
        if rate is None:
            Jg = J @ g
            alpha = _vdot(g, g) / torch.clamp(_vdot(Jg, Jg), min=1e-30)
        else:
            alpha = rate
        x = x - alpha * g
    return _final(r, x)
