"""Linearly-implicit (Rosenbrock) stiff integrators (port of
``reak_tpu/integrators/implicit.py``).

The reference ships only explicit and predictor-corrector methods
(ref: core/integrators/fixed_step_integrators.hpp, pred_corr_integrators.hpp,
variable_step_integrators.hpp), none of which can traverse Pollution
(λ ~ −1e12), the Ring Modulator (C_s = 2e-12) or ROBER (t_f = 1e11).  This
module closes that gap:

* **Rosenbrock 2(3)** (Shampine–Reichelt, the ode23s scheme): L-stable,
  linearly implicit — ONE Jacobian (``torch.func.jacfwd``) + ONE LU
  factorization + three back-substitutions per step, no Newton iteration.
  The factor and its solves go through ``math/linalg._lu_factor`` and
  ``_lu_solve``: a singular W gives a NaN step, which the controller
  rejects, where ``torch.linalg.lu_factor`` would raise.
* Its embedded 3rd-order error estimate drives the bounded step loop of
  ``integrators/adaptive.py`` (``_while_loop``: the condition read on the
  host every ``check_every`` attempts, ``graphed`` replays), with the mixed
  absolute/relative error norm stiff problems need.

Validated against the published CWI/Hairer–Wanner endpoint values of
``integrators/ivp_suite.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.integrators.adaptive import _while_loop
from reak_tpu_torch.integrators.fixed import _time
from reak_tpu_torch.math.linalg import _lu_factor, _lu_solve

_D = 1.0 / (2.0 + 2.0 ** 0.5)  # 1/(2+√2)
_E32 = 6.0 + 2.0 ** 0.5        # 6+√2


def rosenbrock23_step(f, jac, t, y, dt):
    """One Rosenbrock 2(3) attempt → (y1 2nd-order, err_vec 3rd-order est).

    Autonomous-form treatment of time dependence: ∂f/∂t enters via a
    forward-difference (the standard ode23s practice); J = ∂f/∂y at (t, y).
    """
    n = y.shape[0]
    J = jac(t, y)
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    W = eye - (dt * _D) * J
    lu, piv = _lu_factor(W)
    solve = lambda b: _lu_solve(lu, piv, b)

    # df/dt by forward difference, guarded for huge t (autonomous problems
    # see an exactly zero difference)
    tdel = dt * 0.1
    F0 = f(t, y)
    dfdt = (f(t + tdel, y) - F0) / tdel
    hdT = (dt * _D) * dfdt

    k1 = solve(F0 + hdT)
    F1 = f(t + 0.5 * dt, y + 0.5 * dt * k1)
    k2 = solve(F1 - k1) + k1
    y1 = y + dt * k2
    F2 = f(t + dt, y1)
    k3 = solve(F2 - _E32 * (k2 - F1) - 2.0 * (k1 - F0) + hdT)
    err = (dt / 6.0) * (k1 - 2.0 * k2 + k3)
    return y1, err


class StiffResult(NamedTuple):
    y: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    n_steps: torch.Tensor   # accepted + rejected attempts
    ok: torch.Tensor        # reached t_end within budget & above dt_min


def integrate_rosenbrock(
    f,
    y0,
    t0,
    t_end,
    dt0,
    rtol=1e-6,
    atol=1e-9,
    dt_min=0.0,
    dt_max=None,
    max_steps=100_000,
    jac=None,
    check_every: int = 32,
    graphed: bool = False,
    device="cuda",
):
    """Adaptive Rosenbrock 2(3) integration over [t0, t_end].

    ``atol`` may be a scalar or per-component vector.  ``jac`` defaults to
    ``torch.func.jacfwd`` of ``f`` (re-evaluated every attempt).  Same
    bounded-budget failure signalling as integrators/adaptive.
    integrate_adaptive: ``ok`` goes False instead of raising (ref exception
    surface: integration_exceptions.hpp:82 untolerable_integration).
    ``y0`` keeps its type and device when it is a tensor; anything else
    becomes float64 on ``device``.
    """
    if not torch.is_tensor(y0):
        y0 = torch.as_tensor(y0, dtype=torch.float64, device=device)
    t0 = _time(t0, y0)
    t_end = _time(t_end, y0)
    atol_v = torch.broadcast_to(
        torch.as_tensor(atol, dtype=y0.dtype, device=y0.device), y0.shape)
    if jac is None:
        jac = lambda t, y: torch.func.jacfwd(lambda yy: f(t, yy))(y)
    dt_max_v = _time(dt_max, y0) if dt_max is not None else t_end - t0
    dt_min_v = _time(dt_min, y0)

    def err_norm(err, y, y1):
        scale = atol_v + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        return torch.sqrt(torch.mean((err / scale) ** 2))

    def cond(state):
        t, y, dt, n, alive = state
        return alive & (t < t_end) & (n < max_steps)

    def body(state):
        t, y, dt, n, alive = state
        dt_eff = torch.minimum(dt, t_end - t)
        y1, err = rosenbrock23_step(f, jac, t, y, dt_eff)
        e = err_norm(err, y, y1)
        finite = torch.all(torch.isfinite(y1))
        accept = (e <= 1.0) & finite
        # 3rd-order error estimate → exponent 1/3
        scale = torch.where(
            finite,
            torch.clamp(0.8 * (1.0 / torch.clamp(e, min=1e-30)) ** (1.0 / 3.0),
                        0.2, 5.0),
            torch.full_like(e, 0.2))
        new_dt = torch.minimum(torch.maximum(dt_eff * scale, dt_min_v),
                               dt_max_v)
        t_new = torch.where(accept, t + dt_eff, t)
        y_new = torch.where(accept, y1, y)
        died = (~accept) & (dt_eff <= dt_min_v) & (dt_min_v > 0)
        return (t_new, y_new, new_dt, n + 1, alive & ~died)

    start = (t0, y0, _time(dt0, y0),
             torch.zeros((), dtype=torch.int64, device=y0.device),
             torch.ones((), dtype=torch.bool, device=y0.device))
    t, y, dt, n, alive = _while_loop(cond, body, start, check_every, graphed)
    return StiffResult(y=y, t=t, dt=dt, n_steps=n, ok=alive & (t >= t_end))
