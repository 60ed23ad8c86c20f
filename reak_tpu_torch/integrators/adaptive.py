"""Adaptive (embedded-pair) integrators with bounded step-rejection loops
(port of ``reak_tpu/integrators/adaptive.py``; ref:
core/integrators/variable_step_integrators.hpp:66 fehlberg45, :251
dormand_prince45).

- each attempted step returns (y5, error_estimate);
- a loop over (t, y, dt) runs until t ≥ t_end or the attempt budget is
  spent (a ``lax.while_loop`` in JAX), and a failure is a flag, not the
  reference's ``untolerable_integration`` exception;
- step-size control: dt ← dt·min(max(0.84·(tol/err)^¼, 0.1), 4).

The loop's condition lives on the device.  Reading it on the host every
attempt would stop the card's queue every attempt, so ``_while_loop`` reads
it every ``check_every`` attempts and, in between, runs the body masked by
the device-side condition: a state whose condition has gone false keeps its
values, so the result is the one of a check every attempt (``check_every=1``).
With ``graphed=True`` (the port's own) each group of ``check_every``
attempts on CUDA tensors is replayed from one CUDA graph
(``ops/graphs.graphed``); ``f`` must then make no tensor from host memory.
``host_reads`` counts the reads of the condition since import.

Time, the step and the tolerances are 0-dim tensors of the type of ``y0``'s
first leaf, on its device (JAX's ``jnp.result_type(float)`` follows its x64
flag, which the tests turn on).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.integrators.fixed import (_lc, _time, _tree_leaves,
                                              _tree_map, _tree_unflatten)
from reak_tpu_torch.ops import graphs

host_reads = 0  # reads of a loop condition on the host, since import


def _while_loop(cond, body, state, check_every: int, graphed: bool):
    """``while cond(state): state = body(state)`` with the condition read
    on the host once every ``check_every`` attempts (module docstring)."""
    global host_reads

    def masked(*leaves):
        s = _tree_unflatten(state, leaves)
        for _ in range(check_every):
            live = cond(s)
            s = _tree_map(lambda a, b: torch.where(live, a, b), body(s), s)
        return tuple(_tree_leaves(s))

    run = graphs.graphed(masked) if graphed else masked
    leaves = tuple(_tree_leaves(state))
    while True:
        host_reads += 1
        if not bool(cond(_tree_unflatten(state, leaves))):
            return _tree_unflatten(state, leaves)
        leaves = run(*leaves)


def rkf45_step(f, t, y, dt):
    """One Fehlberg 4(5) attempt → (y5, y4) (ref:
    variable_step_integrators.hpp:66)."""
    k1 = f(t, y)
    k2 = f(t + 0.25 * dt, _lc(y, (0.25 * dt, k1)))
    k3 = f(t + 0.375 * dt, _lc(y, (3 * dt / 32, k1), (9 * dt / 32, k2)))
    k4 = f(
        t + 12 / 13 * dt,
        _lc(y, (1932 * dt / 2197, k1), (-7200 * dt / 2197, k2),
            (7296 * dt / 2197, k3)),
    )
    k5 = f(
        t + dt,
        _lc(y, (439 * dt / 216, k1), (-8.0 * dt, k2), (3680 * dt / 513, k3),
            (-845 * dt / 4104, k4)),
    )
    k6 = f(
        t + 0.5 * dt,
        _lc(
            y,
            (-8 * dt / 27, k1),
            (2.0 * dt, k2),
            (-3544 * dt / 2565, k3),
            (1859 * dt / 4104, k4),
            (-11 * dt / 40, k5),
        ),
    )
    y5 = _lc(
        y,
        (16 * dt / 135, k1),
        (6656 * dt / 12825, k3),
        (28561 * dt / 56430, k4),
        (-9 * dt / 50, k5),
        (2 * dt / 55, k6),
    )
    y4 = _lc(
        y,
        (25 * dt / 216, k1),
        (1408 * dt / 2565, k3),
        (2197 * dt / 4104, k4),
        (-dt / 5, k5),
    )
    return y5, y4


def dopri45_step(f, t, y, dt):
    """One Dormand-Prince 4(5) attempt → (y5, y4)
    (ref: variable_step_integrators.hpp:251)."""
    k1 = f(t, y)
    k2 = f(t + dt / 5, _lc(y, (dt / 5, k1)))
    k3 = f(t + 3 * dt / 10, _lc(y, (3 * dt / 40, k1), (9 * dt / 40, k2)))
    k4 = f(t + 4 * dt / 5, _lc(y, (44 * dt / 45, k1), (-56 * dt / 15, k2),
                               (32 * dt / 9, k3)))
    k5 = f(
        t + 8 * dt / 9,
        _lc(
            y,
            (19372 * dt / 6561, k1),
            (-25360 * dt / 2187, k2),
            (64448 * dt / 6561, k3),
            (-212 * dt / 729, k4),
        ),
    )
    k6 = f(
        t + dt,
        _lc(
            y,
            (9017 * dt / 3168, k1),
            (-355 * dt / 33, k2),
            (46732 * dt / 5247, k3),
            (49 * dt / 176, k4),
            (-5103 * dt / 18656, k5),
        ),
    )
    y5 = _lc(
        y,
        (35 * dt / 384, k1),
        (500 * dt / 1113, k3),
        (125 * dt / 192, k4),
        (-2187 * dt / 6784, k5),
        (11 * dt / 84, k6),
    )
    k7 = f(t + dt, y5)
    y4 = _lc(
        y,
        (5179 * dt / 57600, k1),
        (7571 * dt / 16695, k3),
        (393 * dt / 640, k4),
        (-92097 * dt / 339200, k5),
        (187 * dt / 2100, k6),
        (dt / 40, k7),
    )
    return y5, y4


class AdaptiveResult(NamedTuple):
    y: torch.Tensor  # final state tree
    t: torch.Tensor  # reached time
    dt: torch.Tensor  # final step size
    n_steps: torch.Tensor  # accepted+rejected attempts used
    ok: torch.Tensor  # bool: reached t_end within budget & above dt_min


_ATTEMPTS = {"rkf45": rkf45_step, "dopri45": dopri45_step}


def integrate_adaptive(
    f,
    y0,
    t0,
    t_end,
    dt0,
    tol=1e-6,
    dt_min=1e-10,
    dt_max=None,
    max_steps=10_000,
    method="dopri45",
    check_every: int = 32,
    graphed: bool = False,
):
    """Adaptive integration with a bounded attempt budget.

    Failure signalling: instead of throwing ``untolerable_integration``
    (ref: integration_exceptions.hpp:82), returns ``ok=False`` when the step
    size underflows ``dt_min`` or the budget is exhausted before ``t_end``.
    ``check_every`` and ``graphed``: see the module docstring.
    """
    attempt = _ATTEMPTS[method] if isinstance(method, str) else method
    t0 = _time(t0, y0)
    t_end = _time(t_end, y0)
    dt_max_v = _time(dt_max, y0) if dt_max is not None else t_end - t0
    dt_min_v = _time(dt_min, y0)

    def err_norm(y5, y4):
        sq = sum(torch.sum((a - b) ** 2)
                 for a, b in zip(_tree_leaves(y5), _tree_leaves(y4)))
        return torch.sqrt(sq)

    def cond(state):
        t, y, dt, n, alive = state
        return alive & (t < t_end) & (n < max_steps)

    def body(state):
        t, y, dt, n, alive = state
        dt_eff = torch.minimum(dt, t_end - t)
        y5, y4 = attempt(f, t, y, dt_eff)
        err = err_norm(y5, y4)
        accept = err <= tol
        # standard 4th-order controller
        scale = torch.clamp(
            0.84 * (tol / torch.clamp(err, min=1e-30)) ** 0.25, 0.1, 4.0)
        new_dt = torch.minimum(torch.maximum(dt_eff * scale, dt_min_v),
                               dt_max_v)
        t_new = torch.where(accept, t + dt_eff, t)
        y_new = _tree_map(lambda a, b: torch.where(accept, a, b), y5, y)
        died = (~accept) & (dt_eff <= dt_min_v)
        return (t_new, y_new, new_dt, n + 1, alive & ~died)

    start = (t0, y0, _time(dt0, y0),
             torch.zeros((), dtype=torch.int64, device=t0.device),
             torch.ones((), dtype=torch.bool, device=t0.device))
    t, y, dt, n, alive = _while_loop(cond, body, start, check_every, graphed)
    return AdaptiveResult(y=y, t=t, dt=dt, n_steps=n, ok=alive & (t >= t_end))
