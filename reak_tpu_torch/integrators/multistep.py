"""Predictor-corrector multistep integrators (port of
``reak_tpu/integrators/multistep.py``; ref:
core/integrators/pred_corr_integrators.hpp:64 adamsBM3, :301 adamsBM5,
:542 hamming_mod, :821 hamming_iter_mod).

The derivative history is the carry of a Python loop (of a ``lax.scan`` in
JAX); the first steps bootstrap with RK4.  Time is a 0-dim tensor of the
state's type (``fixed._time``).  ``graph_steps`` (the port's own) replays
the loop on CUDA tensors in chunks of that many steps from one CUDA graph,
as ``fixed.integrate`` does.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.integrators.fixed import (_loop, _plus_times, _time,
                                              _tree_map, rk4_step)


def _lin(*coeff_trees):
    """Σ aᵢ·treeᵢ."""
    a0, t0 = coeff_trees[0]
    out = _tree_map(lambda x: a0 * x, t0)
    for a, t in coeff_trees[1:]:
        out = _tree_map(lambda o, x: _plus_times(o, a, x), out, t)
    return out


def _bootstrap(f, y0, t0, dt, n: int):
    """y_0 … y_n by RK4 and f at each, time as a tensor."""
    t = _time(t0, y0)
    ys = [y0]
    fs = [f(t, y0)]
    for i in range(n):
        y = rk4_step(f, t + i * dt, ys[-1], dt)
        ys.append(y)
        fs.append(f(t + (i + 1) * dt, y))
    return t, ys, fs


def adams_bm3(f, y0, t0, dt, n_steps: int, graph_steps: int = 0):
    """Adams-Bashforth-Moulton 3-step PC (ref: pred_corr_integrators.hpp:64)."""
    t, ys, fs = _bootstrap(f, y0, t0, dt, min(2, n_steps))
    if n_steps <= 2:
        return ys[n_steps]

    def body(carry):
        y, f0, f1, f2, t = carry  # f2 = newest
        tn = t + dt
        yp = _lin((1.0, y), (23 * dt / 12, f2), (-16 * dt / 12, f1),
                  (5 * dt / 12, f0))
        fp = f(tn, yp)
        yc = _lin((1.0, y), (5 * dt / 12, fp), (8 * dt / 12, f2),
                  (-1 * dt / 12, f1))
        fc = f(tn, yc)
        return (yc, f1, f2, fc, tn)

    carry = (ys[2], fs[0], fs[1], fs[2], t + 2 * dt)
    return _loop(body, carry, n_steps - 2, graph_steps)[0]


def adams_bm5(f, y0, t0, dt, n_steps: int, graph_steps: int = 0):
    """Adams-Bashforth-Moulton 5-step PC (ref: pred_corr_integrators.hpp:301)."""
    t, ys, fs = _bootstrap(f, y0, t0, dt, min(4, n_steps))
    if n_steps <= 4:
        return ys[n_steps]

    def body(carry):
        y, f0, f1, f2, f3, f4, t = carry  # f4 newest
        tn = t + dt
        yp = _lin(
            (1.0, y),
            (1901 * dt / 720, f4),
            (-2774 * dt / 720, f3),
            (2616 * dt / 720, f2),
            (-1274 * dt / 720, f1),
            (251 * dt / 720, f0),
        )
        fp = f(tn, yp)
        yc = _lin(
            (1.0, y),
            (251 * dt / 720, fp),
            (646 * dt / 720, f4),
            (-264 * dt / 720, f3),
            (106 * dt / 720, f2),
            (-19 * dt / 720, f1),
        )
        fc = f(tn, yc)
        return (yc, f1, f2, f3, f4, fc, tn)

    carry = (ys[4], fs[0], fs[1], fs[2], fs[3], fs[4], t + 4 * dt)
    return _loop(body, carry, n_steps - 4, graph_steps)[0]


def _hamming(f, y0, t0, dt, n_steps: int, corrector_iters: int,
             graph_steps: int):
    t, ys, fs = _bootstrap(f, y0, t0, dt, min(3, n_steps))
    if n_steps <= 3:
        return ys[n_steps]

    def corrector(y, y2, fm, f0, f1):
        return _lin((9.0 / 8.0, y), (-1.0 / 8.0, y2), (3 * dt / 8, fm),
                    (6 * dt / 8, f0), (-3 * dt / 8, f1))

    def body(carry):
        y3, y2, y1, y, f1, f0, fm1, pc_err, t = carry
        # y = y_n, y1 = y_{n-1}, …; f0 = f_n, f1 = f_{n-1}, fm1 = f_{n-2}
        tn = t + dt
        p = _lin((1.0, y3), (8 * dt / 3, f0), (-4 * dt / 3, f1),
                 (8 * dt / 3, fm1))
        m = _tree_map(lambda pp, ee: _plus_times(pp, -112.0 / 121.0, ee), p,
                      pc_err)
        c = corrector(y, y2, f(tn, m), f0, f1)
        for _ in range(corrector_iters - 1):
            c = corrector(y, y2, f(tn, c), f0, f1)
        err = _tree_map(lambda pp, cc: pp - cc, p, c)
        y_new = _tree_map(lambda cc, ee: _plus_times(cc, 9.0 / 121.0, ee), c,
                          err)
        f_new = f(tn, y_new)
        return (y2, y1, y, y_new, f0, f_new, f1, err, tn)

    zero = _tree_map(torch.zeros_like, y0)
    carry = (ys[0], ys[1], ys[2], ys[3], fs[2], fs[3], fs[1], zero,
             t + 3 * dt)
    return _loop(body, carry, n_steps - 3, graph_steps)[3]


def hamming_mod(f, y0, t0, dt, n_steps: int, graph_steps: int = 0):
    """Hamming's modified PC method (ref: pred_corr_integrators.hpp:542)."""
    return _hamming(f, y0, t0, dt, n_steps, 1, graph_steps)


def hamming_iter_mod(f, y0, t0, dt, n_steps: int, iters: int = 3,
                     graph_steps: int = 0):
    """Hamming's iterated modified PC (ref: pred_corr_integrators.hpp:821)."""
    return _hamming(f, y0, t0, dt, n_steps, iters, graph_steps)
