"""Fixed-step integrators (port of ``reak_tpu/integrators/fixed.py``; ref:
core/integrators/fixed_step_integrators.hpp:61-307).

Steppers take ``f(t, y) → ẏ`` (y a tensor or a tree of them: dict, list,
tuple or NamedTuple) and compose into rollouts through a Python loop (a
``lax.scan`` in JAX).  RK5 uses the 6-stage Butcher tableau of the
reference's ``runge_kutta5_integrator`` (Fehlberg's 5th-order stages).

Time is a 0-dim tensor of the state's type on its device: ``t0 + k·dt``
in that type (JAX's follows its x64 flag, which the tests turn on).
``unroll`` is accepted and ignored: it tunes XLA's scan and means nothing
to an eager loop.  ``graph_steps`` (the port's own) runs the loop on CUDA
tensors in chunks of that many steps, each chunk replayed from a CUDA graph
(``ops/graphs.graphed``); ``f`` must then make no tensor from host memory.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.ops import graphs


# ---------------------------------------------------------------------------
# trees of tensors: dict, list, tuple and NamedTuple nodes, as JAX pytrees
# ---------------------------------------------------------------------------


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, tree[k], *(r[k] for r in rest)))
                          for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    """The leaves in JAX's order (a dict's by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in the order of
    ``_tree_leaves``)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return type(t)((k, built[k]) for k in t)
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def _time(t, y):
    """``t`` as a 0-dim tensor of the type and device of y's first leaf."""
    leaf = _tree_leaves(y)[0]
    return torch.as_tensor(t, dtype=leaf.dtype, device=leaf.device)


def _on_card(leaf) -> bool:
    """Whether a loop over ``leaf`` is replayed from CUDA graphs."""
    return leaf.is_cuda


def _loop(body, carry, n: int, graph_steps: int = 0, keep=None):
    """``carry = body(carry)`` n times; with ``keep``, also the list of
    ``keep(carry)`` after each step.  On CUDA tensors with ``graph_steps``
    > 0, whole chunks of that many steps are replayed from one CUDA graph
    (captured at the first chunk) and the rest run eagerly; the values are
    those of the eager loop."""
    kept = []
    leaves = _tree_leaves(carry)
    if graph_steps > 0 and _on_card(leaves[0]) and n >= graph_steps:
        n_carry = len(leaves)
        template = None if keep is None else keep(carry)

        def chunk(*ls):
            c = _tree_unflatten(carry, ls)
            out = []
            for _ in range(graph_steps):
                c = body(c)
                if keep is not None:
                    out += _tree_leaves(keep(c))
            return tuple(_tree_leaves(c)) + tuple(out)

        run = graphs.graphed(chunk)
        for _ in range(n // graph_steps):
            res = run(*leaves)
            leaves = res[:n_carry]
            if keep is not None:
                per = (len(res) - n_carry) // graph_steps
                kept += [_tree_unflatten(template, res[k:k + per])
                         for k in range(n_carry, len(res), per)]
        carry = _tree_unflatten(carry, leaves)
        n = n % graph_steps
    for _ in range(n):
        carry = body(carry)
        if keep is not None:
            kept.append(keep(carry))
    return (carry, kept) if keep is not None else carry


# ---------------------------------------------------------------------------
# steppers
# ---------------------------------------------------------------------------


def _plus_times(x, a, k):
    """x + a·k: one fused operation where ``a`` is a Python number (a CUDA
    graph replays each operation as a launch), else a product and a sum."""
    if isinstance(a, (int, float)):
        return torch.add(x, k, alpha=a)
    return x + a * k


def _axpy(y, a, k):
    return _tree_map(lambda yy, kk: _plus_times(yy, a, kk), y, k)


def _lc(y, *coeff_k):
    """y + Σ aᵢ kᵢ over trees."""
    out = y
    for a, k in coeff_k:
        out = _tree_map(lambda oo, kk: _plus_times(oo, a, kk), out, k)
    return out


def euler_step(f, t, y, dt):
    """(ref: fixed_step_integrators.hpp:61 euler_integrator)"""
    return _axpy(y, dt, f(t, y))


def midpoint_step(f, t, y, dt):
    """(ref: fixed_step_integrators.hpp:133 midpoint_integrator)"""
    k1 = f(t, y)
    return _axpy(y, dt, f(t + 0.5 * dt, _axpy(y, 0.5 * dt, k1)))


def rk4_step(f, t, y, dt):
    """(ref: fixed_step_integrators.hpp:213 runge_kutta4_integrator)"""
    k1 = f(t, y)
    k2 = f(t + 0.5 * dt, _axpy(y, 0.5 * dt, k1))
    k3 = f(t + 0.5 * dt, _axpy(y, 0.5 * dt, k2))
    k4 = f(t + dt, _axpy(y, dt, k3))
    return _tree_map(
        lambda yy, a, b, c, d: yy + dt / 6.0 * (a + 2 * b + 2 * c + d),
        y, k1, k2, k3, k4)


def rk5_step(f, t, y, dt):
    """5th-order Runge-Kutta (Fehlberg stages, ref:
    fixed_step_integrators.hpp:307 runge_kutta5_integrator)."""
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
    return _lc(
        y,
        (16 * dt / 135, k1),
        (6656 * dt / 12825, k3),
        (28561 * dt / 56430, k4),
        (-9 * dt / 50, k5),
        (2 * dt / 55, k6),
    )


STEPPERS = {
    "euler": euler_step,
    "midpoint": midpoint_step,
    "rk4": rk4_step,
    "rk5": rk5_step,
}


def integrate(f, y0, t0, dt, n_steps: int, method="rk4", unroll: int = 1,
              graph_steps: int = 0):
    """Integrate to t0 + n_steps·dt; returns the final state
    (the ``integrator::integrate(aEndTime)`` contract, ref
    integrator.hpp:153)."""
    step = STEPPERS[method] if isinstance(method, str) else method

    def body(carry):
        t, y = carry
        return t + dt, step(f, t, y, dt)

    _, yf = _loop(body, (_time(t0, y0), y0), n_steps, graph_steps)
    return yf


def rollout(f, y0, t0, dt, n_steps: int, method="rk4", unroll: int = 1,
            graph_steps: int = 0):
    """Integrate and keep the whole trajectory: returns the tree stacked
    over time (x_1 … x_n)."""
    step = STEPPERS[method] if isinstance(method, str) else method

    def body(carry):
        t, y = carry
        return t + dt, step(f, t, y, dt)

    _, ys = _loop(body, (_time(t0, y0), y0), n_steps, graph_steps,
                  keep=lambda carry: carry[1])
    return _tree_map(lambda *xs: torch.stack(xs), *ys)
