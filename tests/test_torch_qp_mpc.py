"""The port's dense QP solvers (reak_tpu_torch.ctrl.qp) and generic MPC
(ctrl.mpc: condense, build_qp, solve, receding_horizon) against the JAX
package on the same numpy inputs, f64 on the CPU, ≤1e-8 (relative to the
larger of the reference's largest entry and 1).

``solve`` runs on a damped pendulum written once per package (a nonlinear
plant that the JAX package linearizes op by op in seconds): both methods,
unconstrained, the continuous model with ``f_cont``/``dt``, a caller's
``linearizer``, tracking references, one and two SQP passes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import mpc as jmpc, qp as jqp, systems as jsys
from reak_tpu_torch.ctrl import mpc, qp, systems

torch.set_num_threads(1)
TOL = 1e-8
DT = 0.1


def _close(got, want, tol=TOL):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1.0)


def _rand_qp(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n), rng.standard_normal(n)


def test_box_qp_solvers():
    rng = np.random.default_rng(0)
    H, g = _rand_qp(rng, 8)
    lb, ub = np.full(8, -0.1), np.full(8, 0.05)
    t = lambda *a: [torch.as_tensor(v) for v in a]
    j = lambda *a: [jnp.asarray(v) for v in a]
    got = qp.solve_box_qp(*t(H, g, lb, ub), iters=20)
    want = jqp.solve_box_qp(*j(H, g, lb, ub), iters=20)
    _close(got.x, want.x)
    _close(got.gap, want.gap)
    assert int(got.iters) == int(want.iters) == 20
    # active bounds: the check means something
    assert np.sum(np.isclose(np.asarray(want.x), lb)
                  | np.isclose(np.asarray(want.x), ub)) > 0
    got = qp.solve_box_qp_pg(*t(H, g, lb, ub), iters=150)
    want = jqp.solve_box_qp_pg(*j(H, g, lb, ub), iters=150)
    _close(got.x, want.x)
    assert np.isnan(float(got.gap)) and np.isnan(float(want.gap))
    _close(qp.project_box(*t(5 * g, lb, ub)), jqp.project_box(*j(5 * g, lb,
                                                                  ub)))
    A, b = rng.standard_normal((3, 8)), rng.standard_normal(3)
    _close(qp.solve_eq_qp(*t(H, g, A, b)), jqp.solve_eq_qp(*j(H, g, A, b)))


def test_box_qp_batch():
    """Leading batch axes: each problem as alone."""
    rng = np.random.default_rng(1)
    Hs, gs = zip(*(_rand_qp(rng, 6) for _ in range(3)))
    H, g = np.stack(Hs), np.stack(gs)
    lb, ub = np.full(6, -0.2), np.full(6, 0.2)
    got = qp.solve_box_qp(*(torch.as_tensor(a) for a in (H, g, lb, ub)),
                          iters=15)
    for i in range(3):
        want = jqp.solve_box_qp(jnp.asarray(H[i]), jnp.asarray(g[i]),
                                jnp.asarray(lb), jnp.asarray(ub), iters=15)
        _close(got.x[i], want.x)
        _close(got.gap[i], want.gap)


def _pendulum(lib):
    """x = [θ, ω], u = torque: ω̇ = −sin θ − 0.1 ω + u; the discrete map is
    one explicit Euler step."""
    xp = torch if lib == "torch" else jnp
    stack = (lambda a: torch.stack(a, dim=-1)) if lib == "torch" else \
        (lambda a: jnp.stack(a, axis=-1))

    def f(x, u, t=0.0):
        return stack([x[..., 1], -xp.sin(x[..., 0]) - 0.1 * x[..., 1]
                      + u[..., 0]])

    def F(x, u, t=0.0):
        return x + DT * f(x, u)

    return f, F


def _problem(lib, H=10):
    a = torch.as_tensor if lib == "torch" else jnp.asarray
    mod = mpc if lib == "torch" else jmpc
    return mod.MPCProblem(Q=a(np.diag([10.0, 1.0])), R=a(np.eye(1) * 0.1),
                          QN=a(np.diag([50.0, 5.0])), u_min=a([-1.5]),
                          u_max=a([1.5]), horizon=H)


def test_condense_and_build_qp():
    rng = np.random.default_rng(2)
    H, n, m = 5, 3, 2
    A = np.eye(n) + 0.2 * rng.standard_normal((H, n, n))
    Bm = rng.standard_normal((H, n, m))
    c = 0.1 * rng.standard_normal((H, n))
    x0 = rng.standard_normal(n)
    xr, ur = rng.standard_normal((H, n)), rng.standard_normal((H, m))
    t = lambda *a: [torch.as_tensor(v) for v in a]
    j = lambda *a: [jnp.asarray(v) for v in a]
    got, want = mpc.condense(*t(A, Bm, c, x0)), jmpc.condense(*j(A, Bm, c, x0))
    _close(got, tuple(want))
    w = np.diag([2.0, 1.0, 0.5])
    kw = dict(Q=w, R=0.3 * np.eye(m), QN=5 * w, u_min=-np.ones(m),
              u_max=np.ones(m))
    p_t = mpc.MPCProblem(**{k: torch.as_tensor(v) for k, v in kw.items()},
                         horizon=H)
    p_j = jmpc.MPCProblem(**{k: jnp.asarray(v) for k, v in kw.items()},
                          horizon=H)
    _close(mpc.build_qp(p_t, *got, torch.as_tensor(x0)),
           tuple(jmpc.build_qp(p_j, *want, jnp.asarray(x0))))
    _close(mpc.build_qp(p_t, *got, *t(x0, xr, ur)),
           tuple(jmpc.build_qp(p_j, *want, *j(x0, xr, ur))))


MODES = {
    "riccati": dict(method="riccati"),
    "condensed": dict(method="condensed"),
    "unconstrained": dict(constrained=False),
    "series": dict(method="riccati", use_f_cont=True),
    "linearizer": dict(method="condensed", use_linearizer=True),
    "tracking": dict(method="riccati", track=True),
    "tracking_condensed": dict(method="condensed", track=True),
}


@pytest.mark.parametrize("sqp_iters", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_solve_every_mode(mode, sqp_iters):
    opts = dict(MODES[mode])
    use_f_cont = opts.pop("use_f_cont", False)
    use_lin = opts.pop("use_linearizer", False)
    track = opts.pop("track", False)
    H = 10
    x0 = np.array([1.2, -0.3])
    kw_t, kw_j = dict(opts), dict(opts)
    f_t, F_t = _pendulum("torch")
    f_j, F_j = _pendulum("jax")
    if use_f_cont:
        kw_t.update(f_cont=f_t, dt=DT)
        kw_j.update(f_cont=f_j, dt=DT)
    if use_lin:
        kw_t["linearizer"] = lambda xs, us: mpc.linearize_ltv_series(
            f_t, DT, xs, us, order=3)
        kw_j["linearizer"] = lambda xs, us: jmpc.linearize_ltv_series(
            f_j, DT, xs, us, order=3)
    if track:
        rng = np.random.default_rng(3)
        xr, ur = 0.2 * rng.standard_normal((H, 2)), \
            0.1 * rng.standard_normal((H, 1))
        kw_t.update(x_ref=torch.as_tensor(xr), u_ref=torch.as_tensor(ur))
        kw_j.update(x_ref=jnp.asarray(xr), u_ref=jnp.asarray(ur))
    u_init = 0.05 * np.ones((H, 1))
    got = mpc.solve(F_t, _problem("torch", H), torch.as_tensor(x0),
                    u_init=torch.as_tensor(u_init), qp_iters=12,
                    sqp_iters=sqp_iters, **kw_t)
    want = jmpc.solve(F_j, _problem("jax", H), jnp.asarray(x0),
                      u_init=jnp.asarray(u_init), qp_iters=12,
                      sqp_iters=sqp_iters, **kw_j)
    _close(got.u, want.u)
    _close(got.x, want.x)
    _close(got.qp.x, want.qp.x)
    assert int(mpc.solution_status(got, gap_tol=1.0)) == int(
        jmpc.solution_status(want, gap_tol=1.0))


def test_rollout_and_linearizations():
    rng = np.random.default_rng(4)
    f_t, F_t = _pendulum("torch")
    f_j, F_j = _pendulum("jax")
    x0, us = rng.standard_normal(2), rng.standard_normal((6, 1))
    xs = mpc.rollout_nominal(F_t, torch.as_tensor(x0), torch.as_tensor(us))
    _close(xs, jmpc.rollout_nominal(F_j, jnp.asarray(x0), jnp.asarray(us)))
    _close(mpc.linearize_ltv(F_t, xs, torch.as_tensor(us)),
           tuple(jmpc.linearize_ltv(F_j, jnp.asarray(xs.numpy()),
                                    jnp.asarray(us))))
    _close(mpc.linearize_ltv_series(f_t, DT, xs, torch.as_tensor(us)),
           tuple(jmpc.linearize_ltv_series(f_j, DT, jnp.asarray(xs.numpy()),
                                           jnp.asarray(us))))


def _double_integrator(lib):
    a = torch.as_tensor if lib == "torch" else jnp.asarray
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    Bm = np.array([[0.005], [0.1]])
    sysmod = systems if lib == "torch" else jsys
    mod = mpc if lib == "torch" else jmpc
    prob = mod.MPCProblem(Q=a(np.eye(2)), R=a(np.eye(1) * 0.1),
                          QN=a(np.eye(2) * 10), u_min=a([-2.0]),
                          u_max=a([2.0]), horizon=15)
    return sysmod.lti_discrete(a(A), a(Bm)), prob


def test_receding_horizon_stabilizes():
    """tests/test_qp_mpc.py:143-156 on both packages: the same closed loop
    (≤1e-8) and ‖x₈₀‖ < 1e-2."""
    F_t, p_t = _double_integrator("torch")
    F_j, p_j = _double_integrator("jax")
    xs, us = mpc.receding_horizon(F_t, p_t, torch.tensor([1.5, 0.0],
                                                         dtype=torch.float64),
                                  80, qp_iters=12)
    jxs, jus = jmpc.receding_horizon(F_j, p_j, jnp.array([1.5, 0.0]), 80,
                                     qp_iters=12)
    _close(xs, jxs)
    _close(us, jus)
    assert float(torch.linalg.vector_norm(xs[-1])) < 1e-2
