"""The port's error-state MPC on manifolds (reak_tpu_torch.ctrl.
mpc_manifold) against the JAX package on the same numpy inputs, f64 on the
CPU, ≤1e-8 (relative to the larger of the reference's largest entry and 1):
the rollout, the jacfwd linearization and ``solve_manifold`` on the
satellite; ``make_scenario_mpc`` at B = 4 in one batch-first call against
the JAX package's vmap; both branches of ``make_kte_scenario_mpc``;
``_retract_draws`` on the JAX package's own draws (≤1e-12); and
``sample_belief_states``, whose draws come from a ``torch.Generator``: the
same seed gives the same states, and 20,000 tangent draws have the
belief's mean and covariance within 4σ.  The satellite's JAX references run
under ``jax.jit`` (one compile takes less time than the op-by-op run); so
do both branches of ``make_kte_scenario_mpc`` on their small chains (run
eagerly, each rollout compiled its scan again); the other chains' run op
by op (a jitted KTE rollout of the 6-DoF arm compiles for minutes)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from reak_tpu.ctrl import (belief as jbel, mpc as jmpc, mpc_manifold as jmm,
                           ss_systems as jss)
from reak_tpu.kte import models as jmodels
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import belief as bel, mpc, mpc_manifold as mm, \
    ss_systems as ss
from reak_tpu_torch.ops import chol_lanes

torch.set_num_threads(1)
DT = 0.1


def _close(got, want, tol=1e-8):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1.0)


def _sat(H):
    """The satellite of bench.py:232-250 on both packages."""
    inertia = np.diag([4.0, 5.0, 6.0])
    w = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
    kw = dict(Q=np.diag(w), R=np.eye(6) * 0.05, QN=np.diag(10.0 * w),
              u_min=np.full(6, -20.0), u_max=np.full(6, 20.0))
    p_t = mpc.MPCProblem(**{k: torch.as_tensor(v) for k, v in kw.items()},
                         horizon=H)
    p_j = jmpc.MPCProblem(**{k: jnp.asarray(v) for k, v in kw.items()},
                          horizon=H)
    F_t = ss.satellite3D_imdt(ss.satellite3D(10.0, inertia), DT)
    F_j = jss.satellite3D_imdt(jss.satellite3D(10.0, jnp.asarray(inertia)),
                               DT)
    x_ref = np.asarray(jss.default_state().at[0:3].set(
        jnp.array([1.0, 0.5, -0.3])))
    return (F_t, ss.sat3D_retraction(), p_t), \
        (F_j, jss.sat3D_retraction(), p_j), x_ref


def _states(rng, B):
    q = rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([0.5 * rng.standard_normal((B, 3)), q,
                           0.2 * rng.standard_normal((B, 3)),
                           0.3 * rng.standard_normal((B, 3))], axis=1)


def test_rollout_and_linearization():
    (F_t, ret_t, _), (F_j, ret_j, _), _ = _sat(3)
    rng = np.random.default_rng(0)
    x0, us = _states(rng, 2), rng.uniform(-5, 5, (2, 3, 6))
    xs = mm.rollout_manifold(F_t, torch.as_tensor(x0), torch.as_tensor(us))
    xs_j = jax.jit(jax.vmap(lambda a, b: jmm.rollout_manifold(F_j, a, b)))(
        jnp.asarray(x0), jnp.asarray(us))
    _close(xs, xs_j, tol=1e-12)
    _close(mm.rollout_manifold(F_t, torch.as_tensor(x0[0]),
                               torch.as_tensor(us[0])), xs_j[0], tol=1e-12)
    xs_prev = np.concatenate([x0[:, None], np.asarray(xs_j)[:, :-1]], axis=1)
    got = mm.linearize_ltv_manifold(F_t, ret_t, torch.as_tensor(xs_prev),
                                    torch.as_tensor(us), xs)
    want = jax.jit(jax.vmap(lambda a, b, c: jmm.linearize_ltv_manifold(
        F_j, ret_j, a, b, c)))(jnp.asarray(xs_prev), jnp.asarray(us), xs_j)
    _close(got, tuple(want), tol=1e-10)


def test_solve_manifold_one_scenario():
    H = 4
    (F_t, ret_t, p_t), (F_j, ret_j, p_j), x_ref = _sat(H)
    x0 = _states(np.random.default_rng(1), 1)[0]
    got = mm.solve_manifold(F_t, ret_t, p_t, torch.as_tensor(x0),
                            torch.as_tensor(x_ref), qp_iters=6, sqp_iters=2)
    want = jax.jit(lambda a, b: jmm.solve_manifold(
        F_j, ret_j, p_j, a, b, qp_iters=6, sqp_iters=2))(
        jnp.asarray(x0), jnp.asarray(x_ref))
    _close(tuple(got), tuple(want))


def test_make_scenario_mpc_is_batch_first(monkeypatch):
    """B = 4 scenarios in one call: the JAX package's vmap of the
    single-scenario solve, and each Riccati stage one batched SPD solve
    (``chol_solve_auto``, K3a/K3b on CUDA tensors) over all four — 2 per
    stage and iteration with one right-hand side, 1 with several."""
    H, B, it, sqp = 4, 4, 5, 2
    (F_t, ret_t, p_t), (F_j, ret_j, p_j), x_ref = _sat(H)
    x0s = _states(np.random.default_rng(2), B)
    us0 = np.zeros((B, H, 6))
    batches = []
    real = chol_lanes.chol_solve_auto

    def counted(G, rhs):
        batches.append((tuple(G.shape[:-2]), rhs.ndim == G.ndim - 1
                        or rhs.shape[-1] == 1))
        return real(G, rhs)

    from reak_tpu_torch.ctrl import riccati
    monkeypatch.setattr(riccati, "chol_solve_auto", counted)
    got = mm.make_scenario_mpc(F_t, ret_t, p_t, qp_iters=it, sqp_iters=sqp)(
        torch.as_tensor(x0s), torch.as_tensor(x_ref), torch.as_tensor(us0))
    want = jax.jit(jmm.make_scenario_mpc(F_j, ret_j, p_j, qp_iters=it,
                                         sqp_iters=sqp))(
        jnp.asarray(x0s), jnp.asarray(x_ref), jnp.asarray(us0))
    _close(got, tuple(want))
    assert all(shape == (B,) for shape, _ in batches)
    assert sum(one for _, one in batches) == 2 * sqp * it * H
    assert sum(not one for _, one in batches) == sqp * it * H


def test_make_kte_scenario_mpc_both_branches():
    """A fixed base (planar_2link) routes to ``make_kte_mpc`` tracking
    x_ref, a free base (free_floating_3d) to the lanes error-state SQP;
    each against the JAX package's dispatcher."""
    H = 3
    rng = np.random.default_rng(3)
    for name, m, sqp, dt in (("planar_2link", 2, 1, 0.02),
                             ("free_floating_3d", 6, 2, 0.05)):
        j = getattr(jmodels, name)()
        s = convert.spec_from(j)
        nv = s.nv
        w = np.concatenate([np.full(nv, 5.0), np.full(nv, 0.5)])
        kw = dict(Q=np.diag(w), R=np.eye(m) * 0.05, QN=np.diag(10.0 * w),
                  u_min=np.full(m, -30.0), u_max=np.full(m, 30.0))
        p_t = mpc.MPCProblem(**{k: torch.as_tensor(v) for k, v in kw.items()},
                             horizon=H)
        p_j = jmpc.MPCProblem(**{k: jnp.asarray(v) for k, v in kw.items()},
                              horizon=H)
        x0s = np.zeros((2, s.nq + nv))
        x_ref = np.zeros(s.nq + nv)
        if s.has_free_base:
            x0s[:, 3] = x_ref[3] = 1.0
            x0s[:, 0] = [0.2, -0.1]
        else:
            x0s += 0.2 * rng.standard_normal(x0s.shape)
            x_ref[0] = 0.3
        us0 = np.zeros((2, H, m))
        got = mm.make_kte_scenario_mpc(s, p_t, dt, qp_iters=6,
                                       sqp_iters=sqp)(
            *(torch.as_tensor(a) for a in (x0s, x_ref, us0)))
        want = jax.jit(jmm.make_kte_scenario_mpc(j, p_j, dt, qp_iters=6,
                                                 sqp_iters=sqp))(
            *(jnp.asarray(a) for a in (x0s, x_ref, us0)))
        _close(got, tuple(want))


def _belief(rng):
    g = rng.standard_normal((12, 12))
    mean = np.asarray(jss.default_state().at[0:3].set(
        jnp.array([0.1, -0.2, 0.3])))
    return mean, 0.01 * (g @ g.T) / 12 + 0.02 * np.eye(12)


def test_retract_draws_on_jax_draws():
    """The JAX package's own draws (its fold_in stream) through
    ``_retract_draws``: its ``sample_belief_states`` within 1e-12, with and
    without a retraction."""
    mean, cov = _belief(np.random.default_rng(4))
    key = jax.random.PRNGKey(11)
    n = 9
    z = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(key, i),
                                             (12,), jnp.float64))(
        jnp.arange(n))
    b_t = bel.GaussianBelief(torch.as_tensor(mean), torch.as_tensor(cov))
    b_j = jbel.GaussianBelief(jnp.asarray(mean), jnp.asarray(cov))
    ret_t, ret_j = ss.sat3D_retraction(), jss.sat3D_retraction()
    _close(mm._retract_draws(b_t, torch.as_tensor(np.asarray(z)), ret_t),
           jmm.sample_belief_states(key, b_j, n, ret_j), tol=1e-12)
    b12 = bel.GaussianBelief(torch.as_tensor(mean[:12]), b_t.cov)
    _close(mm._retract_draws(b12, torch.as_tensor(np.asarray(z)), None),
           jmm.sample_belief_states(key, jbel.GaussianBelief(
               jnp.asarray(mean[:12]), jnp.asarray(cov)), n), tol=1e-12)


def test_sample_belief_states_from_a_generator():
    mean, cov = _belief(np.random.default_rng(5))
    b = bel.GaussianBelief(torch.as_tensor(mean), torch.as_tensor(cov))
    ret = ss.sat3D_retraction()
    draw = lambda seed, n: mm.sample_belief_states(
        torch.Generator().manual_seed(seed), b, n, ret)
    x1, x2 = draw(0, 20000), draw(0, 20000)
    assert torch.equal(x1, x2)
    assert not torch.equal(draw(1, 5), x1[:5])
    assert x1.shape == (20000, 13)
    assert float((torch.linalg.vector_norm(x1[:, 3:7], dim=1) - 1).abs()
                 .max()) <= 1e-12
    # the tangent draws about the mean: mean 0 and covariance cov, each
    # entry within 4σ of its sampling distribution
    e = ret.local(x1, b.mean).numpy()
    n = e.shape[0]
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(e.mean(0)) <= 4 * sd / np.sqrt(n))
    emp = np.cov(e, rowvar=False)
    se = np.sqrt((cov ** 2 + np.outer(np.diag(cov), np.diag(cov))) / n)
    assert np.all(np.abs(emp - cov) <= 4 * se)


def test_belief_scenario_mpc():
    """The config-4 composition in one call: its states are
    ``sample_belief_states``' with the same generator seed, and its
    solution is ``make_scenario_mpc``'s on them."""
    H = 4
    (F_t, ret_t, p_t), _, x_ref = _sat(H)
    mean, cov = _belief(np.random.default_rng(6))
    b = bel.GaussianBelief(torch.as_tensor(mean), torch.as_tensor(cov))
    x0s, us, xs = mm.belief_scenario_mpc(
        torch.Generator().manual_seed(3), F_t, ret_t, p_t, b, 3,
        torch.as_tensor(x_ref), qp_iters=6, sqp_iters=2)
    assert torch.equal(x0s, mm.sample_belief_states(
        torch.Generator().manual_seed(3), b, 3, ret_t))
    want = mm.make_scenario_mpc(F_t, ret_t, p_t, qp_iters=6, sqp_iters=2)(
        x0s, torch.as_tensor(x_ref), torch.zeros(3, H, 6, dtype=torch.float64))
    assert torch.equal(us, want[0]) and torch.equal(xs, want[1])
    assert us.shape == (3, H, 6) and xs.shape == (3, H, 13)
