"""The multi-pass SQP of the port's make_kte_mpc (reak_tpu_torch.ctrl.mpc)
against the JAX package's make_kte_mpc on the 6-DoF arm, H=3, B=4, 8
Mehrotra iterations, f64 on the CPU: two or three passes, with and without
the line search, whose RK4 pricing rollout (kte/lanes.make_rollout_lanes)
is held to the JAX one on its own.  Bars: ≤1e-11 relative for the rollout,
≤1e-8 absolute on the controls and the states.

The JAX package's rollouts and QP are jitted once each here (its
make_kte_mpc runs them eagerly otherwise, which compiles every scan again on
each call and takes minutes)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import mpc as jmpc, riccati_soa as jriccati_soa
from reak_tpu.kte import lanes as jlanes, models as jmodels
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import mpc
from reak_tpu_torch.kte import lanes, models
from reak_tpu_torch.ops import chol_lanes

torch.set_num_threads(1)

H, B = 3, 4


def _jax_problem():
    w = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
    return jmpc.MPCProblem(Q=jnp.diag(jnp.asarray(w)), R=jnp.eye(6) * 0.05,
                           QN=jnp.diag(jnp.asarray(5.0 * w)),
                           u_min=jnp.full(6, -8.0), u_max=jnp.full(6, 8.0),
                           horizon=H)


def _states(rng, B=B):
    return np.concatenate([rng.uniform(-0.5, 0.5, (B, 6)),
                           rng.uniform(-0.2, 0.2, (B, 6))], axis=1)


def test_rk4_rollout_matches_jax(rng):
    """The JAX rollout compiled here is the one the line-search passes
    below reuse."""
    x0, ul = _states(rng), rng.uniform(-2.0, 2.0, (H, 6, B))
    want = _jitted(jlanes.make_rollout_lanes, _SPEC_J, 0.01)(
        jnp.asarray(x0), jnp.asarray(ul))
    before = dict(chol_lanes.launches)
    got = lanes.make_rollout_lanes(models.manip_3r3r(), 0.01)(
        torch.as_tensor(x0), torch.as_tensor(ul)).numpy()
    assert got.shape == (H, 12, B)
    assert np.max(np.abs(got - np.asarray(want))) \
        <= 1e-11 * np.max(np.abs(np.asarray(want)))
    assert chol_lanes.launches == before


@functools.lru_cache(maxsize=None)
def _jitted(factory, *args):
    return jax.jit(factory(*args))


@pytest.fixture
def jax_jitted_parts(monkeypatch):
    """The JAX make_kte_mpc with its rollouts and QP jitted once per
    configuration (the same functions, compiled instead of traced eagerly
    on every call)."""
    ltv, nom = jlanes.make_rollout_ltv_lanes, jlanes.make_rollout_lanes
    monkeypatch.setattr(jlanes, "make_rollout_ltv_lanes",
                        lambda *a: _jitted(ltv, *a))
    monkeypatch.setattr(jlanes, "make_rollout_lanes",
                        lambda *a: _jitted(nom, *a))
    monkeypatch.setattr(jriccati_soa, "solve_box_mpc_riccati_soa_fused",
                        _JITTED_QP)


_JITTED_QP = jax.jit(jriccati_soa.solve_box_mpc_riccati_soa_fused,
                     static_argnames=("iters", "use_kernels"))
_SPEC_J = jmodels.manip_3r3r()


@pytest.mark.parametrize("sqp_iters", [2, 3])
@pytest.mark.parametrize("linesearch", [True, False],
                         ids=["line-search", "full-step"])
def test_multipass_sqp_matches_jax(rng, jax_jitted_parts, sqp_iters,
                                   linesearch):
    x0, u0 = _states(rng), rng.uniform(-1.0, 1.0, (B, H, 6))
    prob_j = _jax_problem()
    us_j, xs_j = jmpc.make_kte_mpc(
        _SPEC_J, prob_j, 0.01, qp_iters=8, sqp_iters=sqp_iters,
        sqp_linesearch=linesearch)(jnp.asarray(x0), jnp.asarray(u0))
    spec = convert.spec_from(_SPEC_J)
    prob = convert.problem_from(prob_j, "cpu", torch.float64)
    us_t, xs_t = mpc.make_kte_mpc(
        spec, prob, 0.01, qp_iters=8, sqp_iters=sqp_iters,
        sqp_linesearch=linesearch)(torch.as_tensor(x0), torch.as_tensor(u0))
    assert np.max(np.abs(us_t.numpy() - np.asarray(us_j))) <= 1e-8
    assert np.max(np.abs(xs_t.numpy() - np.asarray(xs_j))) <= 1e-8

