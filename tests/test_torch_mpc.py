"""The whole slice: the port's make_kte_mpc (reak_tpu_torch.ctrl.mpc) against
the JAX package's make_kte_mpc on the 6-DoF arm, H=3, B=4, 8 Mehrotra
iterations, f64 on the CPU, regulator and tracking.  Bar: ≤1e-8 absolute on
the controls and the predicted states.  The multi-pass SQP with its line
search is held to the JAX package in tests/test_torch_sqp.py."""
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
from reak_tpu_torch.ops import kte_step, pdip_whole

torch.set_num_threads(1)

H, B = 3, 4


def _jax_problem(H=H):
    w = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
    return jmpc.MPCProblem(Q=jnp.diag(jnp.asarray(w)), R=jnp.eye(6) * 0.05,
                           QN=jnp.diag(jnp.asarray(5.0 * w)),
                           u_min=jnp.full(6, -8.0), u_max=jnp.full(6, 8.0),
                           horizon=H)


def _port(prob_j):
    return (convert.spec_from(jmodels.manip_3r3r()),
            convert.problem_from(prob_j, "cpu", torch.float64))


@functools.lru_cache(maxsize=None)
def _jitted(factory, *args):
    return jax.jit(factory(*args))


_JITTED_QP = jax.jit(jriccati_soa.solve_box_mpc_riccati_soa_fused,
                     static_argnames=("iters", "use_kernels"))


@pytest.fixture
def jax_jitted_parts(monkeypatch):
    """The JAX make_kte_mpc with its rollouts and QP jitted once per
    configuration: run eagerly, it compiles every scan again on each call,
    so both cases below compiled the same rollout and QP scans."""
    ltv, nom = jlanes.make_rollout_ltv_lanes, jlanes.make_rollout_lanes
    monkeypatch.setattr(jlanes, "make_rollout_ltv_lanes",
                        lambda *a: _jitted(ltv, *a))
    monkeypatch.setattr(jlanes, "make_rollout_lanes",
                        lambda *a: _jitted(nom, *a))
    monkeypatch.setattr(jriccati_soa, "solve_box_mpc_riccati_soa_fused",
                        _JITTED_QP)


@pytest.mark.parametrize("tracking", [False, True],
                         ids=["regulator", "tracking"])
def test_make_kte_mpc_matches_jax(rng, tracking, jax_jitted_parts):
    x0 = np.concatenate([rng.uniform(-0.5, 0.5, (B, 6)),
                         rng.uniform(-0.2, 0.2, (B, 6))], axis=1)
    u0 = rng.uniform(-1.0, 1.0, (B, H, 6))
    refs = {}
    if tracking:
        refs = dict(x_ref=0.1 * rng.standard_normal((B, H, 12)),
                    u_ref=0.5 * rng.standard_normal((H, 6)))
    prob_j = _jax_problem()
    solve_j = jmpc.make_kte_mpc(jmodels.manip_3r3r(), prob_j, 0.01,
                                qp_iters=8, sqp_iters=1)
    us_j, xs_j = solve_j(jnp.asarray(x0), jnp.asarray(u0),
                         **{k: jnp.asarray(v) for k, v in refs.items()})
    spec, prob = _port(prob_j)
    launches = (kte_step.launches, pdip_whole.launches)
    us_t, xs_t = mpc.make_kte_mpc(spec, prob, 0.01, qp_iters=8, sqp_iters=1)(
        torch.as_tensor(x0), torch.as_tensor(u0),
        **{k: torch.as_tensor(v) for k, v in refs.items()})
    assert us_t.shape == (B, H, 6) and xs_t.shape == (B, H, 12)
    assert np.max(np.abs(us_t.numpy() - np.asarray(us_j))) <= 1e-8
    assert np.max(np.abs(xs_t.numpy() - np.asarray(xs_j))) <= 1e-8
    # CPU tensors never launch a kernel
    assert (kte_step.launches, pdip_whole.launches) == launches


def test_fused_rollout_option_is_plain_on_cpu(rng):
    """rollout="fused" goes through the step kernel's wrapper, which on CPU
    tensors is the plain step: the same solve as rollout="lanes"."""
    spec, prob = _port(_jax_problem())
    x0 = torch.as_tensor(rng.uniform(-0.3, 0.3, (2, 12)))
    u0 = torch.zeros(2, H, 6, dtype=torch.float64)
    a = mpc.make_kte_mpc(spec, prob, 0.01, rollout="fused")(x0, u0)
    b = mpc.make_kte_mpc(spec, prob, 0.01, rollout="lanes")(x0, u0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(qp_layout="vmap"),
                                dict(rollout="register")],
                         ids=["vmap", "register"])
def test_unported_options_raise(rng, kw):
    """The two options that the port refused before they were ported now
    build and solve on CPU tensors, with no kernel launch, on the 6-DoF
    arm: finite controls inside the box and states of the right shape (the
    second branch's values are held to the JAX solver in
    tests/test_torch_mpc_layouts.py)."""
    spec, prob = _port(_jax_problem())
    x0 = torch.as_tensor(np.concatenate([rng.uniform(-0.5, 0.5, (2, 6)),
                                         rng.uniform(-0.2, 0.2, (2, 6))],
                                        axis=1))
    u0 = torch.zeros(2, H, 6, dtype=torch.float64)
    launches = (kte_step.launches, pdip_whole.launches)
    us, xs = mpc.make_kte_mpc(spec, prob, 0.01, **kw)(x0, u0)
    assert (kte_step.launches, pdip_whole.launches) == launches
    assert us.shape == (2, H, 6) and xs.shape == (2, H, 12)
    assert bool(torch.isfinite(us).all()) and bool(torch.isfinite(xs).all())
    assert float(us.abs().max()) <= 8.0 + 1e-12


@pytest.mark.parametrize("ref", [
    np.zeros(11), np.zeros((H, 13)), np.zeros((B, H, 6)), np.zeros((H + 1, 12)),
    np.zeros((B, H - 1, 12))], ids=["1d", "2d", "3d", "2d-horizon",
                                    "3d-horizon"])
def test_x_ref_of_wrong_shape_raises(ref):
    """Fault F4 of the JAX package (to_lanes never checks the width) is
    repaired in the port."""
    spec, prob = _port(_jax_problem())
    solve = mpc.make_kte_mpc(spec, prob, 0.01)
    x0 = torch.zeros(B, 12, dtype=torch.float64)
    u0 = torch.zeros(B, H, 6, dtype=torch.float64)
    with pytest.raises(ValueError):
        solve(x0, u0, x_ref=torch.as_tensor(ref))


def test_to_lanes_shapes():
    f = lambda r: mpc.to_lanes(torch.as_tensor(r), 2, 3, torch.float64, "cpu")
    assert f(np.ones(2)).shape == (3, 2, 1)
    assert f(np.ones((3, 2))).shape == (3, 2, 1)
    r = np.arange(24.0).reshape(4, 3, 2)
    np.testing.assert_array_equal(f(r).numpy(), np.moveaxis(r, 0, -1))
    assert mpc.to_lanes(None, 2, 3, torch.float64, "cpu") is None
    with pytest.raises(ValueError):
        f(np.ones(3))  # u_ref of width 3 for m = 2
