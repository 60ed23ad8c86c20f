"""The port's free-base scenario MPC (reak_tpu_torch.ctrl.manifold_lanes and
ss_systems) against the JAX package on the same numpy inputs, f64 on the
CPU: the satellite's lanes step and error-state LTV and the tangent map
``quat_local_lanes`` (≤1e-12), and the whole scenario solve (≤1e-8 on u and
xs) for the satellite, on the whole-solve and on the per-pass path, and for
the floating arm.

The floating arm runs with a 2-link arm, and the JAX solver reaches the
chain's step and linearization through host callbacks into their own
jitted JAX functions, so the solver compiles in seconds instead of
minutes; every number still comes from the JAX package's code."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_host import host_manifold_lanes
from reak_tpu.ctrl import manifold_lanes as jml, mpc as jmpc, ss_systems as jss
from reak_tpu.kte import models as jmodels
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import manifold_lanes as ml, ss_systems
from reak_tpu_torch.kte import lanes
from reak_tpu_torch.ops import chol_lanes, pdip_whole, riccati_bwd

torch.set_num_threads(1)


def _sat_params():
    """bench.py:234-235."""
    return jss.satellite3D(mass=10.0,
                           inertia=jnp.diag(jnp.asarray([4.0, 5.0, 6.0])))


def _sat_problem(H):
    """bench.py:237-240."""
    w = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
    return jmpc.MPCProblem(Q=jnp.diag(jnp.asarray(w)), R=jnp.eye(6) * 0.05,
                           QN=jnp.diag(jnp.asarray(10.0 * w)),
                           u_min=jnp.full(6, -20.0), u_max=jnp.full(6, 20.0),
                           horizon=H)


def _sat_states(rng, B):
    """(B, 13): p, a random unit quaternion, v, ω."""
    q = rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([0.5 * rng.standard_normal((B, 3)), q,
                           0.2 * rng.standard_normal((B, 3)),
                           0.3 * rng.standard_normal((B, 3))], axis=1)


def _max_abs(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want))


def test_satellite_from_carries_bench_parameters():
    p_j = _sat_params()
    p_t = convert.satellite_from(p_j)
    assert p_t.mass.dtype == torch.float64 and float(p_t.mass) == 10.0
    np.testing.assert_array_equal(p_t.inertia.numpy(), np.asarray(p_j.inertia))
    x = ss_systems.default_state(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jss.default_state()))
    assert ss_systems.default_state(n_aug=2, device="cpu").shape == (15,)


def test_default_state_lands_on_the_card():
    """Fault F8, repaired: like the JAX function, which lands on the
    default accelerator, ``default_state`` makes a CUDA tensor unless
    ``device`` says otherwise, with no fall back to the CPU where there is
    no card."""
    import inspect

    default = inspect.signature(ss_systems.default_state).parameters[
        "device"].default
    assert torch.device(default).type == "cuda"
    if torch.cuda.is_available():
        assert ss_systems.default_state().is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ss_systems.default_state()


def test_sat_step_and_ltv_match_jax(rng):
    B = 6
    x, u = _sat_states(rng, B).T, 5.0 * rng.standard_normal((6, B))
    p_j = _sat_params()
    p_t = convert.satellite_from(p_j)
    xj, uj, xt, ut = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), \
        torch.as_tensor(u)
    assert _max_abs(ml.sat_step_lanes(p_t, 0.1)(xt, ut),
                    jml.sat_step_lanes(p_j, 0.1)(xj, uj)) <= 1e-12
    for got, want in zip(ml.sat_error_ltv_lanes(p_t, 0.1)(xt, ut),
                         jml.sat_error_ltv_lanes(p_j, 0.1)(xj, uj)):
        assert _max_abs(got, want) <= 1e-12


def test_quat_local_lanes_matches_jax(rng):
    x1 = _sat_states(rng, 5).T
    x0 = _sat_states(rng, 5).T
    x1[:, 0] = x0[:, 0]  # the identity rotation: the series branch
    for a, b in ((x1, x0), (x1[None], x0[None])):
        assert _max_abs(ml.quat_local_lanes(torch.as_tensor(a),
                                            torch.as_tensor(b)),
                        jml.quat_local_lanes(jnp.asarray(a),
                                             jnp.asarray(b))) <= 1e-12


@pytest.fixture(scope="module")
def sat_case():
    """The small satellite problem (B=4, H=5, numpy seed 42) and the JAX
    package's solve of it on its scan (``use_kernels="never"``), jitted
    (one compile takes less time than the op-by-op run) and run once for
    the tests that share it."""
    rng = np.random.default_rng(42)
    B, H = 4, 5
    x0, u0 = _sat_states(rng, B), rng.uniform(-1.0, 1.0, (B, H, 6))
    x_ref = np.array(jss.default_state().at[0:3].set(
        jnp.asarray([1.0, 0.5, -0.3])))
    p_j, prob_j = _sat_params(), _sat_problem(H)
    us_j, xs_j = jax.jit(jml.make_sat_scenario_mpc_lanes(
        p_j, prob_j, 0.1, qp_iters=8, sqp_iters=2, use_kernels="never"))(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u0))
    return dict(x0=x0, u0=u0, x_ref=x_ref, params=p_j, prob=prob_j,
                us=np.asarray(us_j), xs=np.asarray(xs_j))


def _sat_solve_port(case, **kw):
    return ml.make_sat_scenario_mpc_lanes(
        convert.satellite_from(case["params"]),
        convert.problem_from(case["prob"], "cpu", torch.float64), 0.1,
        qp_iters=8, sqp_iters=2, **kw)(
        torch.as_tensor(case["x0"]), torch.as_tensor(case["x_ref"]),
        torch.as_tensor(case["u0"]))


def test_sat_scenario_mpc_matches_jax(sat_case):
    before = pdip_whole.launches
    us_t, xs_t = _sat_solve_port(sat_case)
    assert _max_abs(us_t, sat_case["us"]) <= 1e-8
    assert _max_abs(xs_t, sat_case["xs"]) <= 1e-8
    assert pdip_whole.launches == before


def _small_floating_arm():
    return jmodels.floating_arm(arm_builder=jmodels.planar_2link)


@functools.lru_cache(maxsize=None)
def _jax_host_chain(dt):
    """The JAX package's step and LTV of the small floating arm, each jitted
    once and reached from the solver through a host callback."""
    return host_manifold_lanes(_small_floating_arm(), dt)


@pytest.mark.parametrize("linesearch", [False, True],
                         ids=["full-step", "line-search"])
def test_floating_arm_scenario_mpc_matches_jax(rng, linesearch):
    spec_j = _small_floating_arm()
    nq, nv = spec_j.nq, spec_j.nv
    B, H = 2, 3
    w = np.concatenate([np.full(nv, 5.0), np.full(nv, 0.5)])
    prob_j = jmpc.MPCProblem(Q=jnp.diag(jnp.asarray(w)), R=jnp.eye(nv) * 0.05,
                             QN=jnp.diag(jnp.asarray(10.0 * w)),
                             u_min=jnp.full(nv, -30.0),
                             u_max=jnp.full(nv, 30.0), horizon=H)
    x0 = np.zeros((B, nq + nv))
    quat = rng.standard_normal((B, 4))
    x0[:, 0:3] = 0.2 * rng.standard_normal((B, 3))
    x0[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    x0[:, 7:nq] = 0.3 * rng.standard_normal((B, nq - 7))
    x0[:, nq:] = 0.1 * rng.standard_normal((B, nv))
    x_ref = np.zeros(nq + nv)
    x_ref[3] = 1.0
    kw = dict(tangent_dim=2 * nv, quat_index=3, qp_iters=8, sqp_iters=2,
              sqp_linesearch=linesearch)
    # one jit of the JAX solve: run eagerly, it traces and compiles its
    # rollout scan again at each of its sqp_iters + 1 rollouts
    us_j, xs_j = jax.jit(jml.make_scenario_mpc_lanes(
        *_jax_host_chain(0.02), prob_j, **kw))(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.zeros((B, H, nv)))
    before = dict(chol_lanes.launches)
    us_t, xs_t = ml.make_scenario_mpc_lanes(
        *lanes.make_kte_manifold_lanes(convert.spec_from(spec_j), 0.02),
        convert.problem_from(prob_j, "cpu", torch.float64), **kw)(
        torch.as_tensor(x0), torch.as_tensor(x_ref),
        torch.zeros(B, H, nv, dtype=torch.float64))
    assert _max_abs(us_t, us_j) <= 1e-8
    assert _max_abs(xs_t, xs_j) <= 1e-8
    assert chol_lanes.launches == before


def test_per_pass_kernels_are_not_ported(sat_case):
    """Named when ``use_kernels="passes"`` raised NotImplementedError; the
    satellite solve on the per-pass path now runs, and this holds it to the
    JAX package's solve on its scan (≤1e-8 on u and xs, the bar of the
    whole-solve path above), with no kernel launch on CPU tensors."""
    before = dict(riccati_bwd.launches)
    us_t, xs_t = _sat_solve_port(sat_case, use_kernels="passes")
    assert _max_abs(us_t, sat_case["us"]) <= 1e-8
    assert _max_abs(xs_t, sat_case["xs"]) <= 1e-8
    assert riccati_bwd.launches == before
    prob = convert.problem_from(_sat_problem(3), "cpu", torch.float64)
    with pytest.raises(ValueError, match="use_kernels"):
        ml.make_scenario_mpc_lanes(None, None, prob, use_kernels="pass")
