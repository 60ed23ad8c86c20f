"""The port's free-base KTE chains (reak_tpu_torch.kte: the FREE joint of
``_fk_soa``, the generic lanes terms, ``make_kte_manifold_lanes``) against
the JAX package on the same numpy inputs, f64 on the CPU, for the floating
arm (free base + 6-DoF arm) and the free-floating platform; the step and
LTV run on the floating arm with a 2-link arm, since compiling the JAX
linearization of the 6-DoF one takes most of a minute.  Bars, relative to
the largest entry of each output: terms ≤1e-10, the RK4 step ≤1e-11, the
error-state LTV ≤1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.kte import lanes as jlanes, models as jmodels
from reak_tpu_torch import convert
from reak_tpu_torch.kte import lanes, models

torch.set_num_threads(1)

CHAINS = ["floating_arm", "free_floating_3d"]


def _small_floating_arm(m):
    return m.floating_arm(arm_builder=m.planar_2link)


def _assert_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err <= rel, f"relative error {err:.3e} > {rel:.0e}"


def _state(rng, spec, B=3):
    """(nq + nv, B): p ~ 0.3 N, a random unit quaternion, arm angles and all
    rates ~ 0.3 N."""
    q = 0.3 * rng.standard_normal((spec.nq, B))
    quat = rng.standard_normal((4, B))
    q[3:7] = quat / np.linalg.norm(quat, axis=0)
    return np.concatenate([q, 0.3 * rng.standard_normal((spec.nv, B))])


@pytest.mark.parametrize("name", CHAINS)
def test_models_match_jax(name):
    """The port's builders give the JAX package's chains, and spec_from
    carries a FREE chain across and back unchanged."""
    spec_j = getattr(jmodels, name)()
    spec_t = convert.spec_from(spec_j)
    assert spec_t == getattr(models, name)()
    assert convert.spec_from(spec_t) == spec_t
    assert (spec_t.nq, spec_t.nv) == (spec_j.nq, spec_j.nv)
    assert spec_t.has_free_base
    small = convert.spec_from(_small_floating_arm(jmodels))
    assert small == _small_floating_arm(models) and small.nv == 8


@pytest.mark.parametrize("name", CHAINS)
def test_generic_terms_match_jax(rng, name):
    spec_j = getattr(jmodels, name)()
    x = _state(rng, spec_j)
    nq = spec_j.nq
    M_j, f_j = jax.jit(jlanes.make_terms_lanes(spec_j))(
        jnp.asarray(x[:nq]), jnp.asarray(x[nq:]))
    M_t, f_t = lanes.make_terms_lanes(convert.spec_from(spec_j))(
        torch.as_tensor(x[:nq]), torch.as_tensor(x[nq:]))
    _assert_rel(M_t, M_j, 1e-10)
    _assert_rel(f_t, f_j, 1e-10)


@pytest.mark.parametrize("name", ["floating_arm_2link", "free_floating_3d"])
def test_manifold_step_and_ltv_match_jax(rng, name):
    spec_j = (_small_floating_arm(jmodels) if name == "floating_arm_2link"
              else getattr(jmodels, name)())
    x = _state(rng, spec_j)
    u = 2.0 * rng.standard_normal((spec_j.nv, x.shape[1]))
    step_j, ltv_j = jlanes.make_kte_manifold_lanes(spec_j, 0.02)
    step_t, ltv_t = lanes.make_kte_manifold_lanes(convert.spec_from(spec_j),
                                                  0.02)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    _assert_rel(step_t(xt, ut), jax.jit(step_j)(jnp.asarray(x),
                                                jnp.asarray(u)), 1e-11)
    want = jax.jit(ltv_j)(jnp.asarray(x), jnp.asarray(u))
    got = ltv_t(xt, ut)
    d = 2 * spec_j.nv
    assert tuple(got[0].shape) == (d, d, x.shape[1])
    for g, w in zip(got, want):
        _assert_rel(g, w, 1e-9)


def test_actuated_map_matches_jax(rng):
    """An input map (nv, nu) onto the generalized forces: the platform
    driven by body torques only."""
    spec_j = jmodels.free_floating_3d()
    act = np.zeros((6, 3))
    act[3:6] = np.eye(3)
    x = _state(rng, spec_j)
    u = rng.standard_normal((3, x.shape[1]))
    step_j, ltv_j = jlanes.make_kte_manifold_lanes(spec_j, 0.05, actuated=act)
    step_t, ltv_t = lanes.make_kte_manifold_lanes(
        convert.spec_from(spec_j), 0.05, actuated=act)
    _assert_rel(step_t(torch.as_tensor(x), torch.as_tensor(u)),
                jax.jit(step_j)(jnp.asarray(x), jnp.asarray(u)), 1e-11)
    for g, w in zip(ltv_t(torch.as_tensor(x), torch.as_tensor(u)),
                    jax.jit(ltv_j)(jnp.asarray(x), jnp.asarray(u))):
        _assert_rel(g, w, 1e-9)


def test_manifold_path_refuses_a_fixed_base_chain():
    with pytest.raises(ValueError):
        lanes.make_kte_manifold_lanes(models.manip_3r3r(), 0.02)
    with pytest.raises(ValueError):
        lanes.make_rollout_lanes(models.floating_arm(), 0.02)
