"""The pendulums, planar 3R, P3R3R, SCARA, ERA, SSRMS and UAV builders of
reak_tpu_torch.kte.models and the task-space forces (kte.forces) against
the JAX package, f64 on the CPU: each builder's ``ChainSpec`` equals the
JAX builder's field by field;
FK and the dynamics terms (M, f) agree ≤1e-12 relative on two seeded
states a chain, and every force map ≤1e-12 on the 7-DoF arms and the
P3R3R (a PRISMATIC joint).  The JAX functions run op by op (no
``jax.jit``).  The pendulum's RK4 small-oscillation check is the JAX
test's (``tests/test_integrators.py:114-130``: the same pendulum, start and
bar) on the port, over 50 steps of 0.02 s where the JAX test takes 1000
of 0.001 s: the chain's rate costs ~15 ms a call on a CPU, and RK4's
error at 0.02 s (ω·dt = 0.09) is far below the bar."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.kte import dynamics as jdyn, forces as jforces, models as jmodels
from reak_tpu_torch import convert, integrators as ig, kte
from reak_tpu_torch.kte import dynamics as dyn, forces, models

torch.set_num_threads(1)
BUILDERS = ["pendulum", "double_pendulum", "manip_3r_planar", "manip_p3r3r",
            "manip_scara", "manip_era", "manip_ssrms", "uav_kinematics"]
WIDTHS = {"pendulum": (1, 1), "double_pendulum": (2, 2),
          "manip_3r_planar": (3, 3), "manip_p3r3r": (7, 7),
          "manip_scara": (3, 3), "manip_era": (7, 7), "manip_ssrms": (7, 7),
          "uav_kinematics": (2, 6)}
RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)), 1.0)


def _state(spec, rng):
    q = rng.uniform(-0.8, 0.8, spec.nq)
    if spec.has_free_base:
        quat = rng.standard_normal(4)
        q[3:7] = quat / np.linalg.norm(quat)
    return q, rng.uniform(-0.5, 0.5, spec.nv)


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_spec_equals_jax(name):
    spec = getattr(models, name)()
    assert spec == convert.spec_from(getattr(jmodels, name)())
    assert (spec.n_joints, spec.nv) == WIDTHS[name]


def test_builder_arguments_carry_over():
    """Non-default arguments reach the same spec as in the JAX package."""
    pairs = [("pendulum", dict(length=0.7, mass=2.0, motor_inertia=0.5,
                               damping=0.1, gravity=3.0,
                               stiction=(0.01, 0.02, 0.3, 0.2))),
             ("manip_p3r3r", dict(carriage_mass=5.0, rotor_inertia=0.1)),
             ("manip_ssrms", dict(masses=[10.0] * 7))]
    for name, kw in pairs:
        assert (getattr(models, name)(**kw)
                == convert.spec_from(getattr(jmodels, name)(**kw)))


@pytest.mark.parametrize("name", BUILDERS)
def test_fk_and_dynamics_terms(name):
    spec, jspec = getattr(models, name)(), getattr(jmodels, name)()
    rng = np.random.default_rng(0)
    for _ in range(2):
        q, qd = _state(spec, rng)
        tq, tqd = torch.as_tensor(q), torch.as_tensor(qd)
        jq, jqd = jnp.asarray(q), jnp.asarray(qd)
        _close(tuple(dyn.fk(spec, tq)), tuple(jdyn.fk(jspec, jq)))
        _close(dyn.dynamics_terms(spec, tq, tqd),
               jdyn.dynamics_terms(jspec, jq, jqd))


@pytest.mark.parametrize("name", ["manip_ssrms", "manip_era", "manip_p3r3r"])
def test_forces_against_jax(name):
    spec, jspec = getattr(models, name)(), getattr(jmodels, name)()
    rng = np.random.default_rng(1)
    q, qd = _state(spec, rng)
    tq, tqd = torch.as_tensor(q), torch.as_tensor(qd)
    jq, jqd = jnp.asarray(q), jnp.asarray(qd)
    pt = [0.1, -0.05, 0.2]
    f = rng.standard_normal(3)
    for body in (3, spec.n_joints - 1):
        _close(forces.point_kinematics(spec, tq, body, pt),
               jforces.point_kinematics(jspec, jq, body, jnp.asarray(pt)))
        _close(forces.point_velocity(spec, tq, tqd, body, pt),
               jforces.point_velocity(jspec, jq, jqd, body, jnp.asarray(pt)))
        _close(forces.world_force_to_tau(spec, tq, body, pt, f),
               jforces.world_force_to_tau(jspec, jq, body, jnp.asarray(pt),
                                          jnp.asarray(f)))
        _close(forces.virtual_spring_damper(spec, tq, tqd, body, pt,
                                            [0.5, 0.2, 1.0], 20.0, 2.0),
               jforces.virtual_spring_damper(jspec, jq, jqd, body,
                                             jnp.asarray(pt),
                                             [0.5, 0.2, 1.0], 20.0, 2.0))
        _close(forces.line_point_mindist_force(
            spec, tq, body, pt, [0.0, 0.1, 0.2], [1.0, 2.0, -1.0], 7.0),
               jforces.line_point_mindist_force(
            jspec, jq, body, jnp.asarray(pt), [0.0, 0.1, 0.2],
            [1.0, 2.0, -1.0], 7.0))
        _close(forces.plane_point_mindist_force(
            spec, tq, body, pt, [0.0, 0.3, 1.0], 0.4, 5.0),
               jforces.plane_point_mindist_force(
            jspec, jq, body, jnp.asarray(pt), [0.0, 0.3, 1.0], 0.4, 5.0))


def test_world_force_to_tau_batched_and_its_jacobian():
    """Under ``torch.func.vmap`` over states and forces, as the chip run
    maps it on 8192 SSRMS states; and Jᵀ f equals the transposed jacfwd
    of the point's position."""
    spec = models.manip_ssrms()
    rng = np.random.default_rng(2)
    qs = torch.as_tensor(rng.uniform(-1, 1, (5, 7)))
    fs = torch.as_tensor(rng.standard_normal((5, 3)))
    pt = torch.tensor([0.0, 0.0, 0.15], dtype=torch.float64)
    tau = torch.func.vmap(
        lambda q, f: forces.world_force_to_tau(spec, q, 6, pt, f))(qs, fs)
    for i in range(5):
        J = torch.func.jacfwd(
            lambda q: forces.point_kinematics(spec, q, 6, pt)[0])(qs[i])
        assert torch.allclose(tau[i], J.T @ fs[i], rtol=0, atol=1e-12)


def test_pendulum_small_oscillation_rk4():
    """The pendulum chain under RK4 (the test_am.cpp simulation loop):
    about the hanging equilibrium q* = −π/2, ω² = g/L."""
    spec = models.pendulum(length=0.5, mass=1.0, motor_inertia=0.0,
                           gravity=9.81)
    y0 = torch.tensor([-np.pi / 2 + 0.01, 0.0], dtype=torch.float64)
    y = ig.integrate(lambda t, y: kte.state_rate(spec, y), y0, 0.0, 0.02,
                     50, method="rk4")
    w = np.sqrt(9.81 / 0.5)
    expected = -np.pi / 2 + 0.01 * np.cos(w * 1.0)
    np.testing.assert_allclose(float(y[0]), expected, atol=1e-5)
