"""The port's single-sample chain dynamics (reak_tpu_torch.kte.dynamics),
frames (math.frames) and generic systems (ctrl.systems) against the JAX
package on the same numpy inputs, f64 on the CPU, ≤1e-10 relative to the
larger of the reference's largest entry and 1 (Ṁ of a lone free body is
rounding noise around 0).

Chains: ``planar_2link``, ``manip_3r3r``, the mixed chain (FIXED and
PRISMATIC joints, offset quaternions, springs, dampers, full inertia; 8
joints, so FK takes the scan form), ``free_floating_3d`` (a FREE base) and
a 2-link with dry friction and backlash.  The JAX functions run op by op
(no ``jax.jit``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import systems as jsys
from reak_tpu.kte import dynamics as jdyn, models as jmodels, spec as jspec
from reak_tpu.math import frames as jfr
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import systems
from reak_tpu_torch.kte import dynamics as dyn, models
from reak_tpu_torch.math import frames as fr

torch.set_num_threads(1)
RTOL = 1e-10
CHAINS = ["planar_2link", "manip_3r3r", "mixed_chain", "free_floating_3d",
          "friction_2link"]


def _jax_chain(name):
    if name == "mixed_chain":
        return jspec.ChainSpec.build(**models.mixed_chain_fields())
    if name == "friction_2link":
        return dataclasses.replace(
            jmodels.planar_2link(), stiction_coef=(0.3, 0.2),
            slip_coef=(0.2, 0.1), stiction_vel=(0.05, 0.05),
            slip_vel=(0.1, 0.1), backlash=(0.05, 0.0), name="friction_2link")
    return getattr(jmodels, name)()


def _close(got, want, rtol=RTOL):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)),
                                                    1.0)


def _state(spec, rng):
    """(q, qd, tau) of one sample; a free base gets a random unit
    quaternion."""
    q = rng.uniform(-0.6, 0.6, spec.nq)
    if spec.has_free_base:
        quat = rng.standard_normal(4)
        q[3:7] = quat / np.linalg.norm(quat)
    return q, rng.uniform(-0.5, 0.5, spec.nv), rng.uniform(-2, 2, spec.nv)


def _pair(*arrays):
    return [torch.as_tensor(a) for a in arrays], [jnp.asarray(a)
                                                 for a in arrays]


@pytest.mark.parametrize("name", CHAINS)
def test_dynamics_terms_and_kinematics(name):
    """Every function of ``kte.dynamics`` on one sample.  The JAX package's
    (M, f) come from one ``dynamics_terms`` call, and the functions that
    only solve with them (forward and inverse dynamics, the state rate) are
    held to numpy's solve of those."""
    j = _jax_chain(name)
    s = convert.spec_from(j)
    (q, qd, tau), (jq, jqd, jtau) = _pair(*_state(s, np.random.default_rng(0)))
    _close(tuple(dyn.fk(s, q)), tuple(jdyn.fk(j, jq)))
    _close(dyn.jacobians(s, q), jdyn.jacobians(j, jq))
    _close(dyn.mass_matrix_and_derivative(s, q, qd),
           jdyn.mass_matrix_and_derivative(j, jq, jqd))
    M_j, f_j = (np.asarray(a) for a in jdyn.dynamics_terms(j, jq, jqd))
    _close(dyn.dynamics_terms(s, q, qd), (M_j, f_j))
    _close(dyn.mass_matrix(s, q), M_j)
    _close(dyn.bias_force(s, q, qd), f_j)
    qdd_j = np.linalg.solve(M_j, f_j + tau.numpy())
    _close(dyn.forward_dynamics(s, q, qd, tau), qdd_j)
    _close(dyn.inverse_dynamics(s, q, qd, tau), M_j @ tau.numpy() - f_j)
    x = torch.cat([q, qd])
    rate_j = np.asarray(jdyn.config_rate(j, jq, jqd))
    _close(dyn.state_rate(s, x, tau), np.concatenate([rate_j, qdd_j]))
    _close(dyn.config_rate(s, q, qd), rate_j)
    frames_j = jdyn.body_frames(j, jq, jqd)
    _close(tuple(dyn.body_frames(s, q, qd)), tuple(frames_j))
    _close(dyn.velocities(s, q, qd), (frames_j.vel, frames_j.omega))
    _close(tuple(dyn.body_frames(s, q)), tuple(jdyn.body_frames(j, jq)))
    _close(dyn.unpack_state(s, dyn.pack_state(s, q, qd)),
           jdyn.unpack_state(j, jdyn.pack_state(j, jq, jqd)))
    qdd, status = dyn.forward_dynamics_checked(s, q, qd, tau)
    _close(qdd, qdd_j)
    assert int(status) == 0


@pytest.mark.parametrize("name", ["planar_2link", "free_floating_3d"])
def test_linearize_fd_and_retraction(name):
    """Both branches of ``linearize_fd`` (the plain chart of a fixed base,
    the retraction's chart of a free base) and ``state_retraction``."""
    j = _jax_chain(name)
    s = convert.spec_from(j)
    (q, qd, tau), (jq, jqd, jtau) = _pair(*_state(s, np.random.default_rng(1)))
    got = dyn.linearize_fd(s, q, qd, tau)
    want = jdyn.linearize_fd(j, jq, jqd, jtau)
    _close(got[:3], want[:3])
    rhs = np.random.default_rng(2).standard_normal((s.nv, 3))
    _close(got[3](torch.as_tensor(rhs)), want[3](jnp.asarray(rhs)))
    _close(got[3](torch.as_tensor(rhs[:, 0])), want[3](jnp.asarray(rhs[:, 0])))
    ret, jret = dyn.state_retraction(s), jdyn.state_retraction(j)
    assert ret.dim == jret.dim == 2 * s.nv
    e = 0.2 * np.random.default_rng(3).standard_normal(ret.dim)
    x = torch.cat([q, qd])
    jx = jnp.concatenate([jq, jqd])
    _close(ret.retract(x, torch.as_tensor(e)), jret.retract(jx,
                                                            jnp.asarray(e)))
    _close(ret.local(ret.retract(x, torch.as_tensor(e)), x),
           jret.local(jret.retract(jx, jnp.asarray(e)), jx))


def test_singular_mass_matrix_flag():
    """A massless chain: the status says SINGULAR_MATRIX and NONFINITE and
    q̈ is NaN, as in the JAX package; nothing raises until
    ``raise_on_error``."""
    from reak_tpu_torch import errors

    j = dataclasses.replace(jmodels.planar_2link(), masses=(0.0, 0.0),
                            inertias=((0.0,) * 9,) * 2)
    s = convert.spec_from(j)
    (q, qd, _), (jq, jqd, _) = _pair(*_state(s, np.random.default_rng(4)))
    qdd, st = dyn.forward_dynamics_checked(s, q, qd)
    jqdd, jst = jdyn.forward_dynamics_checked(j, jq, jqd)
    assert int(st) == int(jst) == errors.SINGULAR_MATRIX | errors.NONFINITE
    assert bool(torch.isnan(qdd).all()) and bool(jnp.isnan(jqdd).all())
    with pytest.raises(errors.SingularityError):
        errors.raise_on_error(st)


def test_frames_compose():
    rng = np.random.default_rng(5)

    def frame3(lib, arrays):
        return lib.Frame3(*arrays)

    def draw3():
        quat = rng.standard_normal(4)
        vecs = [rng.standard_normal(3) for _ in range(5)]
        return [vecs[0], quat / np.linalg.norm(quat), *vecs[1:]]

    a, b = draw3(), draw3()
    f_t = frame3(fr, [torch.as_tensor(v) for v in a]).compose(
        frame3(fr, [torch.as_tensor(v) for v in b]))
    f_j = frame3(jfr, [jnp.asarray(v) for v in a]).compose(
        frame3(jfr, [jnp.asarray(v) for v in b]))
    _close(tuple(f_t), tuple(f_j))
    _close(f_t.quat_dot, f_j.quat_dot)
    p_t, p_j = f_t.pose, f_j.pose
    v = rng.standard_normal(3)
    for name in ("rotate_to_parent", "rotate_from_parent",
                 "transform_to_parent", "transform_from_parent"):
        _close(getattr(p_t, name)(torch.as_tensor(v)),
               getattr(p_j, name)(jnp.asarray(v)))
    _close(tuple(p_t.compose(p_t.inverse())), tuple(p_j.compose(
        p_j.inverse())))
    c2 = [rng.standard_normal(2), rng.standard_normal(()),
          rng.standard_normal(2), rng.standard_normal(()),
          rng.standard_normal(2), rng.standard_normal(())]
    d2 = [rng.standard_normal(a.shape) for a in c2]
    _close(tuple(fr.Frame2(*map(torch.as_tensor, c2)).compose(
        fr.Frame2(*map(torch.as_tensor, d2)))),
        tuple(jfr.Frame2(*map(jnp.asarray, c2)).compose(
            jfr.Frame2(*map(jnp.asarray, d2)))))
    _close(tuple(fr.Frame3.identity(torch.float64, (2,), device="cpu")),
           tuple(jfr.Frame3.identity(jnp.float64, (2,))))
    _close(tuple(fr.GenCoord.zero(torch.float64, (3,), device="cpu")),
           tuple(jfr.GenCoord.zero(jnp.float64, (3,))))


@pytest.mark.parametrize("name", ["planar_2link", "mixed_chain",
                                  "free_floating_3d", "friction_2link"])
def test_kte_systems(name):
    """kte_continuous, kte_discrete (with the free base's quaternion
    renormalized), semi_implicit_kte, rk4/euler_discrete, linearize and
    linearize_discrete_series on each chain."""
    j = _jax_chain(name)
    s = convert.spec_from(j)
    q, qd, u = _state(s, np.random.default_rng(6))
    (x, tu), (jx, ju) = _pair(np.concatenate([q, qd]), u)
    dt = 0.02
    _close(systems.kte_continuous(s)(x, tu), jsys.kte_continuous(j)(jx, ju))
    F, jF = systems.kte_discrete(s, dt), jsys.kte_discrete(j, dt)
    x1 = F(x, tu)
    _close(x1, jF(jx, ju))
    if s.has_free_base:
        assert abs(float(torch.linalg.vector_norm(x1[3:7])) - 1.0) < 1e-14
    _close(systems.semi_implicit_kte(s, dt)(x, tu),
           jsys.semi_implicit_kte(j, dt)(jx, ju))
    _close(systems.euler_discrete(systems.kte_continuous(s), dt)(x, tu),
           jsys.euler_discrete(jsys.kte_continuous(j), dt)(jx, ju))
    if name == "planar_2link":
        _close(tuple(systems.linearize(systems.kte_continuous(s), x, tu)),
               tuple(jsys.linearize(jsys.kte_continuous(j), jx, ju)))
        _close(tuple(systems.linearize_discrete_series(
            systems.kte_continuous(s), x, tu, dt)),
            tuple(jsys.linearize_discrete_series(jsys.kte_continuous(j), jx,
                                                 ju, dt)))


def test_semi_implicit_with_actuation_and_free_base():
    j = jmodels.floating_arm()
    s = convert.spec_from(j)
    act = np.random.default_rng(7).standard_normal((s.nv, 4))
    q, qd, _ = _state(s, np.random.default_rng(8))
    u = np.random.default_rng(9).uniform(-1, 1, 4)
    (x, tu), (jx, ju) = _pair(np.concatenate([q, qd]), u)
    _close(systems.semi_implicit_kte(s, 0.01, actuated=act)(x, tu),
           jsys.semi_implicit_kte(j, 0.01, actuated=jnp.asarray(act))(jx, ju))
    _close(systems.kte_discrete(s, 0.01, actuated=act)(x, tu),
           jsys.kte_discrete(j, 0.01, actuated=jnp.asarray(act))(jx, ju))


def test_kte_ltv_linearizer():
    """The fixed-base series linearizer on a batch of two trajectories of 3
    points (batch first; the JAX one per trajectory), then with an
    actuation matrix."""
    j = _jax_chain("planar_2link")
    s = convert.spec_from(j)
    rng = np.random.default_rng(10)
    xs = np.stack([np.stack([np.concatenate(_state(s, rng)[:2])
                             for _ in range(3)]) for _ in range(2)])
    us = rng.uniform(-2, 2, (2, 3, s.nv))
    lin, jlin = systems.kte_ltv_linearizer(s, 0.01), \
        jsys.kte_ltv_linearizer(j, 0.01)
    got = lin(torch.as_tensor(xs), torch.as_tensor(us))
    for b in range(2):
        _close(tuple(a[b] for a in got),
               tuple(jlin(jnp.asarray(xs[b]), jnp.asarray(us[b]))))
    act = rng.standard_normal((s.nv, 2))
    got = systems.kte_ltv_linearizer(s, 0.01, actuated=act)(
        torch.as_tensor(xs[0]), torch.as_tensor(us[0, :, :2]))
    _close(got, tuple(jsys.kte_ltv_linearizer(j, 0.01, actuated=jnp.asarray(
        act))(jnp.asarray(xs[0]), jnp.asarray(us[0, :, :2]))))


@pytest.mark.parametrize("name", ["free_floating_3d", "planar_2link"])
def test_kte_manifold_ltv_linearizer(name):
    j = _jax_chain(name)
    s = convert.spec_from(j)
    rng = np.random.default_rng(11)
    xs = np.stack([np.concatenate(_state(s, rng)[:2]) for _ in range(3)])
    us = rng.uniform(-2, 2, (3, s.nv))
    got = systems.kte_manifold_ltv_linearizer(s, 0.05)(torch.as_tensor(xs),
                                                       torch.as_tensor(us))
    want = jsys.kte_manifold_ltv_linearizer(j, 0.05)(jnp.asarray(xs),
                                                     jnp.asarray(us))
    _close(got, tuple(want))


def test_lti_and_discretizations():
    rng = np.random.default_rng(12)
    A, Bm = rng.standard_normal((4, 4)), rng.standard_normal((4, 2))
    x, u = rng.standard_normal(4), rng.standard_normal(2)
    (tA, tB, tx, tu), (jA, jB, jx, ju) = _pair(A, Bm, x, u)
    _close(systems.lti_continuous(tA, tB)(tx, tu),
           jsys.lti_continuous(jA, jB)(jx, ju))
    _close(systems.lti_discrete(tA, tB)(tx, tu),
           jsys.lti_discrete(jA, jB)(jx, ju))
    _close(systems.discretize_lti(tA, tB, 0.1), jsys.discretize_lti(jA, jB,
                                                                    0.1))
    f0 = rng.standard_normal(4)
    _close(tuple(systems.discretize_series(tA, tB, torch.as_tensor(f0), tx,
                                           tu, 0.1)),
           tuple(jsys.discretize_series(jA, jB, jnp.asarray(f0), jx, ju,
                                        0.1)))
    F = systems.rk4_discrete(systems.lti_continuous(tA, tB), 0.1)
    jF = jsys.rk4_discrete(jsys.lti_continuous(jA, jB), 0.1)
    _close(F(tx, tu), jF(jx, ju))
