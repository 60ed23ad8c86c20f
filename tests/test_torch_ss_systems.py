"""The port's vehicle models (reak_tpu_torch.ctrl.ss_systems) against the
JAX package on the same numpy inputs, f64 on the CPU, ≤1e-12 relative:
every model, output and retraction, each on one state and on a batch of
states (the JAX function under ``jax.vmap``); the sonar model on origins
inside the room, and the port's guard for origins outside it (fault F2 of
the JAX package) on its own; the ``convert`` functions of this slice."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from reak_tpu.ctrl import belief as jbelief, ss_systems as jss
from reak_tpu.math import rotations as jrot
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import ss_systems as ss

B = 6


def _close(got, want, rtol=1e-12):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert not want.size or np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)),
                                                    1e-300)


def _states(rng, batch, n_aug=0):
    q = rng.standard_normal((batch, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([0.5 * rng.standard_normal((batch, 3)), q,
                           0.3 * rng.standard_normal((batch, 3)),
                           0.4 * rng.standard_normal((batch, 3)),
                           0.1 * rng.standard_normal((batch, n_aug))], axis=1)


def _both(fn_t, fn_j, *arrays):
    """fn on one state (the first) and on the batch: the port directly, the
    JAX function under vmap."""
    _close(fn_t(*(torch.as_tensor(a[0]) for a in arrays)),
           fn_j(*(jnp.asarray(a[0]) for a in arrays)))
    _close(fn_t(*(torch.as_tensor(a) for a in arrays)),
           jax.vmap(fn_j)(*(jnp.asarray(a) for a in arrays)))


def _sat():
    inertia = np.array([[4.0, 0.2, -0.1], [0.2, 5.0, 0.3], [-0.1, 0.3, 6.0]])
    return (ss.satellite3D(mass=10.0, inertia=inertia),
            jss.satellite3D(mass=10.0, inertia=inertia))


def test_satellite_models():
    rng = np.random.default_rng(0)
    x, u = _states(rng, B), rng.standard_normal((B, 6))
    p_t, p_j = _sat()
    _both(ss.satellite3D_cont(p_t), jss.satellite3D_cont(p_j), x, u)
    _both(ss.satellite3D_imdt(p_t, 0.1), jss.satellite3D_imdt(p_j, 0.1),
          x, u)
    _both(ss.rk4_quat_discrete(ss.satellite3D_cont(p_t), 0.05),
          jss.rk4_quat_discrete(jss.satellite3D_cont(p_j), 0.05), x, u)
    # float32 states compute in float32 on their own device
    F32 = ss.satellite3D_imdt(p_t, 0.1)(torch.as_tensor(x, dtype=torch.float32),
                                        torch.as_tensor(u, dtype=torch.float32))
    assert F32.dtype == torch.float32 and F32.shape == (B, 13)


def test_outputs_and_innovation():
    rng = np.random.default_rng(1)
    x, u = _states(rng, B), rng.standard_normal((B, 6))
    z = _states(rng, B)[:, :10]
    p_t, p_j = _sat()
    _both(ss.h_pose, jss.h_pose, x)
    _both(ss.h_pose_gyro, jss.h_pose_gyro, x)
    h_t, h_j = ss.make_h_pose_imu(p_t), jss.make_h_pose_imu(p_j)
    _both(h_t, h_j, x, u)
    _close(h_t(torch.as_tensor(x[0])), h_j(jnp.asarray(x[0])))
    _both(ss.pose_innovation, jss.pose_innovation, z, x[:, :10])
    parts_t = ss.split_state(torch.as_tensor(x))
    parts_j = jss.split_state(jnp.asarray(x))
    for a, b in zip(parts_t, parts_j):
        _close(a, b)
    _close(ss.join_state(*parts_t), jss.join_state(*parts_j))


def test_airship_and_quadrotor():
    rng = np.random.default_rng(2)
    kw = dict(mass=2.0, inertia=np.diag([1.0, 1.5, 2.0]), buoyancy=18.5,
              r_cm=(0.01, -0.02, -0.1), drag_lin=0.3, drag_rot=0.2)
    a_t, a_j = ss.airship3D(**kw), jss.airship3D(**kw)
    x, u = _states(rng, B), rng.standard_normal((B, 6))
    _both(ss.airship3D_cont(a_t), jss.airship3D_cont(a_j), x, u)
    xa = _states(rng, B, n_aug=ss.N_AUG_AIRSHIP)
    _both(ss.airship3D_aug_cont(a_t), jss.airship3D_aug_cont(a_j), xa, u)
    _both(ss.rk4_quat_discrete(ss.airship3D_aug_cont(a_t), 0.02),
          jss.rk4_quat_discrete(jss.airship3D_aug_cont(a_j), 0.02), xa, u)
    q_t, q_j = ss.quadrotor(mass=1.2), jss.quadrotor(mass=1.2)
    uq = 3.0 + rng.standard_normal((B, 4))
    _both(ss.quadrotor_cont(q_t), jss.quadrotor_cont(q_j), x, uq)
    assert float(ss.hover_thrust(q_t)) == float(jss.hover_thrust(q_j))
    # the parameters stay float64 CPU configurations
    for params in (a_t, q_t, _sat()[0]):
        assert all(t.dtype == torch.float64 and t.device.type == "cpu"
                   for t in params)


def test_retraction_and_default_state():
    rng = np.random.default_rng(3)
    for n_aug in (0, 2):
        ret_t, ret_j = ss.sat3D_retraction(n_aug), jss.sat3D_retraction(n_aug)
        assert ret_t.dim == ret_j.dim == 12 + n_aug
        x = _states(rng, B, n_aug)
        x1 = _states(rng, B, n_aug)
        e = 0.3 * rng.standard_normal((B, ret_t.dim))
        _both(ret_t.retract, ret_j.retract, x, e)
        _both(ret_t.local, ret_j.local, x1, x)
        # one state against a batch of tangents broadcasts
        _close(ret_t.retract(torch.as_tensor(x[0]), torch.as_tensor(e)),
               jax.vmap(lambda ee: ret_j.retract(jnp.asarray(x[0]), ee))(
                   jnp.asarray(e)))
    _close(ss.default_state(n_aug=2, device="cpu"), jss.default_state(n_aug=2))


ROOM = (np.array([-2.0, -3.0, -1.0]), np.array([3.0, 2.0, 2.5]))
SONAR_POS = np.array([[0.3, 0.0, 0.0], [0.0, -0.2, 0.1], [0.0, 0.0, -0.4],
                      [0.2, 0.2, 0.2]])
SONAR_DIR = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0],
                      [0.6, 0.0, 0.8]])


def _sonar_origins(x):
    R = np.asarray(jrot.q_to_matrix(jnp.asarray(x[:, 3:7])))
    return x[:, None, 0:3] + np.einsum("bij,nj->bni", R, SONAR_POS)


def test_sonars_in_room_origins_inside():
    """Origins inside the room: the port and the JAX package agree (the
    states are drawn so that every sonar origin is inside)."""
    rng = np.random.default_rng(4)
    x = _states(rng, 12)
    x[:, 0:3] = rng.uniform(-0.8, 0.8, (12, 3))
    orig = _sonar_origins(x)
    assert np.all((orig > ROOM[0]) & (orig < ROOM[1]))
    h_t = ss.make_h_sonars_in_room(*ROOM, SONAR_POS, SONAR_DIR)
    h_j = jss.make_h_sonars_in_room(*ROOM, SONAR_POS, SONAR_DIR)
    _both(h_t, h_j, x)
    d = h_t(torch.as_tensor(x))
    assert d.shape == (12, 4) and bool((d > 0).all())


def test_sonar_origin_outside_room_reports_guard():
    """Fault F2 of the JAX package, repaired in the port: a sonar whose
    world origin lies outside the room reports 0, the reference's guard,
    even where its ray crosses into the room; the other sonars of the same
    state still report their distances."""
    spos = np.array([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.0, 0.0]])
    sdir = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.0]])
    x = np.zeros(13)
    x[3] = 1.0
    x[0:3] = [-1.8, 0.0, 0.0]  # sonar 0 at x = -2.3: outside, facing in
    d = ss.make_h_sonars_in_room(*ROOM, spos, sdir)(torch.as_tensor(x))
    d = d.numpy()
    assert d[0] == 0.0
    # sonar 1, inside at (-1.3, 0, 0), looks along -y to the wall y = -3
    np.testing.assert_allclose(d[1], 3.0, rtol=1e-12)
    # sonar 2 has no direction: no positive crossing, the guard
    assert d[2] == 0.0
    # the JAX package reports the slab crossing 0.3 for the outside origin
    d_j = np.asarray(jss.make_h_sonars_in_room(*ROOM, spos, sdir)(
        jnp.asarray(x)))
    np.testing.assert_allclose(d_j[0], 0.3, rtol=1e-12)
    np.testing.assert_allclose(d[1:], d_j[1:], rtol=1e-12)


def test_convert_belief_airship_quadrotor():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((12, 12))
    b_j = jbelief.GaussianBelief(jss.default_state(),
                                 jnp.asarray(g @ g.T + np.eye(12)))
    b_t = convert.belief_from(b_j, "cpu", torch.float64)
    _close(b_t.mean, b_j.mean)
    _close(b_t.cov, b_j.cov)
    a_j = jss.airship3D(mass=2.5, buoyancy=20.0, r_cm=(0.0, 0.1, -0.2))
    a_t = convert.airship_from(a_j)
    for ft, fj in zip(a_t, a_j):
        _close(ft, fj)
    q_j = jss.quadrotor(mass=0.8, arm=0.25)
    q_t = convert.quadrotor_from(q_j)
    for ft, fj in zip(q_t, q_j):
        _close(ft, fj)
    assert all(t.dtype == torch.float64 and t.device.type == "cpu"
               for t in (*a_t, *q_t))
