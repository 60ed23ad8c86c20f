"""The port's inverse kinematics (reak_tpu_torch.kte.ik) against the JAX
package, f64 on the CPU: the poses and every closed form (3R3R on its
eight branches, P3R3R, SCARA, SSRMS, ERA) ≤1e-10, ``clik`` and
``clik_batched`` over 50 iterations ≤1e-8; the round trips, joint limits
and posture term of ``tests/test_ik.py`` on the port; ``ee_jacobian``
against ``torch.func.jacfwd`` of the pose.  The JAX functions run op by op
(no ``jax.jit``) except ``clik_batched``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.kte import ik as jik, models as jmodels
from reak_tpu_torch.kte import ik, models
from reak_tpu_torch.math import rotations as rot

torch.set_num_threads(1)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol


def _target(spec, jspec, q):
    p, quat = ik.ee_pose(spec, torch.as_tensor(q))
    jp, jquat = jik.ee_pose(jspec, jnp.asarray(q))
    _close(p, jp, 1e-12)
    _close(quat, jquat, 1e-12)
    return (p, quat), (jp, jquat)


def _angle(qa, qb):
    return float(torch.linalg.vector_norm(rot.q_log(rot.qmul(rot.qconj(qa),
                                                             qb))))


def test_ik_3r3r_every_branch():
    spec, jspec = models.manip_3r3r(), jmodels.manip_3r3r()
    rng = np.random.default_rng(0)
    for _ in range(3):
        (p, quat), (jp, jquat) = _target(spec, jspec,
                                         rng.uniform(-1.2, 1.2, 6))
        for sh in (1.0, -1.0):
            for el in (1.0, -1.0):
                for wr in (1.0, -1.0):
                    _close(ik.ik_3r3r(spec, p, quat, sh, el, wr),
                           jik.ik_3r3r(jspec, jp, jquat, sh, el, wr), 1e-10)


def test_ik_3r3r_branches_vmapped_round_trip():
    """The eight branches in one ``torch.func.vmap``; every one reaches the
    pose (``tests/test_ik.py:62-73``)."""
    spec = models.manip_3r3r()
    q = torch.tensor([0.3, -0.5, 0.8, 0.2, 0.6, -0.4], dtype=torch.float64)
    p, quat = ik.ee_pose(spec, q)
    sh = torch.tensor([1.0, 1, 1, 1, -1, -1, -1, -1], dtype=torch.float64)
    el = torch.tensor([1.0, 1, -1, -1, 1, 1, -1, -1], dtype=torch.float64)
    wr = torch.tensor([1.0, -1, 1, -1, 1, -1, 1, -1], dtype=torch.float64)
    qs = torch.func.vmap(lambda s, e, w: ik.ik_3r3r(spec, p, quat, s, e, w))(
        sh, el, wr)
    assert qs.shape == (8, 6)
    for i in range(8):
        p2, quat2 = ik.ee_pose(spec, qs[i])
        assert float(torch.linalg.vector_norm(p2 - p)) < 1e-9
        assert _angle(quat, quat2) < 1e-9


def test_ik_p3r3r_and_scara():
    rng = np.random.default_rng(1)
    spec, jspec = models.manip_p3r3r(), jmodels.manip_p3r3r()
    q = np.concatenate([[0.7], rng.uniform(-1.0, 1.0, 6)])
    (p, quat), (jp, jquat) = _target(spec, jspec, q)
    got = ik.ik_p3r3r(spec, p, quat, track_pos=0.7)
    _close(got, jik.ik_p3r3r(jspec, jp, jquat, track_pos=0.7), 1e-10)
    p2, quat2 = ik.ee_pose(spec, got)
    assert float(torch.linalg.vector_norm(p2 - p)) < 1e-9
    assert _angle(quat, quat2) < 1e-9
    spec, jspec = models.manip_scara(), jmodels.manip_scara()
    (p, _), (jp, _) = _target(spec, jspec, np.array([0.5, -0.7, 0.1]))
    for el in (1.0, -1.0):
        got = ik.ik_scara(spec, p, elbow=el)
        _close(got, jik.ik_scara(jspec, jp, elbow=el), 1e-10)
        p2, _ = ik.ee_pose(spec, got)
        assert float(torch.linalg.vector_norm(p2 - p)) < 1e-9


@pytest.mark.parametrize("arm,solver", [("manip_ssrms", "ik_ssrms"),
                                        ("manip_era", "ik_era")])
def test_ik_7dof(arm, solver):
    """Against JAX on several (phi, elbow), and the round trip at the
    configuration's own phi (``tests/test_ik.py:133-167``)."""
    spec, jspec = getattr(models, arm)(), getattr(jmodels, arm)()
    rng = np.random.default_rng(2)
    for _ in range(3):
        q = rng.uniform(-1.2, 1.2, 7)
        (p, quat), (jp, jquat) = _target(spec, jspec, q)
        for phi, el in ((0.0, 1.0), (0.7, -1.0), (-2.1, 1.0)):
            _close(getattr(ik, solver)(spec, p, quat, phi=phi, elbow=el),
                   getattr(jik, solver)(jspec, jp, jquat, phi=phi,
                                        elbow=el), 1e-10)
    # the round trip: phi of the configuration from the solver's basis
    q = torch.tensor([0.3, 0.4, 0.5, -0.8, 0.3, 0.5, 0.2],
                     dtype=torch.float64)
    phis = torch.linspace(-np.pi, np.pi, 33, dtype=torch.float64)
    p, quat = ik.ee_pose(spec, q)
    qik = torch.func.vmap(lambda f: getattr(ik, solver)(
        spec, p, quat, phi=f, elbow=-1.0))(phis)
    ps, quats = torch.func.vmap(lambda qq: ik.ee_pose(spec, qq))(qik)
    perr = torch.linalg.vector_norm(ps - p, dim=-1)
    ang = torch.stack([torch.tensor(_angle(quat, qt)) for qt in quats])
    feas = (perr < 1e-8) & (ang < 1e-8)
    assert int(feas.sum()) >= 8
    assert float(qik[feas, 0].std()) > 0.1


@pytest.fixture(scope="module")
def clik_case():
    """Two targets of the 3R3R arm, their start configurations, and the JAX
    package's ``clik_batched`` over 50 iterations on them (one ``jax.jit``:
    op by op it takes ~8 s on a CPU)."""
    spec, jspec = models.manip_3r3r(), jmodels.manip_3r3r()
    rng = np.random.default_rng(3)
    qs = rng.uniform(-0.8, 0.8, (2, 6))
    q0s = qs + 0.1 * rng.standard_normal((2, 6))
    q0s[0] = 0.05  # the start of tests/test_ik.py:83-90
    jps, jquats = jax.vmap(lambda q: jik.ee_pose(jspec, q))(jnp.asarray(qs))
    want = jax.jit(lambda p, qt, q0: jik.clik_batched(
        jspec, p, qt, q0, iters=50))(jps, jquats, jnp.asarray(q0s))
    return spec, qs, q0s, want


def test_clik_against_jax(clik_case):
    spec, qs, q0s, want = clik_case
    p, quat = ik.ee_pose(spec, torch.as_tensor(qs[0]))
    got = ik.clik(spec, p, quat, torch.as_tensor(q0s[0]), iters=50)
    _close(got.q, want.q[0], 1e-8)
    assert abs(float(got.err) - float(want.err[0])) <= 1e-8
    assert bool(got.converged) == bool(want.converged[0])


def test_clik_batched_against_jax(clik_case):
    """``clik_batched`` (``torch.func.vmap``) against the JAX package's
    (``jax.vmap``), and each target within 1e-6 of its pose after 60
    iterations as ``tests/test_ik.py:117-124`` holds them."""
    spec, qs, q0s, want = clik_case
    ps, quats = torch.func.vmap(lambda q: ik.ee_pose(spec, q))(
        torch.as_tensor(qs))
    got = ik.clik_batched(spec, ps, quats, torch.as_tensor(q0s), iters=50)
    _close(got.q, want.q, 1e-8)
    _close(got.err, want.err, 1e-8)
    res = ik.clik_batched(spec, ps, quats, torch.as_tensor(q0s), iters=60)
    assert res.q.shape == (2, 6) and float(res.err.max()) < 1e-6


def test_clik_joint_limits_and_posture():
    """``tests/test_ik.py:100-115`` (limits) and ``:117-134`` (posture on
    the redundant P3R3R: the nullspace term pulls the track toward q_rest
    without disturbing the task)."""
    spec = models.manip_3r3r()
    q_true = torch.tensor([0.4, -0.6, 0.9, 0.3, 0.5, -0.2],
                          dtype=torch.float64)
    p, quat = ik.ee_pose(spec, q_true)
    lo, hi = -torch.ones(6, dtype=torch.float64) * 2.0, \
        torch.ones(6, dtype=torch.float64) * 2.0
    res = ik.clik(spec, p, quat, torch.zeros(6, dtype=torch.float64) + 0.05,
                  iters=80, q_min=lo, q_max=hi)
    assert bool(torch.all(res.q >= lo)) and bool(torch.all(res.q <= hi))
    assert float(res.err) < 1e-6
    spec = models.manip_p3r3r()
    q_rest = torch.tensor([0.5, 0.3, -0.4, 0.7, 0.1, 0.4, 0.0],
                          dtype=torch.float64)
    p, quat = ik.ee_pose(spec, q_rest)
    q0 = q_rest.clone()
    q0[0] += 0.3
    post = ik.clik(spec, p, quat, q0, iters=120, posture_weight=5e-2,
                   q_rest=q_rest)
    none = ik.clik(spec, p, quat, q0, iters=120, posture_weight=0.0,
                   q_rest=q_rest)
    assert float(post.err) < 1e-6
    assert abs(float(post.q[0]) - 0.5) < abs(float(none.q[0]) - 0.5)


@pytest.mark.parametrize("arm", ["manip_ssrms", "manip_p3r3r"])
def test_ee_jacobian_is_the_pose_derivative(arm):
    """Rows 0-2: jacfwd of the position; rows 3-5: the world angular
    velocity 2·vec(q̇ ⊗ q*) of jacfwd of the quaternion."""
    spec = getattr(models, arm)()
    q = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, spec.nq))
    J = ik.ee_jacobian(spec, q)
    Jp = torch.func.jacfwd(lambda x: ik.ee_pose(spec, x)[0])(q)
    Jq = torch.func.jacfwd(lambda x: ik.ee_pose(spec, x)[1])(q)
    quat = ik.ee_pose(spec, q)[1]
    Jw = torch.stack([2.0 * rot.qmul(Jq[:, k], rot.qconj(quat))[1:]
                      for k in range(spec.nv)], dim=-1)
    assert torch.allclose(J[:3], Jp, rtol=0, atol=1e-12)
    assert torch.allclose(J[3:], Jw, rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError):
        ik.ee_jacobian(models.uav_kinematics(),
                       torch.as_tensor(models.uav_kinematics().neutral_q()))
