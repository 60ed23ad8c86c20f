"""The port's filters (reak_tpu_torch.ctrl.kalman, ukf, aug_kalman) and
belief predictor (ctrl.predictor) against the JAX package on the same numpy
inputs, f64 on the CPU: EKF, Kalman-Bucy, hybrid EKF, UKF and
``filter_trajectory`` on the systems of ``tests/test_filters.py`` ≤1e-10
relative; TSOS against JAX and against the joint filter
(``tests/test_ss_systems.py:162-201``); the predicted belief trajectory,
``at_time`` and ``sample_scenarios``' map on JAX's own draws ≤1e-12; and a
4-run Monte-Carlo IEKF arc of the estimation example, one ``torch.func.
vmap`` against JAX's ``vmap``, ≤1e-9."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import aug_kalman as jak, belief as jbel, \
    kalman as jkal, predictor as jpred, ss_systems as jss, \
    systems as jsys, ukf as jukf
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import aug_kalman as ak, belief as bel, \
    kalman as kal, predictor as pred, ss_systems as ss, systems as sys_, ukf

torch.set_num_threads(1)
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _close(got, want, rtol=1e-10):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)),
                                                    1e-300)


def _t(*a):
    return [torch.as_tensor(np.asarray(v, np.float64)) for v in a]


def _j(*a):
    return [jnp.asarray(np.asarray(v, np.float64)) for v in a]


def _lin_sys(dt=0.1):
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    C = np.array([[1.0, 0.0]])
    return A, B, C


def test_ekf_linear_and_filter_trajectory():
    """tests/test_filters.py:33-67: one EKF step, then 40 steps of
    ``filter_trajectory`` on simulated measurements."""
    rng = np.random.default_rng(0)
    A, B, C = _lin_sys()
    Q, R = np.eye(2) * 1e-3, np.eye(1) * 1e-2
    tA, tB, tC, tQ, tR = _t(A, B, C, Q, R)
    jA, jB, jC, jQ, jR = _j(A, B, C, Q, R)
    F, jF = sys_.lti_discrete(tA, tB), jsys.lti_discrete(jA, jB)
    h, jh = (lambda x, t=0.0: tC @ x), (lambda x, t=0.0: jC @ x)
    m0, P0, u, z = [0.3, -0.2], np.eye(2) * 0.7, [0.0], [0.7]
    b = bel.GaussianBelief(*_t(m0, P0))
    jb = jbel.GaussianBelief(*_j(m0, P0))
    got = kal.ekf_step(F, h, b, *_t(u, z), tQ, tR)
    want = jkal.ekf_step(jF, jh, jb, *_j(u, z), jQ, jR)
    _close(tuple(got), tuple(want))
    zs = rng.standard_normal((40, 1))
    us = np.zeros((40, 1))
    step = lambda b, u, z: kal.ekf_step(F, h, b, u, z, tQ, tR)
    jstep = lambda b, u, z: jkal.ekf_step(jF, jh, b, u, z, jQ, jR)
    bs = kal.filter_trajectory(step, b, *_t(us, zs))
    jbs = jkal.filter_trajectory(jstep, jb, *_j(us, zs))
    assert bs.mean.shape == (40, 2) and bs.cov.shape == (40, 2, 2)
    _close(tuple(bs), tuple(jbs))


def test_ukf_linear_and_nonlinear():
    """tests/test_filters.py:70-99: the UKF on the linear system (one step)
    and on a range measurement (20 steps)."""
    A, B, C = _lin_sys()
    Q, R = np.eye(2) * 1e-3, np.eye(1) * 1e-2
    tA, tB, tC, tQ, tR = _t(A, B, C, Q, R)
    jA, jB, jC, jQ, jR = _j(A, B, C, Q, R)
    m0, P0 = [0.3, -0.2], np.eye(2) * 0.5
    got = ukf.ukf_step(sys_.lti_discrete(tA, tB), lambda x, t=0.0: tC @ x,
                       bel.GaussianBelief(*_t(m0, P0)), *_t([0.0], [0.4]),
                       tQ, tR)
    want = jukf.ukf_step(jsys.lti_discrete(jA, jB), lambda x, t=0.0: jC @ x,
                         jbel.GaussianBelief(*_j(m0, P0)),
                         *_j([0.0], [0.4]), jQ, jR)
    _close(tuple(got), tuple(want))
    pts, wm, wc = ukf.sigma_points(bel.GaussianBelief(*_t(m0, P0)))
    jpts, jwm, jwc = jukf.sigma_points(jbel.GaussianBelief(*_j(m0, P0)))
    _close((pts, wm, wc), (jpts, jwm, jwc), rtol=1e-14)

    dt = 0.1
    F = lambda x, u, t=0.0: torch.stack([x[0] + dt * x[1], x[1]])
    jF = lambda x, u, t=0.0: jnp.array([x[0] + dt * x[1], x[1]])
    h = lambda x, t=0.0: torch.sqrt(x[0:1] ** 2 + 4.0)
    jh = lambda x, t=0.0: jnp.sqrt(x[0:1] ** 2 + 4.0)
    Q, R = np.eye(2) * 1e-4, np.eye(1) * 1e-3
    rng = np.random.default_rng(1)
    zs = 2.0 + rng.normal(0, 0.03, (20, 1))
    b = bel.GaussianBelief(*_t([1.0, 0.0], np.eye(2)))
    jb = jbel.GaussianBelief(*_j([1.0, 0.0], np.eye(2)))
    for z in zs:
        b = ukf.ukf_step(F, h, b, *_t([0.0], z), *_t(Q, R))
        jb = jukf.ukf_step(jF, jh, jb, *_j([0.0], z), *_j(Q, R))
    _close(tuple(b), tuple(jb))


def test_kalman_bucy_and_hybrid_ekf():
    """tests/test_filters.py:102-118 (Kalman-Bucy on ẋ = −x, 50 steps) and
    the hybrid EKF on a damped pendulum (2 substeps, 10 steps)."""
    rng = np.random.default_rng(2)
    f = lambda x, u, t=0.0: -1.0 * x
    h = lambda x, t=0.0: x
    Q, R = np.eye(1) * 0.1, np.eye(1) * 0.1
    b = bel.GaussianBelief(*_t([2.0], np.eye(1)))
    jb = jbel.GaussianBelief(*_j([2.0], np.eye(1)))
    for z in np.exp(-0.01 * np.arange(1, 51))[:, None] \
            + rng.normal(0, 0.05, (50, 1)):
        b = kal.kalman_bucy_step(f, h, b, *_t([0.0], z), *_t(Q, R), 0.01)
        jb = jkal.kalman_bucy_step(f, h, jb, *_j([0.0], z), *_j(Q, R), 0.01)
    _close(tuple(b), tuple(jb))

    fp = lambda x, u, t=0.0: torch.stack([x[1], -torch.sin(x[0])
                                          - 0.1 * x[1]])
    jfp = lambda x, u, t=0.0: jnp.array([x[1], -jnp.sin(x[0]) - 0.1 * x[1]])
    hp = lambda x, t=0.0: x[0:1]
    Q, R = np.eye(2) * 1e-4, np.eye(1) * 1e-3
    b = bel.GaussianBelief(*_t([0.5, 0.0], np.eye(2) * 0.2))
    jb = jbel.GaussianBelief(*_j([0.5, 0.0], np.eye(2) * 0.2))
    for z in rng.normal(0.4, 0.03, (10, 1)):
        b = kal.hybrid_ekf_step(fp, hp, b, *_t([0.0], z), *_t(Q, R), 0.05,
                                substeps=2)
        jb = jkal.hybrid_ekf_step(jfp, hp, jb, *_j([0.0], z), *_j(Q, R),
                                  0.05, substeps=2)
    _close(tuple(b), tuple(jb))


def _tsos_system(lib, rng, n_s=3, n_a=2, n_z=2):
    """tests/test_ss_systems.py:167-187 in the package ``lib`` (torch or
    jax.numpy)."""
    A = np.eye(n_s) + 0.05 * rng.standard_normal((n_s, n_s))
    Ba = 0.3 * rng.standard_normal((n_s, n_a))
    C = rng.standard_normal((n_z, n_s))
    Da = 0.2 * rng.standard_normal((n_z, n_a))
    cast = _t if lib is torch else _j
    A, Ba, C, Da = cast(A, Ba, C, Da)
    cat = torch.cat if lib is torch else jnp.concatenate
    F = lambda s, a, u, t=0.0: A @ s + Ba @ a + u
    h = lambda s, a, t=0.0: C @ s + Da @ a
    F_joint = lambda x, u, t=0.0: cat([F(x[:n_s], x[n_s:], u, t), x[n_s:]])
    h_joint = lambda x, t=0.0: h(x[:n_s], x[n_s:], t)
    return F, h, F_joint, h_joint


def test_tsos_against_jax_and_the_joint_filter():
    n_s, n_a, n_z = 3, 2, 2
    F, h, Fj, hj = _tsos_system(torch, np.random.default_rng(3))
    jF, jh, _, _ = _tsos_system(jnp, np.random.default_rng(3))
    Q = np.diag(np.r_[np.full(n_s, 1e-3), np.full(n_a, 1e-6)])
    R = np.eye(n_z) * 1e-2
    b_joint = bel.GaussianBelief(*_t(np.zeros(n_s + n_a), np.eye(n_s + n_a)))
    init = (np.zeros(n_s), np.eye(n_s), np.zeros(n_a), np.eye(n_a))
    b = ak.tsos_init(*_t(*init))
    jb = jak.tsos_init(*_j(*init))
    rng = np.random.default_rng(4)
    for _ in range(15):
        u, z = rng.standard_normal(n_s) * 0.1, rng.standard_normal(n_z)
        b_joint = kal.ekf_step(Fj, hj, b_joint, *_t(u, z), *_t(Q, R))
        b = ak.tsos_step(F, h, b, *_t(u, z), *_t(Q, R))
        jb = jak.tsos_step(jF, jh, jb, *_j(u, z), *_j(Q, R))
    _close(tuple(b), tuple(jb))
    _close(ak.tsos_state(b), jak.tsos_state(jb))
    re = ak.tsos_joint_belief(b)
    _close(tuple(re), tuple(jak.tsos_joint_belief(jb)))
    # Friedland equivalence (the JAX test's bars)
    assert float((re.mean - b_joint.mean).abs().max()) < 1e-8
    assert float((re.cov - b_joint.cov).abs().max()) < 1e-7
    # the joint filter's helpers
    _close(tuple(ak.augmented_to_state(re, n_s)),
           tuple(jak.augmented_to_state(jak.tsos_joint_belief(jb), n_s)))
    assert ak.maximum_likelihood_point(re) is re.mean
    got = convert.tsos_from(jb, "cpu", torch.float64)
    _close(tuple(got), tuple(jb), rtol=0.0)


def test_aug_iekf_step_on_the_airship():
    """One joint augmented IEKF step of the augmented airship (pose
    output) against JAX."""
    jp = jss.airship3D(mass=2.0, inertia=jnp.diag(jnp.array([0.8, 1.0,
                                                            1.2])))
    p = convert.airship_from(jp)
    F = ss.rk4_quat_discrete(ss.airship3D_aug_cont(p), 0.05, n_aug=5)
    jF = jss.rk4_quat_discrete(jss.airship3D_aug_cont(jp), 0.05, n_aug=5)
    x0 = np.r_[0.1, 0.0, -0.2, 1.0, 0.0, 0.0, 0.0, np.zeros(6),
               0.15, 0.02, -0.01, 0.0, 0.3]
    P0, Q = np.eye(17) * 1e-2, np.eye(17) * 1e-6
    R = np.eye(6) * 1e-4
    u, z = np.full(6, 0.1), np.r_[0.1, 0.0, -0.2, 1.0, 0.01, 0.0, 0.0]
    z[3:7] /= np.linalg.norm(z[3:7])
    got = ak.aug_iekf_step(F, ss.h_pose, ss.sat3D_retraction(5),
                           bel.GaussianBelief(*_t(x0, P0)), *_t(u, z),
                           *_t(Q, R), diff=ss.pose_innovation)
    # one jit compile of the JAX step beats running it op by op
    want = jax.jit(lambda b, *a: jak.aug_iekf_step(
        jF, jss.h_pose, jss.sat3D_retraction(5), b, *a,
        diff=jss.pose_innovation))(jbel.GaussianBelief(*_j(x0, P0)),
                                   *_j(u, z, Q, R))
    _close(tuple(got), tuple(want))


@pytest.fixture(scope="module")
def sat_prediction():
    """A satellite belief predicted 10 steps (H+1 = 11) in both
    packages."""
    jparams = jss.satellite3D(mass=1.0, inertia=jnp.diag(jnp.array(
        [0.9, 1.1, 1.0])))
    params = convert.satellite_from(jparams)
    F, jF = ss.satellite3D_imdt(params, 0.05), jss.satellite3D_imdt(jparams,
                                                                   0.05)
    rng = np.random.default_rng(5)
    x0 = np.r_[0.1, -0.2, 0.3, 1.0, 0.0, 0.0, 0.0, 0.1, 0.0, -0.1,
               0.3, -0.8, 0.5]
    g = rng.standard_normal((12, 12))
    P0 = 1e-3 * (g @ g.T + 12 * np.eye(12))
    us = rng.standard_normal((10, 6)) * 0.1
    Q = np.eye(12) * 1e-6
    traj = pred.predict_belief_trajectory(
        F, ss.sat3D_retraction(), bel.GaussianBelief(*_t(x0, P0)), *_t(us, Q),
        0.05, t0=1.5)
    jtraj = jpred.predict_belief_trajectory(
        jF, jss.sat3D_retraction(), jbel.GaussianBelief(*_j(x0, P0)),
        *_j(us, Q), 0.05, t0=1.5)
    return traj, jtraj


def test_predict_belief_trajectory_and_at_time(sat_prediction):
    traj, jtraj = sat_prediction
    assert traj.means.shape == (11, 13) and traj.covs.shape == (11, 12, 12)
    _close(tuple(traj), tuple(jtraj), rtol=1e-12)
    _close(tuple(traj.ml_trajectory()), tuple(jtraj.ml_trajectory()),
           rtol=1e-12)
    # before the start, on a knot, between knots, at and past the end
    for t in (1.0, 1.5, 1.6, 1.623, 1.97, 2.0, 2.4):
        _close(tuple(traj.at_time(t)), tuple(jtraj.at_time(t)), rtol=1e-12)
    got = convert.trajectory_from(jtraj, "cpu", torch.float64)
    _close(tuple(got), tuple(jtraj), rtol=0.0)


@pytest.mark.parametrize("with_ret", [True, False])
def test_sample_scenarios_on_jax_draws(with_ret, sat_prediction):
    """``_scenarios_from_draws`` on the draws JAX's ``sample_scenarios``
    makes (a ``fold_in`` key per scenario), against that function; the
    public function draws its own and keeps quaternions unit."""
    traj, jtraj = sat_prediction
    ret, jret = ((ss.sat3D_retraction(), jss.sat3D_retraction()) if with_ret
                 else (None, None))
    dim = 12 if with_ret else 13
    if not with_ret:      # a full-width covariance for the vector case
        pad = lambda c: np.pad(np.asarray(c), ((0, 0), (0, 1), (0, 1))) \
            + np.diag(np.r_[np.zeros(12), 1e-4])
        traj = traj._replace(covs=torch.as_tensor(pad(traj.covs)))
        jtraj = jtraj._replace(covs=jnp.asarray(pad(jtraj.covs)))
    key = jax.random.PRNGKey(7)
    n = 5
    eps = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                 (11, dim), jnp.float64))
                    for i in range(n)])
    got = pred._scenarios_from_draws(traj, torch.as_tensor(eps), ret)
    want = jpred.sample_scenarios(key, jtraj, n, ret=jret)
    _close(got, want, rtol=1e-12)
    scen = pred.sample_scenarios(torch.Generator().manual_seed(0), traj, 64,
                                 ret=ret)
    assert scen.shape == (64, 11, 13)
    if with_ret:
        qn = torch.linalg.vector_norm(scen[..., 3:7], dim=-1)
        assert float((qn - 1.0).abs().max()) <= 1e-12


def test_sample_scenarios_factors_each_covariance_once(monkeypatch,
                                                      sat_prediction):
    """The H+1 covariances are factored in one call, whatever the number
    of scenarios (JAX's vmap leaves the unmapped factor out of the
    batch)."""
    traj, _ = sat_prediction
    calls = []
    real = torch.linalg.cholesky_ex

    def counting(A, *a, **kw):
        calls.append(tuple(A.shape))
        return real(A, *a, **kw)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", counting)
    pred.sample_scenarios(torch.Generator().manual_seed(0), traj, 200,
                          ret=ss.sat3D_retraction())
    assert calls == [(11, 12, 12)]


def test_monte_carlo_iekf_arc_against_jax_vmap():
    """The estimation example's Monte-Carlo path on 4 runs of 15 steps:
    one vmap of ``run_filter`` (iekf) on the draws JAX's keys make, against
    ``jax.vmap`` of the JAX example's ``run_filter``."""
    sys.path.insert(0, os.path.abspath(EXAMPLES))
    import estimate_satellite3d as jest
    from reak_tpu_torch.examples import estimate_satellite3d as est

    cfg = dict(est.DEFAULTS, steps=15, device="cpu")
    _, F = est.make_system(cfg)
    _, jF = jest.make_system(cfg)
    xs = est.truth_rollout(F, 15, device="cpu")
    jxs = jax.jit(lambda: jest.truth_rollout(jF, 15, None))()
    _close(xs, jxs, rtol=1e-13)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    eps = np.asarray(jax.vmap(lambda k: jnp.concatenate(
        [jax.random.normal(k_, (15, 3), jnp.float64)
         for k_ in jax.random.split(k, 3)], axis=-1))(keys))
    zs = est._measurements_from_draws(xs, cfg["meas_noise"],
                                      torch.as_tensor(eps))
    jzs = jax.vmap(lambda k: jest.noisy_measurements(jxs, cfg["meas_noise"],
                                                     k))(keys)
    _close(zs, jzs, rtol=1e-13)
    means = est.monte_carlo(cfg, F, zs)
    jmeans = jax.vmap(lambda z: jest.run_filter(cfg, jF, z))(jzs)
    assert means.shape == (4, 15, 13)
    _close(means, jmeans, rtol=1e-9)
