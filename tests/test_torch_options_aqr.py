"""The port's estimator options (reak_tpu_torch.ctrl.options) and AQR
topologies (ctrl.aqr_space) against the JAX package, f64 on the CPU: every
``EstimatorOptions`` surface (``tests/test_estimator_options.py:77-92``)
≤1e-12 relative; the TSOS airship estimation of
``tests/test_estimator_options.py:94-127`` through the estimation example's
``_run_from_options`` on an instance, at that test's bars; and the MEAQR and
IHAQR tests of ``tests/test_aqr_space.py:30-54`` and ``:96-115``, with the
spaces' tables, distances and interpolations ≤1e-10 relative to JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import aqr_space as jaqr
from reak_tpu.ctrl.options import EstimatorOptions as JOptions
from reak_tpu_torch.ctrl import aqr_space as aqr
from reak_tpu_torch.ctrl.options import EstimatorOptions

torch.set_num_threads(1)


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)),
                                                    1e-300)


KINDS = [("satellite", "pose"), ("satellite", "pose_gyro"),
         ("satellite", "pose_imu"), ("airship", "pose"),
         ("airship_aug", "pose_sonars")]


@pytest.mark.parametrize("kind,meas", KINDS)
def test_options_surfaces(kind, meas):
    n_aug = 5 if kind == "airship_aug" else 0
    nz = {"pose": 7, "pose_gyro": 10, "pose_imu": 13, "pose_sonars": 13}[meas]
    kw = dict(system_kind=kind, measurements=meas, mass=2.0,
              inertia_diag=(0.8, 1.0, 1.2), time_step=0.04,
              buoyancy=-1.0 if kind != "airship" else 18.0,
              measurement_noise=(1e-4,) * (nz - 1),
              initial_cov_diag=(1e-2,) * (12 + n_aug))
    opts, jopts = EstimatorOptions(**kw), JOptions(**kw)
    assert opts.n_aug == jopts.n_aug == n_aug
    b0 = opts.initial_belief("cpu")
    jb0 = jopts.initial_belief()
    assert b0.mean.shape == (13 + n_aug,)
    _close(b0.mean, jb0.mean)
    _close(b0.cov, jb0.cov)
    _close(opts.process_cov("cpu"), jopts.process_cov())
    _close(opts.measurement_cov("cpu"), jopts.measurement_cov())
    # a state off the rest state, inside the room
    rng = np.random.default_rng(0)
    x = np.asarray(jb0.mean).copy()
    x[0:3] = rng.uniform(-1, 1, 3)
    x[3:7] = rng.standard_normal(4)
    x[3:7] /= np.linalg.norm(x[3:7])
    x[7:13] = rng.uniform(-0.3, 0.3, 6)
    u = rng.uniform(-1, 1, 6)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    _close(opts.continuous()(tx, tu), jopts.continuous()(jx, ju))
    x1 = opts.discrete()(tx, tu)
    _close(x1, jopts.discrete()(jx, ju))
    assert abs(float(torch.linalg.vector_norm(x1[3:7])) - 1.0) < 1e-12
    y = opts.output()(tx)
    assert y.shape == (nz,)
    _close(y, jopts.output()(jx))
    x2 = np.asarray(x1.numpy())
    _close(opts.innovation()(y, opts.output()(x1)),
           jopts.innovation()(jopts.output()(jx), jopts.output()(
               jnp.asarray(x2))))
    ret, jret = opts.retraction(), jopts.retraction()
    e = rng.standard_normal(12 + n_aug) * 0.1
    _close(ret.retract(tx, torch.as_tensor(e)), jret.retract(jx,
                                                             jnp.asarray(e)))
    p, jp = opts.params(), jopts.params()
    _close(p.inertia, jp.inertia)


def test_unknown_measurements_kind():
    with pytest.raises(ValueError):
        EstimatorOptions(measurements="lidar").output()


def test_tsos_airship_estimation_from_options():
    """tests/test_estimator_options.py:94-127 on an instance: the
    two-stage filter tracks the state and keeps the augmented parameters
    it was started at over 150 noisy sonar-and-pose measurements."""
    from reak_tpu_torch.examples import estimate_satellite3d as est

    opts = EstimatorOptions(
        system_kind="airship_aug", mass=2.0, inertia_diag=(0.8, 1.0, 1.2),
        time_step=0.05, measurements="pose_sonars", tsos=True,
        room_lower=(-8.0, -8.0, -8.0), room_upper=(8.0, 8.0, 8.0),
        measurement_noise=(1e-6,) * 3 + (1e-6,) * 3 + (1e-5,) * 6,
        initial_cov_diag=(1e-2,) * 12 + (0.05,) * 5,
        initial_state=tuple(
            np.concatenate([np.zeros(3), [1, 0, 0, 0], np.zeros(6),
                            [0.15, 0.02, -0.01, 0.0, 0.3]])),
        steps=150)
    opts2, belief, x_true = est._run_from_options(opts, seed=0,
                                                  device="cpu")
    assert opts2.tsos and opts2.n_aug == 5
    assert belief.mean.shape == (18,) and belief.cov.shape == (18, 18)
    assert float(torch.linalg.vector_norm(belief.mean[0:3]
                                          - x_true[0:3])) < 0.05
    a_true = np.array([0.15, 0.02, -0.01, 0.0, 0.3])
    assert np.max(np.abs(belief.mean[13:18].numpy() - a_true)) < 0.15


def test_run_from_options_reads_the_archive(tmp_path):
    """``run_from_options(path)`` on an options archive gives, bit for bit,
    what ``_run_from_options`` gives on the same options (20 steps), and
    so does an archive written by the JAX package."""
    import dataclasses

    from reak_tpu.io.serialization import save_scene as jax_save_scene
    from reak_tpu_torch.examples import estimate_satellite3d as est
    from reak_tpu_torch.io.serialization import save_scene

    kw = dict(system_kind="airship_aug", mass=2.0,
              inertia_diag=(0.8, 1.0, 1.2), time_step=0.05,
              measurements="pose_sonars", tsos=True,
              room_lower=(-8.0, -8.0, -8.0), room_upper=(8.0, 8.0, 8.0),
              measurement_noise=(1e-6,) * 3 + (1e-6,) * 3 + (1e-5,) * 6,
              initial_cov_diag=(1e-2,) * 12 + (0.05,) * 5,
              initial_state=tuple(np.concatenate(
                  [np.zeros(3), [1, 0, 0, 0], np.zeros(6),
                   [0.15, 0.02, -0.01, 0.0, 0.3]])), steps=20)
    opts = EstimatorOptions(**kw)
    _, b_ref, x_ref = est._run_from_options(opts, seed=0, device="cpu")
    port_path, jax_path = str(tmp_path / "p.rkx"), str(tmp_path / "j.rkx")
    save_scene(port_path, opts)
    jax_save_scene(jax_path, JOptions(**kw))
    for path in (port_path, jax_path):
        loaded, b, x = est.run_from_options(path, seed=0, device="cpu")
        assert dataclasses.asdict(loaded) == dataclasses.asdict(opts)
        assert torch.equal(b.mean, b_ref.mean) and torch.equal(b.cov,
                                                               b_ref.cov)
        assert torch.equal(x, x_ref)


A = np.array([[0.0, 1.0], [0.0, 0.0]])   # double integrator
B = np.array([[0.0], [1.0]])
LO = np.array([-5.0, -3.0])
HI = np.array([5.0, 3.0])


@pytest.fixture(scope="module")
def meaqr():
    kw = dict(lower=LO, upper=HI, t_max=3.0, n_grid=32, time_weight=0.1)
    return (aqr.MEAQRSpace(A, B, device="cpu", **kw),
            jaqr.MEAQRSpace(jnp.asarray(A), jnp.asarray(B), **kw))


@pytest.fixture(scope="module")
def ihaqr():
    return (aqr.IHAQRSpace(A, B, lower=LO, upper=HI, t_horizon=6.0,
                           device="cpu"),
            jaqr.IHAQRSpace(jnp.asarray(A), jnp.asarray(B), lower=LO,
                            upper=HI, t_horizon=6.0))


@pytest.mark.parametrize("space", ["MEAQRSpace", "IHAQRSpace"])
def test_space_from_numpy_lands_on_the_card(space):
    """Like the JAX classes, which land on the default accelerator, a
    space built from numpy matrices puts its tensors on the card unless
    ``device`` says otherwise, with no fall back to the CPU where there is
    no card; a tensor A keeps its device."""
    import inspect

    cls = getattr(aqr, space)
    default = inspect.signature(cls).parameters["device"].default
    assert torch.device(default).type == "cuda"
    if torch.cuda.is_available():
        assert cls(A, B, lower=LO, upper=HI).lower.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cls(A, B, lower=LO, upper=HI)
    on_cpu = cls(torch.as_tensor(A), B, lower=LO, upper=HI, n_grid=4)
    assert on_cpu.lower.device.type == "cpu"


class TestMEAQR:
    def test_tables_match_jax(self, meaqr):
        sp, jsp = meaqr
        for f in ("times", "Phis", "ds", "Gs"):
            _close(getattr(sp, f), getattr(jsp, f), rtol=1e-10)

    def test_interpolate_endpoints(self, meaqr):
        sp, jsp = meaqr
        a, b = np.array([0.0, 0.0]), np.array([1.0, 0.0])
        np.testing.assert_allclose(sp.interpolate(a, b, 0.0), a, atol=1e-9)
        np.testing.assert_allclose(sp.interpolate(a, b, 1.0), b, atol=1e-6)
        for t in (0.0, 0.3, 0.5, 1.0):
            _close(sp.interpolate(a, b, t), jsp.interpolate(a, b, t),
                   rtol=1e-10)

    def test_min_energy_trajectory_arcs_through_velocity(self, meaqr):
        mid = meaqr[0].interpolate(np.array([0.0, 0.0]),
                                   np.array([1.0, 0.0]), 0.5)
        assert float(mid[1]) > 0.3

    def test_distance_batched_and_finite(self, meaqr):
        sp, jsp = meaqr
        rng = np.random.default_rng(42)
        a = np.array([0.0, 0.0])
        V = rng.uniform(-2, 2, (50, 2))
        d = sp.distance(a, V)
        assert d.shape == (50,)
        assert bool(torch.all(torch.isfinite(d))) and bool(torch.all(d > 0))
        _close(d, jsp.distance(jnp.asarray(a), jnp.asarray(V)), rtol=1e-10)
        # batched interpolation, one fraction a pair
        ts = rng.uniform(0, 1, 50)
        _close(sp.interpolate(np.tile(a, (50, 1)), V, ts),
               jsp.interpolate(jnp.tile(jnp.asarray(a), (50, 1)),
                               jnp.asarray(V), jnp.asarray(ts)), rtol=1e-10)

    def test_self_distance_minimal(self, meaqr):
        sp = meaqr[0]
        a, b = np.array([0.4, 0.0]), np.array([1.0, 0.5])
        d_self = float(sp.distance(a, a))
        assert d_self < float(sp.distance(a, b))
        t1 = float(sp.times[1])
        assert d_self == pytest.approx((0.1 * t1) ** 0.5, rel=1e-3)

    def test_sample_clamp_contains_and_workspace(self, meaqr):
        sp = meaqr[0]
        pts = sp.sample(torch.Generator().manual_seed(0), (100,))
        assert pts.shape == (100, 2) and bool(sp.contains(pts).all())
        far = torch.tensor([[9.0, -9.0]], dtype=torch.float64)
        assert not bool(sp.contains(far)[0])
        assert torch.equal(sp.clamp(far), torch.tensor([[5.0, -3.0]],
                                                       dtype=torch.float64))
        ws = aqr.AQRWorkspace(sp, lambda p: p[:, 0] < 0.7, n_checks=8)
        a = torch.zeros(2, 2, dtype=torch.float64)
        b = torch.tensor([[0.5, 0.0], [1.5, 0.0]], dtype=torch.float64)
        assert ws.edge_free_batch(a, b).tolist() == [True, False]


class TestIHAQR:
    def test_gains_match_jax(self, ihaqr):
        sp, jsp = ihaqr
        for f in ("P", "K", "flows"):
            _close(getattr(sp, f), getattr(jsp, f), rtol=1e-10)

    def test_metric_is_lqr_cost_to_go(self, ihaqr):
        sp = ihaqr[0]
        d = torch.tensor([1.0, 0.5], dtype=torch.float64)
        expect = float(torch.sqrt(d @ sp.P @ d))
        assert abs(float(sp.distance(np.zeros(2), d)) - expect) < 1e-12

    def test_closed_loop_flow_converges(self, ihaqr):
        sp, jsp = ihaqr
        a, b = np.array([2.0, 0.0]), np.array([-1.0, 0.0])
        assert float(np.linalg.norm(sp.interpolate(a, b, 1.0).numpy()
                                    - b)) < 0.05
        np.testing.assert_allclose(sp.interpolate(a, b, 0.0), a, atol=1e-12)
        for t in (0.3, 0.6, 1.0):
            _close(sp.interpolate(a, b, t), jsp.interpolate(a, b, t),
                   rtol=1e-10)

    def test_flow_monotone_approach(self, ihaqr):
        sp = ihaqr[0]
        a, b = np.array([2.0, 0.0]), np.array([-1.0, 0.0])
        ds = [float(sp.distance(sp.interpolate(a, b, t), b))
              for t in (0.0, 0.3, 0.6, 1.0)]
        assert ds[0] > ds[1] > ds[2] > ds[3]
