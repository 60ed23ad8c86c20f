"""The port's config and recorder modules (reak_tpu_torch.io), as
``tests/test_io.py:13-84`` and ``:144-173`` test the JAX package's, and its
three examples (``reak_tpu_torch.examples``) on the CPU at small sizes: the
estimation CLI's round trip and Monte-Carlo run (as
``tests/test_examples.py:12-28``), the prediction CLI, and the satellite
MPC CLI.  Two faults of the JAX examples are fixed in the port and tested
here on their own: F10 (the ``ekf`` and ``ukf`` filters fail with a shape
error: here each filter's final position, attitude and rates are held to
the truth, a filter with its update taken out is shown to fail those bars,
and the two fixed branches are held to the JAX package's ``iekf_step`` and
``ukf_step`` on the ambient R) and F11 (``satellite_mpc --output`` calls a
missing ``write_row``)."""
import json
import threading

import numpy as np
import pytest
import torch

import reak_tpu_torch.io as io
from reak_tpu_torch.examples import estimate_satellite3d as est, \
    predict_satellite3d as pred, satellite_mpc as smpc
from reak_tpu_torch.io.recorder import BinaryRecorder, CsvRecorder, \
    MemoryRecorder, NetworkServer, TcpRecorder

torch.set_num_threads(1)
CPU = "--device=cpu"


def test_memory_recorder():
    rec = MemoryRecorder(["t", "x"])
    rec.record([0.0, 1.0])
    rec.record({"t": 1.0, "x": 2.0})
    rec.close()
    np.testing.assert_allclose(rec.as_array(), [[0, 1], [1, 2]])
    with pytest.raises(ValueError):
        MemoryRecorder(["a", "b"]).record([1.0])


@pytest.mark.parametrize("kind", ["ssv", "bin"])
def test_file_roundtrip(tmp_path, kind):
    p = str(tmp_path / f"out.{kind}")
    if kind == "ssv":
        rec = CsvRecorder(p, ["time", "q"], buffered=True)
        for i in range(5):
            rec.record([i * 0.1, i * i])
    else:
        rec = BinaryRecorder(p, ["time", "q"], buffered=False)
        for i in range(5):
            rec.record([i * 0.1, i * i])
    rec.close()
    cols, rows = io.open_extractor(p)
    assert cols == ["time", "q"]
    np.testing.assert_allclose(rows[:, 1], [0, 1, 4, 9, 16])


def test_tcp_loopback():
    srv = NetworkServer(0)
    rows_out = []

    def serve():
        srv.accept()
        while True:
            r = srv.read_row()
            if r is None:
                break
            rows_out.append(r)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    rec = TcpRecorder("127.0.0.1", srv.port, ["t", "z"], buffered=False)
    rec.record([0.0, 42.0])
    rec.record([1.0, 43.0])
    rec.close()
    th.join(timeout=5)
    srv.close()
    assert len(rows_out) == 2
    np.testing.assert_allclose(rows_out[1], [1.0, 43.0])
    assert isinstance(io.open_recorder("mem:", ["x"]), MemoryRecorder)


def test_config(tmp_path):
    cfg = io.Config({"mpc": {"horizon": 50}})
    assert cfg.get_path("mpc.horizon") == 50
    cfg.set_path("mpc.qp.iters", 8)
    assert cfg.mpc.qp.iters == 8
    assert cfg.get_path("missing.key", "dflt") == "dflt"
    base = str(tmp_path / "base.json")
    with open(base, "w") as f:
        json.dump({"sim": {"dt": 0.01, "steps": 100}}, f)
    cfg = io.config_from_args(
        [f"--config={base}", "--sim.dt=0.02", "--flag", "--name=run1",
         "--weights=[1.0,2.0]", "--mc-runs=3"],
        defaults={"sim": {"dt": 0.5}})
    assert cfg.sim.dt == 0.02 and cfg.sim.steps == 100
    assert cfg.flag is True and cfg.name == "run1"
    assert cfg.weights == [1.0, 2.0] and cfg.mc_runs == 3


def test_estimate_cli_roundtrip(tmp_path):
    meas = str(tmp_path / "meas.bin")
    out = str(tmp_path / "est.csv")
    assert est.main([f"--generate-meas={meas}", "--steps=30", CPU]) == 0
    assert est.main([f"--input={meas}", "--filter=iekf", f"--output={out}",
                     CPU]) == 0
    with open(out) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 31  # header + 30 estimates


def test_estimate_cli_options(tmp_path, monkeypatch, capsys):
    """``--options`` runs ``run_from_options`` on the archive: its run is,
    bit for bit, ``_run_from_options`` on the same options (20 steps), and
    it prints that run's final position error."""
    from reak_tpu_torch.ctrl.options import EstimatorOptions
    from reak_tpu_torch.io.serialization import save_scene

    opts = EstimatorOptions(system_kind="satellite", measurements="pose_gyro",
                            mass=1.5, inertia_diag=(0.9, 1.1, 1.0),
                            measurement_noise=(1e-4,) * 9,
                            initial_cov_diag=(1e-2,) * 12, steps=20)
    path = str(tmp_path / "sat.rkx")
    save_scene(path, opts)
    runs = []
    real = est._run_from_options
    monkeypatch.setattr(est, "_run_from_options",
                        lambda *a, **k: runs.append(real(*a, **k)) or runs[-1])
    assert est.main([f"--options={path}", CPU]) == 0
    (got_opts, b, x), = runs
    _, b_ref, x_ref = real(opts, seed=0, device="cpu")
    assert got_opts == opts
    assert torch.equal(b.mean, b_ref.mean) and torch.equal(b.cov, b_ref.cov)
    assert torch.equal(x, x_ref)
    err = float(torch.linalg.vector_norm(b_ref.mean[0:3] - x_ref[0:3]))
    out = capsys.readouterr().out
    assert f"final position error: {err:.3e}" in out
    assert "kind=satellite meas=pose_gyro tsos=False" in out


def test_estimate_cli_mc(capsys):
    assert est.main(["--steps=15", "--mc-runs=4", CPU]) == 0
    out = capsys.readouterr().out
    assert "MC runs: 4" in out and "final pos err" in out


# tests/test_ss_systems.py:95-96: the final position and rate errors after
# 150 steps; the attitude angle (rad) is held to the same bar
BAR = 0.05
JAX_STEPS = 30


def _within_bars(means, x):
    return all(float(e) < BAR for e in est.final_errors(means, x))


@pytest.fixture(scope="module")
def satellite_track():
    """The estimation example at its defaults (f64, 150 steps, seed 0): the
    config, the dynamics, the truth, the measurements and each filter's
    means.  The truth tumbles in place (rates set, no velocity, no input),
    so the attitude and the rates are what it moves."""
    cfg = dict(est.DEFAULTS, device="cpu")
    _, F = est.make_system(cfg)
    xs = est.truth_rollout(F, 150, device="cpu")
    zs = est.noisy_measurements(xs, cfg["meas_noise"],
                                torch.Generator().manual_seed(0))
    means = {kind: est.run_filter(dict(cfg, filter=kind), F, zs)
             for kind in ("iekf", "ekf", "ukf")}
    return cfg, F, xs, zs, means


def test_every_filter_tracks_the_satellite(satellite_track):
    """F10 fixed in the port: ``ekf`` and ``ukf`` run (on the ambient
    measurement covariance), and each of the three filters ends within
    0.05 of the true position and rates and 0.05 rad of the true attitude
    after 150 steps at f64."""
    _, _, xs, _, means = satellite_track
    for kind, m in means.items():
        assert m.shape == (150, 13) and bool(torch.isfinite(m).all())
        assert _within_bars(m, xs[-1]), (kind, est.final_errors(m, xs[-1]))


@pytest.mark.parametrize("kind", ["iekf", "ekf", "ukf"])
def test_a_filter_that_skips_its_update_fails_the_bars(monkeypatch,
                                                       satellite_track,
                                                       kind):
    """The bars above catch a filter that never applies a measurement:
    with each step's update taken out, the estimate after 20 steps is
    outside them (its rates stay at rest and its attitude falls behind;
    the position stays at the truth's, the origin)."""
    from reak_tpu_torch.ctrl.invariant import iekf_predict
    from reak_tpu_torch.ctrl.ukf import ukf_predict

    monkeypatch.setattr(
        est, "iekf_step", lambda F_, h, ret, b, u, z, Q, R, t=0.0,
        diff=None: iekf_predict(F_, ret, b, u, Q, t))
    monkeypatch.setattr(
        est, "ukf_step", lambda F_, h, b, u, z, Q, R, t=0.0, **kw:
        ukf_predict(F_, b, u, Q, t, **kw))
    cfg, F, xs, zs, _ = satellite_track
    m = est.run_filter(dict(cfg, filter=kind), F, zs[:20])
    assert not _within_bars(m, xs[20])


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_ekf_and_ukf_branches_against_jax(satellite_track, kind):
    """F10's branches have no JAX run to be held to, since the JAX
    example's fail; so the JAX package's ``iekf_step`` (no innovation map)
    and ``ukf_step`` are driven here as the fixed branches drive the
    port's, on the 10×10 ambient R that the JAX example's
    ``run_from_options`` builds (examples/estimate_satellite3d.py:110-113)
    and on the same measurements: the first JAX_STEPS means ≤1e-9
    relative."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import block_diag
    from reak_tpu.ctrl import ss_systems as jss
    from reak_tpu.ctrl.belief import GaussianBelief
    from reak_tpu.ctrl.invariant import iekf_step
    from reak_tpu.ctrl.ukf import ukf_step

    cfg, _, _, zs, means = satellite_track
    jF = jss.satellite3D_imdt(jss.satellite3D(
        mass=cfg["mass"], inertia=np.diag(cfg["inertia"])), cfg["dt"])
    R = jnp.eye(9) * cfg["meas_noise"] ** 2 * 10 + jnp.eye(9) * 1e-8
    Ramb = block_diag(R[0:3, 0:3], jnp.eye(4) * R[3, 3], R[6:, 6:])
    u = jnp.zeros(6)
    if kind == "ekf":
        ret = jss.sat3D_retraction()
        Q = jnp.eye(12) * cfg["proc_noise"]
        b = GaussianBelief(jss.default_state(), jnp.eye(12) * 0.5)
        step = jax.jit(lambda b, z: iekf_step(jF, jss.h_pose_gyro, ret, b, u,
                                              z, Q, Ramb))
    else:
        Q = jnp.eye(13) * cfg["proc_noise"]
        b = GaussianBelief(jss.default_state(), jnp.eye(13) * 0.5)
        step = jax.jit(lambda b, z: ukf_step(
            jF, lambda x, t=0.0: jss.h_pose_gyro(x), b, u, z, Q, Ramb))
    want = []
    for z in jnp.asarray(zs[:JAX_STEPS].numpy()):
        b = step(b, z)
        want.append(np.asarray(b.mean))
    want = np.stack(want)
    got = means[kind][:JAX_STEPS].numpy()
    assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))


def test_predict_cli(capsys, tmp_path):
    out = str(tmp_path / "pred.csv")
    assert pred.main(["--steps=20", "--horizon=10", "--n-scenarios=4",
                      f"--output={out}", CPU]) == 0
    text = capsys.readouterr().out
    assert "predicted 10 steps" in text and "scenarios: (4, 11, 13)" in text
    cols, rows = io.open_extractor(out)
    assert len(cols) == 15 and rows.shape == (11, 15)
    assert np.all(np.diff(rows[:, -1]) > 0)        # the trace grows


def test_satellite_mpc_cli(capsys):
    perr = smpc.main(["--scenarios=4", "--est-steps=5", CPU])
    assert "scenarios=4 horizon=20" in capsys.readouterr().out
    assert np.isfinite(perr) and perr < 0.2


def test_satellite_mpc_output(tmp_path):
    """F11 fixed in the port: ``--output`` writes a header and one row a
    scenario and step with the recorder's ``record``."""
    out = str(tmp_path / "plans.csv")
    smpc.main(["--scenarios=2", "--horizon=5", f"--output={out}", CPU])
    cols, rows = io.open_extractor(out)
    assert cols == ["scenario", "t"] + [f"u{i}" for i in range(6)]
    assert rows.shape == (10, 8)
    np.testing.assert_array_equal(rows[:, 0], np.repeat([0, 1], 5))
    np.testing.assert_allclose(rows[:5, 1], 0.1 * np.arange(5))
