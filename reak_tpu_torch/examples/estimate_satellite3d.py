#!/usr/bin/env python
"""Satellite state estimation CLI — EKF / invariant EKF / UKF, Monte-Carlo
(port of ``examples/estimate_satellite3d.py``; ref:
examples/robot_airship/estimate_satellite3D.cpp:1482 main, :1493-1496
--generate-meas, :1502-1505 --mc-runs).

Monte-Carlo runs are one ``torch.func.vmap`` of ``run_filter`` over the
runs, on the card unless ``--device`` says otherwise; measurement streams
use the recorder data plane (file / tcp:// / udp:// URIs).  Everything
computes in float64.

The ``ekf`` and ``ukf`` filters innovate in the 10 ambient coordinates of
the pose-and-gyro output, so they take the ambient measurement covariance
(the attitude variance on each of the 4 quaternion components, as the
TSOS branch of ``run_from_options`` builds it).  The JAX example gives them
the 9×9 tangent covariance and fails with a shape error (fault F10 of the
reference); the ``iekf`` filter keeps the 9×9 one.

``--options`` (an ``EstimatorOptions`` scene file, written by either
package's ``io.serialization.save_scene``) runs ``run_from_options``;
``_run_from_options`` runs the same estimation from an ``EstimatorOptions``
instance.

Usage:
  python -m reak_tpu_torch.examples.estimate_satellite3d \\
      --generate-meas=meas.bin --steps=200
  python -m reak_tpu_torch.examples.estimate_satellite3d --input=meas.bin \\
      --filter=iekf --output=est.csv
  python -m reak_tpu_torch.examples.estimate_satellite3d --mc-runs=256 \\
      --filter=iekf
  python -m reak_tpu_torch.examples.estimate_satellite3d \\
      --options=tsos_airship.rkx
"""
import sys

import numpy as np
import torch
from torch.func import vmap

import reak_tpu_torch
from reak_tpu_torch.ctrl import ss_systems as ss
from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.ctrl.invariant import iekf_step
from reak_tpu_torch.ctrl.ukf import ukf_step
from reak_tpu_torch.io.config import config_from_args
from reak_tpu_torch.math import rotations as rot

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu_torch.enable_full_precision()

F64 = torch.float64

DEFAULTS = dict(
    steps=150, dt=0.05, mass=1.0, inertia=(0.9, 1.1, 1.0),
    meas_noise=1e-3, proc_noise=1e-6, seed=0,
    filter="iekf",          # ekf | iekf | ukf
    mc_runs=0,              # >0: vmapped Monte-Carlo statistics
    generate_meas="",       # write a measurement stream and exit
    input="",               # read measurements from a recorded stream
    output="",              # recorder URI for estimates (csv/bin/tcp/udp)
    options="",             # serialized EstimatorOptions scene file
    device="cuda",
)


def _ambient_cov(R):
    """The tangent measurement covariance [δp(3), δθ(3), rest] on the
    ambient output [p(3), q(4), rest]: the attitude variance on each
    quaternion component."""
    eye4 = torch.eye(4, dtype=R.dtype, device=R.device)
    return torch.block_diag(R[0:3, 0:3], eye4 * R[3, 3], R[6:, 6:])


def run_from_options(path: str, seed: int = 0, device="cuda"):
    """Drive a full estimation run from a serialized EstimatorOptions scene
    (ref: satellite_modeling_options.hpp:73,537 + the --init/--system files
    of estimate_satellite3D.cpp): model kind, noise, measurement config
    (incl. sonar grounding) and the TSOS-vs-joint filter choice all come
    from the archive.  Returns (opts, final joint belief, truth state), as
    ``_run_from_options`` does on the loaded options."""
    from reak_tpu_torch.ctrl import options  # noqa: F401 (registers the tag)
    from reak_tpu_torch.io.serialization import load_scene

    return _run_from_options(load_scene(path), seed, device)


def _run_from_options(opts, seed: int = 0, device="cuda"):
    """A full estimation run from an ``EstimatorOptions`` instance (ref:
    satellite_modeling_options.hpp:73,537 and the --init/--system files of
    estimate_satellite3D.cpp): model kind, noise, measurement configuration
    (sonar grounding included) and the TSOS-or-joint filter choice all come
    from ``opts``.  Returns (opts, final joint belief, true state)."""
    from reak_tpu_torch.ctrl import aug_kalman as ak

    F = opts.discrete()
    h = opts.output()
    gen = torch.Generator(device=device).manual_seed(seed)
    n_aug = opts.n_aug
    n_s = 13

    # truth rollout with gentle thruster excitation (observability)
    b0 = opts.initial_belief(device)
    ts = torch.arange(opts.steps, dtype=F64, device=device) * opts.time_step
    us = 0.5 * torch.stack([torch.sin(ts), torch.cos(1.3 * ts),
                            torch.sin(0.7 * ts), 0.2 * torch.sin(2.1 * ts),
                            0.2 * torch.cos(1.7 * ts),
                            0.2 * torch.sin(0.9 * ts)], dim=-1)
    xs = [b0.mean]
    for t in range(opts.steps):
        xs.append(F(xs[-1], us[t]))
    xs = torch.stack(xs)
    z_clean = h(xs[1:])
    # measurement noise in INNOVATION space: [δp(3), δθ(3), rest]; the
    # attitude block perturbs the quaternion multiplicatively
    R = opts.measurement_cov(device)
    sd = torch.sqrt(torch.diagonal(R))
    n, nz = z_clean.shape
    draw = lambda k: torch.randn((n, k), generator=gen, dtype=F64,
                                 device=device)
    dq = rot.q_exp(sd[3:6] * draw(3))
    parts = [z_clean[:, 0:3] + sd[0:3] * draw(3),
             rot.qnormalize(rot.qmul(z_clean[:, 3:7], dq))]
    if nz > 7:
        parts.append(z_clean[:, 7:] + sd[6:] * draw(nz - 7))
    zs = torch.cat(parts, dim=-1)

    if opts.tsos and n_aug:
        Fsa = lambda s, a, u, t=0.0: F(torch.cat([s, a]), u, t)[:n_s]
        hsa = lambda s, a, t=0.0: h(torch.cat([s, a]), t)
        P0 = b0.cov
        eye = lambda k: torch.eye(k, dtype=F64, device=device)
        # TSOS runs in ambient coordinates: 13-dim state block
        b = ak.tsos_init(b0.mean[:n_s], eye(n_s) * 1e-2, b0.mean[n_s:],
                         P0[12:12 + n_aug, 12:12 + n_aug])
        Qj = torch.block_diag(eye(n_s) * 1e-6, eye(n_aug) * 1e-8)
        # TSOS innovation is ambient (z − h)
        Ramb = _ambient_cov(R)
        for z, u in zip(zs, us):
            b = ak.tsos_step(Fsa, hsa, b, u, z, Qj, Ramb)
        belief = ak.tsos_joint_belief(b)
    else:
        ret = opts.retraction()
        Qt = torch.eye(12 + n_aug, dtype=F64, device=device) * 1e-6
        b = b0
        for z, u in zip(zs, us):
            b = iekf_step(F, lambda xx, t=0.0: h(xx), ret, b, u, z, Qt, R,
                          diff=opts.innovation())
        belief = b
    return opts, belief, xs[-1]


def make_system(cfg):
    params = ss.satellite3D(mass=cfg["mass"], inertia=np.diag(
        np.asarray(cfg["inertia"], np.float64)))
    F = ss.satellite3D_imdt(params, cfg["dt"])
    return params, F


def truth_rollout(F, steps, device="cuda"):
    """The true trajectory (steps+1, 13): a tumbling satellite, no
    input."""
    x = ss.default_state(device=device)
    x[10:13] = torch.tensor([0.3, -0.8, 0.5], dtype=F64)
    u = torch.zeros(6, dtype=F64, device=device)
    xs = [x]
    for _ in range(steps):
        xs.append(F(xs[-1], u))
    return torch.stack(xs)


def _measurements_from_draws(xs, noise, eps):
    """Standard-normal draws eps (..., steps, 9) → noisy pose-and-gyro
    measurements (..., steps, 10) of the trajectory xs: eps[..., 0:3] on
    the position, eps[..., 3:6] on the rates, eps[..., 6:9] as a body-frame
    rotation of the attitude (the JAX example's keys k1, k2, k3)."""
    zs = ss.h_pose_gyro(xs[1:])
    dq = rot.q_exp(noise * eps[..., 6:9])
    q = rot.qnormalize(rot.qmul(zs[..., 3:7], dq))
    return torch.cat([zs[..., 0:3] + noise * eps[..., 0:3], q,
                      zs[..., 7:10] + noise * eps[..., 3:6]], dim=-1)


def noisy_measurements(xs, noise, generator, runs=None):
    """Noisy measurements of the trajectory xs, (steps, 10), or
    (runs, steps, 10) with ``runs``; the draws come from ``generator`` on
    the trajectory's device."""
    shape = (() if runs is None else (runs,)) + (xs.shape[0] - 1, 9)
    eps = torch.randn(shape, generator=generator, dtype=xs.dtype,
                      device=xs.device)
    return _measurements_from_draws(xs, noise, eps)


def run_filter(cfg, F, zs):
    """One filtered trajectory; returns the stacked means (steps, 13)."""
    dev, dt = zs.device, zs.dtype
    eye = lambda k: torch.eye(k, dtype=dt, device=dev)
    Qd = eye(12) * cfg["proc_noise"]
    R = eye(9) * cfg["meas_noise"] ** 2 * 10 + eye(9) * 1e-8
    u = torch.zeros(6, dtype=dt, device=dev)
    ret = ss.sat3D_retraction()
    b = GaussianBelief(ss.default_state(dtype=dt, device=dev), eye(12) * 0.5)

    kind = cfg["filter"]
    if kind == "iekf":
        step = lambda b, z: iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd, R,
                                      diff=ss.pose_innovation)
    elif kind == "ekf":
        # innovation in the ambient output coordinates, the state corrected
        # through the retraction
        Ramb = _ambient_cov(R)
        step = lambda b, z: iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd,
                                      Ramb)
    elif kind == "ukf":
        Ramb = _ambient_cov(R)
        step = lambda b, z: ukf_step(F, lambda x, t=0.0: ss.h_pose_gyro(x),
                                     b, u, z, eye(13) * cfg["proc_noise"],
                                     Ramb)
        b = GaussianBelief(ss.default_state(dtype=dt, device=dev),
                           eye(13) * 0.5)
    else:
        raise SystemExit(f"unknown --filter={kind}")

    means = []
    for z in zs:
        b = step(b, z)
        means.append(b.mean)
    return torch.stack(means)


def final_errors(means, x):
    """The final estimate's errors against the true state x (13,): the
    position distance, the attitude angle (rad, in [0, π]; the quaternion
    normalized first, as the UKF's mean is not) and the rate distance,
    each over the leading axes of ``means`` (..., steps, 13)."""
    est = means[..., -1, :]
    q = rot.qnormalize(est[..., 3:7])
    dq = rot.qmul(rot.qconj(x[3:7]).expand(q.shape), q)
    dq = torch.where(dq[..., 0:1] < 0, -dq, dq)
    return (torch.linalg.vector_norm(est[..., 0:3] - x[0:3], dim=-1),
            torch.linalg.vector_norm(rot.q_log(dq), dim=-1),
            torch.linalg.vector_norm(est[..., 10:13] - x[10:13], dim=-1))


def monte_carlo(cfg, F, zs_mc):
    """``run_filter`` over a batch of measurement streams (runs, steps,
    10): one ``torch.func.vmap`` over the runs (replaces the reference's
    serial --mc-runs loop, estimate_satellite3D.cpp:1502)."""
    return vmap(lambda z: run_filter(cfg, F, z))(zs_mc)


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           defaults=DEFAULTS)
    dev = torch.device(cfg["device"])
    if cfg["options"]:
        opts, belief, x_true = run_from_options(cfg["options"], cfg["seed"],
                                                dev)
        err_p = float(torch.linalg.vector_norm(belief.mean[0:3]
                                               - x_true[0:3]))
        print(f"options={cfg['options']} kind={opts.system_kind} "
              f"meas={opts.measurements} tsos={opts.tsos}")
        print(f"final position error: {err_p:.3e}")
        if opts.n_aug:
            print("estimated aug params:",
                  belief.mean[13:13 + opts.n_aug].cpu().numpy())
        return 0
    params, F = make_system(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])

    if cfg["generate_meas"]:
        xs = truth_rollout(F, cfg["steps"], dev)
        zs = noisy_measurements(xs, cfg["meas_noise"], gen)
        from reak_tpu_torch.io.recorder import open_recorder
        cols = ([f"p{i}" for i in range(3)] + [f"q{i}" for i in range(4)]
                + [f"w{i}" for i in range(3)])
        rec = open_recorder(cfg["generate_meas"], cols)
        for z in zs.cpu().numpy():
            rec.record(z)
        rec.close()
        print(f"wrote {zs.shape[0]} measurements to {cfg['generate_meas']}")
        return 0

    if cfg["input"]:
        from reak_tpu_torch.io.recorder import open_extractor
        _, rows = open_extractor(cfg["input"])
        zs = torch.tensor(rows, dtype=F64, device=dev)
        xs = None
    else:
        xs = truth_rollout(F, cfg["steps"], dev)
        zs = noisy_measurements(xs, cfg["meas_noise"], gen)

    if cfg["mc_runs"] > 0:
        assert xs is not None, "--mc-runs needs simulated truth"
        zs_mc = noisy_measurements(xs, cfg["meas_noise"], gen,
                                   runs=cfg["mc_runs"])
        means = monte_carlo(cfg, F, zs_mc)
        err_p, _, err_w = final_errors(means, xs[-1])
        print(f"MC runs: {cfg['mc_runs']}   filter: {cfg['filter']}")
        print(f"final pos err: mean={float(err_p.mean()):.3e} "
              f"max={float(err_p.max()):.3e}")
        print(f"final rate err: mean={float(err_w.mean()):.3e} "
              f"max={float(err_w.max()):.3e}")
        return 0

    means = run_filter(cfg, F, zs)
    if xs is not None:
        err = float(torch.linalg.vector_norm(means[-1, 0:3] - xs[-1, 0:3]))
        print(f"filter={cfg['filter']}  final position error: {err:.3e}")
    if cfg["output"]:
        from reak_tpu_torch.io.recorder import open_recorder
        cols = [f"x{i}" for i in range(means.shape[1])]
        rec = open_recorder(cfg["output"], cols)
        for m in means.cpu().numpy():
            rec.record(m)
        rec.close()
        print(f"wrote estimates to {cfg['output']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
