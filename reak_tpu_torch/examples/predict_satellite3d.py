#!/usr/bin/env python
"""Satellite target prediction CLI — estimate online, then predict forward
(port of ``examples/predict_satellite3d.py``; ref:
examples/robot_airship/predict_satellite3D.cpp:414 main;
ctrl_sys/belief_state_predictor.hpp:79): run the invariant filter over a
measurement stream, then roll the belief forward over a horizon and emit
the maximum-likelihood predicted trajectory and covariance traces, and
optionally scenarios sampled from it (``--n-scenarios``).  On the card
unless ``--device`` says otherwise, in float64.

Usage:
  python -m reak_tpu_torch.examples.predict_satellite3d --steps=100 \\
      --horizon=50 --output=pred.csv
"""
import sys
from typing import NamedTuple, Optional

import torch

import reak_tpu_torch
from reak_tpu_torch.ctrl import predictor, ss_systems as ss
from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.ctrl.invariant import iekf_step
from reak_tpu_torch.examples.estimate_satellite3d import (
    DEFAULTS as EST_DEFAULTS, make_system, noisy_measurements, truth_rollout)
from reak_tpu_torch.io.config import config_from_args

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu_torch.enable_full_precision()

DEFAULTS = dict(EST_DEFAULTS, horizon=50, n_scenarios=0, output="")


class Prediction(NamedTuple):
    traj: predictor.PredictedBeliefTrajectory
    scenarios: Optional[torch.Tensor]   # (n_scenarios, H+1, 13) or None
    final_err: float       # predicted final position against the truth
    trace_growth: float    # trace of the last covariance over the first


def predict(cfg) -> Prediction:
    """Filter ``cfg["steps"]`` measurements, predict ``cfg["horizon"]``
    steps, and sample ``cfg["n_scenarios"]`` trajectories."""
    dev = torch.device(cfg["device"])
    params, F = make_system(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    xs = truth_rollout(F, cfg["steps"], dev)
    zs = noisy_measurements(xs, cfg["meas_noise"], gen)

    eye = lambda k: torch.eye(k, dtype=xs.dtype, device=dev)
    ret = ss.sat3D_retraction()
    Qd = eye(12) * cfg["proc_noise"]
    R = eye(9) * cfg["meas_noise"] ** 2 * 10 + eye(9) * 1e-8
    u = torch.zeros(6, dtype=xs.dtype, device=dev)
    b = GaussianBelief(ss.default_state(device=dev), eye(12) * 0.5)
    for z in zs:
        b = iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd, R,
                      diff=ss.pose_innovation)

    H = cfg["horizon"]
    traj = predictor.predict_belief_trajectory(
        F, ret, b, torch.zeros((H, 6), dtype=xs.dtype, device=dev), Qd,
        cfg["dt"], t0=cfg["steps"] * cfg["dt"])
    # prediction quality against the continued truth
    x_true = xs[-1]
    for _ in range(H):
        x_true = F(x_true, u)
    err = float(torch.linalg.vector_norm(traj.means[-1, 0:3] - x_true[0:3]))
    growth = float(torch.trace(traj.covs[-1]) / torch.trace(traj.covs[0]))
    scen = None
    if cfg["n_scenarios"] > 0:
        scen = predictor.sample_scenarios(gen, traj, cfg["n_scenarios"],
                                          ret=ret)
    return Prediction(traj, scen, err, growth)


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           defaults=DEFAULTS)
    res = predict(cfg)
    traj = res.traj
    print(f"predicted {cfg['horizon']} steps; final position error vs "
          f"truth: {res.final_err:.3e}")
    print(f"cov trace growth: {res.trace_growth:.2f}x")
    if res.scenarios is not None:
        print(f"sampled scenarios: {tuple(res.scenarios.shape)} (feed to "
              "scenario-MPC batch)")

    if cfg["output"]:
        from reak_tpu_torch.io.recorder import open_recorder
        cols = (["t"] + [f"x{i}" for i in range(13)] + ["cov_trace"])
        rec = open_recorder(cfg["output"], cols)
        traces = torch.diagonal(traj.covs, dim1=-2, dim2=-1).sum(-1)
        for t, m, tr in zip(traj.times.cpu().numpy(),
                            traj.means.cpu().numpy(), traces.cpu().numpy()):
            rec.record([t, *m, tr])
        rec.close()
        print(f"wrote predicted trajectory to {cfg['output']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
