#!/usr/bin/env python
"""Free-base belief-sampled scenario MPC CLI — BASELINE config 4 (port of
``examples/satellite_mpc.py``).

An invariant-EKF posterior on the quaternion-state satellite (ref:
ss_systems/satellite_invar_models.hpp:296), tangent-space scenario sampling
(ref: ctrl_sys/gaussian_belief_state.hpp:491 sample_gaussian_point), then
the batched error-state MPC to a pose target on the lanes route
(``ctrl/manifold_lanes.make_sat_scenario_mpc_lanes``: the analytic step and
LTV, the QP in one whole-solve PDIP kernel launch a pass on the card).  On
the card unless ``--device`` says otherwise, in float64.

``--output`` writes one row a scenario and step with the recorder's
``record``; the JAX example calls a ``write_row`` that no recorder has and
fails there (fault F11 of the reference).

Usage:
  python -m reak_tpu_torch.examples.satellite_mpc --scenarios=32 \\
      --horizon=20
  python -m reak_tpu_torch.examples.satellite_mpc --est-steps=20 \\
      --target="1,0.5,-0.3" --output=plans.csv
"""
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

import reak_tpu_torch
from reak_tpu_torch.ctrl import manifold_lanes as ml, mpc, \
    mpc_manifold as mm, ss_systems as ss
from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.ctrl.invariant import iekf_step
from reak_tpu_torch.io.config import config_from_args
from reak_tpu_torch.math import rotations as rot

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu_torch.enable_full_precision()

F64 = torch.float64

DEFAULTS = dict(
    dt=0.1, horizon=20, scenarios=16, est_steps=15,
    mass=10.0, inertia=(4.0, 5.0, 6.0),
    meas_noise=1e-2, proc_noise=1e-6, seed=0,
    u_max=20.0, qp_iters=8, sqp_iters=2,
    target="1.0,0.5,-0.3",   # pose-target position
    target_yaw=0.6,          # pose-target rotation about +z
    output="",               # recorder URI for per-scenario plans
    device="cuda",
)


class Plan(NamedTuple):
    posterior: GaussianBelief
    posterior_err: float     # |δp, δθ| of the posterior mean
    x0s: torch.Tensor        # (n, 13) sampled initial states
    x_ref: torch.Tensor      # (13,) the pose target
    us: torch.Tensor         # (n, H, 6)
    xs: torch.Tensor         # (n, H, 13)
    terminal_pos_err: torch.Tensor   # (n,)
    terminal_rot_err: torch.Tensor   # (n,)
    solver: Callable         # solve(x0s, x_ref, us_init) → (us, xs)


def plan(cfg) -> Plan:
    """The IEKF over a simulated measured arc, then the belief-sampled
    scenario MPC from its posterior."""
    dev = torch.device(cfg["device"])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    params = ss.satellite3D(mass=cfg["mass"],
                            inertia=np.diag(np.asarray(cfg["inertia"])))
    F = ss.satellite3D_imdt(params, cfg["dt"])
    ret = ss.sat3D_retraction()
    rng = np.random.default_rng(cfg["seed"])

    # ---- estimate: IEKF over a simulated measured arc ---------------------
    eye = lambda k: torch.eye(k, dtype=F64, device=dev)
    Q = eye(12) * cfg["proc_noise"]
    R = torch.diag(t(np.r_[np.full(3, cfg["meas_noise"] ** 2),
                           np.full(3, 1e-5)]))
    x_true = ss.default_state(device=dev)
    x_true[10:13] = t([0.02, -0.01, 0.03])
    b = GaussianBelief(ss.default_state(device=dev), 0.1 * eye(12))
    u0 = torch.zeros(6, dtype=F64, device=dev)
    for _ in range(int(cfg["est_steps"])):
        x_true = F(x_true, u0)
        z = ss.h_pose(x_true)
        z = torch.cat([z[0:3] + t(rng.normal(0, cfg["meas_noise"], 3)),
                       z[3:]])
        b = iekf_step(F, ss.h_pose, ret, b, u0, z, Q, R,
                      diff=ss.pose_innovation)
    e_post = ret.local(x_true, b.mean)

    # ---- plan: belief-sampled scenario MPC to the pose target -------------
    w = np.r_[np.full(6, 10.0), np.full(6, 1.0)]
    prob = mpc.MPCProblem(
        Q=torch.diag(t(w)), R=eye(6) * 0.05, QN=torch.diag(t(10.0 * w)),
        u_min=t(np.full(6, -cfg["u_max"])), u_max=t(np.full(6, cfg["u_max"])),
        horizon=int(cfg["horizon"]))
    x_ref = ss.default_state(device=dev)
    x_ref[0:3] = t([float(s) for s in str(cfg["target"]).split(",")])
    x_ref[3:7] = rot.q_from_axis_angle(t([0.0, 0.0, 1.0]),
                                       float(cfg["target_yaw"]))
    n = int(cfg["scenarios"])
    solver = ml.make_sat_scenario_mpc_lanes(
        params, prob, cfg["dt"], qp_iters=int(cfg["qp_iters"]),
        sqp_iters=int(cfg["sqp_iters"]))
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    x0s = mm.sample_belief_states(gen, b, n, ret=ret)
    us, xs = solver(x0s, x_ref, torch.zeros((n, prob.horizon, 6), dtype=F64,
                                            device=dev))
    perr = torch.linalg.vector_norm(xs[:, -1, 0:3] - x_ref[0:3], dim=-1)
    dth = torch.linalg.vector_norm(rot.q_log(rot.qmul(
        rot.qconj(x_ref[3:7]), xs[:, -1, 3:7])), dim=-1)
    return Plan(b, float(torch.linalg.vector_norm(e_post[0:6])), x0s, x_ref,
                us, xs, perr, dth, solver)


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           DEFAULTS)
    res = plan(cfg)
    n, H = res.us.shape[0], res.us.shape[1]
    print(f"posterior tangent error |δp,δθ| = {res.posterior_err:.4f}")
    print(f"scenarios={n} horizon={H} "
          f"terminal pos err mean={float(res.terminal_pos_err.mean()):.4f} "
          f"max={float(res.terminal_pos_err.max()):.4f} "
          f"rot err max={float(res.terminal_rot_err.max()):.4f}")

    if cfg["output"]:
        from reak_tpu_torch.io.recorder import open_recorder

        cols = ["scenario", "t"] + [f"u{i}" for i in range(6)]
        rec = open_recorder(cfg["output"], cols)
        us = res.us.cpu().numpy()
        for i in range(n):
            for k in range(H):
                rec.record(np.concatenate([[i, k * cfg["dt"]], us[i, k]]))
        rec.close()
        print(f"wrote plans to {cfg['output']}")

    return float(res.terminal_pos_err.max())


if __name__ == "__main__":
    main()
