#!/usr/bin/env python
"""Online composite pipeline: estimate → predict → intercept-plan → record
(port of ``examples/crs_dynexec.py``).

Equivalent of the reference's dynamic-execution composition
(ref: examples/robot_airship/CRS_planner_dynexec.cpp:75
CRS_execute_dynamic_planner_impl + predict_satellite3D.cpp:414 streaming;
ctrl_sys/belief_state_predictor.hpp:79; interpolation/transformed_trajectory.hpp
DK∘IK mapping; path_planning/intercept_query.hpp:75):

  1. a satellite target drifts through the chaser arm's workspace; its noisy
     pose+gyro measurements stream over a LOOPBACK TCP ROW CHANNEL (the
     reference's --online-run measurement plane, network_recorder.cpp:28);
  2. an invariant EKF consumes rows as they arrive (online estimation);
  3. the final belief rolls forward through the belief predictor → the
     maximum-likelihood predicted target trajectory;
  4. the predicted SE(3) poses map through closed-form 3R3R IK into the
     chaser's joint space (the transformed_trajectory composition);
  5. the time-augmented intercept planner plans over the REAL collision
     stack (ChainWorkspace → proxy_query) to meet the target in time;
  6. the executed plan streams out through a recorder sink.

On the card unless ``--device`` says otherwise, in float64.  The
measurement noise is drawn from a ``torch.Generator`` seeded ``--seed`` on
the device; ``main(argv, noise=...)`` takes the standard normal draws
instead (a (steps, 3) array), so that a caller can replay another
package's.

Usage:
  python -m reak_tpu_torch.examples.crs_dynexec --steps=40 --horizon=30 --output=plan.csv
"""
import sys
import threading

import numpy as np
import torch

import reak_tpu_torch
import reak_tpu_torch.planning as pl
import reak_tpu_torch.spaces.vector as sp
from reak_tpu_torch.ctrl import predictor
from reak_tpu_torch.ctrl import ss_systems as ss
from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.ctrl.invariant import iekf_step
from reak_tpu_torch.examples.run_crs_planner import chain_capsules
from reak_tpu_torch.geom.proximity import ProxyModel
from reak_tpu_torch.geom.shapes import Plane, ShapeSet, Sphere
from reak_tpu_torch.interp.trajectory import Trajectory
from reak_tpu_torch.io.config import config_from_args
from reak_tpu_torch.io.recorder import NetworkServer, TcpRecorder, \
    open_recorder
from reak_tpu_torch.kte import ik, models
from reak_tpu_torch.math import rotations as rot
from reak_tpu_torch.planning.workspace import (TemporalChainWorkspace,
                                               rigid_traj_tabulated)

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu_torch.enable_full_precision()

DEFAULTS = dict(
    steps=40,            # measurement rows streamed online
    horizon=30,          # prediction steps
    dt=0.05,
    meas_noise=2e-3,
    proc_noise=1e-6,
    seed=0,
    port=48612,
    max_iters=120,
    output="",
    device="cuda",
)


def _on(cfg, x):
    """``x`` as a float64 tensor on the configured device."""
    if torch.is_tensor(x):
        return x.to(dtype=torch.float64, device=cfg["device"])
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float64,
                           device=cfg["device"])


def target_truth(cfg):
    """Satellite drifting through the arm workspace (reachable grapple):
    the discrete model F and the true states (steps + horizon + 1, 13)."""
    params = ss.satellite3D(mass=120.0, inertia=np.eye(3) * 8.0)
    F = ss.satellite3D_imdt(params, cfg["dt"])
    x = ss.default_state(device=cfg["device"])
    x[0:3] = _on(cfg, [0.62, -0.28, 0.40])    # in-workspace start
    x[7:10] = _on(cfg, [-0.035, 0.06, 0.01])  # slow drift
    x[10:13] = _on(cfg, [0.02, -0.01, 0.03])  # slow tumble
    xs = [x]
    u = torch.zeros(6, dtype=x.dtype, device=x.device)
    for _ in range(cfg["steps"] + cfg["horizon"]):
        xs.append(F(xs[-1], u))
    return F, torch.stack(xs)


def measurements(cfg, xs, noise=None):
    """Pose+gyro rows of the states 1 … steps, position noise
    ``meas_noise`` times ``noise`` (standard normal, (steps, 3)), drawn
    from a generator seeded ``cfg["seed"]`` when None."""
    zs = ss.h_pose_gyro(xs[1: cfg["steps"] + 1])
    if noise is None:
        gen = torch.Generator(xs.device).manual_seed(int(cfg["seed"]))
        noise = torch.randn((cfg["steps"], 3), generator=gen,
                            dtype=zs.dtype, device=zs.device)
    zs = zs.clone()
    zs[:, 0:3] += cfg["meas_noise"] * _on(cfg, noise)
    return zs


def stream_measurements(cfg, zs):
    """Loopback TCP row stream: a producer thread plays the measurement rows
    through TcpRecorder; the caller consumes them row-by-row through
    NetworkServer — the reference's online measurement feed
    (estimate_satellite3D.cpp --online-run; network_recorder.cpp handshake).
    Yields each row as a tensor on the rows' device."""
    cols = [f"z{i}" for i in range(zs.shape[1])]
    rows = zs.cpu().numpy()
    server = NetworkServer(cfg["port"])

    def producer():
        recorder = TcpRecorder("127.0.0.1", cfg["port"], cols, buffered=False)
        for z in rows:
            recorder.record(z)
        recorder.close()

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        server.accept()
        while True:
            row = server.read_row()
            if row is None:
                break
            yield torch.as_tensor(row, dtype=zs.dtype, device=zs.device)
    finally:
        server.close()
        th.join(timeout=5.0)


def estimate_online(cfg, F, zs):
    """The IEKF over the streamed rows: (final belief, rows consumed)."""
    dev = zs.device
    eye = lambda n: torch.eye(n, dtype=zs.dtype, device=dev)
    ret = ss.sat3D_retraction()
    Qd = eye(12) * cfg["proc_noise"]
    R = eye(9) * cfg["meas_noise"] ** 2 * 10 + eye(9) * 1e-8
    u = torch.zeros(6, dtype=zs.dtype, device=dev)
    mean = ss.default_state(device=dev)
    mean[0:3] = _on(cfg, [0.6, -0.3, 0.4])
    b = GaussianBelief(mean, eye(12) * 0.25)
    n_rows = 0
    for z in stream_measurements(cfg, zs):
        b = iekf_step(F, ss.h_pose_gyro, ret, b, u, z, Qd, R,
                      diff=ss.pose_innovation)
        n_rows += 1
    return b, n_rows


def predict(cfg, F, b):
    """The belief rolled ``horizon`` steps ahead from the end of the
    stream."""
    H = cfg["horizon"]
    Qd = torch.eye(12, dtype=b.mean.dtype, device=b.mean.device) \
        * cfg["proc_noise"]
    us = torch.zeros((H, 6), dtype=b.mean.dtype, device=b.mean.device)
    return predictor.predict_belief_trajectory(
        F, ss.sat3D_retraction(), b, us, Qd, cfg["dt"],
        t0=cfg["steps"] * cfg["dt"])


def joint_table(spec, means):
    """Closed-form 3R3R IK (wrist −1 branch) of each predicted pose: the
    reference's transformed_trajectory composition (target pose traj ∘
    chaser IK, CRS_planner_dynexec.cpp:180-195) as ONE batched IK over the
    tabulated belief means."""
    return torch.func.vmap(lambda mm: ik.ik_3r3r(
        spec, mm[0:3], rot.qnormalize(mm[3:7]), wrist=-1.0))(means)


def intercept(cfg, spec, traj, q_tab):
    """(workspace, PlanResult) of the time-augmented interception over the
    real collision stack, with the TARGET BODY AS A MOVING OBSTACLE posed
    along its predicted trajectory until grapple (the reference's
    proxy_traj_applicator composition, manip_free_dynamic_workspace.hpp:60
    + proxy_traj_applicator.hpp).  The target's joint trajectory keeps the
    table's type for its times (the JAX example makes them float32)."""
    H = cfg["horizon"]
    on = lambda x: _on(cfg, x)
    target_joint = Trajectory(
        times=torch.arange(H + 1, dtype=q_tab.dtype, device=q_tab.device)
        * cfg["dt"], points=q_tab)
    space = sp.NdofSpace(np.full(6, -2.8), np.full(6, 2.8),
                         device=cfg["device"])
    env = ProxyModel(
        spheres=Sphere(on([[0.30, 0.25, 0.55]]), on([0.12])),
        planes=Plane(on([[0.0, 0.0, 1.0]]), on([-0.12])),
    )
    tgrid = np.arange(H + 1) * cfg["dt"]  # planner-relative times
    target_body = ShapeSet(
        spheres=Sphere(on(np.zeros((1, 3))), on([0.08])),
        sphere_body=torch.zeros(1, dtype=torch.int64, device=cfg["device"]),
    )
    # the grapple fixture sits on the satellite's NEAR face: the body sphere
    # is offset radially outward from the predicted grapple point, so the
    # goal pose clears it while any sweep THROUGH the body is rejected
    p_pred = traj.means[: H + 1, 0:3]
    p_body = p_pred * (1.0 + 0.18 / torch.linalg.vector_norm(
        p_pred, dim=-1, keepdim=True))
    target_rigid = rigid_traj_tabulated(
        on(tgrid), p_body, rot.qnormalize(traj.means[: H + 1, 3:7]))
    ws = TemporalChainWorkspace(
        space, spec, chain_capsules(spec, device=cfg["device"]), env,
        moving=[(target_body, target_rigid)], margin=0.005, n_checks=8)
    iq = pl.InterceptQuery(start=np.zeros(6), target_traj=target_joint,
                           t_budget=H * cfg["dt"], v_max=4.0, goal_tol=0.35)
    return ws, pl.intercept_plan(ws, iq, max_iters=cfg["max_iters"],
                                 batch=32, seed=cfg["seed"])


def main(argv=None, noise=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           defaults=DEFAULTS)

    # ---- truth + measurements ------------------------------------------
    F, xs = target_truth(cfg)
    zs = measurements(cfg, xs, noise)

    # ---- 1+2: online estimation over the TCP row plane ------------------
    b, n_rows = estimate_online(cfg, F, zs)
    est_err = float(torch.linalg.vector_norm(b.mean[0:3]
                                             - xs[cfg["steps"], 0:3]))
    print(f"online estimate: {n_rows} rows streamed, pos err {est_err:.2e} m")

    # ---- 3: belief prediction -------------------------------------------
    H = cfg["horizon"]
    traj = predict(cfg, F, b)
    pred_err = float(torch.linalg.vector_norm(traj.means[-1, 0:3]
                                              - xs[-1, 0:3]))
    print(f"predicted {H} steps ahead; final pos err vs truth {pred_err:.2e} m")

    # ---- 4: map the predicted pose trajectory into joint space ----------
    spec = models.manip_3r3r()
    q_tab = joint_table(spec, traj.means[: H + 1])

    # ---- 5: intercept planning over the real collision stack ------------
    ws, res = intercept(cfg, spec, traj, q_tab)
    if not res.success:
        print("no interception within the prediction horizon")
        return 1
    path = np.asarray(res.path)
    t_free = ws.is_free_txq_batch(_on(cfg, path[:, 0]), _on(cfg, path[:, 1:]))
    print(f"intercept planned: t={res.cost:.2f}s, "
          f"{res.path.shape[0]} waypoints "
          f"(all clear of the moving target body: {bool(t_free.all())}), "
          f"wall {res.wall_time_s:.2f}s")

    # ---- 6: record the executed plan ------------------------------------
    if cfg["output"]:
        rec = open_recorder(cfg["output"],
                            ["t"] + [f"q{i}" for i in range(6)])
        for row in path:
            rec.record(row)
        rec.close()
        print(f"wrote plan to {cfg['output']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
