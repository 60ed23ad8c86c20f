#!/usr/bin/env python
"""CRS-A465 manipulator planning CLI — static scene & moving-target modes
(port of ``examples/run_crs_planner.py``).

Equivalent of the reference's run_CRS_planner app
(ref: examples/robot_airship/run_CRS_planner.cpp:217 main, planner dispatch
:141-190; dynamic interception CRS_planner_dynexec.cpp:75).

Plans for the 6-DoF 3R3R arm in joint space with chain-vs-environment
collision checks batched on the device; Monte-Carlo benchmarking mirrors the
reference's monte_carlo_mp_engine (planner_exec_engines.hpp:86).  On the
card unless ``--device`` says otherwise, in float64.

Usage:
  python -m reak_tpu_torch.examples.run_crs_planner --planner=rrt --mc-runs=5
  python -m reak_tpu_torch.examples.run_crs_planner --planner=fadprm
  python -m reak_tpu_torch.examples.run_crs_planner --dynamic=1  # intercept
"""
import sys

import numpy as np
import torch

import reak_tpu_torch
import reak_tpu_torch.planning as pl
import reak_tpu_torch.spaces.vector as sp
from reak_tpu_torch.geom.proximity import ProxyModel
from reak_tpu_torch.geom.shapes import Capsule, Plane, ShapeSet, Sphere
from reak_tpu_torch.io.config import config_from_args
from reak_tpu_torch.kte import ik, models
from reak_tpu_torch.planning.queries import PlanningQuery

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu_torch.enable_full_precision()

DEFAULTS = dict(
    planner="rrt",        # rrt | birrt | rrt_star | prm | sbastar | fadprm | rrg
    mc_runs=0, seed=0, max_iters=150, step_size=0.5,
    dynamic=0, output="", device="cuda",
)


def chain_capsules(spec, radius=0.05, device="cuda", dtype=torch.float64):
    """Chain-anchored collision capsules: one per body, spanning that body's
    frame origin to the next joint's offset (the reference's
    kte_chain_geometry_3D shape anchoring, kte_chain_geometry.hpp:101)."""
    n = len(spec.joint_types)
    offs = np.asarray(spec.offsets_pos, float)  # (n, 3): joint i in frame i-1
    ends = np.vstack([offs[1:], [[0.0, 0.0, 0.06]]])  # tool stub on last body
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    caps = Capsule(t(np.zeros((n, 3))), t(ends), t(np.full(n, radius)))
    return ShapeSet(capsules=caps,
                    capsule_body=torch.arange(n, device=device))


def build_scene(device="cuda", dtype=torch.float64):
    """3R3R arm with chain-anchored capsule geometry vs a sphere obstacle +
    floor plane — a miniature of the reference's chaser_target .rkx scenes
    (chaser_target_model_data.hpp:65), checked through the REAL proximity
    stack (ChainWorkspace → proxy_query).  Returns (spec, workspace,
    query)."""
    spec = models.manip_3r3r()
    space = sp.NdofSpace(np.full(6, -2.8), np.full(6, 2.8), device=device,
                         dtype=dtype)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    robot = chain_capsules(spec, device=device, dtype=dtype)
    env = ProxyModel(
        spheres=Sphere(t([[0.35, 0.0, 0.55]]), t([0.18])),
        planes=Plane(t([[0.0, 0.0, 1.0]]), t([-0.12])),
    )
    ws = pl.ChainWorkspace(space, spec, robot, env, margin=0.01, n_checks=12)
    q_start = np.zeros(6)
    # goal: a posture on the far side of the obstacle
    q_goal = np.asarray([0.9, -0.5, 0.9, 0.2, 0.5, -0.1])
    return spec, ws, PlanningQuery(q_start, q_goal, goal_tolerance=0.3)


PLANNERS = {
    "rrt": lambda ws, q, cfg: pl.rrt_plan(ws, q, max_iters=cfg["max_iters"],
                                          step_size=cfg["step_size"],
                                          seed=cfg["seed"]),
    "birrt": lambda ws, q, cfg: pl.birrt_plan(ws, q, max_iters=cfg["max_iters"],
                                              step_size=cfg["step_size"],
                                              seed=cfg["seed"]),
    "rrt_star": lambda ws, q, cfg: pl.rrt_star_plan(
        ws, q, max_iters=cfg["max_iters"], step_size=cfg["step_size"],
        seed=cfg["seed"]),
    "prm": lambda ws, q, cfg: pl.prm_plan(ws, q, n_samples=600,
                                          seed=cfg["seed"]),
    "sbastar": lambda ws, q, cfg: pl.sbastar_plan(ws, q, seed=cfg["seed"]),
    "fadprm": lambda ws, q, cfg: pl.fadprm_plan(ws, q, n_samples=600,
                                                seed=cfg["seed"]),
    "rrg": lambda ws, q, cfg: pl.rrg_plan(ws, q, max_iters=cfg["max_iters"],
                                          step_size=cfg["step_size"],
                                          seed=cfg["seed"]),
}


def plan(cfg):
    """(workspace, query, PlanResult) of one run of ``cfg["planner"]`` on
    the scene; ``cfg["seed"]`` may be an int or a draw object
    (``planning/draws.py``)."""
    _, ws, query = build_scene(cfg["device"])
    return ws, query, PLANNERS[cfg["planner"]](ws, query, cfg)


def run_static(cfg):
    if cfg["mc_runs"] > 0:
        # Monte-Carlo benchmarking (ref: monte_carlo_mp_engine,
        # planner_exec_engines.hpp:86-205)
        times, costs, succ = [], [], 0
        for run in range(cfg["mc_runs"]):
            _, _, res = plan(dict(cfg, seed=cfg["seed"] + run))
            times.append(res.wall_time_s)
            if res.success:
                succ += 1
                costs.append(res.cost)
        print(f"planner={cfg['planner']}  runs={cfg['mc_runs']}  "
              f"success={succ}/{cfg['mc_runs']}")
        print(f"time:  mean={np.mean(times):.3f}s  min={np.min(times):.3f}s")
        if costs:
            print(f"cost:  mean={np.mean(costs):.3f}  best={np.min(costs):.3f}")
        return 0
    _, _, res = plan(cfg)
    print(f"planner={cfg['planner']}  success={res.success}  "
          f"cost={res.cost:.3f}  verts={res.n_vertices}  "
          f"time={res.wall_time_s:.3f}s")
    if res.success and cfg["output"]:
        from reak_tpu_torch.io.recorder import open_recorder
        rec = open_recorder(cfg["output"], [f"q{i}" for i in range(6)])
        for w in np.asarray(res.path):
            rec.record(w)
        rec.close()
        print(f"wrote path to {cfg['output']}")
    return 0 if res.success else 1


def intercept(cfg):
    """(workspace, InterceptQuery, PlanResult) of the moving-target
    interception in joint space: the target trajectory is a tool pose
    sliding through the workspace, mapped through closed-form IK — the
    reference's DK∘IK transformed_trajectory composition
    (CRS_planner_dynexec.cpp:180-199)."""
    spec, ws, _ = build_scene(cfg["device"])
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)

    def target_joint_traj(t):
        # tool path behind the base, clear of the obstacle sphere
        p = torch.tensor([-0.45, -0.3 + 0.06 * t, 0.4], dtype=torch.float64)
        # wrist=−1 branch stays continuous and near the home posture along
        # this tool path (branch choice = the reference's IK branch policy)
        return ik.ik_3r3r(spec, p, quat, wrist=-1.0).numpy()

    iq = pl.InterceptQuery(start=np.zeros(6), target_traj=target_joint_traj,
                           t_budget=8.0, v_max=1.5, goal_tol=0.5)
    return ws, iq, pl.intercept_plan(ws, iq, max_iters=cfg["max_iters"],
                                     batch=32, seed=cfg["seed"])


def run_dynamic(cfg):
    _, _, res = intercept(cfg)
    if res.success:
        print(f"intercepted at t={res.cost:.2f}s  "
              f"waypoints={res.path.shape[0]}  time={res.wall_time_s:.3f}s")
    else:
        print("no interception within budget")
    return 0 if res.success else 1


def main(argv=None):
    cfg = config_from_args(argv if argv is not None else sys.argv[1:],
                           defaults=DEFAULTS)
    if cfg["planner"] not in PLANNERS:
        raise SystemExit(f"unknown --planner={cfg['planner']}; "
                         f"options: {sorted(PLANNERS)}")
    return run_dynamic(cfg) if cfg["dynamic"] else run_static(cfg)


if __name__ == "__main__":
    raise SystemExit(main())
