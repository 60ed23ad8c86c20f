#!/usr/bin/env python
"""X8 quadrotor kinodynamic planning over a MEAQR control topology (port of
``examples/x8_planner.py``).

Equivalent of the reference's X8 planner app
(ref: examples/misc/X8_run_planner.cpp + quadrotor_scene.cpp: quadrotor
system + MEAQR topology + RRT*/SBA* planner, composed into one workload;
topology machinery misc/MEAQR_topology.hpp:316, planners
misc/MEAQR_rrtstar_planner.hpp:78 / MEAQR_sbastar_planner.hpp:85).

Pipeline:
  1. ctrl.ss_systems.quadrotor — the full nonlinear X-configuration model
     (quadrotor_system.hpp:51).
  2. Hover linearization on the 12-d error state (p, θ, v, ω) by
     ``torch.func.jacfwd`` through the quaternion retraction — the LTI
     (A, B) the MEAQR topology needs.
  3. ctrl.aqr_space.MEAQRSpace — distance = minimum-energy cost-to-go,
     interpolation = the min-energy system trajectory.
  4. meaqr_rrt_star_plan / meaqr_sbastar_plan through a slalom of pillar
     obstacles (position-space collision gate).

On the card unless ``--device`` says otherwise, in float64.

Usage:
  python -m reak_tpu_torch.examples.x8_planner --planner=rrt_star --max-iters=40
  python -m reak_tpu_torch.examples.x8_planner --planner=sbastar
"""
import json
import sys
import time

import numpy as np
import torch

import reak_tpu_torch
from reak_tpu_torch.ctrl import ss_systems as ss
from reak_tpu_torch.ctrl.aqr_space import (MEAQRSpace, meaqr_rrt_star_plan,
                                           meaqr_sbastar_plan)
from reak_tpu_torch.io.config import config_from_args
from reak_tpu_torch.math import rotations as rot
from reak_tpu_torch.planning.queries import PlanningQuery

# full-f32 contractions for parity-grade numerics (explicit opt-in)
reak_tpu_torch.enable_full_precision()

DEFAULTS = dict(planner="rrt_star", max_iters=30, seed=0, step_size=2.0,
                n_grid=48, capacity=4096, output="", device="cuda")

PILLARS = np.array([[3.0, 0.6], [6.0, -0.6]])
PILLAR_RADIUS = 0.9


def hover_lti(params, device="cuda"):
    """LTI (A (12,12), B (12,4)) of the quadrotor about hover on the error
    state (p, θ, v, ω); θ the body rotation vector (quaternion retraction).
    At hover f(x0, u0) = 0 exactly, so the MEAQR drift term c vanishes.
    Float64 on ``device``."""
    f = ss.quadrotor_cont(params)
    kw = dict(dtype=torch.float64, device=device)
    u0 = torch.full((4,), float(ss.hover_thrust(params)), **kw)

    def f_err(xe, du):
        p, th, v, w = xe[0:3], xe[3:6], xe[6:9], xe[9:12]
        q = rot.q_exp(th)  # unit quaternion from rotation vector
        dx = f(torch.cat([p, q, v, w]), u0 + du)
        # small-angle attitude rate: θ̇ = 2·vec(q̄⊗q̇) → at identity, 2·q̇_vec
        return torch.cat([dx[0:3], 2.0 * dx[4:7], dx[7:10], dx[10:13]])

    z = torch.zeros(12, **kw)
    du0 = torch.zeros(4, **kw)
    A = torch.func.jacfwd(lambda xe: f_err(xe, du0))(z)
    B = torch.func.jacfwd(lambda du: f_err(z, du))(du0)
    return A, B


def pillar_scene(device="cuda"):
    """Two pillars forcing a slalom in the x-y plane (quadrotor_scene.cpp):
    ``is_free(pts (K, 12)) → (K,)``, gated on the position (x, y)."""
    pillars = torch.as_tensor(PILLARS, device=device)

    def is_free(pts):
        xy = pts[:, 0:2]
        d = torch.stack([torch.linalg.vector_norm(xy - p.to(xy.dtype)[None],
                                                  dim=-1) for p in pillars])
        return torch.all(d > PILLAR_RADIUS, dim=0)

    return is_free


def build(device="cuda", n_grid=48):
    """(space, is_free, query) of the slalom: the MEAQR space of the hover
    LTI, the pillars, and a rest-to-rest transfer 9 m ahead."""
    kw = dict(dtype=torch.float64, device=device)
    A, B = hover_lti(ss.quadrotor(), device)
    lower = torch.tensor([-1.0, -3.0, -1.0, *[-0.6] * 3, *[-2.0] * 3,
                          *[-2.0] * 3], **kw)
    upper = torch.tensor([10.0, 3.0, 3.0, *[0.6] * 3, *[2.0] * 3,
                          *[2.0] * 3], **kw)
    space = MEAQRSpace(A, B, lower, upper, R=torch.eye(4, **kw) * 0.5,
                       t_max=3.0, n_grid=int(n_grid), time_weight=1.0)
    start = np.zeros(12)
    goal = np.zeros(12)
    goal[0] = 9.0  # 9 m ahead, ending at rest (kinodynamic rendezvous)
    return space, pillar_scene(device), PlanningQuery(start, goal,
                                                      goal_tolerance=1.2)


def plan(cfg):
    """(space, is_free, PlanResult) of one run of ``cfg["planner"]``
    (``rrt_star`` or ``sbastar``); ``cfg["seed"]`` may be an int or a draw
    object (``planning/draws.py``)."""
    space, is_free, query = build(cfg["device"], cfg["n_grid"])
    planner = (meaqr_rrt_star_plan if cfg["planner"] == "rrt_star"
               else meaqr_sbastar_plan)
    res = planner(space, is_free, query, max_iters=int(cfg["max_iters"]),
                  step_size=float(cfg["step_size"]), seed=cfg["seed"],
                  capacity=int(cfg["capacity"]))
    return space, is_free, res


def main(argv=None):
    cfg = config_from_args(sys.argv[1:] if argv is None else argv, DEFAULTS)
    t0 = time.perf_counter()
    _, _, res = plan(cfg)
    out = dict(planner=cfg["planner"], success=bool(res.success),
               cost=float(res.cost), n_vertices=int(res.n_vertices),
               wall_s=round(time.perf_counter() - t0, 2))
    print(json.dumps(out))
    if res.success and cfg["output"]:
        np.savetxt(cfg["output"], np.asarray(res.path), delimiter=",")
    return 0 if res.success else 1


if __name__ == "__main__":
    raise SystemExit(main())
