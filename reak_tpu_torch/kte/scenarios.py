"""Named scenario bundles: robot + environment + query, serialized as one
scene file (port of ``reak_tpu/kte/scenarios.py``).

(ref: ctrl/kte_models/navigation_model_data.hpp:65 navigation_scenario and
 chaser_target_model_data.hpp:65 chaser_target_data — the reference persists
 these aggregates through its archive system and example apps reload them;
 here they are NamedTuples registered with io.serialization under the JAX
 package's tags, so they round-trip through both the typed-JSON and compact
 binary ``.rkb`` archives, and an archive of either package loads in the
 other.)  A loaded bundle holds numpy arrays;
``reak_tpu_torch.convert.navigation_scenario_from`` and
``chaser_target_scenario_from`` put one on a device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reak_tpu_torch.geom.proximity import ProxyModel
from reak_tpu_torch.geom.shapes import Plane, ShapeSet, Sphere
from reak_tpu_torch.io.serialization import register_type
from reak_tpu_torch.kte.spec import ChainSpec


class NavigationScenario(NamedTuple):
    """A navigation planning bundle (ref: navigation_model_data.hpp:65 —
    robot model + environment geometry + space bounds + start/goal)."""

    name: str
    robot: ChainSpec              # e.g. models.uav_kinematics()
    robot_shapes: ShapeSet        # chain-anchored collision geometry
    env: ProxyModel               # static obstacle set
    bounds_lower: torch.Tensor    # (3,) workspace position bounds
    bounds_upper: torch.Tensor
    start: torch.Tensor           # start configuration (robot.nq,)
    goal: torch.Tensor            # goal configuration


class ChaserTargetScenario(NamedTuple):
    """Chaser robot + target model + shared environment
    (ref: chaser_target_model_data.hpp:65 chaser_target_data)."""

    name: str
    chaser: ChainSpec
    chaser_shapes: ShapeSet
    target: ChainSpec
    target_shapes: ShapeSet
    env: ProxyModel
    start: torch.Tensor
    target_state: torch.Tensor


register_type("reak.NavigationScenario", NavigationScenario)
register_type("reak.ChaserTargetScenario", ChaserTargetScenario)


def uav_corridor_scenario(name: str = "uav_corridor", device="cuda",
                          dtype=torch.float64) -> NavigationScenario:
    """A ready-made UAV navigation scene: quadrotor airframe sphere flying a
    corridor with two pillar obstacles and a floor (the ref ships its
    scenarios as data files built by builder apps, build_MD148_lab.cpp-style;
    this factory is the equivalent builder).  The JAX package's values, as
    tensors of ``dtype`` on ``device`` (body indices int64)."""
    from reak_tpu_torch.kte import models

    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    robot = models.uav_kinematics()
    shapes = ShapeSet(
        spheres=Sphere(t([[0.0, 0.0, 0.0]]), t([0.25])),
        sphere_body=torch.tensor([0], device=device),
    )
    env = ProxyModel(
        spheres=Sphere(t([[3.0, 0.6, 1.0], [6.0, -0.6, 1.0]]), t([0.9, 0.9])),
        planes=Plane(t([[0.0, 0.0, 1.0]]), t([0.0])),
    )
    start = np.asarray(robot.neutral_q(), np.float64)
    start[0:3] = [0.0, 0.0, 1.0]
    goal = np.asarray(robot.neutral_q(), np.float64)
    goal[0:3] = [9.0, 0.0, 1.0]
    return NavigationScenario(
        name=name, robot=robot, robot_shapes=shapes, env=env,
        bounds_lower=t([-1.0, -3.0, 0.2]), bounds_upper=t([10.0, 3.0, 3.0]),
        start=t(start), goal=t(goal),
    )
