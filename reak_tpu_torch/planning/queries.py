"""Planning queries & results (port of ``reak_tpu/planning/queries.py``).

(ref: ctrl/path_planning/planning_queries.hpp:66 planning_query,
p2p_planning_query.hpp:74, intercept_query.hpp:75 motion_plan_intercept_query)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch


@dataclass
class PlanningQuery:
    """Point-to-point query; ``goal_fn`` generalizes to moving-target
    interception (goal = any point within tolerance of goal_fn(t),
    ref: intercept_query.hpp:75)."""

    start: np.ndarray
    goal: np.ndarray
    goal_tolerance: float = 1e-2
    goal_fn: Optional[Callable] = None  # t → goal point (interception)
    time_budget: Optional[float] = None


@dataclass
class PlanResult:
    """(ref: planning_queries solution records + seq_path factories,
    solution_path_factories.hpp)"""

    success: bool
    path: Optional[np.ndarray]  # (L, n) waypoints incl. start/goal
    cost: float
    n_vertices: int
    n_iterations: int
    wall_time_s: float
    stats: dict = field(default_factory=dict)


def path_cost(space, path) -> float:
    """Total metric length of a waypoint path: the space's distance between
    consecutive waypoints, summed on the path's device.  ``path`` is a tensor
    of waypoints (L, ...), or a tuple of such tensors for a space whose
    points are records (``NdofPoint1`` …), or anything ``torch.as_tensor``
    reads."""
    if path is None:
        return float("inf")
    if isinstance(path, tuple):  # a record of waypoint tensors
        a = type(path)(*(x[:-1] for x in path))
        b = type(path)(*(x[1:] for x in path))
        n = len(path[0])
    else:
        path = torch.as_tensor(path)
        a, b, n = path[:-1], path[1:], len(path)
    if n < 2:
        return float("inf")
    return float(torch.sum(space.distance(a, b)))
