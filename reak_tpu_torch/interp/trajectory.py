"""Trajectory containers: waypoint sequences with batched time lookup (port
of ``reak_tpu/interp/trajectory.py``).

(ref: ctrl/interpolation/waypoint_container.hpp, interpolated_trajectory.hpp,
trajectory_base.hpp, constant_trajectory.hpp, point_to_point_path.hpp,
transformed_trajectory.hpp)

A Trajectory is a value object: ``eval(t)`` broadcasts over arbitrary t
batches using ``torch.searchsorted`` + the chosen interpolator — the
pointer-chasing waypoint iterators of the reference become one gather.
Everything follows the device and dtype of the waypoint times.  The
builders keep a tensor argument as it is and put numbers, lists and numpy
arrays on the device and in the dtype of their first tensor argument, else
on ``device`` (the card unless the caller asks for the CPU) in ``dtype``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from reak_tpu_torch.interp.hermite import (_as_tensors,
                                           cubic_hermite_interp,
                                           linear_interp,
                                           quintic_hermite_interp)


class Trajectory(NamedTuple):
    """Waypoint trajectory.  times: (K,); points: (K, n); optional vels/accs
    enable cubic/quintic evaluation (ref: interpolated_trajectory.hpp)."""

    times: torch.Tensor
    points: torch.Tensor
    vels: Optional[torch.Tensor] = None
    accs: Optional[torch.Tensor] = None

    @property
    def t0(self):
        return self.times[0]

    @property
    def t1(self):
        return self.times[-1]

    def eval(self, t):
        """Position at time(s) t (clamped to the time range)."""
        return self.eval_with_derivatives(t)[0]

    def eval_with_derivatives(self, t):
        """(pos, vel[, acc]) at t; order depends on stored data."""
        times = self.times
        t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
        tc = torch.minimum(torch.maximum(t, times[0]), times[-1])
        found = torch.searchsorted(times, tc.reshape(-1).contiguous(),
                                   right=True).reshape(tc.shape)
        idx = torch.clamp(found - 1, 0, times.shape[0] - 2)
        t_a = times[idx]
        t_b = times[idx + 1]
        dt = t_b - t_a
        s = (tc - t_a) / torch.clamp_min(dt, 1e-30)
        p0 = self.points[idx]
        p1 = self.points[idx + 1]
        dtb = dt[..., None] if dt.ndim else dt
        if self.vels is None:
            return linear_interp(p0, p1, s, dtb)
        v0 = self.vels[idx]
        v1 = self.vels[idx + 1]
        if self.accs is None:
            return cubic_hermite_interp(p0, v0, p1, v1, s, dtb)
        a0 = self.accs[idx]
        a1 = self.accs[idx + 1]
        return quintic_hermite_interp(p0, v0, a0, p1, v1, a1, s, dtb)


def waypoint_trajectory(times, points, vels=None, accs=None, device="cuda",
                        dtype=torch.float64) -> Trajectory:
    return Trajectory(*_as_tensors(times, points, vels, accs, device=device,
                                   dtype=dtype))


def constant_trajectory(point, t0=0.0, t1=math.inf, device="cuda",
                        dtype=torch.float64):
    """(ref: constant_trajectory.hpp); an unbounded end is stored as 1e30."""
    p, = _as_tensors(point, device=device, dtype=dtype)
    times = torch.tensor([float(t0), 1e30 if t1 == math.inf else float(t1)],
                         dtype=p.dtype, device=p.device)
    return Trajectory(times=times, points=torch.stack([p, p]))


def point_to_point_trajectory(p0, p1, t0, t1, device="cuda",
                              dtype=torch.float64) -> Trajectory:
    """(ref: point_to_point_path.hpp)"""
    points = torch.stack(_as_tensors(p0, p1, device=device, dtype=dtype))
    times = torch.tensor([float(t0), float(t1)], dtype=points.dtype,
                         device=points.device)
    return Trajectory(times=times, points=points)


class transformed_trajectory:
    """View of a trajectory through a point mapping (topology map), e.g. the
    target state-trajectory mapped through target-DK ∘ chaser-IK
    (ref: transformed_trajectory.hpp; used by CRS_planner_dynexec.cpp:180-195)."""

    def __init__(self, base: Trajectory, fn: Callable):
        self.base = base
        self.fn = fn

    def eval(self, t):
        return self.fn(self.base.eval(t))

    @property
    def t0(self):
        return self.base.t0

    @property
    def t1(self):
        return self.base.t1
