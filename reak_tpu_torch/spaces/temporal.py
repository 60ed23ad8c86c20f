"""Temporal space: time × base space (port of
``reak_tpu/spaces/temporal.py``; ref: ctrl/topologies/temporal_space.hpp,
time_topology.hpp; reachability metrics reachability_space.hpp:180).

Used by dynamic (moving-obstacle) planning: points are ``(t, p)``; the metric
makes backward-in-time moves infinite (can't steer into the past), matching
the reference's temporal-distance semantics.  Times are drawn float64 with
the generator on its device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TemporalPoint(NamedTuple):
    time: torch.Tensor  # (...)
    point: object  # base-space point


class TemporalSpace:
    def __init__(self, base_space, t_max: float, time_weight: float = 1.0,
                 max_speed: float | None = None):
        self.base = base_space
        self.t_max = float(t_max)
        self.time_weight = time_weight
        # max_speed enables reachability pruning: base distance / max_speed
        # must fit into the time difference (reachability_space.hpp semantics)
        self.max_speed = max_speed

    def sample(self, generator, batch=()):
        t = self.t_max * torch.rand(tuple(batch), generator=generator,
                                    dtype=torch.float64,
                                    device=generator.device)
        return TemporalPoint(t, self.base.sample(generator, batch))

    def distance(self, a: TemporalPoint, b: TemporalPoint):
        """Directed temporal distance from a to b (inf when b is in a's past
        or unreachable at max_speed)."""
        dt = b.time - a.time
        d = self.base.distance(a.point, b.point)
        cost = torch.sqrt((self.time_weight * dt) ** 2 + d * d)
        ok = dt > 0
        if self.max_speed is not None:
            ok = ok & (d <= self.max_speed * dt)
        return torch.where(ok, cost, float("inf"))

    def interpolate(self, a: TemporalPoint, b: TemporalPoint, t):
        return TemporalPoint(
            a.time + (b.time - a.time) * t,
            self.base.interpolate(a.point, b.point, t),
        )

    def difference(self, a, b):
        return (a.time - b.time, self.base.difference(a.point, b.point))

    def clamp(self, p: TemporalPoint):
        return TemporalPoint(torch.clamp(p.time, 0.0, self.t_max),
                             self.base.clamp(p.point))


def _exponential(generator, shape):
    """Exp(1) draws of ``shape``, float64, with ``generator`` on its
    device."""
    out = torch.empty(tuple(shape), dtype=torch.float64,
                      device=generator.device)
    return out.exponential_(generator=generator)


class TimePoissonSampler:
    """Poisson-process time sampling for temporal planning
    (ref: ctrl/topologies/time_poisson_topology.hpp): sample times as the
    arrivals of a rate-λ process anchored at a start time, so temporal
    planners draw expansion times with exponential inter-arrival gaps
    instead of uniformly over [0, t_max].
    """

    def __init__(self, rate: float, t_start: float = 0.0,
                 t_max: float | None = None):
        self.rate = float(rate)
        self.t_start = float(t_start)
        self.t_max = t_max

    def sample(self, generator, batch=()):
        """One arrival per draw: t_start + Exp(rate)."""
        dt = _exponential(generator, batch) / self.rate
        t = self.t_start + dt
        if self.t_max is not None:
            t = torch.clamp_max(t, self.t_max)
        return t

    def sample_arrivals(self, generator, n: int, batch=()):
        """First n arrivals of the process: cumulative exponential gaps,
        shape ``batch + (n,)``."""
        gaps = _exponential(generator, tuple(batch) + (n,)) / self.rate
        t = self.t_start + torch.cumsum(gaps, dim=-1)
        if self.t_max is not None:
            t = torch.clamp_max(t, self.t_max)
        return t


def poisson_temporal_sampler(space: TemporalSpace, rate: float):
    """Wrap a TemporalSpace's sampler to draw times from a Poisson process
    anchored at t=0 (the reference composes time_poisson_topology into its
    temporal spaces the same way, temporal_space.hpp)."""
    tp = TimePoissonSampler(rate, 0.0, space.t_max)

    def sample(generator, batch=()):
        return TemporalPoint(tp.sample(generator, batch),
                             space.base.sample(generator, batch))

    return sample
