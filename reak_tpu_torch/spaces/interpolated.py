"""Interpolation-aware topology wrappers (port of
``reak_tpu/spaces/interpolated.py``).

(ref: ctrl/topologies/interpolated_topologies.hpp — wraps a topology so its
move_position_toward / interpolation follows a chosen interpolator instead
of the metric geodesic; the CRS planner dispatches on this interp tag,
run_CRS_planner.cpp:141-190)

For position-only spaces, cubic/quintic Hermite interpolation with zero
boundary velocities reduces exactly to a smoothstep time-reparameterization
of the straight segment — so the wrapper composes any base space with the
matching easing profile.  (Dynamic spaces interpolate along real SVP/SAP
min-time profiles natively: spaces/tangent.py.)
"""
from __future__ import annotations

import torch


def _ease(profile: str, s):
    if profile == "linear":
        return s
    if profile == "cubic":
        # cubic Hermite, zero end velocities: 3s² − 2s³
        return s * s * (3.0 - 2.0 * s)
    if profile == "quintic":
        # quintic Hermite, zero end velocities AND accelerations:
        # 10s³ − 15s⁴ + 6s⁵
        return s * s * s * (10.0 + s * (-15.0 + 6.0 * s))
    raise ValueError(f"unknown interpolation profile {profile!r} "
                     "(linear | cubic | quintic)")


class InterpolatedSpace:
    """A base space whose ``interpolate`` follows the given profile
    (planners steer along it transparently; distance/sampling unchanged)."""

    def __init__(self, base, profile: str = "cubic"):
        self.base = base
        self.profile = profile
        _ease(profile, 0.0)  # validate eagerly

    def __getattr__(self, name):
        return getattr(self.base, name)

    def interpolate(self, a, b, t):
        return self.base.interpolate(a, b, _ease(self.profile, t))

    def eval_with_derivatives(self, a, b, t, duration=1.0):
        """Position, velocity, acceleration at fraction t of a ``duration``-
        long traversal (the interpolator-factory surface of the reference,
        generic_interpolator_factory.hpp): chain rule through the easing.
        ``t`` is a number or a tensor (a number is taken as float64)."""
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t, dtype=torch.float64)
        s = _ease(self.profile, t)
        if self.profile == "linear":
            ds, dds = torch.ones_like(t), torch.zeros_like(t)
        elif self.profile == "cubic":
            ds, dds = 6.0 * t * (1.0 - t), 6.0 - 12.0 * t
        else:  # quintic
            ds = 30.0 * t * t * (1.0 - t) ** 2
            dds = 60.0 * t * (1.0 - 3.0 * t + 2.0 * t * t)
        p = self.base.interpolate(a, b, s)
        delta = self.base.difference(b, a)
        vel = delta * ds / duration
        acc = delta * dds / (duration * duration)
        return p, vel, acc
