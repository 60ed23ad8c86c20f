"""Rate-limited joint spaces and joint-limit mappings (port of
``reak_tpu/spaces/rate_limited.py``).

(ref: ctrl/topologies/rate_limited_spaces.hpp, joint_space_limits.hpp:60,97,117
— ``joint_limits_collection::make_rl_joint_space`` / ``map_to_space``)

The reference rescales joint coordinates by their speed/accel limits so that
the metric is travel TIME; planners then treat all joints uniformly.  Here
that is a pair of diagonal affine maps + a HyperboxSpace in the scaled
coordinates.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reak_tpu_torch.interp.hermite import _as_tensors
from reak_tpu_torch.spaces.vector import HyperboxSpace


class JointLimits(NamedTuple):
    lower: torch.Tensor  # (n,)
    upper: torch.Tensor  # (n,)
    speed: torch.Tensor  # (n,) max |q̇|
    accel: Optional[torch.Tensor] = None  # (n,) max |q̈| (2nd-order spaces)


def joint_limits_mapping(limits: JointLimits):
    """Returns (to_rl, from_rl): maps between natural joint coords and
    rate-limited (time-scaled) coords  q_rl = q / q̇_max
    (ref: joint_space_limits.hpp map_to_space)."""

    def to_rl(q):
        return q / limits.speed

    def from_rl(q_rl):
        return q_rl * limits.speed

    return to_rl, from_rl


class RateLimitedNdofSpace(HyperboxSpace):
    """N-DoF joint space in rate-limited coordinates: distances are seconds of
    travel at per-joint max speed (ref: Ndof_rl_space of Ndof_spaces.hpp,
    rate_limited_spaces.hpp).  Limits that are not tensors go on the device
    and into the dtype of the first that is, else on ``device`` in
    ``dtype``."""

    def __init__(self, limits: JointLimits, device="cuda",
                 dtype=torch.float64):
        limits = JointLimits(*_as_tensors(*limits, device=device,
                                          dtype=dtype))
        self.limits = limits
        super().__init__(limits.lower / limits.speed, limits.upper / limits.speed)

    def to_natural(self, q_rl):
        return q_rl * self.limits.speed

    def from_natural(self, q):
        return q / self.limits.speed

    @staticmethod
    def for_chain(spec, lower, upper, speed, device="cuda",
                  dtype=torch.float64):
        return RateLimitedNdofSpace(JointLimits(lower, upper, speed),
                                    device=device, dtype=dtype)
