"""SE(3) pose space, 0th/1st/2nd order tangent bundles (port of
``reak_tpu/spaces/se3.py``).

(ref: ctrl/topologies/se3_topologies.hpp:186,384 se3_0th/1st/2nd_order_topology,
make_se3_space:213; differentiable_space.hpp:220 for the order stacking)

A 0th-order point is ``SE3Point(pos (...,3), quat (...,4))``.  The 1st-order
bundle appends body-frame velocity ``(vel, omega)`` bounded by max
linear/angular speed balls; the 2nd order appends ``(acc, alpha)`` bounded by
max acceleration balls — the reference builds the same stack out of
``differentiable_space< hyperbox × hyperball... >`` tuples.  Rate limits turn
every level's metric into seconds-of-travel, so the product metric is a
travel-time estimate, matching the rate-limited se3 spaces used by the
satellite/airship planners.

Bounds follow ``spaces/vector``'s rule (``device``, the card unless the
caller asks for the CPU, and ``dtype`` for numbers and numpy arrays); the
quaternion draws are ``SO3Space``'s (float64 on the generator's device).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.interp.hermite import _lift
from reak_tpu_torch.math import rotations as rot
from reak_tpu_torch.spaces.se2 import _frac
from reak_tpu_torch.spaces.so3 import SO3Space
from reak_tpu_torch.spaces.vector import HyperballSpace, HyperboxSpace


class SE3Point(NamedTuple):
    pos: torch.Tensor  # (..., 3)
    quat: torch.Tensor  # (..., 4)


class SE3Point1(NamedTuple):
    pos: torch.Tensor
    quat: torch.Tensor
    vel: torch.Tensor  # (..., 3) linear velocity
    omega: torch.Tensor  # (..., 3) angular velocity


class SE3Point2(NamedTuple):
    pos: torch.Tensor
    quat: torch.Tensor
    vel: torch.Tensor
    omega: torch.Tensor
    acc: torch.Tensor  # (..., 3)
    alpha: torch.Tensor  # (..., 3) angular acceleration


def _ball(radius, like):
    """A ball of ``radius`` about the origin of R³, on ``like``'s device and
    in its dtype."""
    return HyperballSpace(torch.zeros(3, dtype=like.dtype,
                                      device=like.device), radius)


class SE3Space:
    """Position box × SO(3), with relative metric weighting
    (ref: se3_topologies.hpp make_se3_space — position bounds + max speeds)."""

    order = 0

    def __init__(self, pos_lower, pos_upper, rot_weight: float = 1.0,
                 device="cuda", dtype=torch.float64):
        self.pos_space = HyperboxSpace(pos_lower, pos_upper, device=device,
                                       dtype=dtype)
        self.rot_space = SO3Space()
        self.rot_weight = rot_weight

    def sample(self, generator, batch=()):
        return SE3Point(self.pos_space.sample(generator, batch),
                        self.rot_space.sample(generator, batch))

    def distance(self, a: SE3Point, b: SE3Point):
        dp = self.pos_space.distance(a.pos, b.pos)
        dr = self.rot_space.distance(a.quat, b.quat)
        return torch.sqrt(dp * dp + (self.rot_weight * dr) ** 2)

    def interpolate(self, a: SE3Point, b: SE3Point, t):
        """The fraction ``t`` of the way from a to b: a number, or one
        fraction per pair (the JAX package's slerp takes a number only:
        its per-pair fractions broadcast against the quaternion axis)."""
        tb = _lift(_frac(t, a.pos))
        return SE3Point(a.pos + (b.pos - a.pos) * tb,
                        rot.qslerp(a.quat, b.quat, tb))

    def difference(self, a: SE3Point, b: SE3Point):
        return torch.cat([a.pos - b.pos,
                          self.rot_space.difference(a.quat, b.quat)], dim=-1)

    def clamp(self, p: SE3Point):
        return SE3Point(self.pos_space.clamp(p.pos),
                        self.rot_space.clamp(p.quat))


class SE31stOrderSpace:
    """1st-order SE(3) tangent bundle (ref: se3_topologies.hpp:384
    se3_1st_order_topology): pose level + velocity level (linear-velocity
    ball of radius max_speed, angular-velocity ball of radius
    max_ang_speed).  With rate limits the metric is a travel-time norm:
    positions scale by 1/max_speed, angles by 1/max_ang_speed, velocity
    deltas by the corresponding 1/max_acc when given.
    """

    order = 1

    def __init__(self, pos_lower, pos_upper, max_speed: float,
                 max_ang_speed: float, max_acc: float | None = None,
                 max_ang_acc: float | None = None, device="cuda",
                 dtype=torch.float64):
        self.pose = SE3Space(pos_lower, pos_upper, device=device, dtype=dtype)
        # clamp divisors: a zero rate limit on an unused axis must give zero
        # travel time for equal coordinates, not NaN
        self.max_speed = max(float(max_speed), 1e-12)
        self.max_ang_speed = max(float(max_ang_speed), 1e-12)
        # velocity-delta weights (seconds per unit Δv); default: one
        # "characteristic time" so the metric stays a time even without
        # acceleration limits
        self.inv_acc = 1.0 / max_acc if max_acc else 1.0 / self.max_speed
        self.inv_ang_acc = (1.0 / max_ang_acc if max_ang_acc
                            else 1.0 / self.max_ang_speed)
        like = self.pose.pos_space.lower
        self.vel_space = _ball(max_speed, like)
        self.omega_space = _ball(max_ang_speed, like)

    def sample(self, generator, batch=()):
        pose = self.pose.sample(generator, batch)
        return SE3Point1(pose.pos, pose.quat,
                         self.vel_space.sample(generator, batch),
                         self.omega_space.sample(generator, batch))

    def _level_times(self, a, b):
        norm = lambda d: torch.linalg.vector_norm(d, dim=-1)
        dp = norm(a.pos - b.pos) / self.max_speed
        dr = self.pose.rot_space.distance(a.quat, b.quat) / self.max_ang_speed
        dv = norm(a.vel - b.vel) * self.inv_acc
        dw = norm(a.omega - b.omega) * self.inv_ang_acc
        return dp, dr, dv, dw

    def distance(self, a: SE3Point1, b: SE3Point1):
        dp, dr, dv, dw = self._level_times(a, b)
        return torch.sqrt(dp * dp + dr * dr + dv * dv + dw * dw)

    def interpolate(self, a: SE3Point1, b: SE3Point1, t):
        pose = self.pose.interpolate(SE3Point(a.pos, a.quat),
                                     SE3Point(b.pos, b.quat), t)
        tb = _lift(_frac(t, a.pos))
        return SE3Point1(pose.pos, pose.quat, a.vel + (b.vel - a.vel) * tb,
                         a.omega + (b.omega - a.omega) * tb)

    def difference(self, a: SE3Point1, b: SE3Point1):
        return torch.cat([a.pos - b.pos,
                          self.pose.rot_space.difference(a.quat, b.quat),
                          a.vel - b.vel, a.omega - b.omega], dim=-1)

    def clamp(self, p: SE3Point1):
        pose = self.pose.clamp(SE3Point(p.pos, p.quat))
        return SE3Point1(pose.pos, pose.quat, self.vel_space.clamp(p.vel),
                         self.omega_space.clamp(p.omega))


class SE32ndOrderSpace(SE31stOrderSpace):
    """2nd-order SE(3) tangent bundle (ref: se3_topologies.hpp:384): adds
    linear/angular acceleration ball levels on top of the 1st-order bundle."""

    order = 2

    def __init__(self, pos_lower, pos_upper, max_speed: float,
                 max_ang_speed: float, max_acc: float, max_ang_acc: float,
                 max_jerk: float | None = None,
                 max_ang_jerk: float | None = None, device="cuda",
                 dtype=torch.float64):
        super().__init__(pos_lower, pos_upper, max_speed, max_ang_speed,
                         max_acc, max_ang_acc, device=device, dtype=dtype)
        self.inv_jerk = (1.0 / max_jerk if max_jerk
                         else 1.0 / max(max_acc, 1e-12))
        self.inv_ang_jerk = (1.0 / max_ang_jerk if max_ang_jerk
                             else 1.0 / max(max_ang_acc, 1e-12))
        like = self.pose.pos_space.lower
        self.acc_space = _ball(max_acc, like)
        self.alpha_space = _ball(max_ang_acc, like)

    def sample(self, generator, batch=()):
        p1 = super().sample(generator, batch)
        return SE3Point2(*p1, self.acc_space.sample(generator, batch),
                         self.alpha_space.sample(generator, batch))

    def distance(self, a: SE3Point2, b: SE3Point2):
        dp, dr, dv, dw = self._level_times(a, b)
        da = torch.linalg.vector_norm(a.acc - b.acc, dim=-1) * self.inv_jerk
        dl = (torch.linalg.vector_norm(a.alpha - b.alpha, dim=-1)
              * self.inv_ang_jerk)
        return torch.sqrt(dp * dp + dr * dr + dv * dv + dw * dw + da * da
                          + dl * dl)

    def interpolate(self, a: SE3Point2, b: SE3Point2, t):
        p1 = super().interpolate(SE3Point1(*a[:4]), SE3Point1(*b[:4]), t)
        tb = _lift(_frac(t, a.pos))
        return SE3Point2(*p1, a.acc + (b.acc - a.acc) * tb,
                         a.alpha + (b.alpha - a.alpha) * tb)

    def difference(self, a: SE3Point2, b: SE3Point2):
        d1 = super().difference(SE3Point1(*a[:4]), SE3Point1(*b[:4]))
        return torch.cat([d1, a.acc - b.acc, a.alpha - b.alpha], dim=-1)

    def clamp(self, p: SE3Point2):
        p1 = super().clamp(SE3Point1(*p[:4]))
        return SE3Point2(*p1, self.acc_space.clamp(p.acc),
                         self.alpha_space.clamp(p.alpha))


def make_se3_space(pos_lower, pos_upper, order=0, **limits):
    """Order-dispatched SE(3) space factory (ref: se3_topologies.hpp
    make_se3_space:213)."""
    if order == 0:
        return SE3Space(pos_lower, pos_upper, **limits)
    if order == 1:
        return SE31stOrderSpace(pos_lower, pos_upper, **limits)
    if order == 2:
        return SE32ndOrderSpace(pos_lower, pos_upper, **limits)
    raise ValueError(f"unsupported order {order}")
