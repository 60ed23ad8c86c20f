"""SE(2) pose space, 0th/1st/2nd order tangent bundles (port of
``reak_tpu/spaces/se2.py``).

(ref: ctrl/topologies/se2_topologies.hpp:62,85,114 se2_0th/1st/2nd_order_topology
and the rate-limited variants :230,253,282; differentiable_space.hpp:220 for
the order stacking)

A 0th-order point is ``SE2Point(pos (...,2), theta (...))`` with the heading
on the circle (wrap-around metric and shortest-arc interpolation); the
reference models the angle as a clipped segment (line_topology.hpp:191),
and the circle metric avoids its artificial ±π seam.  The 1st-order bundle
appends planar velocity ``vel (...,2)`` bounded by a max-speed disc and
angular rate ``omega (...)``; the 2nd order appends ``acc (...,2)`` and
``alpha (...)``.  Rate limits make each level's metric a seconds-of-travel
estimate, so the product metric is a travel-time norm (the reference's rl
topologies, se2_topologies.hpp:230).

Bounds follow ``spaces/vector``'s rule: tensors keep their device and
dtype, numbers and numpy arrays go on ``device`` (the card unless the
caller asks for the CPU) in ``dtype``.  ``sample(generator, batch)`` draws
every coordinate, the heading included, in the bounds' dtype on their
device, in the JAX package's key order (the JAX package draws the heading
in the default float type whatever the bounds' type).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from reak_tpu_torch.interp.hermite import _lift
from reak_tpu_torch.spaces.tangent import _uniform
from reak_tpu_torch.spaces.vector import HyperballSpace, HyperboxSpace

_TWO_PI = 2.0 * math.pi


def wrap_angle(theta):
    """Wrap to (-pi, pi].  Round to the nearest turn, and one turn less
    where the remainder lands on -pi exactly: rounding half to even alone
    (the JAX package's ``jnp.round``) maps -pi and 3pi to -pi."""
    x = theta / _TWO_PI
    k = torch.round(x)
    k = torch.where(x - k == -0.5, k - 1.0, k)
    return theta - _TWO_PI * k


class SE2Point(NamedTuple):
    pos: torch.Tensor  # (..., 2)
    theta: torch.Tensor  # (...,) heading


class SE2Point1(NamedTuple):
    pos: torch.Tensor
    theta: torch.Tensor
    vel: torch.Tensor  # (..., 2) planar velocity
    omega: torch.Tensor  # (...,) angular rate


class SE2Point2(NamedTuple):
    pos: torch.Tensor
    theta: torch.Tensor
    vel: torch.Tensor
    omega: torch.Tensor
    acc: torch.Tensor  # (..., 2)
    alpha: torch.Tensor  # (...,)


def _frac(t, like):
    """An interpolation fraction: a number or a tensor as it is, anything
    else a tensor in ``like``'s dtype on its device."""
    if isinstance(t, (int, float, torch.Tensor)):
        return t
    return torch.as_tensor(np.asarray(t), dtype=like.dtype,
                           device=like.device)


def _ball(radius, like):
    """A disc of ``radius`` about the origin of the plane, on ``like``'s
    device and in its dtype."""
    return HyperballSpace(torch.zeros(2, dtype=like.dtype,
                                      device=like.device), radius)


class SE2Space:
    """Position box × heading circle with relative rotation weighting
    (ref: se2_topologies.hpp:62 se2_0th_order_topology — hyperbox ×
    line_segment over the angle)."""

    order = 0

    def __init__(self, pos_lower, pos_upper, rot_weight: float = 1.0,
                 device="cuda", dtype=torch.float64):
        self.pos_space = HyperboxSpace(pos_lower, pos_upper, device=device,
                                       dtype=dtype)
        self.rot_weight = float(rot_weight)

    def sample(self, generator, batch=()):
        pos = self.pos_space.sample(generator, batch)
        theta = _uniform(generator, tuple(batch), pos, -math.pi, math.pi)
        return SE2Point(pos, theta)

    def _dtheta(self, a, b):
        return wrap_angle(a.theta - b.theta)

    def distance(self, a: SE2Point, b: SE2Point):
        dp = self.pos_space.distance(a.pos, b.pos)
        dr = torch.abs(self._dtheta(a, b))
        return torch.sqrt(dp * dp + (self.rot_weight * dr) ** 2)

    def interpolate(self, a: SE2Point, b: SE2Point, t):
        t = _frac(t, a.pos)
        return SE2Point(a.pos + (b.pos - a.pos) * _lift(t),
                        wrap_angle(a.theta - self._dtheta(a, b) * t))

    def difference(self, a: SE2Point, b: SE2Point):
        return torch.cat([a.pos - b.pos, self._dtheta(a, b)[..., None]],
                         dim=-1)

    def clamp(self, p: SE2Point):
        return SE2Point(self.pos_space.clamp(p.pos), wrap_angle(p.theta))


class SE21stOrderSpace:
    """1st-order SE(2) tangent bundle (ref: se2_topologies.hpp:85
    se2_1st_order_topology): pose level + planar-velocity disc of radius
    max_speed and angular-rate interval ±max_ang_speed.  With rate limits the
    metric is a travel-time norm (se2_topologies.hpp:253 rl variant)."""

    order = 1

    def __init__(self, pos_lower, pos_upper, max_speed: float,
                 max_ang_speed: float, max_acc: float | None = None,
                 max_ang_acc: float | None = None, device="cuda",
                 dtype=torch.float64):
        self.pose = SE2Space(pos_lower, pos_upper, device=device, dtype=dtype)
        # clamp divisors so a non-moving/non-rotating axis (max_*_speed=0)
        # yields zero travel time when the coordinates agree, not NaN
        self.max_speed = max(float(max_speed), 1e-12)
        self.max_ang_speed = max(float(max_ang_speed), 1e-12)
        self.inv_acc = 1.0 / max_acc if max_acc else 1.0 / self.max_speed
        self.inv_ang_acc = (1.0 / max_ang_acc if max_ang_acc
                            else 1.0 / self.max_ang_speed)
        self.vel_space = _ball(max_speed, self.pose.pos_space.lower)

    def sample(self, generator, batch=()):
        pose = self.pose.sample(generator, batch)
        vel = self.vel_space.sample(generator, batch)
        omega = _uniform(generator, tuple(batch), pose.pos,
                         -self.max_ang_speed, self.max_ang_speed)
        return SE2Point1(pose.pos, pose.theta, vel, omega)

    def _level_times(self, a, b):
        dp = torch.linalg.vector_norm(a.pos - b.pos, dim=-1) / self.max_speed
        dr = torch.abs(self.pose._dtheta(a, b)) / self.max_ang_speed
        dv = torch.linalg.vector_norm(a.vel - b.vel, dim=-1) * self.inv_acc
        dw = torch.abs(a.omega - b.omega) * self.inv_ang_acc
        return dp, dr, dv, dw

    def distance(self, a: SE2Point1, b: SE2Point1):
        dp, dr, dv, dw = self._level_times(a, b)
        return torch.sqrt(dp * dp + dr * dr + dv * dv + dw * dw)

    def interpolate(self, a: SE2Point1, b: SE2Point1, t):
        t = _frac(t, a.pos)
        pose = self.pose.interpolate(SE2Point(a.pos, a.theta),
                                     SE2Point(b.pos, b.theta), t)
        return SE2Point1(pose.pos, pose.theta,
                         a.vel + (b.vel - a.vel) * _lift(t),
                         a.omega + (b.omega - a.omega) * t)

    def difference(self, a: SE2Point1, b: SE2Point1):
        return torch.cat([a.pos - b.pos, self.pose._dtheta(a, b)[..., None],
                          a.vel - b.vel, (a.omega - b.omega)[..., None]],
                         dim=-1)

    def clamp(self, p: SE2Point1):
        pose = self.pose.clamp(SE2Point(p.pos, p.theta))
        return SE2Point1(pose.pos, pose.theta, self.vel_space.clamp(p.vel),
                         torch.clamp(p.omega, -self.max_ang_speed,
                                     self.max_ang_speed))


class SE22ndOrderSpace(SE21stOrderSpace):
    """2nd-order SE(2) tangent bundle (ref: se2_topologies.hpp:114): adds a
    planar-acceleration disc and an angular-acceleration interval."""

    order = 2

    def __init__(self, pos_lower, pos_upper, max_speed: float,
                 max_ang_speed: float, max_acc: float, max_ang_acc: float,
                 max_jerk: float | None = None,
                 max_ang_jerk: float | None = None, device="cuda",
                 dtype=torch.float64):
        super().__init__(pos_lower, pos_upper, max_speed, max_ang_speed,
                         max_acc, max_ang_acc, device=device, dtype=dtype)
        self.max_acc = float(max_acc)
        self.max_ang_acc = float(max_ang_acc)
        self.inv_jerk = (1.0 / max_jerk if max_jerk
                         else 1.0 / max(max_acc, 1e-12))
        self.inv_ang_jerk = (1.0 / max_ang_jerk if max_ang_jerk
                             else 1.0 / max(max_ang_acc, 1e-12))
        self.acc_space = _ball(max_acc, self.pose.pos_space.lower)

    def sample(self, generator, batch=()):
        p1 = super().sample(generator, batch)
        acc = self.acc_space.sample(generator, batch)
        alpha = _uniform(generator, tuple(batch), p1.pos, -self.max_ang_acc,
                         self.max_ang_acc)
        return SE2Point2(*p1, acc, alpha)

    def distance(self, a: SE2Point2, b: SE2Point2):
        dp, dr, dv, dw = self._level_times(a, b)
        da = torch.linalg.vector_norm(a.acc - b.acc, dim=-1) * self.inv_jerk
        dl = torch.abs(a.alpha - b.alpha) * self.inv_ang_jerk
        return torch.sqrt(dp * dp + dr * dr + dv * dv + dw * dw + da * da
                          + dl * dl)

    def interpolate(self, a: SE2Point2, b: SE2Point2, t):
        t = _frac(t, a.pos)
        p1 = super().interpolate(SE2Point1(*a[:4]), SE2Point1(*b[:4]), t)
        return SE2Point2(*p1, a.acc + (b.acc - a.acc) * _lift(t),
                         a.alpha + (b.alpha - a.alpha) * t)

    def difference(self, a: SE2Point2, b: SE2Point2):
        d1 = super().difference(SE2Point1(*a[:4]), SE2Point1(*b[:4]))
        return torch.cat([d1, a.acc - b.acc, (a.alpha - b.alpha)[..., None]],
                         dim=-1)

    def clamp(self, p: SE2Point2):
        p1 = super().clamp(SE2Point1(*p[:4]))
        return SE2Point2(*p1, self.acc_space.clamp(p.acc),
                         torch.clamp(p.alpha, -self.max_ang_acc,
                                     self.max_ang_acc))


class FlatSE2Space:
    """Array-chart SE(2): points are plain ``(..., 3)`` tensors ``[x, y, θ]``
    with the wrap-around heading metric — the representation the
    array-backed planners (``planning/rrt.py`` fixed-capacity vertex tables)
    consume, so a mobile-robot pose plans exactly like a joint vector (the
    reference plans SE(2) through the same generic topology concept,
    se2_topologies.hpp:145 + ptrobot2D_test_world.hpp)."""

    order = 0

    def __init__(self, pos_lower, pos_upper, rot_weight: float = 1.0,
                 device="cuda", dtype=torch.float64):
        self.pos_space = HyperboxSpace(pos_lower, pos_upper, device=device,
                                       dtype=dtype)
        self.rot_weight = float(rot_weight)

    def sample(self, generator, batch=()):
        pos = self.pos_space.sample(generator, batch)
        theta = _uniform(generator, tuple(batch) + (1,), pos, -math.pi,
                         math.pi)
        return torch.cat([pos, theta], dim=-1)

    def distance(self, a, b):
        dp = self.pos_space.distance(a[..., :2], b[..., :2])
        dr = torch.abs(wrap_angle(a[..., 2] - b[..., 2]))
        return torch.sqrt(dp * dp + (self.rot_weight * dr) ** 2)

    def interpolate(self, a, b, t):
        t = _frac(t, a)
        pos = a[..., :2] + (b[..., :2] - a[..., :2]) * _lift(t)
        dth = wrap_angle(a[..., 2] - b[..., 2])
        theta = wrap_angle(a[..., 2] - dth * t)
        return torch.cat([pos, theta[..., None]], dim=-1)

    def difference(self, a, b):
        return torch.cat([a[..., :2] - b[..., :2],
                          wrap_angle(a[..., 2] - b[..., 2])[..., None]],
                         dim=-1)

    def clamp(self, p):
        return torch.cat([self.pos_space.clamp(p[..., :2]),
                          wrap_angle(p[..., 2])[..., None]], dim=-1)


def make_se2_space(pos_lower, pos_upper, order=0, **limits):
    """Order-dispatched SE(2) space factory (ref: se2_topologies.hpp:145
    se2_topology order dispatch)."""
    if order == 0:
        return SE2Space(pos_lower, pos_upper, **limits)
    if order == 1:
        return SE21stOrderSpace(pos_lower, pos_upper, **limits)
    if order == 2:
        return SE22ndOrderSpace(pos_lower, pos_upper, **limits)
    raise ValueError(f"unsupported order {order}")
