"""Kinematic poses and frames as named tuples of tensors (port of
``reak_tpu/math/frames.py``).

Conventions (identical to the reference, frame_3D.hpp:40-48):
- ``pos``   position of the frame origin, expressed in PARENT coordinates
- ``quat``  orientation quaternion [w,x,y,z], local→parent rotation
- ``vel``   linear velocity relative-to and expressed-in PARENT coordinates
- ``omega`` angular velocity relative to parent, expressed in LOCAL (body)
  coords
- ``acc``   linear acceleration, PARENT coordinates
- ``alpha`` angular acceleration, LOCAL coordinates

All fields broadcast over leading batch axes (ref: core/kinetostatics/
pose_3D.hpp, frame_3D.hpp:50-76, gen_coord.hpp:45).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.math import rotations as rot


class Pose3(NamedTuple):
    """Static pose: position (PARENT coords) + quaternion (local→parent)."""

    pos: torch.Tensor  # (..., 3)
    quat: torch.Tensor  # (..., 4) [w,x,y,z]

    @staticmethod
    def identity(dtype=torch.float32, batch_shape=(), device="cuda"):
        return Pose3(
            pos=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                            device=device),
            quat=rot.qidentity(dtype, batch_shape, device))

    def rotate_to_parent(self, v):
        """Local vector → parent coords (ref: pose_3D.hpp:147)."""
        return rot.qrot(self.quat, v)

    def rotate_from_parent(self, v):
        return rot.qrot_inv(self.quat, v)

    def transform_to_parent(self, p):
        """Local point → parent coords."""
        return self.pos + rot.qrot(self.quat, p)

    def transform_from_parent(self, p):
        return rot.qrot_inv(self.quat, p - self.pos)

    def compose(self, child: "Pose3") -> "Pose3":
        """this ∘ child: the pose of ``child`` (expressed relative to this)
        in this pose's parent (ref: pose_3D.hpp:206)."""
        return Pose3(pos=self.pos + rot.qrot(self.quat, child.pos),
                     quat=rot.qmul(self.quat, child.quat))

    def inverse(self) -> "Pose3":
        qi = rot.qconj(self.quat)
        return Pose3(pos=-rot.qrot(qi, self.pos), quat=qi)


class Frame3(NamedTuple):
    """Kinematic frame: pose + velocity + acceleration (ReaK frame_3D
    semantics)."""

    pos: torch.Tensor  # (..., 3) parent coords
    quat: torch.Tensor  # (..., 4) local→parent
    vel: torch.Tensor  # (..., 3) parent coords
    omega: torch.Tensor  # (..., 3) LOCAL coords
    acc: torch.Tensor  # (..., 3) parent coords
    alpha: torch.Tensor  # (..., 3) LOCAL coords

    @staticmethod
    def identity(dtype=torch.float32, batch_shape=(), device="cuda"):
        z = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return Frame3(z, rot.qidentity(dtype, batch_shape, device), z, z, z, z)

    @property
    def pose(self) -> Pose3:
        return Pose3(self.pos, self.quat)

    def compose(self, child: "Frame3") -> "Frame3":
        """Kinematic composition: ``child`` expressed relative to this frame
        → the same frame expressed relative to this frame's parent (the
        rotating-frame formulae of ReaK ``frame_3D::add_before``,
        frame_3D.hpp:50; inertia.cpp:111-121):
          p = p1 + R1 p2
          v = v1 + R1 v2 + R1(ω1 × p2)
          a = a1 + R1 a2 + R1(α1 × p2 + ω1 × (ω1 × p2) + 2 ω1 × v2)
          ω = R2ᵀ ω1 + ω2
          α = R2ᵀ α1 + (R2ᵀ ω1) × ω2 + α2
        """
        q1, q2 = self.quat, child.quat
        p2_in1 = rot.qrot(q1, child.pos)
        v2_in1 = rot.qrot(q1, child.vel)
        a2_in1 = rot.qrot(q1, child.acc)
        w1xp2 = rot.cross(self.omega, child.pos)
        pos = self.pos + p2_in1
        vel = self.vel + v2_in1 + rot.qrot(q1, w1xp2)
        acc = (self.acc + a2_in1
               + rot.qrot(q1, rot.cross(self.alpha, child.pos)
                          + rot.cross(self.omega, w1xp2)
                          + 2.0 * rot.cross(self.omega, child.vel)))
        w1_in2 = rot.qrot_inv(q2, self.omega)
        omega = w1_in2 + child.omega
        alpha = (rot.qrot_inv(q2, self.alpha)
                 + rot.cross(w1_in2, child.omega) + child.alpha)
        return Frame3(pos, rot.qmul(q1, q2), vel, omega, acc, alpha)

    @property
    def quat_dot(self):
        """Quaternion time-derivative (ref: frame_3D.hpp QuatDot)."""
        return rot.qdot_from_omega(self.quat, self.omega)


class Frame2(NamedTuple):
    """2D kinematic frame (ReaK frame_2D semantics; ref: frame_2D.hpp)."""

    pos: torch.Tensor  # (..., 2) parent coords
    angle: torch.Tensor  # (...)
    vel: torch.Tensor  # (..., 2) parent coords
    omega: torch.Tensor  # (...)
    acc: torch.Tensor  # (..., 2) parent coords
    alpha: torch.Tensor  # (...)

    @staticmethod
    def identity(dtype=torch.float32, batch_shape=(), device="cuda"):
        z2 = torch.zeros(tuple(batch_shape) + (2,), dtype=dtype,
                         device=device)
        z = torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
        return Frame2(z2, z, z2, z, z2, z)

    def compose(self, child: "Frame2") -> "Frame2":
        th = self.angle
        p2_in1 = rot.rot2d_apply(th, child.pos)
        v2_in1 = rot.rot2d_apply(th, child.vel)
        a2_in1 = rot.rot2d_apply(th, child.acc)

        def perp(v):  # ω × p in 2D: ω ẑ × (x, y) = ω(-y, x)
            return torch.stack([-v[..., 1], v[..., 0]], dim=-1)

        w1xp2 = self.omega[..., None] * perp(child.pos)
        pos = self.pos + p2_in1
        vel = self.vel + v2_in1 + rot.rot2d_apply(th, w1xp2)
        acc = (self.acc + a2_in1
               + rot.rot2d_apply(
                   th, self.alpha[..., None] * perp(child.pos)
                   + self.omega[..., None] * perp(w1xp2)
                   + 2.0 * self.omega[..., None] * perp(child.vel)))
        return Frame2(pos, self.angle + child.angle, vel,
                      self.omega + child.omega, acc,
                      self.alpha + child.alpha)


class GenCoord(NamedTuple):
    """Generalized coordinate {q, q_dot, q_ddot} (ref: gen_coord.hpp:45)."""

    q: torch.Tensor
    qd: torch.Tensor
    qdd: torch.Tensor

    @staticmethod
    def zero(dtype=torch.float32, batch_shape=(), device="cuda"):
        z = torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
        return GenCoord(z, z, z)
