"""Lanes-layout (batch-last) quaternion and rotation functions (port of
``reak_tpu/math/rot_lanes.py``).

Components sit on axis -2 and the scenario batch on the last axis; every
function takes (..., k, B) with k ∈ {3, 4} and broadcasts leading axes.
``q_exp_l`` and ``q_log_l`` keep the JAX package's double-``where`` guards
(the square root and the division see a safe value on the series branch),
so a forward-mode derivative at the identity stays finite.
(ref: core/kinetostatics/rotations_3D.hpp, quat_alg.hpp)
"""
from __future__ import annotations

import torch

# a float factor as the scalar argument of aten.mul.Scalar: under
# torch.func.jvp that keeps clear of the zero-tangent detour through
# torch._refs that a float taken as a wrapped number takes (kte/soa._mul)
_MUL_S = torch.ops.aten.mul.Scalar


def cross_l(a, b):
    """Cross product over axis -2 (size 3)."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2
    )


def qmul_l(a, b):
    """Hamilton product, components on axis -2: (..., 4, B)."""
    w1, x1, y1, z1 = a[..., 0, :], a[..., 1, :], a[..., 2, :], a[..., 3, :]
    w2, x2, y2, z2 = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-2,
    )


def qconj_l(q):
    return torch.cat([q[..., 0:1, :], -q[..., 1:4, :]], dim=-2)


def qnormalize_l(q):
    n = torch.sqrt(torch.sum(q * q, dim=-2, keepdim=True))
    return q / n


def qrot_l(q, v):
    """Rotate v by q (frame → parent): t = 2 q_v × v; v + w t + q_v × t."""
    w = q[..., 0:1, :]
    qv = q[..., 1:4, :]
    t = _MUL_S(cross_l(qv, v), 2.0)
    return v + w * t + cross_l(qv, t)


def qrot_inv_l(q, v):
    """Rotate v by q⁻¹ (parent → frame)."""
    w = q[..., 0:1, :]
    qv = q[..., 1:4, :]
    t = _MUL_S(cross_l(qv, v), 2.0)
    return v - w * t + cross_l(qv, t)


def q_exp_l(v):
    """Rotation vector (..., 3, B) → quaternion (..., 4, B); AD-safe at 0."""
    n2 = torch.sum(v * v, dim=-2, keepdim=True)
    safe = n2 > 1e-16
    angle = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    half = 0.5 * angle
    k = torch.where(safe, torch.sin(half) / angle, 0.5 - n2 / 48.0)
    w = torch.where(safe, torch.cos(half), 1.0 - n2 / 8.0)
    return torch.cat([w, k * v], dim=-2)


def q_log_l(q):
    """Quaternion (..., 4, B) → rotation vector (..., 3, B); AD-safe at id."""
    w = q[..., 0:1, :]
    qv = q[..., 1:4, :]
    n2 = torch.sum(qv * qv, dim=-2, keepdim=True)
    safe = n2 > 1e-16
    n = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    scale = torch.where(
        safe, 2.0 * torch.atan2(n, w) / n,
        2.0 / w * (1.0 - n2 / (3.0 * w * w)))
    return scale * qv


def q_to_matrix_l(q):
    """Unit quaternion (..., 4, B) → rotation matrix (..., 3, 3, B)."""
    w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
                       dim=-2)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
                       dim=-2)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
                       dim=-2)
    return torch.stack([row0, row1, row2], dim=-3)


def skew_l(v):
    """(..., 3, B) → (..., 3, 3, B) cross-product matrix [v]×."""
    zero = torch.zeros_like(v[..., 0, :])
    vx, vy, vz = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    row0 = torch.stack([zero, -vz, vy], dim=-2)
    row1 = torch.stack([vz, zero, -vx], dim=-2)
    row2 = torch.stack([-vy, vx, zero], dim=-2)
    return torch.stack([row0, row1, row2], dim=-3)


def qdot_from_omega_l(q, w_body):
    """Q̇ = ½ Q ⊗ (0, ω_body), lanes layout: q (..., 4, B), w (..., 3, B)."""
    zw = torch.cat([torch.zeros_like(w_body[..., 0:1, :]), w_body], dim=-2)
    return 0.5 * qmul_l(q, zw)
