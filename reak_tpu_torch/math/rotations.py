"""Rotations: 2D angles, 3D quaternions, rotation matrices, axis-angle,
Euler TB (port of ``reak_tpu/math/rotations.py``).

Conventions, as in the JAX package (ref: core/kinetostatics/
rotations_2D.hpp, rotations_3D.hpp:73,552, quat_alg.hpp:49):

- 2D rotation        : scalar angle ``theta`` (radians)
- 3D quaternion      : shape ``(..., 4)`` tensor ``[w, x, y, z]``, unit norm
- rotation matrix    : shape ``(..., 3, 3)``, acts on column vectors (R @ v)
- axis-angle         : ``(axis (..., 3), angle (...))``
- Euler angles (TB)  : Tait-Bryan body-fixed Z-Y'-X'' yaw/pitch/roll

Every function indexes the last axis, so it takes any leading batch axes,
and keeps the input's dtype and device.  ``math/rot_lanes.py`` holds the
lanes forms (components on axis 0, the batch last).  Frame composition:
``qmul(q_parent_to_world, q_child_to_parent)`` gives child-to-world.
"""
from __future__ import annotations

import torch


def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# 2D rotations (scalar angle)
# ---------------------------------------------------------------------------


def rot2d(theta):
    """2x2 rotation matrix from angle (ref: rotations_2D.hpp rot_mat_2D)."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def rot2d_apply(theta, v):
    """Rotate 2D vector(s) v by angle theta."""
    theta = torch.as_tensor(theta, dtype=v.dtype, device=v.device)
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions [w, x, y, z]
# ---------------------------------------------------------------------------


def qidentity(dtype=torch.float32, batch_shape=(), device="cuda"):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0].fill_(1.0)  # a fill on the device, no copy from the host
    return q


def qmul(q1, q2):
    """Hamilton product q1 ⊗ q2 (composition: parent * child)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def qconj(q):
    """Conjugate = inverse for unit quaternions."""
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def qnormalize(q, eps=0.0):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps) if eps else q / n


def cross(a, b):
    """a × b over the last axis (broadcasting the leading ones)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrot(q, v):
    """Rotate vector v from the frame of q into its parent: R(q) @ v.

    The 15-multiply form t = 2 q_v × v; v' = v + w t + q_v × t."""
    w = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def qrot_inv(q, v):
    """Rotate v from parent coords into the frame of q: R(q)^T @ v."""
    w = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v - w * t + cross(qv, t)


def q_to_matrix(q):
    """Unit quaternion → rotation matrix (ref: rotations_3D.hpp
    getRotMat)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def q_from_matrix(R):
    """Rotation matrix → unit quaternion, branch-free Shepperd via
    max-trace select; canonical sign w ≥ 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    root = lambda a: torch.sqrt(torch.clamp(a, min=1e-30)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 candidates, 4)
    q = torch.take_along_dim(qs, idx[..., None, None], dim=-2)[..., 0, :]
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)


def q_from_axis_angle(axis, angle):
    """Axis-angle → quaternion (ref: rotations_3D.hpp
    axis_angle::getQuaternion)."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], s[..., None] * axis], dim=-1)


def q_to_axis_angle(q):
    """Quaternion → (axis, angle); axis defaults to +x for identity."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    qv = q[..., 1:4]
    n = torch.linalg.vector_norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    safe = n > 1e-12
    axis = torch.where(safe[..., None],
                       qv / torch.clamp(n, min=1e-30)[..., None],
                       _t([1.0, 0.0, 0.0], q).expand(qv.shape))
    return axis, angle


def q_exp(v):
    """Exponential map from rotation vector (..., 3) to quaternion.

    AD-safe at v = 0 (the double where guards the norm so jvp and grad are
    finite)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    safe = n2 > 1e-16
    angle = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    half = 0.5 * angle
    # sinc(half)/2: series 0.5 − n²/48 near zero
    k = torch.where(safe, torch.sin(half) / angle, 0.5 - n2 / 48.0)
    w = torch.where(safe, torch.cos(half), 1.0 - n2 / 8.0)
    return torch.cat([w, k * v], dim=-1)


def q_log(q):
    """Log map: quaternion → rotation vector (..., 3).  AD-safe at
    identity."""
    w = q[..., 0:1]
    qv = q[..., 1:4]
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    safe = n2 > 1e-16
    n = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    # scale = 2·atan2(n, w)/n; series for small n: 2/w·(1 − n²/(3w²))
    scale = torch.where(safe, 2.0 * torch.atan2(n, w) / n,
                        2.0 / w * (1.0 - n2 / (3.0 * w * w)))
    return scale * qv


def qslerp(q0, q1, t):
    """Spherical linear interpolation with shortest-arc sign fix."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    # fall back to lerp for nearly parallel quaternions
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-6
    safe_sin = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe_sin)
    return qnormalize(w0 * q0 + w1 * q1)


def qdot_from_omega(q, omega_body):
    """Quaternion rate from body-frame angular velocity:
    Q̇ = ½ Q ⊗ (0, ω_body) (ref: core/kinetostatics/frame_3D.hpp
    UpdateQuatDot)."""
    zero = torch.zeros_like(omega_body[..., :1])
    return 0.5 * qmul(q, torch.cat([zero, omega_body], dim=-1))


def omega_from_qdot(q, qdot):
    """Body angular velocity from quaternion rate: ω = 2 (Q* ⊗ Q̇)_vec."""
    return 2.0 * qmul(qconj(q), qdot)[..., 1:4]


# ---------------------------------------------------------------------------
# Euler angles, Tait-Bryan ZYX (yaw-pitch-roll), body-fixed
# ---------------------------------------------------------------------------


def q_from_euler_tb(yaw, pitch, roll):
    """Tait-Bryan Z-Y'-X'' → quaternion (ref: rotations_3D.hpp
    euler_angles_TB)."""
    yaw, pitch, roll = torch.broadcast_tensors(
        *(torch.as_tensor(a) for a in (yaw, pitch, roll)))
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1)


def q_to_euler_tb(q):
    """Quaternion → (yaw, pitch, roll), Tait-Bryan ZYX."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    sinp = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.arcsin(sinp)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    return yaw, pitch, roll


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def hat(v):
    """Skew-symmetric cross-product matrix [v]× (..., 3) → (..., 3, 3)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def vee(M):
    """Inverse of hat: (..., 3, 3) skew matrix → (..., 3)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)
