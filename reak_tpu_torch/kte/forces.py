"""Task-space and virtual-model-control forces on KTE chains (port of
``reak_tpu/kte/forces.py``; ref: ctrl/mbd_kte/force_actuator.hpp:55,
vmc_revolute_joint.hpp:58, virtual_kte_interface.hpp:49,
line_point_mindist.hpp:51, plane_point_mindist.hpp:49).

Pure functions of ONE sample that map world-space forces to generalized
joint forces through the point Jacobian, τ = Jᵀ f: add their outputs to
``tau`` before ``kte.dynamics.forward_dynamics``.  A batch goes through
``torch.func.vmap``.  Plain torch on the device of ``q``; the point and the
force may be tensors, numpy arrays or lists.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.kte import dynamics
from reak_tpu_torch.kte.spec import ChainSpec, JointType, PRISMATIC, REVOLUTE
from reak_tpu_torch.math import rotations as rot


def _like(x, q):
    return torch.as_tensor(x, dtype=q.dtype, device=q.device)


def point_kinematics(spec: ChainSpec, q, body: int, point_local):
    """World position of a body-fixed point and its (3, nv) Jacobian; the
    columns of REVOLUTE and PRISMATIC joints (a FREE joint has none), zero
    for the joints past ``body``."""
    r = dynamics.fk(spec, q)
    p = r.body_pos[body] + rot.qrot(r.body_quat[body], _like(point_local, q))
    zeros3 = torch.zeros(3, dtype=q.dtype, device=q.device)
    cols = []
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == REVOLUTE:
            col = rot.cross(r.joint_axis[i], p - r.joint_anchor[i])
        elif jt == PRISMATIC:
            col = r.joint_axis[i]
        else:
            continue
        cols.append(col if i <= body else zeros3)
    return p, torch.stack(cols, dim=-1)


def point_velocity(spec: ChainSpec, q, qd, body: int, point_local):
    _, J = point_kinematics(spec, q, body, point_local)
    return J @ qd


def world_force_to_tau(spec: ChainSpec, q, body: int, point_local, f_world):
    """Generalized force of a world-frame force applied at a body point:
    τ = Jᵀ f  (ref: force_actuator_3D doForce accumulation)."""
    _, J = point_kinematics(spec, q, body, point_local)
    return J.T @ _like(f_world, q)


def virtual_spring_damper(spec: ChainSpec, q, qd, body: int, point_local,
                          target_world, k: float, d: float = 0.0):
    """Virtual-model control: spring(+damper) pulling a body point toward a
    world target (ref: vmc_revolute_joint.hpp:58, virtual_kte_interface.hpp:49
    — virtual elements acting through the real chain's Jacobian)."""
    p, J = point_kinematics(spec, q, body, point_local)
    f = k * (_like(target_world, q) - p)
    if d:
        f = f - d * (J @ qd)
    return J.T @ f


def line_point_mindist_force(spec: ChainSpec, q, body: int, point_local,
                             line_origin, line_dir, k: float):
    """Restoring force pulling a body point onto a world line
    (ref: line_point_mindist.hpp:51,164)."""
    p, J = point_kinematics(spec, q, body, point_local)
    o = _like(line_origin, q)
    u = _like(line_dir, q)
    u = u / torch.linalg.vector_norm(u)
    closest = o + torch.dot(p - o, u) * u
    return J.T @ (k * (closest - p))


def plane_point_mindist_force(spec: ChainSpec, q, body: int, point_local,
                              plane_normal, plane_offset, k: float):
    """Restoring force pulling a body point onto the plane n·x = d
    (ref: plane_point_mindist.hpp:49)."""
    p, J = point_kinematics(spec, q, body, point_local)
    n = _like(plane_normal, q)
    n = n / torch.linalg.vector_norm(n)
    dist = torch.dot(p, n) - _like(plane_offset, q)
    return J.T @ (-k * dist * n)
