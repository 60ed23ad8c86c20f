"""Register-form forward kinematics (port of ``reak_tpu/kte/soa.py``).

Vectors are 3-tuples and quaternions 4-tuples whose entries are tensors of
the batch shape (scenario batch last) or Python floats; chain constants stay
Python floats, so a literal zero or one costs nothing.  Only what the lanes
terms (``kte/lanes.make_terms_lanes``) call is ported: the quaternion helpers
and ``_fk_soa``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.kte.spec import (ChainSpec, JointType, REVOLUTE,
                                     PRISMATIC, FIXED, FREE)


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _qrot(q, v):
    """Rotate v by q: v + 2 w (qv×v) + 2 qv×(qv×v)."""
    w = q[0]
    qv = (q[1], q[2], q[3])
    t = _cross(qv, v)
    t = (2.0 * t[0], 2.0 * t[1], 2.0 * t[2])
    u = _cross(qv, t)
    return (v[0] + w * t[0] + u[0], v[1] + w * t[1] + u[1], v[2] + w * t[2] + u[2])


def _qrot_inv(q, v):
    return _qrot((q[0], -q[1], -q[2], -q[3]), v)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _scale(s, a):
    return tuple(s * x for x in a)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _const_vec(v):
    return (float(v[0]), float(v[1]), float(v[2]))


class _SoaFk(NamedTuple):
    com: tuple  # per body: vec3 (world COM)
    quat: tuple  # per body: quat (body→world)
    anchors: tuple  # per joint: vec3
    axes_g: tuple  # per 1-dof joint: vec3 (world axis)
    types: tuple
    pre_quat: tuple  # per joint: quat of the frame BEFORE the joint


def _fk_soa(spec: ChainSpec, q):
    """q: tuple of nq tensors (batch-last; nq = nv for fixed-base chains,
    nv + 1 with a free base: [p(3), quat(4)] per FREE joint, ref
    free_joints.hpp:165 packing)."""
    p = (0.0, 0.0, 0.0)
    Q = (1.0, 0.0, 0.0, 0.0)
    coms, quats, anchors, axes_g, types, pre_quats = [], [], [], [], [], []
    ci = 0
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        off = _const_vec(spec.offsets_pos[i])
        oq = tuple(float(x) for x in spec.offsets_quat[i])
        if off != (0.0, 0.0, 0.0):
            p = _add(p, _qrot(Q, off))
        if oq != (1.0, 0.0, 0.0, 0.0):
            Q = _qmul(Q, oq)
        pre_quats.append(Q)
        ax = _const_vec(spec.axes[i])
        if jt == REVOLUTE:
            qi = q[ci]
            ci += 1
            a_g = _qrot(Q, ax)
            anchors.append(p)
            axes_g.append(a_g)
            types.append(REVOLUTE)
            half = 0.5 * qi
            c, s = torch.cos(half), torch.sin(half)
            qj = (c, ax[0] * s, ax[1] * s, ax[2] * s)
            Q = _qmul(Q, qj)
        elif jt == PRISMATIC:
            qi = q[ci]
            ci += 1
            a_g = _qrot(Q, ax)
            anchors.append(p)
            axes_g.append(a_g)
            types.append(PRISMATIC)
            p = _add(p, _scale(qi, a_g))
        elif jt == FREE:
            # 6-DoF joint: q = [pos(3) in pre-frame coords, quat(4)]
            # (ref: free_joints.hpp:165 — end = base * coordinate frame)
            dp = (q[ci], q[ci + 1], q[ci + 2])
            p = _add(p, _qrot(Q, dp))
            qf = (q[ci + 3], q[ci + 4], q[ci + 5], q[ci + 6])
            inv_n = torch.rsqrt(qf[0] * qf[0] + qf[1] * qf[1]
                                + qf[2] * qf[2] + qf[3] * qf[3])
            qf = tuple(x * inv_n for x in qf)
            Q = _qmul(Q, qf)
            ci += 7
            anchors.append(p)
            axes_g.append((0.0, 0.0, 0.0))
            types.append(FREE)
        elif jt == FIXED:
            anchors.append(p)
            axes_g.append((0.0, 0.0, 0.0))
            types.append(FIXED)
        else:
            raise NotImplementedError(f"soa path: joint type {jt}")
        com = _const_vec(spec.com_pos[i])
        pc = _add(p, _qrot(Q, com)) if com != (0.0, 0.0, 0.0) else p
        coms.append(pc)
        quats.append(Q)
    return _SoaFk(tuple(coms), tuple(quats), tuple(anchors), tuple(axes_g),
                  tuple(types), tuple(pre_quats))
