"""Static chain specification — the "compiled" form of a KTE chain.

A copy of ``reak_tpu/kte/spec.py`` (numpy only), kept here so that the torch
port imports without JAX.  Replaces the reference's runtime object graph
(kte_map_chain of shared_ptr elements, ref: ctrl/mbd_kte/kte_map_chain.hpp:49)
with a frozen, hashable description: the plain torch paths read it as Python
constants, and the CUDA kernels get it packed into a small device tensor
(``reak_tpu_torch.ops.kte_step.chain_table``).

A chain is a serial sequence of joints; after each joint sits a body (possibly
massless) whose center of mass is placed relative to the joint's end frame.
Joint types: REVOLUTE / PRISMATIC (1 DoF about/along ``axis``), FIXED (0 DoF —
a pure link transform), FREE (6 DoF floating joint; only valid at index 0,
quaternion-parameterized, ref: ctrl/mbd_kte/free_joints.hpp:50,165).

Planar (2D) mechanisms are expressed as 3D chains with z-axis revolute joints —
same dynamics, no separate 2D code path (the reference's *_2D element family,
e.g. revolute_joint.hpp:51, collapses into this).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np


class JointType(enum.IntEnum):
    REVOLUTE = 0  # ref: ctrl/mbd_kte/revolute_joint.hpp:167
    PRISMATIC = 1  # ref: ctrl/mbd_kte/prismatic_joint.hpp:183
    FIXED = 2  # ref: rigid_link.hpp:50 (a link with no joint DoF)
    FREE = 3  # ref: free_joints.hpp:165


REVOLUTE = JointType.REVOLUTE
PRISMATIC = JointType.PRISMATIC
FIXED = JointType.FIXED
FREE = JointType.FREE

_DOF_Q = {REVOLUTE: 1, PRISMATIC: 1, FIXED: 0, FREE: 7}
_DOF_V = {REVOLUTE: 1, PRISMATIC: 1, FIXED: 0, FREE: 6}


def _as_tuple(a) -> tuple:
    return tuple(np.asarray(a, dtype=np.float64).ravel().tolist())


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Immutable serial-chain description.  All numeric metadata is stored as
    nested tuples so the spec is hashable (usable as a jit static argument).

    Per joint i:
      - ``joint_types[i]``: JointType
      - ``axes[i]``: unit axis in the joint's base-frame coords (revolute/prismatic)
      - ``offsets_pos[i]``, ``offsets_quat[i]``: fixed pose of joint i's base frame
        expressed in joint (i-1)'s end frame (the rigid_link before the joint)
      - body i hangs off joint i's end frame:
        ``com_pos[i]`` COM position in end-frame coords, ``masses[i]``,
        ``inertias[i]`` 3x3 inertia tensor about the COM in end-frame coords
        (ref: inertia.hpp:232 inertia_3D)
      - passive joint elements acting on the joint coordinate
        (gen springs/dampers/friction, ref: spring.hpp:53, damper.hpp:51,
        joint_friction.hpp:48,134):
        ``stiffness``, ``rest_q``, ``damping``,
        ``stiction_vel/slip_vel/stiction_coef/slip_coef`` (dry microslip)
    """

    joint_types: Tuple[int, ...]
    axes: tuple
    offsets_pos: tuple
    offsets_quat: tuple
    com_pos: tuple
    masses: tuple
    inertias: tuple
    stiffness: tuple
    rest_q: tuple
    damping: tuple
    stiction_vel: tuple
    slip_vel: tuple
    stiction_coef: tuple
    slip_coef: tuple
    gravity: tuple
    backlash: tuple = ()   # per-joint transmission deadband width (rad/m)
    name: str = "chain"

    # ------------------------------------------------------------------
    @staticmethod
    def build(
        joint_types,
        axes=None,
        offsets_pos=None,
        offsets_quat=None,
        com_pos=None,
        masses=None,
        inertias=None,
        stiffness=None,
        rest_q=None,
        damping=None,
        stiction_vel=None,
        slip_vel=None,
        stiction_coef=None,
        slip_coef=None,
        gravity=(0.0, 0.0, -9.81),
        backlash=None,
        name="chain",
    ) -> "ChainSpec":
        n = len(joint_types)
        joint_types = tuple(int(t) for t in joint_types)
        if any(t == FREE for t in joint_types[1:]):
            raise ValueError("FREE joint only supported at chain index 0")

        def default(x, shape, fill=0.0):
            if x is None:
                return np.full(shape, fill, dtype=np.float64)
            x = np.asarray(x, dtype=np.float64)
            if x.shape != shape:
                raise ValueError(f"expected shape {shape}, got {x.shape}")
            return x

        axes = default(axes, (n, 3))
        if np.all(axes == 0):
            axes[:, 2] = 1.0  # default: z-axis joints (planar convention)
        offsets_pos = default(offsets_pos, (n, 3))
        if offsets_quat is None:
            offsets_quat = np.zeros((n, 4))
            offsets_quat[:, 0] = 1.0
        else:
            offsets_quat = np.asarray(offsets_quat, dtype=np.float64)
        com_pos = default(com_pos, (n, 3))
        masses = default(masses, (n,))
        inertias = default(inertias, (n, 3, 3))
        stiffness = default(stiffness, (n,))
        rest_q = default(rest_q, (n,))
        damping = default(damping, (n,))
        stiction_vel = default(stiction_vel, (n,), 1e-6)
        slip_vel = default(slip_vel, (n,), 2e-6)
        stiction_coef = default(stiction_coef, (n,))
        slip_coef = default(slip_coef, (n,))
        backlash = default(backlash, (n,))

        return ChainSpec(
            joint_types=joint_types,
            axes=tuple(map(_as_tuple, axes)),
            offsets_pos=tuple(map(_as_tuple, offsets_pos)),
            offsets_quat=tuple(map(_as_tuple, offsets_quat)),
            com_pos=tuple(map(_as_tuple, com_pos)),
            masses=_as_tuple(masses),
            inertias=tuple(map(_as_tuple, inertias)),
            stiffness=_as_tuple(stiffness),
            rest_q=_as_tuple(rest_q),
            damping=_as_tuple(damping),
            stiction_vel=_as_tuple(stiction_vel),
            slip_vel=_as_tuple(slip_vel),
            stiction_coef=_as_tuple(stiction_coef),
            slip_coef=_as_tuple(slip_coef),
            gravity=_as_tuple(gravity),
            backlash=_as_tuple(backlash),
            name=name,
        )

    # ------------------------------------------------------------------
    @property
    def n_joints(self) -> int:
        return len(self.joint_types)

    @property
    def nq(self) -> int:
        """Configuration dimension (7 for a free base: pos + quat)."""
        return sum(_DOF_Q[JointType(t)] for t in self.joint_types)

    @property
    def nv(self) -> int:
        """Velocity / generalized-force dimension."""
        return sum(_DOF_V[JointType(t)] for t in self.joint_types)

    @property
    def has_free_base(self) -> bool:
        return self.n_joints > 0 and self.joint_types[0] == FREE

    def q_index(self, i: int) -> int:
        """Start index of joint i in the configuration vector."""
        return sum(_DOF_Q[JointType(t)] for t in self.joint_types[:i])

    def v_index(self, i: int) -> int:
        """Start index of joint i in the velocity vector."""
        return sum(_DOF_V[JointType(t)] for t in self.joint_types[:i])

    def axis_np(self, i: int) -> np.ndarray:
        return np.asarray(self.axes[i])

    def neutral_q(self) -> np.ndarray:
        """Neutral configuration (identity quaternion for a free base)."""
        q = np.zeros(self.nq)
        if self.has_free_base:
            q[3] = 1.0  # quaternion w at index 3 of [pos(3), quat(4)]
        return q
