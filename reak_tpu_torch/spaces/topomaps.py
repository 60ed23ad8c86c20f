"""Kinematics topological maps: joint space ↔ end-effector SE(3) space
(port of ``reak_tpu/spaces/topomaps.py``).

(ref: ctrl/topologies/direct_kinematics_topomap.hpp manip_direct_kin_map /
manip_DK_map applying doDirectMotion to lift a joint-space point into the
end-effector's SE(3) topology, inverse_kinematics_topomap.hpp
manip_inverse_kin_map / manip_IK_map running the model's doInverseMotion,
and the rate-limited variants in direct_kinematics_topomap_detail.hpp)

These close the loop between the planning topologies (``spaces/``) and the
KTE models (``kte/``): a planner works in the Ndof joint space while goals,
queries, and recorded results live in the workspace SE(3) topology.  Both
maps take batched points: the per-point function of ``kte/ik`` runs under
``torch.func.vmap`` over every leading axis, on the device of the points.
Numbers and numpy arrays go on ``device`` (the card unless the caller asks
for the CPU) in float64.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.interp.hermite import _as_tensors
from reak_tpu_torch.kte import dynamics, ik
from reak_tpu_torch.spaces.se3 import SE3Point, SE3Point1


def _batched(fn, ndim):
    """``fn`` mapped over the ``ndim - 1`` leading axes of its arguments."""
    for _ in range(ndim - 1):
        fn = torch.func.vmap(fn)
    return fn


class DirectKinTopoMap:
    """Joint point → end-effector SE(3) pose (ref:
    direct_kinematics_topomap.hpp manip_direct_kin_map::map_to_space)."""

    def __init__(self, spec, device="cuda"):
        self.spec = spec
        self.device = device

    def __call__(self, q) -> SE3Point:
        q, = _as_tensors(q, device=self.device)
        p, quat = _batched(lambda qi: ik.ee_pose(self.spec, qi), q.ndim)(q)
        return SE3Point(p, quat)

    def lift(self, q, qd) -> SE3Point1:
        """1st-order lift: (q, q̇) → pose + the end effector's twist
        [v, ω] = J q̇ through the geometric Jacobian, in world coordinates
        (``kte/ik.ee_jacobian``'s frame; the JAX docstring says a body
        twist) (ref: direct_kinematics_topomap_detail.hpp — the
        rate-limited 1st-order map writes frame velocities from the joint
        rates)."""
        q, qd = _as_tensors(q, qd, device=self.device)

        def one(qi, qdi):
            fk_res = dynamics.fk(self.spec, qi)
            tw = ik.ee_jacobian(self.spec, qi, fk_res) @ qdi
            return fk_res.body_pos[-1], fk_res.body_quat[-1], tw[:3], tw[3:]

        return SE3Point1(*_batched(one, q.ndim)(q, qd))


class InverseKinTopoMap:
    """End-effector SE(3) pose → joint point (ref:
    inverse_kinematics_topomap.hpp manip_inverse_kin_map::map_to_space).

    ``solver`` is a closed-form solver of ``kte/ik.py`` taking
    ``(spec, p, quat, **branches)``: ``ik_3r3r``, ``ik_ssrms``, ``ik_era``,
    or ``ik_p3r3r`` with ``track_pos`` among the branches (``ik_scara``,
    which the JAX docstring lists too, takes a yaw, not a quaternion);
    when None, damped CLIK from ``q0`` is used (≙ the reference falling
    back to manip_clik_calculator)."""

    def __init__(self, spec, solver=None, device="cuda", **branches):
        self.spec = spec
        self.solver = solver
        self.device = device
        self.branches = branches

    def __call__(self, pose: SE3Point, q0=None):
        p, quat = _as_tensors(pose.pos, pose.quat, device=self.device)
        if self.solver is not None:
            fn = lambda pi, qi: self.solver(self.spec, pi, qi,
                                            **self.branches)
            return _batched(fn, p.ndim)(p, quat)
        if q0 is None:
            raise ValueError("CLIK-backed inverse map needs a seed q0")
        q0, = _as_tensors(q0, device=p.device, dtype=p.dtype)
        if p.ndim > 1:
            return ik.clik_batched(self.spec, p, quat, q0,
                                   **self.branches).q
        return ik.clik(self.spec, p, quat, q0, **self.branches).q
