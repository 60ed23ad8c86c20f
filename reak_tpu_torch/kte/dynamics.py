"""Chain kinematics and dynamics as pure functions (port of
``reak_tpu/kte/dynamics.py``; ref: ctrl/mbd_kte/kte_map_chain.hpp:71-89,
mass_matrix_calculator.cpp:80-287, manipulator_model.cpp:292-355).

Every function takes ONE sample (q (nq,), qd (nv,)), as the JAX functions
do; a batch goes through ``torch.func.vmap``, which every function here
admits.  The chain spec is a static constant: the per-joint loops unroll in
Python.  ``lax.scan`` over the joints of a long 1-DoF chain (``_fk_scan``)
becomes a Python loop over the spec with the same masked arithmetic,
``jax.jvp`` becomes ``torch.func.jvp`` and ``jax.jacfwd`` becomes
``torch.func.jacfwd``.  Plain torch on the device of the inputs; the chain
constants are moved there once for each (dtype, device).

Semantics, as in the reference:
- kinematics sweep base→tip == ``fk``;
- geometric Jacobian columns stacked into the twist-shaping matrix T
  (linear rows in world coords, angular rows in body coords);
- force sweep tip→base with q̈=0 == ``bias_force``, its J̇q̇ terms from one
  jvp through the velocity map;
- gravity enters as a base-frame acceleration (d'Alembert).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp

from reak_tpu_torch.kte.spec import (ChainSpec, JointType, REVOLUTE,
                                     PRISMATIC, FIXED, FREE)
from reak_tpu_torch.math import rotations as rot
from reak_tpu_torch.math.frames import Frame3
from reak_tpu_torch.math.linalg import _cholesky, solve_pd


class FkResult(NamedTuple):
    """Stacked per-body global kinematics (nb = n_joints bodies)."""

    body_pos: torch.Tensor  # (nb, 3) joint end-frame origins, world coords
    body_quat: torch.Tensor  # (nb, 4) body orientation, local→world
    com_pos: torch.Tensor  # (nb, 3) COM positions, world coords
    joint_anchor: torch.Tensor  # (nb, 3) rotation anchor points, world
    joint_axis: torch.Tensor  # (nb, 3) joint axes, world coords
    pre_quat: torch.Tensor  # (nb, 4) orientation of the frame before a joint


def _one_dof_index(spec: ChainSpec) -> list:
    """The joints with one dof (REVOLUTE, PRISMATIC), in chain order."""
    return [i for i, t in enumerate(spec.joint_types)
            if JointType(t) in (REVOLUTE, PRISMATIC)]


@functools.lru_cache(maxsize=None)
def _spec_consts(spec: ChainSpec):
    from reak_tpu_torch.kte.lanes import _Consts

    nb = spec.n_joints
    idx = np.asarray(_one_dof_index(spec), np.int64)
    order = np.arange(nb)
    return _Consts(
        axes=np.asarray(spec.axes, np.float64),
        off_pos=np.asarray(spec.offsets_pos, np.float64),
        off_quat=np.asarray(spec.offsets_quat, np.float64),
        com=np.asarray(spec.com_pos, np.float64),
        mass=np.asarray(spec.masses, np.float64),
        inertia=np.asarray(spec.inertias, np.float64).reshape(-1, 3, 3),
        gravity=np.asarray(spec.gravity, np.float64),
        # body k moves with joint i iff k >= i: mask[i] (nb, 1)
        mask=(order[None, :] >= order[:, None]).astype(np.float64)[:, :,
                                                                    None],
        # the same over the one-dof joints (nb, nv, 1), which of them
        # revolve (1, nv, 1), and their indices
        reach=(order[:, None] >= idx[None, :]).astype(np.float64)[:, :,
                                                                   None],
        w_rev=np.array([JointType(spec.joint_types[i]) == REVOLUTE
                        for i in idx], np.float64)[None, :, None],
        one_dof=idx,
        stiffness=np.asarray(spec.stiffness, np.float64)[idx],
        damping=np.asarray(spec.damping, np.float64)[idx],
        rest_q=np.asarray(spec.rest_q, np.float64)[idx])


def _spec_const(spec: ChainSpec, like) -> dict:
    """The spec's metadata as tensors of ``like``'s dtype and device, made
    once for each (a CUDA graph capture refuses a copy from the host)."""
    return _spec_consts(spec)(like)


def _zeros(shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _one_dof_only(spec: ChainSpec) -> bool:
    return all(JointType(t) in (REVOLUTE, PRISMATIC, FIXED)
               for t in spec.joint_types)


def _fk_scan(spec: ChainSpec, q) -> FkResult:
    """FK of a 1-DoF/fixed chain in the JAX package's scan form: one
    masked body per joint (the joint type selects by a factor), looped over
    the spec."""
    c = _spec_const(spec, q)
    is_rev = [JointType(t) == REVOLUTE for t in spec.joint_types]
    is_pri = [JointType(t) == PRISMATIC for t in spec.joint_types]
    p = _zeros(3, q)
    Q = rot.qidentity(q.dtype, device=q.device)
    out = []
    for i, jt in enumerate(spec.joint_types):
        r, s = float(is_rev[i]), float(is_pri[i])
        qi = (q[spec.q_index(i)] if JointType(jt) != FIXED else q[0]) \
            * (r + s)
        ax = c["axes"][i]
        p = p + rot.qrot(Q, c["off_pos"][i])
        Q = rot.qmul(Q, c["off_quat"][i])
        pre_Q = Q
        a_g = rot.qrot(Q, ax)
        anchor = p
        half = 0.5 * qi * r  # identity quaternion when not revolute
        qj = torch.cat([torch.cos(half)[None], ax * torch.sin(half)])
        Q = rot.qmul(Q, qj)
        p = p + (qi * s) * a_g
        com_w = p + rot.qrot(Q, c["com"][i])
        out.append((p, Q, com_w, anchor, a_g * (r + s), pre_Q))
    bp, bq, cw, an, ag, pq = (torch.stack(v) for v in zip(*out))
    return FkResult(body_pos=bp, body_quat=bq, com_pos=cw, joint_anchor=an,
                    joint_axis=ag, pre_quat=pq)


def fk(spec: ChainSpec, q) -> FkResult:
    """Forward kinematics sweep base→tip (ref: kte_map_chain.hpp:71
    doMotion).  ``q``: (nq,) configuration.  Long 1-DoF chains (8 joints or
    more) take the scan form, as in the JAX package."""
    if _one_dof_only(spec) and spec.n_joints >= 8:
        return _fk_scan(spec, q)
    c = _spec_const(spec, q)
    p = _zeros(3, q)
    Q = rot.qidentity(q.dtype, device=q.device)
    body_pos, body_quat, com_pos = [], [], []
    anchors, axes_g, pre_quats = [], [], []

    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        # fixed offset (the rigid link before the joint, rigid_link.hpp:50)
        p = p + rot.qrot(Q, c["off_pos"][i])
        Q = rot.qmul(Q, c["off_quat"][i])
        pre_quats.append(Q)
        qidx = spec.q_index(i)

        if jt == REVOLUTE:
            anchors.append(p)
            axes_g.append(rot.qrot(Q, c["axes"][i]))
            Q = rot.qmul(Q, rot.q_from_axis_angle(c["axes"][i], q[qidx]))
        elif jt == PRISMATIC:
            a_g = rot.qrot(Q, c["axes"][i])
            axes_g.append(a_g)
            anchors.append(p)
            p = p + q[qidx] * a_g
        elif jt == FREE:
            # 6-DoF joint: q = [pos (3) in pre-frame coords, quat (4)]
            # (ref: free_joints.hpp:165)
            p = p + rot.qrot(Q, q[qidx:qidx + 3])
            quat = q[qidx + 3:qidx + 7]
            quat = quat / torch.linalg.vector_norm(quat)
            Q = rot.qmul(Q, quat)
            anchors.append(p)
            axes_g.append(_zeros(3, q))
        else:  # FIXED
            anchors.append(p)
            axes_g.append(_zeros(3, q))

        body_pos.append(p)
        body_quat.append(Q)
        com_pos.append(p + rot.qrot(Q, c["com"][i]))

    return FkResult(body_pos=torch.stack(body_pos),
                    body_quat=torch.stack(body_quat),
                    com_pos=torch.stack(com_pos),
                    joint_anchor=torch.stack(anchors),
                    joint_axis=torch.stack(axes_g),
                    pre_quat=torch.stack(pre_quats))


def jacobians(spec: ChainSpec, q, fk_res: FkResult | None = None):
    """Stacked geometric Jacobians — the twist-shaping matrix Tcm (ref:
    mass_matrix_calculator.cpp:100-287).  Returns ``(Jv, Jw)`` of shapes
    (nb, 3, nv): q̇ → COM linear velocity (world coords) and q̇ → angular
    velocity (BODY coords)."""
    if fk_res is None:
        fk_res = fk(spec, q)
    if _one_dof_only(spec):
        return _jacobians_1dof(spec, q, fk_res)
    nb = spec.n_joints
    cols_v, cols_w = [], []
    mask = _spec_const(spec, q)["mask"]  # body k moves with joint i iff k >= i

    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == REVOLUTE:
            a = fk_res.joint_axis[i]
            r = fk_res.com_pos - fk_res.joint_anchor[i]
            cols_v.append(rot.cross(a[None, :], r) * mask[i])
            cols_w.append(a.expand(nb, 3) * mask[i])
        elif jt == PRISMATIC:
            a = fk_res.joint_axis[i]
            cols_v.append(a.expand(nb, 3) * mask[i])
            cols_w.append(_zeros((nb, 3), q))
        elif jt == FREE:
            # linear dofs: velocity in pre-frame coords → world
            pre_R = rot.q_to_matrix(fk_res.pre_quat[i])  # columns = axes
            for j in range(3):
                cols_v.append(pre_R[:, j].expand(nb, 3) * mask[i])
                cols_w.append(_zeros((nb, 3), q))
            # angular dofs: ω in base-body coords, anchored at the joint end
            base_R = rot.q_to_matrix(fk_res.body_quat[i])
            r = fk_res.com_pos - fk_res.joint_anchor[i]
            for j in range(3):
                a = base_R[:, j]
                cols_v.append(rot.cross(a[None, :], r) * mask[i])
                cols_w.append(a.expand(nb, 3) * mask[i])
        # FIXED: no columns

    if not cols_v:
        return _zeros((nb, 3, 0), q), _zeros((nb, 3, 0), q)
    Jv = torch.stack(cols_v, dim=-1)
    Jw_world = torch.stack(cols_w, dim=-1)
    R_body = rot.q_to_matrix(fk_res.body_quat)  # (nb, 3, 3)
    return Jv, torch.einsum("bij,bik->bjk", R_body, Jw_world)


def _jacobians_1dof(spec: ChainSpec, q, fk_res: FkResult):
    """Twist columns of a 1-DoF/fixed chain as masked batched cross
    products (the same Tcm as the generic path)."""
    nb = spec.n_joints
    if not _one_dof_index(spec):
        return _zeros((nb, 3, 0), q), _zeros((nb, 3, 0), q)
    c = _spec_const(spec, q)
    reach, w_rev, sel = c["reach"], c["w_rev"], c["one_dof"]  # (nb, nv, 1)
    ax = fk_res.joint_axis[sel]  # (nv, 3)
    anch = fk_res.joint_anchor[sel]
    rel = fk_res.com_pos[:, None, :] - anch[None, :, :]  # (nb, nv, 3)
    axb = ax[None].expand(rel.shape)
    crossed = rot.cross(axb, rel)
    Jv_cols = (w_rev * crossed + (1.0 - w_rev) * axb) * reach
    Jw_cols = (w_rev * axb) * reach
    R_body = rot.q_to_matrix(fk_res.body_quat)
    Jw = torch.einsum("bij,bik->bjk", R_body, Jw_cols.transpose(1, 2))
    return Jv_cols.transpose(1, 2), Jw


def config_rate(spec: ChainSpec, q, v):
    """dq/dt from the generalized velocity (the quaternion rate for a free
    base, ref: manipulator_model.cpp:301-344)."""
    if not spec.has_free_base:
        return v
    qdot = rot.qdot_from_omega(q[3:7], v[3:6])
    return torch.cat([v[0:3], qdot, v[6:]])


def velocities(spec: ChainSpec, q, qd, fk_res=None):
    """Per-body COM linear velocity (world) and angular velocity (body)."""
    Jv, Jw = jacobians(spec, q, fk_res)
    return Jv @ qd, Jw @ qd


def _inertia_products(c, Jv, Jw):
    M = torch.einsum("b,bik,bil->kl", c["mass"], Jv, Jv)
    return M + torch.einsum("bik,bij,bjl->kl", Jw, c["inertia"], Jw)


def mass_matrix(spec: ChainSpec, q):
    """Joint-space mass matrix  M = Tᵀ Mcm T (ref:
    mass_matrix_calculator.cpp:80-98)."""
    Jv, Jw = jacobians(spec, q)
    return _inertia_products(_spec_const(spec, q), Jv, Jw)


def mass_matrix_and_derivative(spec: ChainSpec, q, qd):
    """(M, Ṁ) — Ṁ by forward-mode AD along the configuration rate."""
    dq = config_rate(spec, q, qd)
    return jvp(lambda qq: mass_matrix(spec, qq), (q,), (dq,))


def _passive_joint_force(spec: ChainSpec, q, qd):
    """Generalized force of the joint springs, dampers, backlash and dry
    friction (ref: spring.hpp:53, damper.hpp:51, joint_backlash.hpp:47,
    joint_friction.cpp:43-57).  Free-base dofs carry none."""
    nv = spec.nv
    idx = _one_dof_index(spec)
    smooth = all(spec.backlash[i] == 0.0 and spec.stiction_coef[i] == 0.0
                 and spec.slip_coef[i] == 0.0 for i in idx)
    if smooth and not spec.has_free_base and len(idx) == nv:
        # vectorized spring/damper path (no deadband, no friction)
        c = _spec_const(spec, q)
        return -c["stiffness"] * (q - c["rest_q"]) - c["damping"] * qd
    f = [None] * nv
    for i, jt in enumerate(spec.joint_types):
        if JointType(jt) not in (REVOLUTE, PRISMATIC):
            continue
        qi = q[spec.q_index(i)]
        vi = qd[spec.v_index(i)]
        e = qi - spec.rest_q[i]
        # transmission backlash: the spring engages only outside the deadband
        gap = spec.backlash[i] if len(spec.backlash) > i else 0.0
        if gap != 0.0:
            e = torch.sign(e) * torch.clamp(torch.abs(e) - 0.5 * gap, min=0.0)
        fi = -spec.stiffness[i] * e - spec.damping[i] * vi
        # dry microslip friction, piecewise (joint_friction.cpp:49-56)
        sc, sl = spec.stiction_coef[i], spec.slip_coef[i]
        if sc != 0.0 or sl != 0.0:
            v_st, v_sl = spec.stiction_vel[i], spec.slip_vel[i]
            speed = torch.abs(vi)
            sgn = torch.sign(vi)
            f_stick = vi * sc / v_st
            f_micro = sgn * (sc + (sl - sc) * (speed - v_st) / (v_sl - v_st))
            f_slip = sgn * sl
            fr = torch.where(speed <= v_st, f_stick,
                             torch.where(speed < v_sl, f_micro, f_slip))
            fi = fi - fr
        f[spec.v_index(i)] = fi
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    return torch.stack([zero if v is None else v for v in f])


def dynamics_terms(spec: ChainSpec, q, qd):
    """Fused (M, f_nl): one FK and one jvp give the mass matrix AND the
    accumulated bias force (ref: kte_map_chain.hpp:71-89 +
    mass_matrix_calculator.cpp:80-287)."""
    c = _spec_const(spec, q)

    def vel_map(qq):
        res = fk(spec, qq)
        Jv, Jw = jacobians(spec, qq, res)
        return Jv @ qd, Jw @ qd, Jv, Jw

    # one jvp: primals give velocities + Jacobians, tangents J̇q̇
    (v, w, Jv, Jw), (a_bias, alpha_bias, _, _) = jvp(
        vel_map, (q,), (config_rate(spec, q, qd),))
    M = _inertia_products(c, Jv, Jw)
    # d'Alembert: base acceleration = -gravity (test_am.cpp:106)
    a_total = a_bias - c["gravity"][None, :]
    # inertia elements subtract m·a and Iα + ω×Iω (inertia.cpp:111-121)
    f_lin = -c["mass"][:, None] * a_total  # (nb, 3) world coords
    Iw = torch.einsum("bij,bj->bi", c["inertia"], w)
    f_ang = -(torch.einsum("bij,bj->bi", c["inertia"], alpha_bias)
              + rot.cross(w, Iw))
    f = (torch.einsum("bik,bi->k", Jv, f_lin)
         + torch.einsum("bik,bi->k", Jw, f_ang))
    return M, f + _passive_joint_force(spec, q, qd)


def bias_force(spec: ChainSpec, q, qd):
    """Accumulated generalized force with q̈ = 0 — the reference's ``f_nl``
    (test_am.cpp:47-59): gravity, centrifugal/Coriolis bias and passive
    joint elements.  Forward dynamics is  M q̈ = τ + bias_force."""
    return dynamics_terms(spec, q, qd)[1]


def forward_dynamics(spec: ChainSpec, q, qd, tau=None):
    """q̈ = M⁻¹(τ + f_nl) via Cholesky (ref: manipulator_model.cpp:346-354)."""
    M, f = dynamics_terms(spec, q, qd)
    if tau is not None:
        f = f + tau
    return solve_pd(M, f)


def forward_dynamics_checked(spec: ChainSpec, q, qd, tau=None):
    """Forward dynamics and its status flags: ``(q̈, status)``, status an
    ``errors`` bitmask (SINGULAR_MATRIX when M is numerically singular —
    the reference THROWS there, manipulator_model.cpp:351-354 — NONFINITE
    when inputs or outputs blow up).  Raise on the host with
    ``errors.raise_on_error``."""
    from reak_tpu_torch import errors

    M, f = dynamics_terms(spec, q, qd)
    if tau is not None:
        f = f + tau
    # a factor that fails gives NaN, as the JAX package's does, not a raise
    qdd = torch.cholesky_solve(f[:, None], _cholesky(M))[:, 0]
    status = (errors.chol_singular_flag(M) | errors.finite_flag(q, qd, f)
              | errors.finite_flag(qdd))
    return qdd, status


def inverse_dynamics(spec: ChainSpec, q, qd, qdd):
    """Required generalized force: τ = M q̈ − f_nl (ref:
    kte_models/inverse_dynamics_model.hpp:54)."""
    M, f = dynamics_terms(spec, q, qd)
    return M @ qdd - f


def state_retraction(spec: ChainSpec):
    """Manifold chart of the packed state x = [q | q̇], tangent dim 2·nv:
    a plain vector chart for a fixed base; for a free base the unit
    quaternion at q[3:7] takes a body-frame 3-vector rotation error,
    [δp, δθ, δq_joints, δq̇] (ref: satellite_invar_models.hpp:296;
    ctrl/invariant.quat_state_retraction)."""
    from reak_tpu_torch.ctrl.invariant import (quat_state_retraction,
                                               vector_retraction)

    if spec.has_free_base:
        return quat_state_retraction(3, spec.nq + spec.nv, 2 * spec.nv)
    return vector_retraction(2 * spec.nv)


def linearize_fd(spec: ChainSpec, q, qd, tau=None):
    """Linearization of the forward dynamics in the 2·nv tangent chart of
    ``state_retraction``: (q̈, ∂q̈/∂e_q, ∂q̈/∂e_q̇, a closure solving with M).

    ∂(M⁻¹(f+τ)) = M⁻¹(∂f − ∂M·q̈), so AD runs through ``dynamics_terms``
    only (2·nv tangents, ``torch.func.jacfwd``), never through the Cholesky
    solve, and one factor of M serves every right-hand side."""
    nv = spec.nv
    if spec.has_free_base:
        ret = state_retraction(spec)
        x0 = torch.cat([q, qd])

        def terms(e):
            x = ret.retract(x0, e)
            return dynamics_terms(spec, x[:spec.nq], x[spec.nq:])

        M, f = dynamics_terms(spec, q, qd)
        dM, df = jacfwd(terms)(_zeros(2 * nv, q))
    else:
        def terms(x):
            return dynamics_terms(spec, x[:nv], x[nv:])

        x = torch.cat([q, qd])
        M, f = terms(x)
        dM, df = jacfwd(terms)(x)  # dM: (nv, nv, 2nv), df: (nv, 2nv)
    rhs = f if tau is None else f + tau
    L = _cholesky(M)

    def msolve(b):
        vec = b.ndim == 1
        b = b[:, None] if vec else b
        y = torch.linalg.solve_triangular(L, b, upper=False)
        x_ = torch.linalg.solve_triangular(L.T, y, upper=True)
        return x_[:, 0] if vec else x_

    qdd = msolve(rhs)
    # ∂q̈/∂x = M⁻¹ (df/∂x − (∂M/∂x) q̈)
    dqdd = msolve(df - torch.einsum("ijx,j->ix", dM, qdd))  # (nv, 2nv)
    return qdd, dqdd[:, :nv], dqdd[:, nv:], msolve


# ---------------------------------------------------------------------------
# State packing — the computeStateRate surface (manipulator_model.cpp:292)
# ---------------------------------------------------------------------------


def pack_state(spec: ChainSpec, q, qd):
    return torch.cat([q, qd])


def unpack_state(spec: ChainSpec, x):
    return x[:spec.nq], x[spec.nq:]


def state_rate(spec: ChainSpec, x, tau=None):
    """ẋ = [q̇ (quaternion rates for a free base) | q̈] (ref:
    manipulator_model.cpp:292-355 computeStateRate)."""
    q, qd = unpack_state(spec, x)
    qdd = forward_dynamics(spec, q, qd, tau)
    return torch.cat([config_rate(spec, q, qd), qdd])


def body_frames(spec: ChainSpec, q, qd=None) -> Frame3:
    """Stacked world-frame Frame3 of every body (pose + twist) (ref:
    kte_ext_mappings.hpp:119 frame_storage)."""
    res = fk(spec, q)
    z = _zeros((spec.n_joints, 3), q)
    if qd is None:
        return Frame3(res.body_pos, res.body_quat, z, z, z, z)
    Jv, Jw = jacobians(spec, q, res)
    return Frame3(res.body_pos, res.body_quat, Jv @ qd, Jw @ qd, z, z)
