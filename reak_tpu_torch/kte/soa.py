"""Register-form KTE dynamics (port of ``reak_tpu/kte/soa.py``).

Vectors are 3-tuples and quaternions 4-tuples whose entries are tensors of
the batch shape (scenario batch last) or Python floats; chain constants stay
Python floats, so a literal zero or one costs nothing.  The lanes terms
(``kte/lanes.make_terms_lanes``) call the quaternion helpers and
``_fk_soa``; the rest is the register-form rollout that
``ctrl/mpc.make_kte_mpc`` takes with ``rollout="register"`` (or with
``qp_layout="vmap"`` and any rollout but "lanes"): ``make_terms_soa``,
``forward_dynamics_soa`` and ``make_rollout_ltv_soa``.

``jax.jvp`` becomes ``torch.func.jvp``, and ``jax.linearize`` followed by
``vmap`` over the 2nv unit tangents becomes ``torch.func.vmap`` over
``torch.func.jvp``, as in ``kte/lanes.py``.  ``torch.func`` takes tensors
only where JAX also takes Python floats, so two things differ in form, not
in value: the Jacobians leave the inner jvp as an auxiliary list of their
tensor entries (their constant entries are put back after it), and the
terms give every entry of M and f as a tensor of the batch shape (the JAX
package does so for a free base only).  The unit tangents and the identity
right-hand sides are made once per (dtype, device) (``kte/lanes._Consts``).
Plain torch throughout, on whatever device the inputs are; on CUDA tensors
each step of ``make_rollout_ltv_soa`` is replayed from a CUDA graph
(``ops/graphs.graphed``): eagerly a step of the flagship arm launches its
thousands of small ops from Python, one at a time (``chip_smoke.py`` phase
``batch_first`` times one eager step beside the replayed rollout).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from reak_tpu_torch.ops import graphs

from reak_tpu_torch.kte.spec import (ChainSpec, JointType, REVOLUTE,
                                     PRISMATIC, FIXED, FREE)


# Products and sums where one side may be a Python float.  A float goes in
# as the scalar argument of ``aten.mul/add/sub/rsub.Scalar``: under
# ``torch.func.jvp`` those have tangent formulas of their own, while a
# float taken as a wrapped number, like a tensor without a tangent, gets a
# zero tangent that runs through ``torch._refs`` in Python (about ten times
# the time of the op on the CPU).  The values are the same: the Scalar ops
# wrap the float and call the Tensor ops.
_MUL_S = torch.ops.aten.mul.Scalar
_ADD_S = torch.ops.aten.add.Scalar
_SUB_S = torch.ops.aten.sub.Scalar
_RSUB_S = torch.ops.aten.rsub.Scalar


def _mul(a, b):
    if isinstance(a, float):
        return a * b if isinstance(b, float) else _MUL_S(b, a)
    return _MUL_S(a, b) if isinstance(b, float) else a * b


def _plus(a, b):
    if isinstance(a, float):
        return a + b if isinstance(b, float) else _ADD_S(b, a)
    return _ADD_S(a, b) if isinstance(b, float) else a + b


def _minus(a, b):
    if isinstance(a, float):
        return a - b if isinstance(b, float) else _RSUB_S(b, a)
    return _SUB_S(a, b) if isinstance(b, float) else a - b


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    m = _mul
    return (
        _minus(_minus(_minus(m(w1, w2), m(x1, x2)), m(y1, y2)), m(z1, z2)),
        _minus(_plus(_plus(m(w1, x2), m(x1, w2)), m(y1, z2)), m(z1, y2)),
        _plus(_plus(_minus(m(w1, y2), m(x1, z2)), m(y1, w2)), m(z1, x2)),
        _plus(_minus(_plus(m(w1, z2), m(x1, y2)), m(y1, x2)), m(z1, w2)),
    )


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    m = _mul
    return (_minus(m(ay, bz), m(az, by)), _minus(m(az, bx), m(ax, bz)),
            _minus(m(ax, by), m(ay, bx)))


def _qrot(q, v):
    """Rotate v by q: v + 2 w (qv×v) + 2 qv×(qv×v)."""
    w = q[0]
    qv = (q[1], q[2], q[3])
    t = _cross(qv, v)
    t = (_mul(2.0, t[0]), _mul(2.0, t[1]), _mul(2.0, t[2]))
    u = _cross(qv, t)
    return tuple(_plus(_plus(v[k], _mul(w, t[k])), u[k]) for k in range(3))


def _qrot_inv(q, v):
    return _qrot((q[0], -q[1], -q[2], -q[3]), v)


def _add(a, b):
    return tuple(_plus(x, y) for x, y in zip(a, b))


def _scale(s, a):
    return tuple(_mul(s, x) for x in a)


def _dot(a, b):
    return _plus(_plus(_mul(a[0], b[0]), _mul(a[1], b[1])), _mul(a[2], b[2]))


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
            half = _mul(0.5, qi)
            c, s = torch.cos(half), torch.sin(half)
            qj = (c, _mul(ax[0], s), _mul(ax[1], s), _mul(ax[2], s))
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


def _jacobians_soa(spec: ChainSpec, fkr: _SoaFk):
    """Per body b, per dof k: (Jv[b][k] vec3 world, Jw[b][k] vec3 BODY).

    FREE joints contribute 6 columns: 3 linear dofs along the pre-frame
    axes (world coordinates), 3 angular ones along the base BODY frame axes
    anchored at the joint origin."""
    nb = spec.n_joints
    Jv = [[None] * spec.nv for _ in range(nb)]
    Jw = [[None] * spec.nv for _ in range(nb)]
    zero3 = (0.0, 0.0, 0.0)
    basis = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    col = 0
    for i, jt in enumerate(fkr.types):
        if jt == FIXED:
            continue
        if jt == FREE:
            lin_axes = [_qrot(fkr.pre_quat[i], e) for e in basis]
            ang_axes = [_qrot(fkr.quat[i], e) for e in basis]
            for b in range(nb):
                for j in range(3):
                    if b < i:
                        Jv[b][col + j] = zero3
                        Jw[b][col + j] = zero3
                        Jv[b][col + 3 + j] = zero3
                        Jw[b][col + 3 + j] = zero3
                        continue
                    Jv[b][col + j] = lin_axes[j]
                    Jw[b][col + j] = zero3
                    r = tuple(_minus(fkr.com[b][k], fkr.anchors[i][k])
                              for k in range(3))
                    Jv[b][col + 3 + j] = _cross(ang_axes[j], r)
                    Jw[b][col + 3 + j] = _qrot_inv(fkr.quat[b], ang_axes[j])
            col += 6
            continue
        for b in range(nb):
            if b < i:
                Jv[b][col] = zero3
                Jw[b][col] = zero3
                continue
            if jt == REVOLUTE:
                r = tuple(_minus(fkr.com[b][k], fkr.anchors[i][k])
                          for k in range(3))
                Jv[b][col] = _cross(fkr.axes_g[i], r)
                Jw[b][col] = _qrot_inv(fkr.quat[b], fkr.axes_g[i])
            else:  # prismatic
                Jv[b][col] = fkr.axes_g[i]
                Jw[b][col] = (0.0, 0.0, 0.0)
        col += 1
    return Jv, Jw


def _config_rate_soa(spec: ChainSpec, q, qd):
    """Register-form config rate: the tangent of the configuration tuple
    along the generalized velocity (½ q⊗(0, ω_body) for a FREE joint's
    quaternion, raw, not normalized)."""
    out = []
    ci = vi = 0
    for jt in spec.joint_types:
        jt = JointType(jt)
        if jt in (REVOLUTE, PRISMATIC):
            out.append(qd[vi])
            ci += 1
            vi += 1
        elif jt == FREE:
            out.extend(qd[vi:vi + 3])
            quat = (q[ci + 3], q[ci + 4], q[ci + 5], q[ci + 6])
            w = (qd[vi + 3], qd[vi + 4], qd[vi + 5])
            qdot = _qmul(quat, (torch.zeros_like(w[0]),) + w)
            out.extend(0.5 * x for x in qdot)
            ci += 7
            vi += 6
    return tuple(out)


def _pack(nested):
    """A nested list of (tensor | float) → (its tensor entries, a function
    that puts the floats back): ``torch.func`` hands tensors only through
    a transform."""
    flat, floats = [], []
    for row in nested:
        for vec in row:
            for x in vec:
                if torch.is_tensor(x):
                    flat.append(x)
                    floats.append(None)
                else:
                    floats.append(float(x))

    def unpack(tensors):
        it = iter(tensors)
        vals = [next(it) if f is None else f for f in floats]
        out, k = [], 0
        for row in nested:
            out.append([])
            for vec in row:
                out[-1].append(tuple(vals[k:k + len(vec)]))
                k += len(vec)
        return out

    return flat, unpack


def make_terms_soa(spec: ChainSpec):
    """terms(q, qd) → (M nested nv × nv tuple, f nv-tuple) in register form.

    q: tuple of nq tensors, qd: tuple of nv tensors (any broadcastable
    shape, batch last by convention).  Free-base (quaternion) chains are
    taken: the configuration carries [p(3), quat(4)] for each FREE joint and
    the jvp tangent is the register-form config rate.  Every entry comes
    back as a tensor of q[0]'s shape (see module)."""
    nv = spec.nv
    nb = spec.n_joints
    masses = [float(m) for m in spec.masses]
    inertias = [np.asarray(I).reshape(3, 3) for I in spec.inertias]
    gravity = _const_vec(spec.gravity)

    def vel_map(q, qd):
        fkr = _fk_soa(spec, q)
        Jv, Jw = _jacobians_soa(spec, fkr)
        v = []
        w = []
        for b in range(nb):
            vb = (0.0, 0.0, 0.0)
            wb = (0.0, 0.0, 0.0)
            for k in range(nv):
                vb = _add(vb, _scale(qd[k], Jv[b][k]))
                wb = _add(wb, _scale(qd[k], Jw[b][k]))
            v.append(vb)
            w.append(wb)
        return tuple(v), tuple(w), Jv, Jw

    def terms(q, qd):
        # one jvp gives the J̇q̇ bias accelerations; the tangent is the
        # config rate (q̇ for a fixed-base chain)
        dq = _config_rate_soa(spec, q, qd) if spec.has_free_base else qd
        unpack = []

        def inner(*qq):
            v, w, Jv, Jw = vel_map(qq, qd)
            flat, up = _pack(Jv + Jw)
            unpack.append(up)
            return (v, w), flat

        (v, w), (a_bias, al_bias), flat = jvp(inner, tuple(q), tuple(dq),
                                              has_aux=True)
        J = unpack[0](flat)
        Jv, Jw = J[:nb], J[nb:]
        # mass matrix
        M = [[0.0] * nv for _ in range(nv)]
        for b in range(nb):
            m_b = masses[b]
            I_b = inertias[b]
            for k in range(nv):
                for l in range(k, nv):
                    term = 0.0
                    if m_b != 0.0:
                        term = term + m_b * _dot(Jv[b][k], Jv[b][l])
                    # Jwᵀ I Jw (I static; its zeros skipped)
                    for r in range(3):
                        for c in range(3):
                            Irc = float(I_b[r, c])
                            if Irc != 0.0:
                                term = term + Irc * Jw[b][k][r] * Jw[b][l][c]
                    M[k][l] = M[k][l] + term
        for k in range(nv):
            for l in range(k):
                M[k][l] = M[l][k]

        # bias force f (q̈ = 0 accumulated force)
        f = [0.0] * nv
        for b in range(nb):
            m_b = masses[b]
            I_b = inertias[b]
            a_tot = tuple(a_bias[b][k] - gravity[k] for k in range(3))
            f_lin = _scale(-m_b, a_tot) if m_b != 0.0 else (0.0, 0.0, 0.0)
            # I α + ω × Iω
            Iw = tuple(
                sum(float(I_b[r, c]) * w[b][c] for c in range(3)
                    if I_b[r, c] != 0.0)
                for r in range(3)
            )
            Ial = tuple(
                sum(float(I_b[r, c]) * al_bias[b][c] for c in range(3)
                    if I_b[r, c] != 0.0)
                for r in range(3)
            )
            wxIw = _cross(w[b], Iw)
            f_ang = tuple(-(Ial[k] + wxIw[k]) for k in range(3))
            for k in range(nv):
                f[k] = f[k] + _dot(Jv[b][k], f_lin) + _dot(Jw[b][k], f_ang)

        # passive joint elements (springs/dampers; FREE dofs carry none)
        ci = col = 0
        for i, jt in enumerate(spec.joint_types):
            jt = JointType(jt)
            if jt == FIXED:
                continue
            if jt == FREE:
                ci += 7
                col += 6
                continue
            kstf = float(spec.stiffness[i])
            dmp = float(spec.damping[i])
            if kstf != 0.0:
                f[col] = f[col] - kstf * (q[ci] - float(spec.rest_q[i]))
            if dmp != 0.0:
                f[col] = f[col] - dmp * qd[col]
            ci += 1
            col += 1
        # every entry a tensor of the batch shape (a constant one, such as
        # a free base's lin-lin mass block, folds to a Python float)
        batch, like = q[0].shape, q[0]
        bc = lambda x: (torch.broadcast_to(x, batch) if torch.is_tensor(x)
                        else torch.full(batch, x, dtype=like.dtype,
                                        device=like.device))
        M = tuple(tuple(bc(M[k][l]) for l in range(nv)) for k in range(nv))
        return M, tuple(bc(x) for x in f)

    return terms


def _chol_solve_reg(M, rhs_list):
    """Unrolled Cholesky solve in register form.  M: nv × nv nested tuple;
    rhs_list: list of nv-tuples (several right-hand sides, each entry
    broadcasting against M's).  Returns the list of solution tuples."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    outs = []
    for rhs in rhs_list:
        y = [None] * n
        for i in range(n):
            s = rhs[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        outs.append(tuple(x))
    return outs


def forward_dynamics_soa(spec: ChainSpec, terms, q, qd, tau=None):
    """q̈ in register form; q, qd, tau tuples of nv tensors."""
    M, f = terms(q, qd)
    if tau is not None:
        f = tuple(fi + ti for fi, ti in zip(f, tau))
    (qdd,) = _chol_solve_reg(M, [f])
    return qdd


class _UnitConsts:
    """The step's host constants as tensors, made once per (dtype, device)
    (a host copy is refused inside a CUDA graph capture; see
    ``kte/lanes._Consts``): the n unit tangents, each a tuple of n (n, 1)
    columns, the nv identity right-hand sides (nv, 1) and the identity
    (n, n)."""

    def __init__(self, n: int, nv: int):
        self.n, self.nv = n, nv
        self._made = {}

    def __call__(self, like):
        key = (like.dtype, like.device)
        if key not in self._made:
            eye = torch.eye(self.n, dtype=like.dtype, device=like.device)
            eye_nv = torch.eye(self.nv, dtype=like.dtype, device=like.device)
            self._made[key] = (
                tuple(eye[:, i:i + 1] for i in range(self.n)),
                tuple(eye_nv[i][:, None] for i in range(self.nv)),
                eye)
        return self._made[key]


def make_rollout_ltv_soa(spec: ChainSpec, dt: float, horizon: int,
                         order: int = 4):
    """Fused nominal rollout + LTV linearization in register form.

    Returns ``fn(x0 (B, 2nv), us (B, H, m)) → (A_seq (B,H,n,n), B_seq,
    c_seq, xs (B,H,n))`` with n = 2nv, batch first.  Per step: the terms
    and their n unit-tangent jvps (vmapped); ∂q̈ = M⁻¹(∂f − ∂M q̈) with the
    direction axis broadcast through one register-form solve; the
    exponential-series map of the frozen linearization.  Fixed-base chains
    (a free base takes ``kte/lanes.make_kte_manifold_lanes``).  On CUDA
    tensors each step is replayed from a CUDA graph (``fn.step``, one
    capture per shape and type at its first call; ``fn.step.eager`` runs
    one step eagerly)."""
    if spec.has_free_base:
        raise ValueError("make_rollout_ltv_soa takes fixed-base chains; a "
                         "free base takes kte/lanes.make_kte_manifold_lanes")
    nv = spec.nv
    n = 2 * nv
    terms = make_terms_soa(spec)
    consts = _UnitConsts(n, nv)

    def terms_flat(*xt):
        return terms(xt[:nv], xt[nv:])

    def step(x_tup, u_cols):
        # x_tup: tuple of n tensors (B,); u_cols: tuple of nv tensors (B,)
        x0_ = x_tup[0]
        units, eye_rhs, eye = consts(x0_)
        M, f = terms_flat(*x_tup)
        f_tau = tuple(fi + ui for fi, ui in zip(f, u_cols))
        # the n unit-tangent pulls in one vmapped pass: tangent entry i is
        # (n, B), ones where the direction is i
        batch = x0_.shape
        tangents = tuple(units[i].expand((n,) + batch) for i in range(n))
        Mt, ft = vmap(lambda tt: jvp(terms_flat, x_tup, tt)[1])(tangents)
        # Mt[i][j]: (n, B), the derivative of M_ij along each direction

        (qdd,) = _chol_solve_reg(M, [f_tau])
        dd_rhs = tuple(
            ft[i] - sum(Mt[i][j] * qdd[j] for j in range(nv))
            for i in range(nv))  # entries (n, B)
        dd_sol, minv_sol = _chol_solve_reg(M, [dd_rhs, eye_rhs])
        # dd_sol[i]: (n, B) = ∂q̈_i/∂x_d over directions d; minv_sol[i]:
        # (nv, B) = row i of M⁻¹
        dqdd = [tuple(dd_sol[i][d] for i in range(nv)) for d in range(n)]
        minv_cols = [tuple(minv_sol[i][j] for i in range(nv))
                     for j in range(nv)]

        # continuous A = [[0, I], [∂q̈/∂q, ∂q̈/∂q̇]], B = [[0], [M⁻¹]]
        zero = torch.zeros_like(x0_)
        one = torch.ones_like(x0_)

        def Ac(i, j):
            if i < nv:
                return one if j == i + nv else zero
            return dqdd[j][i - nv]

        A_c = torch.stack([torch.stack([Ac(i, j) for j in range(n)], dim=0)
                           for i in range(n)], dim=0)  # (n, n, B)
        A_cb = A_c.permute(2, 0, 1)  # (B, n, n)
        B_c = torch.stack([torch.stack(
            [zero if i < nv else minv_cols[j][i - nv] for j in range(nv)],
            dim=0) for i in range(n)], dim=0).permute(2, 0, 1)  # (B, n, nv)
        f0 = torch.stack(list(x_tup[nv:]) + list(qdd), dim=0).T  # (B, n)
        xb = torch.stack(x_tup, dim=0).T  # (B, n)
        ub = torch.stack(u_cols, dim=0).T  # (B, nv)

        S = eye * dt
        term = eye * dt
        for k in range(2, order + 1):
            term = (dt / k) * (A_cb @ term)
            S = S + term
        Ad = eye + A_cb @ S
        Bd = S @ B_c
        x_new = xb + torch.einsum("bij,bj->bi", S, f0)
        cd = (x_new - torch.einsum("bij,bj->bi", Ad, xb)
              - torch.einsum("bij,bj->bi", Bd, ub))
        return Ad, Bd, cd, x_new

    def step_rows(x, u):
        """The step on x (n, B) and u (nv, B), its state and inputs as rows
        (the tensors a CUDA graph takes)."""
        return step(tuple(x[i] for i in range(n)),
                    tuple(u[i] for i in range(nv)))

    step_graphed = graphs.graphed(step_rows)

    def roll(step_fn, x0, us):
        # x0: (B, n); us: (B, H, m)
        x = x0.T.contiguous()
        outs = []
        for t in range(us.shape[1]):
            Ad, Bd, cd, x_new = step_fn(x, us[:, t].T.contiguous())
            x = x_new.T.contiguous()
            outs.append((Ad, Bd, cd, x_new))
        # (H, B, ...) → (B, H, ...)
        return tuple(torch.stack(seq, dim=1) for seq in zip(*outs))

    def rollout(x0, us):
        return roll(step_graphed, x0, us)

    rollout.step = step_graphed
    return rollout
