"""Dense-lanes KTE rollout + LTV linearization (port of
``reak_tpu/kte/lanes.py``, fixed-base part).

The same math as the register form (kte/soa.py) in the batch-LAST ("lanes")
layout, with the small structural dims (body, dof, xyz) stacked into tensor
axes so every assembly step is one einsum.  ``jax.jvp`` becomes
``torch.func.jvp``; ``jax.linearize`` followed by ``vmap`` over the unit
tangents becomes ``torch.func.vmap`` over ``torch.func.jvp``; ``lax.scan``
becomes a Python loop.

``make_rollout_ltv_lanes``'s step is the plain version of the hand-written
rollout-step kernel (``ops/kte_step.py``); ``make_rollout_ltv_fullfused``
is the rollout over that kernel.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from reak_tpu_torch.ctrl.riccati_soa import _chol_solve_lanes, _mm, _mv
from reak_tpu_torch.kte.soa import _fk_soa
from reak_tpu_torch.kte.spec import ChainSpec, JointType, PRISMATIC, FIXED


# ---------------------------------------------------------------------------
# lanes-layout vector helpers: component axis at -2, batch axis last
# ---------------------------------------------------------------------------


def _cross_l(a, b):
    """Cross product over axis -2 (size 3); a, b (..., 3, B) broadcastable."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2
    )


def _qrot_inv_l(q, v):
    """Rotate v by q⁻¹: q (..., 4, B), v (..., 3, B) → (..., 3, B)."""
    w = q[..., 0:1, :]
    qv = -q[..., 1:4, :]  # conjugate
    t = 2.0 * _cross_l(qv, v)
    return v + w * t + _cross_l(qv, t)


def _bcast_stack(items, batch_shape, dtype, device):
    """Stack a list of tuples of (tensor | float) → (len, k, *batch)."""
    rows = []
    for it in items:
        comps = [
            torch.full(batch_shape, c, dtype=dtype, device=device)
            if isinstance(c, float) else torch.broadcast_to(c, batch_shape)
            for c in it
        ]
        rows.append(torch.stack(comps, dim=0))
    return torch.stack(rows, dim=0)


# ---------------------------------------------------------------------------
# mass matrix + bias force in dense lanes form
# ---------------------------------------------------------------------------


def make_terms_lanes(spec: ChainSpec):
    """terms(q, qd) → (M (nv, nv, B), f (nv, B)); q, qd (nv, B).

    M = JᵀMcmJ twist-shaped mass, f = applied-minus-bias generalized force
    (ref mass_matrix_calculator.cpp:80-287, inertia.cpp:111-121), assembled
    as einsums over stacked (body, dof, xyz) axes.  Fixed-base chains only:
    free-base chains raise ``NotImplementedError`` (slice 2)."""
    if spec.has_free_base:
        raise NotImplementedError(
            "free-base chains are not ported yet (slice 2)")
    nb = spec.n_joints
    nv = spec.nv

    # static structure, Python/numpy constants
    jidx = [i for i, t in enumerate(spec.joint_types) if JointType(t) != FIXED]
    assert len(jidx) == nv
    mask_np = np.array(
        [[1.0 if jidx[k] <= b else 0.0 for k in range(nv)] for b in range(nb)]
    )
    is_pri_np = np.array(
        [1.0 if JointType(spec.joint_types[i]) == PRISMATIC else 0.0 for i in jidx]
    )
    masses_np = np.asarray(spec.masses)
    I_np = np.asarray(spec.inertias).reshape(nb, 3, 3)
    grav_np = np.asarray(spec.gravity)
    stiff_np = np.array([spec.stiffness[i] for i in jidx])
    rest_np = np.array([spec.rest_q[i] for i in jidx])
    damp_np = np.array([spec.damping[i] for i in jidx])

    def const(a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def jac_map(q):
        """q (nv, B) → Jv (nb, nv, 3, B) world, Jw (nb, nv, 3, B) body."""
        batch = q.shape[1:]
        fkr = _fk_soa(spec, tuple(q[i] for i in range(nv)))
        stack = lambda items: _bcast_stack(items, batch, q.dtype, q.device)
        coms = stack(fkr.com)  # (nb, 3, B)
        quats = stack(fkr.quat)  # (nb, 4, B)
        anchors = stack([fkr.anchors[i] for i in jidx])
        axes_g = stack([fkr.axes_g[i] for i in jidx])

        mask = const(mask_np, q)[:, :, None, None]
        is_pri = const(is_pri_np, q)[None, :, None, None]

        r = coms[:, None] - anchors[None]  # (nb, nv, 3, B)
        Jv_rev = _cross_l(axes_g[None], r)
        Jv = (is_pri * axes_g[None] + (1.0 - is_pri) * Jv_rev) * mask
        ax_rev = axes_g * (1.0 - const(is_pri_np, q)[:, None, None])
        Jw = _qrot_inv_l(quats[:, None], ax_rev[None]) * mask
        return Jv, Jw

    def vel_map(q, qd):
        Jv, Jw = jac_map(q)
        v = torch.einsum("bkcz,kz->bcz", Jv, qd)
        w = torch.einsum("bkcz,kz->bcz", Jw, qd)
        return v, w, Jv, Jw

    def terms(q, qd):
        masses = const(masses_np, q)
        I_all = const(I_np, q)
        # one jvp gives the J̇q̇ bias accelerations (kte/dynamics.py trick)
        (v, w, Jv, Jw), (a_b, al_b, _, _) = jvp(
            lambda qq: vel_map(qq, qd), (q,), (qd,)
        )
        M = torch.einsum("b,bkcz,blcz->klz", masses, Jv, Jv) + torch.einsum(
            "bkrz,brc,blcz->klz", Jw, I_all, Jw
        )
        a_tot = a_b - const(grav_np, q)[None, :, None]
        f_lin = -masses[:, None, None] * a_tot
        Iw = torch.einsum("brc,bcz->brz", I_all, w)
        Ial = torch.einsum("brc,bcz->brz", I_all, al_b)
        f_ang = -(Ial + _cross_l(w, Iw))
        f = torch.einsum("bkcz,bcz->kz", Jv, f_lin) + torch.einsum(
            "bkcz,bcz->kz", Jw, f_ang
        )
        # passive joint springs/dampers (smooth part, hot path)
        f = (
            f
            - const(stiff_np, q)[:, None] * (q - const(rest_np, q)[:, None])
            - const(damp_np, q)[:, None] * qd
        )
        return M, f

    return terms


# ---------------------------------------------------------------------------
# fused rollout + LTV linearization
# ---------------------------------------------------------------------------


def make_step_ltv_lanes(spec: ChainSpec, dt: float, order: int = 4):
    """One rollout step with its LTV linearization, lanes layout:
    ``step(x (n, B), u (nv, B)) → (Ad (n, n, B), Bd (n, nv, B), cd (n, B),
    x_new (n, B))`` — the step of ``make_rollout_ltv_lanes`` and the plain
    version of the kernel in ``ops/kte_step.py``."""
    nv = spec.nv
    n = 2 * nv
    terms = make_terms_lanes(spec)

    def step(x, u):
        dtype, device = x.dtype, x.device
        batch = x.shape[1:]

        def terms_flat(xx):
            return terms(xx[:nv], xx[nv:])

        M, f = terms_flat(x)
        qd = x[nv:]
        qdd = _chol_solve_lanes(M, (f + u)[:, None, :])[:, 0]  # (nv, B)

        # all n unit-tangent pulls in one vmapped pass
        eye_n = torch.eye(n, dtype=dtype, device=device)
        basis = eye_n[:, :, None].expand((n, n) + batch)
        dM, df = vmap(lambda t: jvp(terms_flat, (x,), (t,))[1])(basis)
        # dM (n, nv, nv, B), df (n, nv, B)
        rhs = df - torch.einsum("dklz,lz->dkz", dM, qdd)  # (n, nv, B)
        rhs_t = rhs.permute(1, 0, 2)  # (nv, n, B)
        eye_nv = torch.eye(nv, dtype=dtype, device=device)[:, :, None] \
            .expand((nv, nv) + batch)
        sol = _chol_solve_lanes(M, torch.cat([rhs_t, eye_nv], dim=1))
        dqdd = sol[:, :n]  # (nv, n, B): ∂q̈_k/∂x_d
        Minv = sol[:, n:]  # (nv, nv, B)

        # continuous A = [[0, I], [∂q̈/∂q, ∂q̈/∂q̇]], B = [[0], [M⁻¹]]
        top = torch.cat([torch.zeros(nv, nv, dtype=dtype, device=device),
                         torch.eye(nv, dtype=dtype, device=device)], dim=1)
        A_c = torch.cat([top[:, :, None].expand((nv, n) + batch), dqdd], dim=0)
        B_c = torch.cat([torch.zeros((nv, nv) + batch, dtype=dtype,
                                     device=device), Minv], dim=0)
        f0 = torch.cat([qd, qdd], dim=0)  # (n, B)

        # S = Σ_{k=1..order} dt^k A^{k-1}/k!;  Ad = I + A S;  Bd = S B
        eye3 = eye_n[:, :, None]
        S = eye3 * dt
        term = eye3 * dt
        for k in range(2, order + 1):
            term = (dt / k) * _mm(A_c, term)
            S = S + term
        Ad = eye3 + _mm(A_c, S)
        Bd = _mm(S, B_c)
        x_new = x + _mv(S, f0)
        cd = x_new - _mv(Ad, x) - _mv(Bd, u)
        return Ad, Bd, cd, x_new

    return step


def _scan_rollout(step, x0, us):
    """x0 (B, n), us (B, H, m) → (A (H,n,n,B), B (H,n,m,B), c (H,n,B),
    xs (H,n,B)): the lax.scan of the JAX package as a Python loop."""
    x = x0.T.contiguous()  # (n, B)
    us_t = us.permute(1, 2, 0).contiguous()  # (H, m, B)
    outs = []
    for t in range(us_t.shape[0]):
        Ad, Bd, cd, x = step(x, us_t[t])
        outs.append((Ad, Bd, cd, x))
    return tuple(torch.stack(seq, dim=0) for seq in zip(*outs))


def make_rollout_ltv_lanes(spec: ChainSpec, dt: float, horizon: int,
                           order: int = 4):
    """Fused nominal rollout + LTV linearization, lanes-native I/O.

    Returns ``fn(x0 (B, 2nv), us (B, H, m)) → (A_seq (H, n, n, B),
    B_seq (H, n, m, B), c_seq (H, n, B), xs (H, n, B))`` with n = 2nv — the
    layout ctrl/riccati_soa consumes.  Per step: the (M, f) assembly, its n
    unit-tangent jvps, ∂q̈ = M⁻¹(∂f − ∂M q̈), and the exponential-series
    discretization of the frozen linearization (exact RK4-on-LTI)."""
    step = make_step_ltv_lanes(spec, dt, order)
    return lambda x0, us: _scan_rollout(step, x0, us)


def make_rollout_ltv_fullfused(spec: ChainSpec, dt: float, horizon: int,
                               order: int = 4):
    """Rollout with the ENTIRE step (core + series discretization) in one
    kernel launch (ops/kte_step.make_step_lanes); same contract as
    make_rollout_ltv_lanes.  On CPU tensors the wrapper takes the plain
    step."""
    from reak_tpu_torch.ops import kte_step

    step = kte_step.make_step_lanes(spec, dt, order=order)
    return lambda x0, us: _scan_rollout(step, x0, us)
