"""Dense-lanes KTE rollout + LTV linearization (port of
``reak_tpu/kte/lanes.py``).

The same math as the register form (kte/soa.py) in the batch-LAST ("lanes")
layout, with the small structural dims (body, dof, xyz) stacked into tensor
axes so every assembly step is one einsum.  ``jax.jvp`` becomes
``torch.func.jvp``; ``jax.linearize`` followed by ``vmap`` over the unit
tangents becomes ``torch.func.vmap`` over ``torch.func.jvp``; ``lax.scan``
becomes a Python loop.

``make_rollout_ltv_lanes``'s step is the plain version of the hand-written
rollout-step kernel (``ops/kte_step.py``); ``make_rollout_ltv_fullfused``
is the rollout over that kernel.  The step's core (``make_core_ltv_lanes``)
is the plain version of the core kernel (``ops/kte_core.py``), and
``make_rollout_ltv_fused`` is the rollout over that kernel with the
exponential series in torch.  The RK4 rollout that prices the SQP line
search (``make_rollout_lanes``) and the free-base step and linearization
(``make_kte_manifold_lanes``) solve with M through the batched Cholesky
kernels (``ops/chol_lanes.py``): one right-hand side through ``solve_lanes``,
several through ``solve_lanes_multi``.  Their solves stand outside every
``torch.func`` transform, since a kernel launch needs real tensors.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from reak_tpu_torch.ctrl.riccati_soa import _chol_solve_lanes, _mm, _mv
from reak_tpu_torch.kte.soa import _MUL_S, _fk_soa
from reak_tpu_torch.kte.spec import (ChainSpec, JointType, REVOLUTE,
                                     PRISMATIC, FIXED, FREE)
from reak_tpu_torch.math import rot_lanes as rl
from reak_tpu_torch.ops import chol_lanes, graphs


class _Consts:
    """A chain's host constants (numpy arrays) as tensors, made once per
    (dtype, device) at their first use: a tensor made from host memory
    cannot be captured into a CUDA graph (ops/graphs.py), and each one is a
    copy from the host.  Floating arrays take the type of ``like``, integer
    ones keep theirs."""

    def __init__(self, **arrays):
        self._arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._made = {}

    def __call__(self, like) -> dict:
        key = (like.dtype, like.device)
        made = self._made.get(key)
        if made is None:
            made = self._made[key] = {
                k: torch.as_tensor(
                    a, dtype=like.dtype if a.dtype.kind == "f" else None,
                    device=like.device)
                for k, a in self._arrays.items()}
        return made


def _inertial(spec: ChainSpec, **arrays) -> _Consts:
    """The constants of ``_terms_from_jacobians`` and ``arrays``."""
    return _Consts(masses=np.asarray(spec.masses, np.float64),
                   inertias=np.asarray(spec.inertias, np.float64).reshape(
                       spec.n_joints, 3, 3),
                   gravity=np.asarray(spec.gravity, np.float64), **arrays)


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


def _times01(w, x):
    """x · w for a constant weight of zeros and ones given as the bool
    tensor ``w``: x where w, else x · 0.0 (the same values).  Under
    ``torch.func.jvp`` a product with a constant tensor gives that tensor a
    zero tangent, which runs through ``torch._refs`` in Python; this form
    takes a tangent rule of its own (``kte/soa._mul``)."""
    return torch.where(w, x, _MUL_S(x, 0.0))


# ---------------------------------------------------------------------------
# mass matrix + bias force in dense lanes form
# ---------------------------------------------------------------------------


def _terms_from_jacobians(consts: dict, jac_map, q, qd, q_rate):
    """(M, f) without the passive joint elements, from the per-body
    Jacobians ``jac_map(q) → (Jv (nb, nv, 3, B) world, Jw (nb, nv, 3, B)
    body)``: M = Σ m Jvᵀ Jv + Jwᵀ I Jw, f = Jᵀ of the gravity, bias and
    gyroscopic forces.  One jvp along ``q_rate`` (the configuration rate of
    q̇) gives the J̇q̇ bias accelerations (kte/dynamics.py trick).
    ``consts``: masses, inertias and gravity as tensors (``_inertial``)."""
    masses, I_all = consts["masses"], consts["inertias"]

    def vel_map(qq):
        Jv, Jw = jac_map(qq)
        v = torch.einsum("bkcz,kz->bcz", Jv, qd)
        w = torch.einsum("bkcz,kz->bcz", Jw, qd)
        return v, w, Jv, Jw

    (v, w, Jv, Jw), (a_b, al_b, _, _) = jvp(vel_map, (q,), (q_rate,))
    M = torch.einsum("b,bkcz,blcz->klz", masses, Jv, Jv) + torch.einsum(
        "bkrz,brc,blcz->klz", Jw, I_all, Jw
    )
    a_tot = a_b - consts["gravity"][None, :, None]
    f_lin = -masses[:, None, None] * a_tot
    Iw = torch.einsum("brc,bcz->brz", I_all, w)
    Ial = torch.einsum("brc,bcz->brz", I_all, al_b)
    f_ang = -(Ial + rl.cross_l(w, Iw))
    f = torch.einsum("bkcz,bcz->kz", Jv, f_lin) + torch.einsum(
        "bkcz,bcz->kz", Jw, f_ang
    )
    return M, f


def make_terms_lanes(spec: ChainSpec):
    """terms(q, qd) → (M (nv, nv, B), f (nv, B)); q, qd (nv, B).

    M = JᵀMcmJ twist-shaped mass, f = applied-minus-bias generalized force
    (ref mass_matrix_calculator.cpp:80-287, inertia.cpp:111-121), assembled
    as einsums over stacked (body, dof, xyz) axes.  Free-base (quaternion)
    chains route through the generic per-joint block assembly; q is then
    (nq, B) with the [p(3), quat(4)] packing of the FREE joint."""
    if spec.has_free_base:
        return _make_terms_lanes_generic(spec)
    nb = spec.n_joints
    nv = spec.nv

    # static structure, Python/numpy constants
    jidx = [i for i, t in enumerate(spec.joint_types) if JointType(t) != FIXED]
    assert len(jidx) == nv
    mask_np = np.array(
        [[jidx[k] <= b for k in range(nv)] for b in range(nb)]
    )
    is_pri_np = np.array(
        [JointType(spec.joint_types[i]) == PRISMATIC for i in jidx]
    )
    stiff_np = np.array([spec.stiffness[i] for i in jidx])
    rest_np = np.array([spec.rest_q[i] for i in jidx])
    damp_np = np.array([spec.damping[i] for i in jidx])
    consts = _inertial(spec, mask=mask_np, is_pri=is_pri_np, stiff=stiff_np,
                       rest=rest_np, damp=damp_np)

    def jac_map(q):
        """q (nv, B) → Jv (nb, nv, 3, B) world, Jw (nb, nv, 3, B) body."""
        batch = q.shape[1:]
        fkr = _fk_soa(spec, tuple(q[i] for i in range(nv)))
        stack = lambda items: _bcast_stack(items, batch, q.dtype, q.device)
        coms = stack(fkr.com)  # (nb, 3, B)
        quats = stack(fkr.quat)  # (nb, 4, B)
        anchors = stack([fkr.anchors[i] for i in jidx])
        axes_g = stack([fkr.axes_g[i] for i in jidx])

        c = consts(q)
        mask = c["mask"][:, :, None, None]  # bool
        is_pri = c["is_pri"][None, :, None, None]

        r = coms[:, None] - anchors[None]  # (nb, nv, 3, B)
        Jv_rev = rl.cross_l(axes_g[None], r)
        Jv = _times01(mask, _times01(is_pri, axes_g[None])
                      + _times01(~is_pri, Jv_rev))
        ax_rev = _times01(~c["is_pri"][:, None, None], axes_g)
        Jw = _times01(mask, rl.qrot_inv_l(quats[:, None], ax_rev[None]))
        return Jv, Jw

    def terms(q, qd):
        c = consts(q)
        M, f = _terms_from_jacobians(c, jac_map, q, qd, qd)
        # passive joint springs/dampers (smooth part, hot path)
        f = (
            f
            - c["stiff"][:, None] * (q - c["rest"][:, None])
            - c["damp"][:, None] * qd
        )
        return M, f

    return terms


def _make_terms_lanes_generic(spec: ChainSpec):
    """Free-base-capable lanes terms: per-joint Jacobian column blocks
    (FREE joints contribute 6 columns — 3 pre-frame linear + 3 base-body
    angular, matching kte/dynamics.jacobians of the JAX package)
    concatenated on the dof axis, then the same einsum mass/bias assembly
    as the fixed-base path.  The J̇q̇ jvp runs along the configuration rate
    (the quaternion rate ½ q⊗(0, ω_body) on the base)."""
    nb = spec.n_joints
    nv = spec.nv
    nq = spec.nq

    # per-dof passive-element constants (zeros on FREE dofs) + config index
    stiff_np = np.zeros(nv)
    damp_np = np.zeros(nv)
    rest_np = np.zeros(nv)
    qsel_np = np.zeros(nv, np.int64)
    ci = vi = 0
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == FIXED:
            continue
        if jt == FREE:
            ci += 7
            vi += 6
            continue
        stiff_np[vi] = spec.stiffness[i]
        damp_np[vi] = spec.damping[i]
        rest_np[vi] = spec.rest_q[i]
        qsel_np[vi] = ci
        ci += 1
        vi += 1
    # row i: the bodies at or past joint i
    joint_mask_np = (np.arange(nb)[None, :]
                     >= np.arange(nb)[:, None]).astype(np.float64)
    consts = _inertial(spec, joint_mask=joint_mask_np, stiff=stiff_np,
                       damp=damp_np, rest=rest_np, qsel=qsel_np)

    def jac_map(q):
        """q (nq, B) → Jv (nb, nv, 3, B) world, Jw (nb, nv, 3, B) body."""
        batch = q.shape[1:]
        fkr = _fk_soa(spec, tuple(q[i] for i in range(nq)))
        stack = lambda items: _bcast_stack(items, batch, q.dtype, q.device)
        coms = stack(fkr.com)      # (nb, 3, B)
        quats = stack(fkr.quat)    # (nb, 4, B)
        basis = torch.eye(3, dtype=q.dtype, device=q.device)[:, :, None] \
            .expand((3, 3) + batch)
        blocks_v, blocks_w = [], []
        joint_mask = consts(q)["joint_mask"]
        for i, jt in enumerate(spec.joint_types):
            jt = JointType(jt)
            if jt == FIXED:
                continue
            mask = joint_mask[i][:, None, None, None]
            anch = stack([fkr.anchors[i]])              # (1, 3, B)
            r = coms[:, None] - anch[None]              # (nb, 1, 3, B)
            if jt == REVOLUTE:
                a = stack([fkr.axes_g[i]])[None]
                Jv_blk = rl.cross_l(a, r) * mask
                Jw_blk = rl.qrot_inv_l(quats[:, None], a.expand(r.shape)) * mask
            elif jt == PRISMATIC:
                a = stack([fkr.axes_g[i]])[None]
                Jv_blk = a.expand(r.shape) * mask
                Jw_blk = torch.zeros_like(Jv_blk)
            else:  # FREE: 3 pre-frame linear + 3 base-body angular columns
                lin_axes = rl.qrot_l(stack([fkr.pre_quat[i]]), basis)
                ang_axes = rl.qrot_l(stack([fkr.quat[i]]), basis)  # (3,3,B)
                full = (nb, 3, 3) + batch
                Jv_lin = lin_axes[None].expand(full) * mask
                Jw_lin = torch.zeros(full, dtype=q.dtype, device=q.device)
                ang_b = ang_axes[None].expand(full)
                Jv_ang = rl.cross_l(ang_b, r.expand(full)) * mask
                Jw_ang = rl.qrot_inv_l(quats[:, None], ang_b) * mask
                Jv_blk = torch.cat([Jv_lin, Jv_ang], dim=1)
                Jw_blk = torch.cat([Jw_lin, Jw_ang], dim=1)
            blocks_v.append(Jv_blk)
            blocks_w.append(Jw_blk)
        return torch.cat(blocks_v, dim=1), torch.cat(blocks_w, dim=1)

    def terms(q, qd):
        c = consts(q)
        M, f = _terms_from_jacobians(c, jac_map, q, qd,
                                     _config_rate_l(q, qd))
        f = (
            f
            - c["stiff"][:, None]
            * (q.index_select(0, c["qsel"]) - c["rest"][:, None])
            - c["damp"][:, None] * qd
        )
        return M, f

    return terms


def _config_rate_l(q, qd):
    """(nq, B) tangent of a free-base configuration along qd (lanes form of
    kte/dynamics.config_rate: the base quaternion moves at ½ q⊗(0, ω))."""
    qdot = rl.qdot_from_omega_l(q[3:7], qd[3:6])
    return torch.cat([qd[0:3], qdot, qd[6:]], dim=0)


# ---------------------------------------------------------------------------
# fused rollout + LTV linearization
# ---------------------------------------------------------------------------


def make_core_ltv_lanes(spec: ChainSpec):
    """The core of a rollout step, lanes layout: ``core(x (n, B), u (nv, B))
    → (qdd (nv, B), dqdd (nv, n, B), Minv (nv, nv, B))`` — the (M, f)
    assembly, its n unit-tangent jvps, q̈ = M⁻¹(f + u),
    ∂q̈/∂x = M⁻¹(∂f − ∂M q̈) and M⁻¹.  The plain version of the core kernel
    (``ops/kte_core.py``; the JAX package's ``make_core_lanes_xla``)."""
    nv = spec.nv
    n = 2 * nv
    terms = make_terms_lanes(spec)

    def core(x, u):
        dtype, device = x.dtype, x.device
        batch = x.shape[1:]

        def terms_flat(xx):
            return terms(xx[:nv], xx[nv:])

        M, f = terms_flat(x)
        qdd = _chol_solve_lanes(M, (f + u)[:, None, :])[:, 0]  # (nv, B)

        # all n unit-tangent pulls in one vmapped pass
        basis = torch.eye(n, dtype=dtype, device=device)[:, :, None] \
            .expand((n, n) + batch)
        dM, df = vmap(lambda t: jvp(terms_flat, (x,), (t,))[1])(basis)
        # dM (n, nv, nv, B), df (n, nv, B)
        rhs = df - torch.einsum("dklz,lz->dkz", dM, qdd)  # (n, nv, B)
        rhs_t = rhs.permute(1, 0, 2)  # (nv, n, B)
        eye_nv = torch.eye(nv, dtype=dtype, device=device)[:, :, None] \
            .expand((nv, nv) + batch)
        sol = _chol_solve_lanes(M, torch.cat([rhs_t, eye_nv], dim=1))
        return qdd, sol[:, :n], sol[:, n:]  # ∂q̈_k/∂x_d, M⁻¹

    return core


def _series_ltv(x, u, qdd, dqdd, Minv, dt: float, order: int):
    """The step's tail: the continuous A = [[0, I], [∂q̈/∂x]], B = [[0],
    [M⁻¹]] about x, discretized by the order-``order`` exponential series
    S = Σ_{k=1..order} dt^k A^{k-1}/k!, Ad = I + A S, Bd = S B,
    x_new = x + S [q̇; q̈], cd = x_new − Ad x − Bd u."""
    nv = qdd.shape[0]
    n = 2 * nv
    dtype, device = x.dtype, x.device
    batch = x.shape[1:]
    top = torch.cat([torch.zeros(nv, nv, dtype=dtype, device=device),
                     torch.eye(nv, dtype=dtype, device=device)], dim=1)
    A_c = torch.cat([top[:, :, None].expand((nv, n) + batch), dqdd], dim=0)
    B_c = torch.cat([torch.zeros((nv, nv) + batch, dtype=dtype,
                                 device=device), Minv], dim=0)
    f0 = torch.cat([x[nv:], qdd], dim=0)  # (n, B)

    eye_n = torch.eye(n, dtype=dtype, device=device)[:, :, None]
    S = eye_n * dt
    term = eye_n * dt
    for k in range(2, order + 1):
        term = (dt / k) * _mm(A_c, term)
        S = S + term
    Ad = eye_n + _mm(A_c, S)
    Bd = _mm(S, B_c)
    x_new = x + _mv(S, f0)
    cd = x_new - _mv(Ad, x) - _mv(Bd, u)
    return Ad, Bd, cd, x_new


def make_step_ltv_lanes(spec: ChainSpec, dt: float, order: int = 4):
    """One rollout step with its LTV linearization, lanes layout:
    ``step(x (n, B), u (nv, B)) → (Ad (n, n, B), Bd (n, nv, B), cd (n, B),
    x_new (n, B))`` — the step of ``make_rollout_ltv_lanes`` and the plain
    version of the kernel in ``ops/kte_step.py``: the core
    (``make_core_ltv_lanes``) and the exponential series."""
    core = make_core_ltv_lanes(spec)
    return lambda x, u: _series_ltv(x, u, *core(x, u), dt, order)


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


def make_rollout_ltv_batchfirst(spec: ChainSpec, dt: float, horizon: int,
                                order: int = 4):
    """The lanes rollout with the signature of
    ``kte/soa.make_rollout_ltv_soa``: ``fn(x0 (B, n), us (B, H, m)) →
    (A (B,H,n,n), B (B,H,n,m), c (B,H,n), xs (B,H,n))``, batch first — the
    rollout of ``make_kte_mpc(qp_layout="vmap", rollout="lanes")``.  On CUDA
    tensors each of its plain steps, launched op by op from Python when
    eager, is replayed from a CUDA graph (``fn.step``; ``fn.step.eager``
    runs one step eagerly)."""
    step = make_step_ltv_lanes(spec, dt, order)
    step_graphed = graphs.graphed(step)
    batch_first = lambda outs: tuple(torch.movedim(a, -1, 0) for a in outs)

    def fn(x0, us):
        # (H, ..., B) → (B, H, ...)
        return batch_first(_scan_rollout(step_graphed, x0, us))

    fn.step = step_graphed
    return fn


def make_rollout_ltv_fullfused(spec: ChainSpec, dt: float, horizon: int,
                               order: int = 4):
    """Rollout with the ENTIRE step (core + series discretization) in one
    kernel launch (ops/kte_step.make_step_lanes); same contract as
    make_rollout_ltv_lanes.  On CPU tensors the wrapper takes the plain
    step; the kernel's instance is chosen, and a chain it does not take
    refused, at the first call on a device tensor."""
    from reak_tpu_torch.ops import kte_step

    step = kte_step.make_step_lanes(spec, dt, order=order)
    return lambda x0, us: _scan_rollout(step, x0, us)


def make_rollout_ltv_fused(spec: ChainSpec, dt: float, horizon: int,
                           order: int = 4):
    """Rollout with the step core (q̈, ∂q̈/∂x, M⁻¹) in one kernel launch per
    step (``ops/kte_core.make_core_lanes``, K5) and the exponential series in
    torch; same contract as make_rollout_ltv_lanes.  On CPU tensors the core
    wrapper takes the plain core."""
    from reak_tpu_torch.ops import kte_core

    core = kte_core.make_core_lanes(spec)
    step = lambda x, u: _series_ltv(x, u, *core(x, u), dt, order)
    return lambda x0, us: _scan_rollout(step, x0, us)


def _rk4(rate, x, u, dt):
    k1 = rate(x, u)
    k2 = rate(x + 0.5 * dt * k1, u)
    k3 = rate(x + 0.5 * dt * k2, u)
    k4 = rate(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def make_rollout_lanes(spec: ChainSpec, dt: float):
    """Nominal-only lanes rollout (RK4) of a fixed-base chain: prices the
    candidate input sequences of the SQP line search at 4 terms
    evaluations per step.  ``fn(x0 (B, n), us_l (H, m, B)) → xs (H, n, B)``
    (x_1..x_H).  Each stage solves with M through ``chol_lanes.solve_lanes``
    (the kernel on CUDA tensors).  On CUDA tensors each RK4 step is replayed
    from a CUDA graph (``ops/graphs.graphed``, ``fn.step``); ``fn.eager`` is
    the same rollout with every step run eagerly."""
    if spec.has_free_base:
        raise ValueError("free-base chains use make_kte_manifold_lanes")
    nv = spec.nv
    terms = make_terms_lanes(spec)

    def rate(x, u):
        qd = x[nv:]
        M, f = terms(x[:nv], qd)
        return torch.cat([qd, chol_lanes.solve_lanes(M, f + u)], dim=0)

    step = graphs.graphed(lambda x, u: _rk4(rate, x, u, dt))

    def roll(step_fn, x0, us_l):
        x = x0.T.contiguous()
        xs = []
        for t in range(us_l.shape[0]):
            x = step_fn(x, us_l[t])
            xs.append(x)
        return torch.stack(xs, dim=0)

    def rollout(x0, us_l):
        return roll(step, x0, us_l)

    rollout.step = step
    rollout.eager = lambda x0, us_l: roll(step.eager, x0, us_l)
    return rollout


def make_kte_manifold_lanes(spec: ChainSpec, dt: float, actuated=None,
                            order: int = 4):
    """Free-base KTE chain on the lanes path: returns ``(step, ltv)`` for
    ctrl/manifold_lanes.make_scenario_mpc_lanes.

    * ``step(x (nq+nv, B), u (nu, B)) → x'`` — RK4 + base-quaternion
      renormalization (the math of ctrl/systems.kte_discrete of the JAX
      package; ref manipulator_model.cpp:292-355);
    * ``ltv(x, u) → (A_d (2nv, 2nv, B), B_d (2nv, nu, B), c_d (2nv, B))`` —
      the error-state series LTV in the tangent chart e = [δp, δθ, δq_arm |
      δq̇] of the state retraction: the (M, f) assembly in that chart, its
      2nv unit-tangent jvps, ∂q̈ = M⁻¹(∂f − ∂M q̈), the exponential series
      with the −[ω̄]× attitude-error transport block; c_d = −B_d ū.

    ``actuated`` (nv, nu) maps the inputs onto the generalized forces
    (identity when None).  Every solve with M goes through
    ``ops/chol_lanes``, outside the jvps.  On CUDA tensors both are
    replayed from CUDA graphs (``ops/graphs.graphed``, one capture per
    shape and type); ``step.eager`` and ``ltv.eager`` run eagerly."""
    if not spec.has_free_base:
        raise ValueError("fixed-base chains use make_rollout_ltv_lanes")
    nq = spec.nq
    nv = spec.nv
    d = 2 * nv
    terms = make_terms_lanes(spec)
    act_np = None if actuated is None else np.asarray(actuated, np.float64)
    nu = nv if act_np is None else act_np.shape[1]
    act = None if act_np is None else _Consts(S=act_np)

    def tau_of(u):
        if act is None:
            return u
        return torch.einsum("vu,uz->vz", act(u)["S"], u)

    def state_rate(x, tau):
        q, qd = x[:nq], x[nq:]
        M, f = terms(q, qd)
        qdd = chol_lanes.solve_lanes(M, f + tau)
        return torch.cat([_config_rate_l(q, qd), qdd], dim=0)

    def step(x, u):
        xn = _rk4(state_rate, x, tau_of(u), dt)
        quat = xn[3:7]
        quat = quat / torch.sqrt(torch.sum(quat * quat, dim=0, keepdim=True))
        return torch.cat([xn[0:3], quat, xn[7:]], dim=0)

    def retract(x, e):
        """Lanes form of kte.dynamics.state_retraction.retract."""
        p = x[0:3] + e[0:3]
        quat = rl.qmul_l(x[3:7], rl.q_exp_l(e[3:6]))
        arm = x[7:nq] + e[6:nv]
        qd = x[nq:] + e[nv:]
        return torch.cat([p, quat, arm, qd], dim=0)

    def ltv(x, u):
        dtype, device = x.dtype, x.device
        batch = x.shape[1:]
        qd = x[nq:]

        def terms_e(e):
            xe = retract(x, e)
            return terms(xe[:nq], xe[nq:])

        e0 = torch.zeros((d,) + batch, dtype=dtype, device=device)
        M, f = terms_e(e0)
        qdd = chol_lanes.solve_lanes(M, f + tau_of(u))

        basis = torch.eye(d, dtype=dtype, device=device)[:, :, None] \
            .expand((d, d) + batch)
        dM, df = vmap(lambda t: jvp(terms_e, (e0,), (t,))[1])(basis)
        # dM (d, nv, nv, B), df (d, nv, B)
        rhs = df - torch.einsum("dklz,lz->dkz", dM, qdd)
        rhs_t = rhs.permute(1, 0, 2)            # (nv, d, B)
        S_u = (torch.eye(nv, dtype=dtype, device=device)[:, :, None]
               .expand((nv, nv) + batch) if act_np is None else
               act(x)["S"][:, :, None].expand((nv, nu) + batch))
        sol = chol_lanes.solve_lanes_multi(M, torch.cat([rhs_t, S_u], dim=1))
        dqdd = sol[:, :d]                       # (nv, d, B)
        Minv_S = sol[:, d:]                     # (nv, nu, B)

        # attitude-error transport: δθ̇ = −ω̄×δθ + δω (invariant-EKF error
        # kinematics; ctrl/systems.kte_manifold_ltv_linearizer)
        Sblk = torch.zeros((nv, nv) + batch, dtype=dtype, device=device)
        Sblk[3:6, 3:6] = -rl.skew_l(qd[3:6])
        eye_v = torch.eye(nv, dtype=dtype, device=device)[:, :, None] \
            .expand((nv, nv) + batch)
        A_c = torch.cat([torch.cat([Sblk, eye_v], dim=1), dqdd], dim=0)
        B_c = torch.cat([torch.zeros((nv, nu) + batch, dtype=dtype,
                                     device=device), Minv_S], dim=0)

        eye_d = torch.eye(d, dtype=dtype, device=device)[:, :, None]
        S = eye_d * dt
        term = eye_d * dt
        for k in range(2, order + 1):
            term = (dt / k) * _mm(A_c, term)
            S = S + term
        A_d = eye_d + _mm(A_c, S)
        B_d = _mm(S, B_c)
        c_d = -_mv(B_d, u)
        return A_d, B_d, c_d

    return graphs.graphed(step), graphs.graphed(ltv)
