"""State-space systems: linearization, discretization, generic LTI/LTV
types (port of ``reak_tpu/ctrl/systems.py``; ref: ctrl/ctrl_sys/
state_space_sys_concept.hpp:112, linear_ss_system_concept.hpp:189,
lti_ss_system.hpp:54, lti_discrete_sys.hpp, discretized_lti_sys.hpp:64,
num_int_dtnl_system.hpp:55, kte_nl_system.hpp:67).

A system is a pair of pure functions:

- continuous: ``f(x, u, t) → ẋ``
- discrete:   ``F(x, u, t) → x⁺``

Linearizations (A, B) come by forward-mode AD (``torch.func.jacfwd``), the
exact LTI discretization by the matrix exponential.  The KTE systems take
ONE state (``kte/dynamics.py``); the LTV linearizers take trajectories with
any leading axes, ``(..., H, n)``, and linearize every point at once under
``torch.func.vmap`` where the JAX package scans over the horizon.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from reak_tpu_torch.ctrl.riccati import _mv
from reak_tpu_torch.math.linalg import expm_pade, solve_pd


class LinearModel(NamedTuple):
    """x⁺ ≈ A x + B u + c  (or ẋ for continuous)."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor


def _per_point(lin: Callable, *arrays):
    """``lin`` of one point under vmap over every leading axis of
    ``arrays`` (each (..., k)); its outputs keep those axes."""
    lead = arrays[0].shape[:-1]
    outs = vmap(lin)(*(a.reshape(-1, a.shape[-1]) for a in arrays))
    return tuple(o.reshape(lead + o.shape[1:]) for o in outs)


def linearize(f: Callable, x, u, t=0.0) -> LinearModel:
    """Jacobian linearization of ``f(x, u, t)`` about (x, u) by jacfwd
    (replaces the reference's per-model get_state_transition_blocks)."""
    A = jacfwd(lambda xx: f(xx, u, t))(x)
    B = jacfwd(lambda uu: f(x, uu, t))(u)
    c = f(x, u, t) - A @ x - B @ u
    return LinearModel(A=A, B=B, c=c)


def discretize_lti(A, B, dt):
    """Exact zero-order-hold discretization by the augmented matrix
    exponential (ref: discretized_lti_sys.hpp:64)."""
    n, m = A.shape[-1], B.shape[-1]
    Z = torch.zeros(A.shape[:-2] + (m, n + m), dtype=A.dtype, device=A.device)
    M = torch.cat([torch.cat([A, B], dim=-1), Z], dim=-2) * dt
    E = expm_pade(M)
    return E[..., :n, :n], E[..., :n, n:]


def discretize_series(A, B, f0, x, u, dt, order: int = 4) -> LinearModel:
    """Series discretization of a continuous linear model (A, B, affine rate
    f0 = f(x, u)) about the nominal (x, u):

        S   = Σ_{k=1..order} dtᵏ A^{k-1} / k!
        A_d = I + A·S,   B_d = S·B,   c_d = x + S·f0 − A_d x − B_d u

    order=4 reproduces RK4 on an LTI system exactly."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    S = eye * dt
    term = eye * dt
    for k in range(2, order + 1):
        term = (dt / k) * (A @ term)
        S = S + term
    Ad = eye + A @ S
    Bd = S @ B
    cd = x + _mv(S, f0) - _mv(Ad, x) - _mv(Bd, u)
    return LinearModel(A=Ad, B=Bd, c=cd)


def linearize_discrete_series(f: Callable, x, u, dt, order: int = 4,
                              t=0.0) -> LinearModel:
    """Discrete linearization of the flow of ẋ = f(x, u) over one step from
    ONE continuous jacfwd and the exponential series."""
    A = jacfwd(lambda xx: f(xx, u, t))(x)
    B = jacfwd(lambda uu: f(x, uu, t))(u)
    return discretize_series(A, B, f(x, u, t), x, u, dt, order)


def _actuation(actuated):
    """τ = S u with S (nv, nu) moved to u's dtype and device, or τ = u."""
    if actuated is None:
        return None, lambda u: u
    from reak_tpu_torch.kte.lanes import _Consts

    act = _Consts(S=np.asarray(actuated, np.float64))
    return act, lambda u: _mv(act(u)["S"], u)


def kte_ltv_linearizer(spec, dt: float, actuated=None,
                       order: int = 4) -> Callable:
    """LTV linearizer for fixed-base KTE chains: ``linearizer(xs, us) →
    (A_d, B_d, c_d)`` per trajectory point, from the analytic
    forward-dynamics derivative (``kte.dynamics.linearize_fd``; ∂q̈/∂u =
    M⁻¹S) and the exponential series."""
    from reak_tpu_torch.kte.dynamics import linearize_fd

    act, tau_of = _actuation(actuated)

    def lin_one(x, u):
        nvs = x.shape[-1] // 2
        q, qd = x[:nvs], x[nvs:]
        qdd, dq, dqd, msolve = linearize_fd(spec, q, qd, tau_of(u))
        zero = torch.zeros((nvs, nvs), dtype=x.dtype, device=x.device)
        eye = torch.eye(nvs, dtype=x.dtype, device=x.device)
        A = torch.cat([torch.cat([zero, eye], dim=1),
                       torch.cat([dq, dqd], dim=1)], dim=0)
        Minv_S = msolve(eye if act is None else act(x)["S"])
        B = torch.cat([torch.zeros_like(Minv_S), Minv_S], dim=0)
        md = discretize_series(A, B, torch.cat([qd, qdd]), x, u, dt, order)
        return md.A, md.B, md.c

    return lambda xs, us: _per_point(lin_one, xs, us)


def kte_manifold_ltv_linearizer(spec, dt: float, actuated=None,
                                order: int = 4) -> Callable:
    """Error-state LTV linearizer for FREE-BASE KTE chains, in the tangent
    chart of ``kte.dynamics.state_retraction`` (e = [δp, δθ, δq_arm | δv]):

        δṗ = δv_base_lin,  δθ̇ = δω − ω̄ × δθ,  δq̇_arm = δv_arm
        δv̇ = (∂q̈/∂e_c) δc + (∂q̈/∂e_v) δv + M⁻¹ S_u δu

    with the bottom row from ``linearize_fd`` and the exponential series;
    the decision variable is the ABSOLUTE input: c_d = −B_d ū.  Returns
    ``linearizer(xs (..., nq+nv), us (..., nu)) → (A (..., 2nv, 2nv),
    B (..., 2nv, nu), c (..., 2nv))`` for ``ctrl.mpc_manifold.
    solve_manifold``."""
    from reak_tpu_torch.kte.dynamics import linearize_fd
    from reak_tpu_torch.math.rotations import hat

    nv, nq = spec.nv, spec.nq
    act, tau_of = _actuation(actuated)

    def lin_one(x, u):
        q, qd = x[:nq], x[nq:]
        qdd, dq, dqd, msolve = linearize_fd(spec, q, qd, tau_of(u))
        dtype, device = x.dtype, x.device
        eye = torch.eye(nv, dtype=dtype, device=device)
        S = torch.zeros((nv, nv), dtype=dtype, device=device)
        if spec.has_free_base:
            S = torch.cat([S[:3], torch.cat([S[3:6, :3], -hat(qd[3:6]),
                                             S[3:6, 6:]], dim=1), S[6:]])
        A = torch.cat([torch.cat([S, eye], dim=1),
                       torch.cat([dq, dqd], dim=1)], dim=0)
        nu = u.shape[-1]
        Minv_S = msolve(eye if act is None else act(x)["S"])
        B = torch.cat([torch.zeros((nv, nu), dtype=dtype, device=device),
                       Minv_S[:, :nu]], dim=0)
        zero = torch.zeros(2 * nv, dtype=dtype, device=device)
        md = discretize_series(A, B, zero, zero, u, dt, order)
        return md.A, md.B, md.c  # md.c = −B_d ū (nominal error rate 0)

    return lambda xs, us: _per_point(lin_one, xs, us)


def rk4_discrete(f: Callable, dt: float) -> Callable:
    """A continuous system as a one-step discrete map by RK4 (ref:
    num_int_dtnl_system.hpp:55 num_int_dtnl_sys)."""

    def F(x, u, t=0.0):
        k1 = f(x, u, t)
        k2 = f(x + 0.5 * dt * k1, u, t + 0.5 * dt)
        k3 = f(x + 0.5 * dt * k2, u, t + 0.5 * dt)
        k4 = f(x + dt * k3, u, t + dt)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    return F


def euler_discrete(f: Callable, dt: float) -> Callable:
    def F(x, u, t=0.0):
        return x + dt * f(x, u, t)

    return F


def semi_implicit_kte(spec, dt: float, actuated=None) -> Callable:
    """Linearly-implicit (IMEX) one-step map for STIFF KTE chains (ref:
    flexible_beam.hpp:52):

        (M + dt·D + dt²·K) v⁺ = M v + dt(f_ex + τ − K(q_e − q_rest))
        q⁺ = q ⊕ dt·v⁺

    K = diag(joint stiffness) and D = diag(joint damping) backward Euler,
    the other forces f_ex explicit; one PD solve a step.  A free base
    carries no passive elements, and its quaternion is advanced by its rate
    and renormalized."""
    from reak_tpu_torch.kte.dynamics import config_rate, dynamics_terms
    from reak_tpu_torch.kte.lanes import _Consts
    from reak_tpu_torch.kte.spec import JointType, REVOLUTE, PRISMATIC, FREE

    nv, nq = spec.nv, spec.nq
    # per-velocity-dof passive constants (zeros on FREE dofs) and the
    # configuration row of each 1-dof joint's coordinate
    k_np, d_np, rq_np = np.zeros(nv), np.zeros(nv), np.zeros(nv)
    qsel_np = np.zeros(nv, np.int64)
    ci = vi = 0
    for i, jt in enumerate(spec.joint_types):
        jt = JointType(jt)
        if jt == FREE:
            ci += 7
            vi += 6
            continue
        if jt in (REVOLUTE, PRISMATIC):
            k_np[vi] = spec.stiffness[i]
            d_np[vi] = spec.damping[i]
            rq_np[vi] = spec.rest_q[i]
            qsel_np[vi] = ci
            ci += 1
            vi += 1
    consts = _Consts(k=k_np, d=d_np, rq=rq_np, qsel=qsel_np)
    act, tau_of = _actuation(actuated)

    def F(x, u, t=0.0):
        c = consts(x)
        k, d = c["k"], c["d"]
        q, v = x[:nq], x[nq:]
        e = q[c["qsel"]] - c["rq"]              # joint coordinate errors
        M, f = dynamics_terms(spec, q, v)       # f includes −K e − D v
        f_ex = f + k * e + d * v
        A = M + dt * torch.diag(d) + dt * dt * torch.diag(k)
        rhs = M @ v + dt * (f_ex + tau_of(u) - k * e)
        v1 = solve_pd(A, rhs)
        q1 = q + dt * config_rate(spec, q, v1)
        if spec.has_free_base:
            quat = q1[3:7]
            q1 = torch.cat([q1[:3], quat / torch.linalg.vector_norm(quat),
                            q1[7:]])
        return torch.cat([q1, v1])

    return F


def lti_continuous(A, B) -> Callable:
    """ẋ = A x + B u (ref: lti_ss_system.hpp:54)."""

    def f(x, u, t=0.0):
        return _mv(A, x) + _mv(B, u)

    return f


def lti_discrete(A, B) -> Callable:
    """x⁺ = A x + B u (ref: lti_discrete_sys.hpp)."""

    def F(x, u, t=0.0):
        return _mv(A, x) + _mv(B, u)

    return F


def kte_discrete(spec, dt: float, actuated=None) -> Callable:
    """One RK4 step of a KTE chain that respects the configuration
    manifold: a free base's quaternion q[3:7] is renormalized after the
    step (under RK4 in ambient coordinates its norm drifts O(dt⁵)).  Pair
    with ``kte.dynamics.state_retraction`` for error-state MPC."""
    F = rk4_discrete(kte_continuous(spec, actuated), dt)
    if not spec.has_free_base:
        return F

    def F_renorm(x, u, t=0.0):
        x1 = F(x, u, t)
        q = x1[..., 3:7]
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return torch.cat([x1[..., 0:3], q, x1[..., 7:]], dim=-1)

    return F_renorm


def kte_continuous(spec, actuated=None) -> Callable:
    """Continuous system of a KTE chain: x = [q, qd], u = joint torques
    (ref: ctrl/ctrl_sys/kte_nl_system.hpp:67).  ``actuated``: an optional
    (nv, nu) selection matrix from inputs to generalized forces (identity
    when None)."""
    from reak_tpu_torch.kte.dynamics import state_rate

    _, tau_of = _actuation(actuated)

    def f(x, u, t=0.0):
        return state_rate(spec, x, tau_of(u))

    return f
