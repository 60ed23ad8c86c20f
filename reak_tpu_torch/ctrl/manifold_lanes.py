"""Batch-in-lanes error-state scenario MPC — the free-base path (port of
``reak_tpu/ctrl/manifold_lanes.py``).

The SQP-on-manifold composition with the scenario batch on the LAST axis of
every array:

  * the nominal rollout runs a lanes step — the exact invariant mid-point
    satellite step (``sat_step_lanes``) or the RK4 step of a free-base KTE
    chain (``kte/lanes.make_kte_manifold_lanes``);
  * the tangent-space LTV comes from the matching lanes linearization —
    the analytic error-state model of the rigid body
    (``sat_error_ltv_lanes``) or the chain's series LTV;
  * the box QP is ``ctrl/riccati_soa.solve_box_mpc_riccati_soa_fused`` with
    x_ref = tangent reference errors: on CUDA tensors the whole-solve kernel
    (``ops/pdip_whole.py``) in its x_ref mode, or with
    ``use_kernels="passes"`` the per-pass kernels (``ops/riccati_bwd.py``).

Error-state convention (ctrl/ss_systems.sat3D_retraction of the JAX
package): tangent e = [δp (global), δθ (body, right-mult), δv (global),
δω (body)], nominal-relative; the QP decision variable is the ABSOLUTE input
sequence, so c_t = −B_t ū_t keeps the nominal (e ≡ 0 at u = ū) consistent
with constant box bounds.

(ref lineage: satellite dynamics satellite_invar_models.hpp:296
satellite3D_imdt_sys; tracking recursion mat_are_solver.hpp:1449.)
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from reak_tpu_torch.ctrl.mpc import MPCProblem
from reak_tpu_torch.ctrl.riccati_soa import (solve_box_mpc_riccati_soa_fused,
                                             _mm, _mv)
from reak_tpu_torch.ctrl.ss_systems import SatelliteParams
from reak_tpu_torch.math import rot_lanes as rl


def _like(a, x):
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# exact invariant mid-point satellite step, lanes layout
# ---------------------------------------------------------------------------


def sat_step_lanes(params: SatelliteParams, dt: float) -> Callable:
    """``step(x (13, B), u (6, B)) → x' (13, B)`` — the math of
    ctrl/ss_systems.satellite3D_imdt (invariant mid-point on SE(3)) with the
    scenario batch last."""
    J_np = np.asarray(params.inertia, np.float64)
    Jinv_np = np.linalg.inv(J_np)
    mass = float(params.mass)

    def step(x, u):
        J, Jinv = _like(J_np, x), _like(Jinv_np, x)
        p, q, v, w = x[0:3], x[3:7], x[7:10], x[10:13]
        fb, tb = u[0:3], u[3:6]

        def wdot(wb):
            Jw = torch.einsum("ij,jz->iz", J, wb)
            return torch.einsum("ij,jz->iz", Jinv, tb - rl.cross_l(wb, Jw))

        w_half = w + 0.5 * dt * wdot(w)
        w_half = w + 0.5 * dt * wdot(w_half)
        q_next = rl.qnormalize_l(rl.qmul_l(q, rl.q_exp_l(dt * w_half)))
        w_next = w + dt * wdot(w_half)
        q_half = rl.qmul_l(q, rl.q_exp_l(0.5 * dt * w_half))
        acc = rl.qrot_l(q_half, fb) / mass
        v_next = v + dt * acc
        p_next = p + dt * v + (0.5 * dt * dt) * acc
        return torch.cat([p_next, q_next, v_next, w_next], dim=0)

    return step


# ---------------------------------------------------------------------------
# analytic error-state LTV, lanes layout
# ---------------------------------------------------------------------------


def sat_error_ltv_lanes(params: SatelliteParams, dt: float,
                        order: int = 4) -> Callable:
    """``ltv(x (13, B), u (6, B)) → (A_d (12,12,B), B_d (12,6,B),
    c_d (12,B))`` — one step of the tangent-space LTV model about (x, u).

    Continuous error dynamics of the free rigid body in the [δp, δθ, δv, δω]
    chart, frozen at the step midpoint (the w_half/q_half of the mid-point
    integrator):

        δṗ = δv
        δθ̇ = −ω̄ × δθ + δω
        δv̇ = −(1/m) R̄ [f̄_b]× δθ + (1/m) R̄ δf
        δω̇ = J⁻¹([Jω̄]× − [ω̄]× J) δω + J⁻¹ δτ

    then S = Σ_{k=1..order} dtᵏ A^{k-1}/k!,  A_d = I + A S,  B_d = S B,
    c_d = −B_d ū.
    """
    J_np = np.asarray(params.inertia, np.float64)
    Jinv_np = np.linalg.inv(J_np)
    inv_m = 1.0 / float(params.mass)

    def ltv(x, u):
        dtype, device = x.dtype, x.device
        batch = x.shape[1:]
        J, Jinv = _like(J_np, x), _like(Jinv_np, x)
        q, w0 = x[3:7], x[10:13]
        fb, tb = u[0:3], u[3:6]

        def wdot(wb):
            Jwb = torch.einsum("ij,jz->iz", J, wb)
            return torch.einsum("ij,jz->iz", Jinv, tb - rl.cross_l(wb, Jwb))

        w_half = w0 + 0.5 * dt * wdot(w0)
        w_half = w0 + 0.5 * dt * wdot(w_half)
        w = w_half
        q = rl.qmul_l(q, rl.q_exp_l(0.5 * dt * w_half))

        R = rl.q_to_matrix_l(q)                      # (3, 3, B)
        wx = rl.skew_l(w)                            # (3, 3, B)
        Jw = torch.einsum("ij,jz->iz", J, w)
        # d(−ω×Jω)/dω = [Jω̄]× − [ω̄]× J
        Aww = torch.einsum("ij,jkz->ikz", Jinv, rl.skew_l(Jw) - torch.einsum(
            "ijz,jk->ikz", wx, J))                   # (3, 3, B)
        Avth = -inv_m * _mm(R, rl.skew_l(fb))        # (3, 3, B)

        zero3 = torch.zeros((3, 3) + batch, dtype=dtype, device=device)
        eye3 = torch.eye(3, dtype=dtype, device=device)[:, :, None] \
            .expand((3, 3) + batch)
        # A_c rows: [δp | δθ | δv | δω]
        A_c = torch.cat([
            torch.cat([zero3, zero3, eye3, zero3], dim=1),
            torch.cat([zero3, -wx, zero3, eye3], dim=1),
            torch.cat([zero3, Avth, zero3, zero3], dim=1),
            torch.cat([zero3, zero3, zero3, Aww], dim=1),
        ], dim=0)                                    # (12, 12, B)
        Jinv_b = Jinv[:, :, None].expand((3, 3) + batch)
        B_c = torch.cat([
            torch.cat([zero3, zero3], dim=1),
            torch.cat([zero3, zero3], dim=1),
            torch.cat([inv_m * R, zero3], dim=1),
            torch.cat([zero3, Jinv_b], dim=1),
        ], dim=0)                                    # (12, 6, B)

        eye_d = torch.eye(12, dtype=dtype, device=device)[:, :, None]
        S = eye_d * dt
        term = eye_d * dt
        for k in range(2, order + 1):
            term = (dt / k) * _mm(A_c, term)
            S = S + term
        A_d = eye_d + _mm(A_c, S)
        B_d = _mm(S, B_c)
        c_d = -_mv(B_d, u)
        return A_d, B_d, c_d

    return ltv


def quat_local_lanes(x1, x0, qi: int = 3):
    """Lanes-form ``ret.local``: the tangent taking x0 to x1 for states that
    embed a unit quaternion at rows [qi, qi+4) — (..., S, B), (..., S, B) →
    (..., S−1, B), components on axis -2 (ctrl/invariant.
    quat_state_retraction.local of the JAX package)."""
    dq = rl.qmul_l(rl.qconj_l(x0[..., qi:qi + 4, :]), x1[..., qi:qi + 4, :])
    dth = rl.q_log_l(dq)
    return torch.cat(
        [x1[..., :qi, :] - x0[..., :qi, :], dth,
         x1[..., qi + 4:, :] - x0[..., qi + 4:, :]], dim=-2)


# ---------------------------------------------------------------------------
# the SQP-on-manifold scenario solver, lanes end to end
# ---------------------------------------------------------------------------


def make_scenario_mpc_lanes(
    step: Callable,
    ltv: Callable,
    problem: MPCProblem,
    tangent_dim: int = 12,
    quat_index: int = 3,
    qp_iters: int = 8,
    sqp_iters: int = 2,
    use_kernels: str = "auto",
    sqp_linesearch: bool = False,
):
    """Lanes-layout belief-scenario MPC solver.

    ``step``/``ltv``: lanes-form nominal step and tangent LTV (e.g.
    sat_step_lanes / sat_error_ltv_lanes, or the pair of
    kte/lanes.make_kte_manifold_lanes).  Returns ``solve(x0s (B, S), x_ref
    (S,) or (H, S), us_init (B, H, m)) → (us (B, H, m), xs (B, H, S))``.

    ``use_kernels`` goes to the QP: "auto" (the whole-solve kernel on CUDA
    tensors, the plain scan on CPU), "whole", "passes" (the per-pass
    kernels, ``ops/riccati_bwd.py``) or "never" (the plain scan on any
    device).

    ``sqp_linesearch``: per-scenario backtracking over α ∈ {1, ½, ¼} on the
    true manifold tracking cost (one exact nominal rollout per candidate);
    off by default.
    """
    if use_kernels not in ("auto", "whole", "passes", "never"):
        raise ValueError(f"use_kernels={use_kernels!r}: expected 'auto', "
                         "'whole', 'passes' or 'never'")
    Hh = problem.horizon
    d = tangent_dim

    def rollout(x, us_l):
        # x (S, B), us_l (H, m, B) → xs_prev (H, S, B), xs (H, S, B)
        xs_prev, xs = [], []
        for t in range(us_l.shape[0]):
            xs_prev.append(x)
            x = step(x, us_l[t])
            xs.append(x)
        return torch.stack(xs_prev, dim=0), torch.stack(xs, dim=0)

    def weights(like):
        return tuple(_like(a, like) for a in (problem.Q, problem.QN,
                                              problem.R))

    def traj_cost(x_l, u_l, xr_l):
        """True manifold tracking cost per scenario (B,)."""
        _, xs = rollout(x_l, u_l)
        e = quat_local_lanes(xr_l.expand(xs.shape), xs, qi=quat_index)
        Q, QN, R = weights(xs)
        qx = torch.einsum("hib,ij,hjb->b", e[:-1], Q, e[:-1])
        qn = torch.einsum("ib,ij,jb->b", e[-1], QN, e[-1])
        ru = torch.einsum("hib,ij,hjb->b", u_l, R, u_l)
        cost = 0.5 * (qx + qn + ru)
        return torch.where(torch.isfinite(cost), cost,
                           torch.full_like(cost, math.inf))

    def solve(x0s, x_ref, us_init):
        dtype, device = x0s.dtype, x0s.device
        x_l = x0s.T.contiguous()                      # (S, B)
        u_l = us_init.permute(1, 2, 0)                # (H, m, B)
        x_ref = torch.as_tensor(x_ref, dtype=dtype, device=device)
        xr_l = x_ref.expand((Hh,) + x_ref.shape[-1:])[..., None]  # (H, S, 1)
        e0 = torch.zeros((d,) + x_l.shape[1:], dtype=dtype, device=device)

        for _ in range(sqp_iters):
            xs_prev, xs = rollout(x_l, u_l)
            lin = [ltv(xs_prev[t], u_l[t]) for t in range(Hh)]
            A_seq, B_seq, c_seq = (torch.stack(seq, dim=0)
                                   for seq in zip(*lin))
            # target as tangent errors about the nominal: e_ref_t =
            # local(x_ref, x̄_t) over the H tracked states x_1..x_H
            e_ref = quat_local_lanes(xr_l.expand(xs.shape), xs,
                                     qi=quat_index)
            u_new, _ = solve_box_mpc_riccati_soa_fused(
                A_seq, B_seq, c_seq, problem.Q, problem.QN, problem.R,
                e0, problem.u_min, problem.u_max, x_ref=e_ref,
                iters=qp_iters, use_kernels=use_kernels)
            if sqp_linesearch and sqp_iters > 1:
                best_u = u_l
                best_J = traj_cost(x_l, u_l, xr_l)
                for alpha in (1.0, 0.5, 0.25):
                    u_a = u_l + alpha * (u_new - u_l)
                    J_a = traj_cost(x_l, u_a, xr_l)
                    take = J_a < best_J
                    best_J = torch.where(take, J_a, best_J)
                    best_u = torch.where(take[None, None, :], u_a, best_u)
                u_l = best_u
            else:
                u_l = u_new

        _, xs = rollout(x_l, u_l)
        return u_l.permute(2, 0, 1), xs.permute(2, 0, 1)

    return solve


def make_sat_scenario_mpc_lanes(params: SatelliteParams, problem: MPCProblem,
                                dt: float, qp_iters: int = 8,
                                sqp_iters: int = 2,
                                use_kernels: str = "auto"):
    """The free-base bench configuration's entry point: the satellite
    error-state scenario MPC, lanes end to end."""
    return make_scenario_mpc_lanes(
        sat_step_lanes(params, dt), sat_error_ltv_lanes(params, dt),
        problem, tangent_dim=12, quat_index=3, qp_iters=qp_iters,
        sqp_iters=sqp_iters, use_kernels=use_kernels)
