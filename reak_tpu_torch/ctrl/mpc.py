"""Batched KTE-MPC (port of ``make_kte_mpc`` of ``reak_tpu/ctrl/mpc.py``).

The lanes branch, the default: one SQP pass is the lanes rollout + LTV
linearization of a fixed-base chain (kte/lanes.py), then the
box-constrained Riccati interior-point QP (ctrl/riccati_soa.py); with
several passes, a per-scenario line search on the true RK4 cost
(kte/lanes.make_rollout_lanes).  On CUDA tensors every phase runs through
hand-written kernels (ops/kte_step.py, ops/pdip_whole.py,
ops/chol_lanes.py); on CPU tensors through their plain torch versions.

The second branch (``qp_layout="vmap"``, or ``rollout="register"``) is the
JAX package's cross-check: the batch-first lanes rollout or the
register-form one (kte/soa.py), then the batch-first Riccati PDIP
(ctrl/riccati.py, its Schur solves on K3a/K3b on CUDA tensors) or the
unfused lanes PDIP (ctrl/riccati_soa.solve_box_mpc_riccati_soa, on K3b).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reak_tpu_torch.ctrl.riccati import solve_box_mpc_riccati
from reak_tpu_torch.ctrl.riccati_soa import (solve_box_mpc_riccati_soa,
                                             solve_box_mpc_riccati_soa_fused)
from reak_tpu_torch.kte import lanes, soa


class MPCProblem(NamedTuple):
    """Static MPC definition (weights broadcast over the horizon)."""

    Q: torch.Tensor  # (n, n) state stage cost
    R: torch.Tensor  # (m, m) input stage cost
    QN: torch.Tensor  # (n, n) terminal cost
    u_min: torch.Tensor  # (m,)
    u_max: torch.Tensor  # (m,)
    horizon: int


def to_lanes(ref, width: int, horizon: int, dtype, device):
    """(width,) | (H, width) | (B, H, width) reference → lanes (H, width, 1|B).

    Raises ``ValueError`` when the trailing width or the horizon does not
    match (the JAX package's ``to_lanes`` checks neither: fault F4)."""
    if ref is None:
        return None
    ref = torch.as_tensor(ref, dtype=dtype, device=device)
    if ref.ndim not in (1, 2, 3) or ref.shape[-1] != width:
        raise ValueError(
            f"reference of shape {tuple(ref.shape)}: expected (..., {width})")
    if ref.ndim >= 2 and ref.shape[-2] != horizon:
        raise ValueError(
            f"reference of shape {tuple(ref.shape)}: expected horizon "
            f"{horizon} on axis -2")
    if ref.ndim == 1:
        return ref[None, :, None].expand(horizon, width, 1)
    if ref.ndim == 2:
        return ref[..., None]  # (H, w, 1)
    return ref.permute(1, 2, 0)  # (H, w, B)


def make_traj_cost(spec, problem: MPCProblem, dt: float):
    """``cost(x0s (B, n), ul (H, m, B), xr_l, ur_l) → (B,)``: the true
    nonlinear trajectory cost of an input sequence, an RK4 rollout
    (kte/lanes.make_rollout_lanes) priced with the problem's quadratic stage
    costs; a non-finite cost becomes +inf.  ``xr_l``/``ur_l`` are lanes
    references (H, w, 1|B) or None."""
    roll = lanes.make_rollout_lanes(spec, dt)
    weights = {}  # (dtype, device) → Q, QN, R, made once

    def cost(x0s, ul, xr_l=None, ur_l=None):
        xs = roll(x0s, ul)                                  # (H, n, B)
        dx = xs if xr_l is None else xs - xr_l
        du = ul if ur_l is None else ul - ur_l
        key = (xs.dtype, xs.device)
        if key not in weights:
            weights[key] = tuple(
                torch.as_tensor(a, dtype=xs.dtype, device=xs.device)
                for a in (problem.Q, problem.QN, problem.R))
        Q, QN, R = weights[key]
        qx = torch.einsum("hib,ij,hjb->b", dx[:-1], Q, dx[:-1])
        qn = torch.einsum("ib,ij,jb->b", dx[-1], QN, dx[-1])
        ru = torch.einsum("hib,ij,hjb->b", du, R, du)
        c = 0.5 * (qx + qn + ru)
        return torch.where(torch.isfinite(c), c, torch.full_like(c, math.inf))

    return cost, roll


def make_kte_mpc(spec, problem: MPCProblem, dt: float, qp_iters: int = 8,
                 sqp_iters: int = 1, qp_layout: str = "lanes",
                 rollout: str = "auto", sqp_linesearch: bool = True):
    """Batched MPC solver for a fixed-base KTE chain.

    Returns ``solve(x0s (B, 2nv), us_init (B, H, m), x_ref=None, u_ref=None)
    → (us (B, H, m), xs (B, H, 2nv))``, the contract of the JAX package's
    ``make_kte_mpc``.  ``x_ref``/``u_ref`` are (w,), (H, w) or (B, H, w).

    ``rollout``:
      - "auto" (default): the rollout-step kernel for CUDA tensors, the plain
        lanes rollout for CPU tensors;
      - "fused": always through the kernel's wrapper (plain on CPU tensors);
      - "lanes": always the plain lanes rollout;
      - "register": the register-form rollout (``kte/soa.py``), a
        cross-check.
    ``qp_layout``:
      - "lanes" (default): the QP is ``solve_box_mpc_riccati_soa_fused`` with
        its "auto" dispatch: the whole-solve kernel for CUDA tensors, the
        plain scan for CPU;
      - "vmap": the batch-first PDIP ``ctrl/riccati.solve_box_mpc_riccati``,
        a cross-check.

    With ``qp_layout="lanes"`` and ``rollout`` "auto", "fused" or "lanes"
    (the lanes branch): ``sqp_linesearch`` (only with ``sqp_iters > 1``):
    after each QP, per scenario, the steps α ∈ {1, ½, ¼} from the previous
    inputs towards the QP's are priced by their true RK4 cost
    (``make_traj_cost``); the cheapest is taken if it is strictly below the
    previous inputs' cost (ties keep the earlier candidate), else the
    previous inputs are kept — so the true cost never rises.  The returned
    xs is then the RK4 trajectory of the accepted inputs, not the QP model's
    prediction.  Without it each pass takes the full QP step.

    Any other combination takes the JAX package's second branch:
    ``solve(x0s, us_init)`` with no references; the rollout is the
    batch-first lanes one (``kte/lanes.make_rollout_ltv_batchfirst``) for
    ``rollout="lanes"``, else the register form; the QP is
    ``solve_box_mpc_riccati`` for ``qp_layout="vmap"``, else the unfused
    ``solve_box_mpc_riccati_soa`` on the rollout moved to lanes.  Every pass
    takes the full QP step (no line search, whatever ``sqp_linesearch``
    says), and xs is the QP model's trajectory.
    """
    if sqp_iters < 1:
        raise ValueError(f"sqp_iters={sqp_iters}: expected at least 1")
    if qp_layout not in ("lanes", "vmap"):
        raise ValueError(f"qp_layout={qp_layout!r}: expected 'lanes' or "
                         "'vmap'")
    if rollout not in ("auto", "fused", "lanes", "register"):
        raise ValueError(f"rollout={rollout!r}: expected 'auto', 'fused', "
                         "'lanes' or 'register'")
    if qp_layout != "lanes" or rollout == "register":
        return _make_cross_check_mpc(spec, problem, dt, qp_iters, sqp_iters,
                                     qp_layout, rollout)
    H = problem.horizon
    n = 2 * spec.nv
    m = problem.R.shape[-1]
    roll_fused = lanes.make_rollout_ltv_fullfused(spec, dt, H)
    roll_lanes = lanes.make_rollout_ltv_lanes(spec, dt, H)
    linesearch = sqp_linesearch and sqp_iters > 1
    if linesearch:
        traj_cost, roll_nom = make_traj_cost(spec, problem, dt)

    def pick_roll(x0s):
        if rollout == "lanes":
            return roll_lanes
        if rollout == "fused" or x0s.is_cuda:
            return roll_fused
        return roll_lanes

    def solve(x0s, us_init, x_ref=None, u_ref=None):
        dtype, device = x0s.dtype, x0s.device
        xr_l = to_lanes(x_ref, n, H, dtype, device)
        ur_l = to_lanes(u_ref, m, H, dtype, device)
        roll = pick_roll(x0s)
        x0_l = x0s.T.contiguous()
        us = us_init  # (B, H, m)
        for _ in range(sqp_iters):
            A_l, B_l, c_l, _ = roll(x0s, us)
            ul, xl = solve_box_mpc_riccati_soa_fused(
                A_l, B_l, c_l, problem.Q, problem.QN, problem.R, x0_l,
                problem.u_min, problem.u_max, iters=qp_iters,
                x_ref=xr_l, u_ref=ur_l,
            )
            if linesearch:
                u_prev = us.permute(1, 2, 0)  # (H, m, B)
                best_u = u_prev
                best_J = traj_cost(x0s, u_prev, xr_l, ur_l)
                for alpha in (1.0, 0.5, 0.25):
                    u_a = u_prev + alpha * (ul - u_prev)
                    J_a = traj_cost(x0s, u_a, xr_l, ur_l)
                    take = J_a < best_J
                    best_J = torch.where(take, J_a, best_J)
                    best_u = torch.where(take[None, None, :], u_a, best_u)
                ul = best_u
                xl = roll_nom(x0s, ul)  # the true trajectory of the choice
            us = ul.permute(2, 0, 1)
        return us, xl.permute(2, 0, 1)

    return solve


def _make_cross_check_mpc(spec, problem: MPCProblem, dt: float,
                          qp_iters: int, sqp_iters: int, qp_layout: str,
                          rollout: str):
    """The second branch of the JAX package's ``make_kte_mpc``
    (``reak_tpu/ctrl/mpc.py:373-397``): ``solve(x0s, us_init) → (us, xs)``,
    batch first (see ``make_kte_mpc``)."""
    H = problem.horizon
    roll = (lanes.make_rollout_ltv_batchfirst(spec, dt, H)
            if rollout == "lanes" else soa.make_rollout_ltv_soa(spec, dt, H))
    lanes_of = lambda a: torch.movedim(a, 0, -1)  # (B, ...) → (..., B)
    batch_of = lambda a: torch.movedim(a, -1, 0)

    def solve(x0s, us_init):
        us = us_init
        for _ in range(sqp_iters):
            A_seq, B_seq, c_seq, _ = roll(x0s, us)
            if qp_layout == "lanes":
                ul, xl = solve_box_mpc_riccati_soa(
                    lanes_of(A_seq), lanes_of(B_seq), lanes_of(c_seq),
                    problem.Q, problem.QN, problem.R, x0s.T, problem.u_min,
                    problem.u_max, iters=qp_iters)
                us, xs = batch_of(ul), batch_of(xl)
            else:
                us, xs = solve_box_mpc_riccati(
                    A_seq, B_seq, c_seq, problem.Q, problem.QN, problem.R,
                    x0s, problem.u_min, problem.u_max, iters=qp_iters)
        return us, xs

    return solve
