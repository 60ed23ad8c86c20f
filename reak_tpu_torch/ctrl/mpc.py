"""MPC (port of ``reak_tpu/ctrl/mpc.py``): the batched KTE-MPC
``make_kte_mpc`` and the generic MPC of one scenario, ``solve``.

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

The generic MPC of one scenario (``solve``, ``receding_horizon``): a
nominal rollout of any discrete dynamics F, its LTV linearization
(``torch.func.jacfwd`` under ``torch.func.vmap``, the exponential series of
a continuous f, or a caller's ``linearizer``), then either the batch-first
Riccati PDIP (``method="riccati"``: each stage's Schur solve one K3a or
K3b launch on CUDA tensors) or the condensed QP (``condense``,
``build_qp``, ``ctrl/qp.solve_box_qp``: a dense (H·m)² Cholesky through
``torch.linalg.cholesky_ex``, as the JAX package has it outside any
kernel).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd

from reak_tpu_torch.ctrl.qp import QPResult, solve_box_qp
from reak_tpu_torch.ctrl.riccati import solve_box_mpc_riccati
from reak_tpu_torch.ctrl.riccati_soa import (solve_box_mpc_riccati_soa,
                                             solve_box_mpc_riccati_soa_fused)
from reak_tpu_torch.ctrl.systems import _per_point, linearize_discrete_series
from reak_tpu_torch.kte import lanes, soa
from reak_tpu_torch.math.linalg import solve_pd


class MPCProblem(NamedTuple):
    """Static MPC definition (weights broadcast over the horizon)."""

    Q: torch.Tensor  # (n, n) state stage cost
    R: torch.Tensor  # (m, m) input stage cost
    QN: torch.Tensor  # (n, n) terminal cost
    u_min: torch.Tensor  # (m,)
    u_max: torch.Tensor  # (m,)
    horizon: int


class MPCSolution(NamedTuple):
    u: torch.Tensor  # (H, m) optimal input sequence
    x: torch.Tensor  # (H, n) predicted states under u (linear model)
    qp: QPResult


def solution_status(sol: MPCSolution, gap_tol: float = 1e-6):
    """Status flags of an MPC solution (an ``errors`` bitmask): NONFINITE
    when the plan blew up, NOT_CONVERGED when the PDIP complementarity gap
    is above tolerance."""
    from reak_tpu_torch import errors

    return errors.finite_flag(sol.u, sol.x) | errors.convergence_flag(
        sol.qp.gap, gap_tol)


def rollout_nominal(F: Callable, x0, u_seq):
    """Roll the discrete dynamics under a nominal input sequence (..., H, m)
    → (..., H, n); F takes the leading axes of x0 and u_seq."""
    x, xs = x0, []
    for t in range(u_seq.shape[-2]):
        x = F(x, u_seq[..., t, :])
        xs.append(x)
    return torch.stack(xs, dim=-2)


def linearize_ltv(F: Callable, xs, us):
    """Per-step Jacobians along a trajectory (..., H, ·): A_t, B_t, c_t with
    x_{t+1} = A_t x_t + B_t u_t + c_t (jacfwd under vmap)."""

    def lin(x, u):
        A = jacfwd(lambda xx: F(xx, u))(x)
        B = jacfwd(lambda uu: F(x, uu))(u)
        c = F(x, u) - A @ x - B @ u
        return A, B, c

    return _per_point(lin, xs, us)


def linearize_ltv_series(f_cont: Callable, dt: float, xs, us,
                         order: int = 4):
    """Per-step discrete linearization from the CONTINUOUS dynamics by the
    truncated exponential series (one jacfwd a step instead of AD through
    the RK stages; ``systems.linearize_discrete_series``)."""
    def lin(x, u):
        md = linearize_discrete_series(f_cont, x, u, dt, order)
        return md.A, md.B, md.c

    return _per_point(lin, xs, us)


def condense(A_seq, B_seq, c_seq, x0):
    """Prediction matrices of one scenario:  X = Sx·x0 + Su·U + d, with X
    the stacked x_1..x_H (H·n) and U the stacked u_0..u_{H-1} (H·m)."""
    H, n, m = B_seq.shape[0], A_seq.shape[-1], B_seq.shape[-1]
    dtype, device = A_seq.dtype, A_seq.device
    phi = torch.zeros((n, H * m), dtype=dtype, device=device)
    d = torch.zeros(n, dtype=dtype, device=device)
    P = torch.eye(n, dtype=dtype, device=device)
    phis, ds, Ps = [], [], []
    for t in range(H):
        # x_{t+1} = A x_t + B u_t + c, with x_t = phi·U + (Sx row)·x0 + d
        phi = A_seq[t] @ phi
        phi = torch.cat([phi[:, :t * m], B_seq[t], phi[:, (t + 1) * m:]],
                        dim=1)
        d = A_seq[t] @ d + c_seq[t]
        P = A_seq[t] @ P  # Phi_t = A_t···A_0
        phis.append(phi)
        ds.append(d)
        Ps.append(P)
    Su = torch.stack(phis).reshape(H * n, H * m)
    Sx = torch.stack(Ps).reshape(H * n, n)
    return Sx, Su, torch.stack(ds).reshape(H * n)


def build_qp(problem: MPCProblem, Sx, Su, d, x0, x_ref=None, u_ref=None):
    """Condensed QP data:  min ½UᵀH_qp U + gᵀU  with box bounds, where
    H_qp = SuᵀQ̄Su + R̄,  g = SuᵀQ̄(Sx x0 + d − Xref) − R̄·Uref and
    Q̄ = blockdiag(Q, …, Q, QN)."""
    H, n, m = problem.horizon, problem.Q.shape[-1], problem.R.shape[-1]
    free = Sx @ x0 + d  # (H·n,) free response
    if x_ref is not None:
        free = free - x_ref.reshape(H * n)

    def apply_Qbar(X):  # (H·n, k) → (H·n, k)
        Xs = X.reshape(H, n, -1)
        QX = torch.cat([problem.Q @ Xs[:-1], problem.QN @ Xs[-1:]])
        return QX.reshape(H * n, -1)

    Rbar = torch.kron(torch.eye(H, dtype=Su.dtype, device=Su.device),
                      problem.R)
    H_qp = Su.T @ apply_Qbar(Su) + Rbar
    g = Su.T @ apply_Qbar(free[:, None])[:, 0]
    if u_ref is not None:
        g = g - Rbar @ u_ref.reshape(H * m)
    return H_qp, g


def solve(F: Callable, problem: MPCProblem, x0, u_init=None, x_ref=None,
          u_ref=None, qp_iters: int = 15, sqp_iters: int = 1,
          constrained: bool = True, f_cont: Optional[Callable] = None,
          dt: Optional[float] = None, linearizer: Optional[Callable] = None,
          method: str = "riccati") -> MPCSolution:
    """One MPC solve of one scenario x0 (n,): linearize about a nominal,
    then the QP.

    ``sqp_iters > 1`` re-linearizes about the previous solution.  The LTV
    model comes from ``linearizer(xs_prev, u) → (A, B, c)`` when given,
    else from the continuous ``f_cont`` by the exponential series with step
    ``dt`` when given, else from jacfwd of F.

    ``method``:
      - "riccati" (default, with ``constrained``): the batch-first Riccati
        interior point (``ctrl/riccati.solve_box_mpc_riccati``),
        O(H·(n+m)³); on CUDA tensors each stage's Schur solve is one K3a or
        K3b launch.
      - "condensed" (or ``constrained=False``): the dense condensed QP,
        prediction matrices and the PDIP with an (H·m)² Cholesky, or the
        unconstrained solve −H_qp⁻¹g."""
    Hh, m = problem.horizon, problem.R.shape[-1]
    n = problem.Q.shape[-1]
    dtype, device = x0.dtype, x0.device
    u = (torch.zeros((Hh, m), dtype=dtype, device=device) if u_init is None
         else u_init)
    lb = problem.u_min.repeat(Hh)
    ub = problem.u_max.repeat(Hh)

    qp_res = None
    for _ in range(sqp_iters):
        xs = rollout_nominal(F, x0, u)
        xs_prev = torch.cat([x0[None], xs[:-1]], dim=0)
        if linearizer is not None:
            A_seq, B_seq, c_seq = linearizer(xs_prev, u)
        elif f_cont is not None:
            A_seq, B_seq, c_seq = linearize_ltv_series(f_cont, dt, xs_prev, u)
        else:
            A_seq, B_seq, c_seq = linearize_ltv(F, xs_prev, u)

        if method == "riccati" and constrained:
            u, xs_pred = solve_box_mpc_riccati(
                A_seq, B_seq, c_seq, problem.Q, problem.QN, problem.R, x0,
                problem.u_min, problem.u_max, x_ref=x_ref, u_ref=u_ref,
                iters=qp_iters)
            qp_res = QPResult(x=u.reshape(-1), iters=torch.tensor(qp_iters),
                              gap=torch.zeros((), dtype=dtype, device=device))
        else:
            Sx, Su, d = condense(A_seq, B_seq, c_seq, x0)
            H_qp, g = build_qp(problem, Sx, Su, d, x0, x_ref, u_ref)
            if constrained:
                qp_res = solve_box_qp(H_qp, g, lb, ub, iters=qp_iters)
            else:
                qp_res = QPResult(x=-solve_pd(H_qp, g), iters=torch.tensor(0),
                                  gap=torch.zeros((), dtype=dtype,
                                                  device=device))
            u = qp_res.x.reshape(Hh, m)
            xs_pred = (Sx @ x0 + Su @ qp_res.x + d).reshape(Hh, n)

    return MPCSolution(u=u, x=xs_pred, qp=qp_res)


def receding_horizon(F, problem, x0, n_steps, **kw):
    """Closed-loop MPC: apply the first input, advance the plant F, shift
    the warm start, repeat (a Python loop where the JAX package scans).
    Returns (states (n_steps, n), inputs (n_steps, m))."""
    m = problem.R.shape[-1]
    x = x0
    u_warm = torch.zeros((problem.horizon, m), dtype=x0.dtype,
                         device=x0.device)
    xs, us = [], []
    for _ in range(n_steps):
        sol = solve(F, problem, x, u_init=u_warm, **kw)
        u0 = sol.u[0]
        x = F(x, u0)
        u_warm = torch.cat([sol.u[1:], sol.u[-1:]], dim=0)
        xs.append(x)
        us.append(u0)
    return torch.stack(xs), torch.stack(us)


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
