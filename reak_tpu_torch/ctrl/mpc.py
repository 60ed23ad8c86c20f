"""Batched KTE-MPC (port of the lanes branch of ``reak_tpu/ctrl/mpc.py``).

One solve: the lanes rollout + LTV linearization of a fixed-base chain
(kte/lanes.py), then the box-constrained Riccati interior-point QP
(ctrl/riccati_soa.py).  On CUDA tensors both phases run as hand-written
kernels (ops/kte_step.py, ops/pdip_whole.py); on CPU tensors they run as the
plain torch versions of those kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused
from reak_tpu_torch.kte import lanes


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
      - "lanes": always the plain lanes rollout.
    The QP always takes ``solve_box_mpc_riccati_soa_fused`` with its "auto"
    dispatch: the whole-solve kernel for CUDA tensors, the plain scan for CPU.

    Not ported yet: ``sqp_iters > 1`` (its SQP line search prices candidates
    with an RK4 rollout that needs the batched Cholesky kernel of
    ``ops/chol_lanes.py``), ``qp_layout="vmap"`` and ``rollout="register"``.
    ``sqp_linesearch`` only matters when ``sqp_iters > 1``.
    """
    if sqp_iters != 1:
        raise NotImplementedError(
            "sqp_iters > 1 needs the SQP line search, which comes with the "
            "port of the chol_lanes kernel")
    if qp_layout != "lanes":
        raise NotImplementedError(f"qp_layout={qp_layout!r} is not ported")
    if rollout not in ("auto", "fused", "lanes"):
        raise NotImplementedError(f"rollout={rollout!r} is not ported")
    H = problem.horizon
    n = 2 * spec.nv
    m = problem.R.shape[-1]
    roll_fused = lanes.make_rollout_ltv_fullfused(spec, dt, H)
    roll_lanes = lanes.make_rollout_ltv_lanes(spec, dt, H)

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
        A_l, B_l, c_l, _ = pick_roll(x0s)(x0s, us_init)
        ul, xl = solve_box_mpc_riccati_soa_fused(
            A_l, B_l, c_l, problem.Q, problem.QN, problem.R,
            x0s.T.contiguous(), problem.u_min, problem.u_max, iters=qp_iters,
            x_ref=xr_l, u_ref=ur_l,
        )
        return ul.permute(2, 0, 1), xl.permute(2, 0, 1)

    return solve
