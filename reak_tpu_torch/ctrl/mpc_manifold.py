"""Error-state (retraction-based) MPC on manifold state spaces (port of
``reak_tpu/ctrl/mpc_manifold.py``).

The reference's config-4 composition — the invariant satellite systems
(ref: ss_systems/satellite_invar_models.hpp:296), Gaussian belief sampling
(ref: ctrl_sys/gaussian_belief_state.hpp:491) and the belief predictor
(ref: ctrl_sys/belief_state_predictor.hpp:79) — as one pipeline:

    IEKF posterior belief  →  tangent-space scenario sampling
    →  error-state LTV linearization along each scenario's nominal rollout
    →  batched Riccati interior-point box QP

The QP decision stays the absolute input sequence while the state is the
tangent error e_t = local(x_t, x̄_t) about the nominal rollout x̄; along its
own nominal the error dynamics are e_{t+1} = A_t e_t + B_t (u_t − ū_t),
e_0 = 0, so c_t = −B_t ū_t and the LTV solver applies unchanged.

Batch first: ``solve_manifold`` and ``make_scenario_mpc`` take leading
batch axes on x0 (and the warm start), where the JAX package vmaps a
single-scenario solve.  The discrete dynamics F and the retraction are
functions of ONE state, run under ``torch.func.vmap`` over the batch (and
the horizon, for the jacfwd linearization); the QP is
``ctrl/riccati.solve_box_mpc_riccati`` over the whole batch, so on CUDA
tensors each Riccati stage is one K3a or K3b launch for every scenario.
Random draws take an explicit ``torch.Generator`` where JAX takes a key;
``_retract_draws`` maps standard-normal draws to states, apart from the
draw.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.ctrl.invariant import Retraction
from reak_tpu_torch.ctrl.mpc import MPCProblem, rollout_nominal
from reak_tpu_torch.ctrl.riccati import solve_box_mpc_riccati
from reak_tpu_torch.ctrl.systems import _per_point
from reak_tpu_torch.math.linalg import _cholesky


class ManifoldMPCSolution(NamedTuple):
    u: torch.Tensor   # (..., H, m) absolute optimal inputs
    x: torch.Tensor   # (..., H, n_state) predicted manifold states
    e: torch.Tensor   # (..., H, d) predicted tangent errors about the nominal


def rollout_manifold(F: Callable, x0, u_seq):
    """Nominal rollout of the manifold-respecting discrete dynamics F (a
    function of one state, vmapped over the leading axes of x0) — x_1..x_H
    stacked (..., H, n_state)."""
    lead = x0.shape[:-1]
    xs = rollout_nominal(vmap(F), x0.reshape(-1, x0.shape[-1]),
                         u_seq.reshape((-1,) + u_seq.shape[-2:]))
    return xs.reshape(lead + xs.shape[1:])


def linearize_ltv_manifold(F: Callable, ret: Retraction, xs_prev, us,
                           xs_next):
    """Tangent-space LTV models along nominal trajectories (..., H, ·):

        A_t = ∂/∂e  local(F(retract(x̄_t, e), ū_t), x̄_{t+1}) |_{e=0}
        B_t = ∂/∂δu local(F(x̄_t, ū_t + δu),      x̄_{t+1}) |_{δu=0}

    ``torch.func.vmap(torch.func.jacfwd(…))`` over every (scenario, step).
    Returns (A (..., H, d, d), B (..., H, d, m))."""
    d = ret.dim

    def lin(xp, u, xn):
        zero_e = torch.zeros(d, dtype=xp.dtype, device=xp.device)
        A = jacfwd(lambda e: ret.local(F(ret.retract(xp, e), u), xn))(zero_e)
        B = jacfwd(lambda du: ret.local(F(xp, u + du), xn))(
            torch.zeros_like(u))
        return A, B

    return _per_point(lin, xs_prev, us, xs_next)


def solve_manifold(F: Callable, ret: Retraction, problem: MPCProblem, x0,
                   x_ref, u_init=None, u_ref=None, qp_iters: int = 8,
                   sqp_iters: int = 2,
                   linearizer=None) -> ManifoldMPCSolution:
    """Error-state MPC solves tracking a manifold target, batch first.

    ``x0``: (..., n_state), one state or a batch.  ``problem.Q/QN`` are
    (d, d) tangent-space weights (d = ret.dim).  ``x_ref``: the target, one
    (n_state,) point or an (H, n_state) trajectory, or (..., H, n_state)
    per scenario.
    ``u_init``: (..., H, m) warm start (zeros when None).  ``linearizer``:
    an optional analytic tangent-space LTV ``(xs_prev, us) → (A, B, c)`` on
    (..., H, ·) (e.g. ``ctrl.systems.kte_manifold_ltv_linearizer``)."""
    Hh, m = problem.horizon, problem.R.shape[-1]
    lead = x0.shape[:-1]
    dtype, device = x0.dtype, x0.device
    u = (torch.zeros(lead + (Hh, m), dtype=dtype, device=device)
         if u_init is None else u_init)
    x_ref = torch.as_tensor(x_ref, dtype=dtype, device=device)
    if x_ref.ndim == 1:
        x_ref = x_ref[None]
    x_ref_b = x_ref.expand(lead + (Hh, x0.shape[-1]))
    e0 = torch.zeros(lead + (ret.dim,), dtype=dtype, device=device)

    es = None
    for _ in range(sqp_iters):
        xs = rollout_manifold(F, x0, u)                         # x_1..x_H
        xs_prev = torch.cat([x0[..., None, :], xs[..., :-1, :]], dim=-2)
        if linearizer is not None:
            A_seq, B_seq, c_seq = linearizer(xs_prev, u)
        else:
            A_seq, B_seq = linearize_ltv_manifold(F, ret, xs_prev, u, xs)
            # the decision variable is the ABSOLUTE input: c_t = −B_t ū_t
            # keeps the nominal (e ≡ 0 at u = ū) consistent with the box
            c_seq = -(B_seq @ u[..., None])[..., 0]
        # the target as tangent errors about the nominal
        e_ref = ret.local(x_ref_b, xs)                          # (..., H, d)
        u, es = solve_box_mpc_riccati(
            A_seq, B_seq, c_seq, problem.Q, problem.QN, problem.R, e0,
            problem.u_min, problem.u_max, x_ref=e_ref, u_ref=u_ref,
            iters=qp_iters)

    return ManifoldMPCSolution(u=u, x=rollout_manifold(F, x0, u), e=es)


def make_scenario_mpc(F: Callable, ret: Retraction, problem: MPCProblem,
                      qp_iters: int = 8, sqp_iters: int = 2):
    """Batched scenario solver: ``solve(x0s (B, n), x_ref, us_init (B, H, m))
    → (us (B, H, m), xs (B, H, n))`` — one batch-first ``solve_manifold``
    over all the scenarios."""

    def solve(x0s, x_ref, us_init):
        sol = solve_manifold(F, ret, problem, x0s, x_ref, u_init=us_init,
                             qp_iters=qp_iters, sqp_iters=sqp_iters)
        return sol.u, sol.x

    return solve


def make_kte_scenario_mpc(spec, problem: MPCProblem, dt: float,
                          actuated=None, qp_iters: int = 8,
                          sqp_iters: int = 2, use_kernels: str = "auto"):
    """Scenario MPC for ANY KTE chain, routed as the JAX package routes it:

    * a free base (quaternion) → the lanes error-state SQP
      (``kte/lanes.make_kte_manifold_lanes`` +
      ``ctrl/manifold_lanes.make_scenario_mpc_lanes``, ``use_kernels``
      passed on);
    * a fixed base → the flagship solver ``ctrl/mpc.make_kte_mpc``
      (tracking ``x_ref``).

    Both return ``solve(x0s (B, n_state), x_ref, us_init (B, H, m))``."""
    if spec.has_free_base:
        from reak_tpu_torch.ctrl.manifold_lanes import make_scenario_mpc_lanes
        from reak_tpu_torch.kte.lanes import make_kte_manifold_lanes

        step, ltv = make_kte_manifold_lanes(spec, dt, actuated=actuated)
        return make_scenario_mpc_lanes(
            step, ltv, problem, tangent_dim=2 * spec.nv, quat_index=3,
            qp_iters=qp_iters, sqp_iters=sqp_iters, use_kernels=use_kernels)

    from reak_tpu_torch.ctrl.mpc import make_kte_mpc

    solver = make_kte_mpc(spec, problem, dt, qp_iters=qp_iters,
                          sqp_iters=sqp_iters)

    def solve(x0s, x_ref, us_init):
        return solver(x0s, us_init, x_ref=x_ref)

    return solve


def _retract_draws(belief: GaussianBelief, z, ret: Optional[Retraction]):
    """Standard-normal draws z (n, dim) → n states of the belief: e = L z
    with L the Cholesky factor of the covariance (+1e-12 I), then
    ``ret.retract(mean, e)`` (``mean + e`` without a retraction)."""
    dim = z.shape[-1]
    L = _cholesky(
        belief.cov + 1e-12 * torch.eye(dim, dtype=belief.cov.dtype,
                                       device=belief.cov.device))
    e = z @ L.T
    if ret is None:
        return belief.mean + e
    return ret.retract(belief.mean, e)


def sample_belief_states(generator: torch.Generator, belief: GaussianBelief,
                         n: int, ret: Optional[Retraction] = None):
    """Draw n initial-state scenarios (n, n_state) from a (possibly
    manifold) belief.

    With a retraction the covariance lives in the tangent space (the IEKF
    posterior convention) and the draws are retracted onto the manifold, so
    quaternions stay unit (ref: gaussian_belief_state.hpp:491 samples in
    ambient coordinates).  The draws come from ``generator``, which must be
    on the belief's device; the JAX package's per-scenario ``fold_in``
    stream is not reproduced."""
    dim = ret.dim if ret is not None else belief.mean.shape[-1]
    z = torch.randn((n, dim), generator=generator, dtype=belief.mean.dtype,
                    device=belief.mean.device)
    return _retract_draws(belief, z, ret)


def belief_scenario_mpc(generator: torch.Generator, F: Callable,
                        ret: Retraction, problem: MPCProblem,
                        belief: GaussianBelief, n_scenarios: int, x_ref,
                        qp_iters: int = 8, sqp_iters: int = 2):
    """The config-4 composition in one call: draw ``n_scenarios`` initial
    states from the belief, solve the error-state MPC of all of them at
    once, and return (x0s, us, xs)."""
    x0s = sample_belief_states(generator, belief, n_scenarios, ret)
    us0 = torch.zeros((n_scenarios, problem.horizon, problem.R.shape[-1]),
                      dtype=belief.mean.dtype, device=belief.mean.device)
    us, xs = make_scenario_mpc(F, ret, problem, qp_iters, sqp_iters)(
        x0s, x_ref, us0)
    return x0s, us, xs
