"""SBA*-RRT* hybrid — anytime optimizing planner (port of
``reak_tpu/planning/sbastar_rrtstar.py``).

(ref: ctrl/graph_alg/sbastar_rrtstar.hpp generate_sbarrtstar — the reference's
flagship anytime planner: SBA* best-key density-guided expansion interleaved
with RRT* random exploration, all connections through the optimal
choose-parent + rewire machinery.)

Every iteration draws ONE mixed K-sample wave — half uniform/goal-biased (the
RRT* exploration share), half Gaussian around the current best-key SBA* front
(key = (g + h)·(1 + α·density), density as a batched KDE over the vertex
set) — and pushes the whole wave through the batched RRT* choose-parent/rewire
step (planning/rrt_star._make_star_step), so every accepted vertex is
asymptotically-optimally wired regardless of which strategy proposed it.

Returns an anytime cost history so callers (and tests) can check that the
hybrid's cost curve dominates both plain SBA* and plain RRT*.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from reak_tpu_torch.planning.draws import as_draws
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult
from reak_tpu_torch.planning.rrt import _endpoints, _path_cost, _trace
from reak_tpu_torch.planning.rrt_star import (_StarState, _make_star_step,
                                              _new_star)


def sbastar_rrtstar_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 150,
    step_size: float = 0.5,
    gamma: float = 3.0,
    goal_bias: float = 0.05,
    front_size: int = 8,
    density_bw: float = 0.4,
    sba_share: float = 0.5,
    capacity: int = 4096,
    seed=0,
    K: int = 32,
    return_history: bool = False,
):
    """Anytime hybrid plan.  With ``return_history=True`` also returns the
    per-iteration best goal-connected cost (inf before the first solution)."""
    space, device, start, goal = _endpoints(workspace, query)
    n = start.shape[-1]
    n_sba = max(1, int(K * sba_share))
    draws = as_draws(seed, device)

    def sba_sampler(state: _StarState, goal_, draws_):
        """Mixed wave: [SBA* local samples | uniform | goal bias]."""
        cap = state.verts.shape[0]
        vmask = torch.arange(cap, device=device) < state.count
        h = space.distance(state.verts, goal_.expand_as(state.verts))
        # batched KDE density over the current graph (the SBA* constriction
        # term, density_calculators.hpp)
        d2 = torch.sum(
            (state.verts[:, None, :] - state.verts[None, :, :]) ** 2, dim=-1
        )
        dens = torch.sum(
            torch.where(vmask[None, :],
                        torch.exp(-d2 / (2 * density_bw**2)), 0.0),
            dim=-1,
        )
        keys_ = torch.where(
            vmask & torch.isfinite(state.costs),
            (state.costs + h) * (1.0 + 0.25 * dens),
            torch.inf,
        )
        front = torch.argsort(keys_, stable=True)[:front_size]
        pick = draws_.randint(0, front_size, (n_sba,), device)
        centers = state.verts[front[pick]]
        local = space.clamp(
            centers + step_size * draws_.normal((n_sba, n), centers)
        )
        uni = draws_.sample(space, (K - n_sba,)).clone()
        uni[:max(1, int(K * goal_bias))] = goal_
        return torch.cat([local, uni], dim=0)

    state = _new_star(start, capacity)
    step = _make_star_step(space, workspace, step_size, gamma, goal_bias,
                           K=K, sampler=sba_sampler)

    def best_goal_cost(st: _StarState):
        vmask = torch.arange(capacity, device=device) < st.count
        dg = space.distance(st.verts, goal.expand_as(st.verts))
        ok = vmask & (dg <= query.goal_tolerance) & torch.isfinite(st.costs)
        return torch.amin(torch.where(ok, st.costs + dg, torch.inf))

    t0 = time.perf_counter()
    history = np.full(max_iters, np.inf)
    for it in range(max_iters):
        state = step(state, goal, draws)
        history[it] = float(best_goal_cost(state))

    verts = state.verts.cpu().numpy()
    costs = state.costs.cpu().numpy()
    parents = state.parents.cpu().numpy()
    cnt = int(state.count)
    d_goal = space.distance(state.verts[:cnt],
                            goal.expand(cnt, n)).cpu().numpy()
    near_goal = (d_goal <= query.goal_tolerance) & np.isfinite(costs[:cnt])
    wall = time.perf_counter() - t0
    if not near_goal.any():
        res = PlanResult(False, None, float("inf"), cnt, max_iters, wall)
        return (res, history) if return_history else res
    cand = np.where(near_goal)[0]
    gi = cand[np.argmin(costs[cand] + d_goal[cand])]
    path = _trace(query.goal, verts, parents, gi)
    res = PlanResult(True, path, _path_cost(space, path), cnt, max_iters,
                     wall)
    return (res, history) if return_history else res
