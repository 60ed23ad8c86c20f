"""RRG — Rapidly-exploring Random Graph (port of
``reak_tpu/planning/rrg.py``).

(ref: ctrl/graph_alg/rr_graph.hpp:254 generate_rrg)

RRT-style steering toward uniform samples, but every new vertex also connects
to *all* collision-free neighbors inside the shrinking RRT* ball, producing a
graph (not a tree) whose shortest paths converge to optimal.  Split: the
sample→nearest→steer→edge-check pipeline runs as device batches; the ball's
neighbour edges are checked a vertex at a time and the final shortest path
is host A* (planning.graph_search.astar), as in the JAX package.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from reak_tpu_torch.planning.draws import as_draws, space_like
from reak_tpu_torch.planning.graph_search import astar
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult


def rrg_plan(workspace, query: PlanningQuery, max_iters: int = 300,
             batch: int = 16, step_size: float = 0.5, gamma: float = 2.0,
             goal_bias: float = 0.1, goal_tol: float = 0.3,
             seed=0) -> PlanResult:
    space = workspace.space
    device, dtype = space_like(space)
    start = np.asarray(query.start, np.float64)
    goal = np.asarray(query.goal, np.float64)
    n = start.shape[-1]
    t0 = time.perf_counter()
    draws = as_draws(seed, device)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    goal_t = as_t(goal)

    verts = [start]
    edges, costs = [], []

    def wave(V, cnt):
        """One batched expansion wave: sample `batch` targets, steer from the
        nearest existing vertex, return candidate new points."""
        samp = draws.sample(space, (batch,))
        use_goal = draws.uniform((batch,), V) < goal_bias
        samp = torch.where(use_goal[:, None], goal_t[None, :], samp)
        mask = torch.arange(V.shape[0], device=device) < cnt
        d = torch.where(mask, space.distance(samp[:, None, :], V[None]),
                        torch.inf)
        ni = torch.argmin(d, dim=1)
        near = V[ni]
        dd = torch.clamp_min(d[torch.arange(batch, device=device), ni], 1e-12)
        t = torch.clamp_max(step_size / dd, 1.0)
        new = space.clamp(near + t[:, None] * (samp - near))
        ok = workspace.edge_free_batch(near, new)
        return new, ni, ok

    cap = max_iters * batch + 1
    V = np.zeros((cap, n))
    V[0] = start
    cnt = 1
    goal_idx = -1

    for it in range(max_iters):
        new, ni, ok = wave(as_t(V), cnt)
        new, ni, ok = new.cpu().numpy(), ni.cpu().numpy(), ok.cpu().numpy()
        # RRT* ball radius shrinks with graph size
        r = min(gamma * (np.log(cnt + 1) / (cnt + 1)) ** (1.0 / n), step_size * 2)
        for b in range(batch):
            if not ok[b]:
                continue
            vi = cnt
            V[vi] = new[b]
            cnt += 1
            # neighbor set within ball (batched distance on device)
            d = space.distance(as_t(new[b]), as_t(V[:vi])).cpu().numpy()
            nbrs = np.nonzero(d <= max(r, float(d[ni[b]]) + 1e-12))[0]
            if nbrs.size:
                A = as_t(np.repeat(new[b][None, :], nbrs.size, 0))
                B = as_t(V[nbrs])
                free = workspace.edge_free_batch(A, B).cpu().numpy()
                for u, okk in zip(nbrs, free):
                    if okk:
                        edges.append((int(u), vi))
                        costs.append(float(d[u]))
            if float(space.distance(as_t(new[b]), goal_t)) < goal_tol:
                goal_idx = vi
        if goal_idx >= 0 and it > max_iters // 4:
            break

    fail = lambda: PlanResult(success=False, path=None, cost=float("inf"),
                              n_vertices=cnt, n_iterations=max_iters,
                              wall_time_s=time.perf_counter() - t0)
    if goal_idx < 0:
        return fail()
    hgoal = space.distance(as_t(V[:cnt]), goal_t).cpu().numpy()
    path_idx, cost = astar(cnt, np.asarray(edges, np.int64),
                           np.asarray(costs), 0, goal_idx,
                           heuristic=lambda v: float(hgoal[v]))
    if path_idx is None:
        return fail()
    return PlanResult(success=True, path=V[path_idx], cost=cost,
                      n_vertices=cnt, n_iterations=max_iters,
                      wall_time_s=time.perf_counter() - t0)
