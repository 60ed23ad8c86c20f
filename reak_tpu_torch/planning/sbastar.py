"""SBA* — sampling-based A* with density-penalized expansion (port of
``reak_tpu/planning/sbastar.py``).

(ref: ctrl/graph_alg/sbastar_search.hpp:854-897 generate_sbastar & variants,
lazy_sbastar.hpp, anytime_sbastar.hpp:485, density_calculators.hpp,
density_plan_visitors.hpp; façade sbastar_path_planner.hpp:74)

The reference expands the best-key vertex (key = g + h, penalized by sampling
density) and draws samples around it.  Here each iteration selects the best
FRONT of vertices and expands all of them with one batched sample/NN/edge
wave; density is a batched kernel-density estimate over the vertex set.  The
vertex bookkeeping and the orderings (numpy's ``argsort``) stay on the host,
as in the JAX package.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from reak_tpu_torch.planning.draws import as_draws, space_like
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult
from reak_tpu_torch.planning.rrt import _path_cost, _trace


def sbastar_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 60,
    front_size: int = 8,
    samples_per_vertex: int = 8,
    step_size: float = 0.6,
    density_bw: float = 0.3,
    capacity: int = 4096,
    seed=0,
) -> PlanResult:
    space = workspace.space
    device, dtype = space_like(space)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    goal = as_t(np.asarray(query.goal))
    n = goal.shape[-1]
    t0 = time.perf_counter()

    verts = np.zeros((capacity, n), np.float64)
    verts[0] = np.asarray(query.start)
    parents = np.full(capacity, -1, np.int64)
    g = np.full(capacity, np.inf)
    g[0] = 0.0
    expansions = np.zeros(capacity)  # per-vertex expansion count → key penalty
    count = 1
    goal_idx = -1
    draws = as_draws(seed, device)

    def expand_front(front_pts, all_verts, cnt):
        # samples around each front vertex (Gaussian local sampling — the
        # reference's sample-near-vertex expansion)
        F = front_pts.shape[0]
        K = F * samples_per_vertex
        noise = step_size * draws.normal((F, samples_per_vertex, n), front_pts)
        cand = space.clamp(front_pts[:, None, :] + noise).reshape(K, n)
        srcs = torch.arange(F, device=device).repeat_interleave(
            samples_per_vertex)
        ok = workspace.edge_free_batch(front_pts[srcs], cand)
        # density penalty: KDE against existing vertices (batched)
        d2 = torch.sum((all_verts[None, :, :] - cand[:, None, :]) ** 2,
                       dim=-1)
        mask = torch.arange(all_verts.shape[0], device=device)[None, :] < cnt
        dens = torch.sum(torch.where(
            mask, torch.exp(-d2 / (2 * density_bw**2)), 0.0), dim=-1)
        return cand, srcs, ok, dens

    accept_per_iter = max(4, front_size * samples_per_vertex // 4)
    for it in range(max_iters):
        # best front by key = g + h, penalized by prior expansions (the SBA*
        # density/constriction key — repeatedly-expanded vertices decay)
        cnt = count
        hv = space.distance(as_t(verts[:cnt]),
                            goal.expand(cnt, n)).cpu().numpy()
        keys = (g[:cnt] + hv) * (1.0 + 0.5 * expansions[:cnt])
        front = np.argsort(keys)[:front_size]
        expansions[front] += 1.0
        cand, srcs, ok, dens = expand_front(as_t(verts[front]), as_t(verts),
                                            cnt)
        cand = cand.cpu().numpy()
        srcs = front[srcs.cpu().numpy()]
        ok = ok.cpu().numpy()
        dens = dens.cpu().numpy()
        # accept a quota of the lowest-density valid candidates
        order = np.argsort(dens)
        taken = 0
        for i in order:
            if taken >= accept_per_iter or count >= capacity - 1:
                break
            if not ok[i]:
                continue
            c_new = g[srcs[i]] + float(
                space.distance(as_t(verts[srcs[i]]), as_t(cand[i])))
            verts[count] = cand[i]
            parents[count] = srcs[i]
            g[count] = c_new
            count += 1
            taken += 1
        # lazy goal connection: try direct edges front→goal (batched)
        front_pts = as_t(verts[front])
        goals = goal.expand(len(front), n)
        fg = workspace.edge_free_batch(front_pts, goals).cpu().numpy()
        dg_front = space.distance(front_pts, goals).cpu().numpy()
        reach = fg & (dg_front <= max(query.goal_tolerance, step_size))
        if reach.any():
            cands = front[reach]
            goal_idx = cands[np.argmin(g[cands] + dg_front[reach])]
            break
        # direct goal test for new vertices
        dg = space.distance(as_t(verts[:count]),
                            goal.expand(count, n)).cpu().numpy()
        hits = np.where(dg <= query.goal_tolerance)[0]
        if len(hits):
            goal_idx = hits[np.argmin(g[hits])]
            break

    wall = time.perf_counter() - t0
    if goal_idx < 0:
        return PlanResult(False, None, float("inf"), count, it + 1, wall)
    path = _trace(query.goal, verts, parents, goal_idx)
    return PlanResult(True, path, _path_cost(space, path), count, it + 1, wall)
