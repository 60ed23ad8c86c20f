"""RRT* with batched expansion, choose-parent, and rewiring (port of
``reak_tpu/planning/rrt_star.py``).

(ref: ctrl/graph_alg/rrt_star.hpp:530 generate_rrt_star, star-neighborhood
sizing neighborhood_functors.hpp:57; façade rrtstar_path_planner.hpp:65)

Each iteration expands a wave of K samples; for every accepted vertex the
choose-parent and rewire passes evaluate ALL candidate neighbors as one masked
matrix on device (radius from the standard γ(log N / N)^{1/d} shrinking-ball).

As in the JAX package, the ball radius is computed from the vertex count in
float32 whatever the points' type; here it is read from a table made once
on the CPU (one entry a count), so the card and the CPU use the same radius
bits.  XLA's float32 ``log`` and ``pow`` round differently in the last bit
for some counts, which moves a ball's membership only where a distance lies
within that bit of the radius.  A rewire gives a vertex a new parent and
cost-to-come but leaves its descendants' costs as they were, as the JAX
package does.  The rewire's edge checks run only on the vertices it would
rewire (one host read a wave); the JAX package checks an edge for every
slot and masks the rest, with the same result.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from reak_tpu_torch.math import sorting
from reak_tpu_torch.planning.draws import as_draws
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult
from reak_tpu_torch.planning.rrt import (_at, _compact_slots, _endpoints,
                                         _graph, _insert, _masked_nn,
                                         _new_tree, _path_cost, _rows_at,
                                         _steer, _sync, _trace, _with_goal,
                                         _edges_free)


class _StarState(NamedTuple):
    verts: torch.Tensor  # (..., cap, n)
    parents: torch.Tensor  # (..., cap) int64
    costs: torch.Tensor  # (..., cap) cost-to-come
    count: torch.Tensor  # (...)


@functools.lru_cache(maxsize=32)
def _radius_table(cap, step_size, gamma, dim, device):
    """Computed on the CPU, so every device reads the same float32 bits."""
    N = torch.clamp_min(torch.arange(cap + 1, dtype=torch.float32), 2.0)
    return torch.clamp_max(gamma * (torch.log(N) / N) ** (1.0 / dim),
                           step_size * 2.0).to(device)


def _radius(count, cap, step_size, gamma, dim):
    """The float32 shrinking-ball radius (rrt_star.hpp star_neighborhood)
    for each vertex count."""
    table = _radius_table(cap, float(step_size), float(gamma), float(dim),
                          count.device)
    return table[count]


def _new_star(start, capacity, batch=()):
    verts, parents, count = _new_tree(start, capacity, batch)
    costs = start.new_full(tuple(batch) + (capacity,), torch.inf)
    costs[..., 0] = 0.0
    return _StarState(verts, parents, costs, count)


def _make_star_step(space, workspace, step_size, gamma, goal_bias, K=32,
                    sampler=None):
    """``sampler(state, goal, draws) → (..., K, n)`` overrides the default
    uniform+goal-bias draw — the hook the SBA*-RRT* hybrid uses to mix
    density-guided local samples into the RRT* wave
    (planning/sbastar_rrtstar.py)."""
    dist_fn = space.distance

    def step(state: _StarState, goal, draws):
        cap, n = state.verts.shape[-2:]
        if sampler is not None:
            samples = sampler(state, goal, draws)
        else:
            samples = draws.sample(space, tuple(state.count.shape) + (K,))
            samples = _with_goal(samples, goal, max(1, int(K * goal_bias)))

        near_idx = _masked_nn(state.verts, state.count, samples, dist_fn)
        near = _rows_at(state.verts, near_idx)
        d, new_pts = _steer(space, near, samples, step_size)
        ok = _edges_free(workspace, near, new_pts) & (d > 1e-9)

        radius = _radius(state.count, cap, step_size, gamma, n)

        # choose parent: masked distances from each new point to all vertices
        dmat = dist_fn(new_pts[..., :, None, :],
                       state.verts[..., None, :, :])  # (..., K, cap)
        slot = torch.arange(cap, device=dmat.device)
        vmask = slot < state.count[..., None, None]
        in_ball = vmask & (dmat <= radius[..., None, None])
        # the steering parent is always a candidate (the ball may shrink
        # below step_size; without this the expansion starves)
        in_ball = in_ball | (slot == near_idx[..., None])
        # edge feasibility for in-ball candidates: (K, cap) edge checks would
        # be cap-heavy — restrict to the M best candidates per new point
        M = 8
        cand_cost = torch.where(in_ball, state.costs[..., None, :] + dmat,
                                torch.inf)
        top_cost, top_idx = sorting.smallest_k(cand_cost, M)  # (..., K, M)
        # batch edge checks: (K*M,) pairs
        cand_pts = _rows_at(state.verts, top_idx.flatten(-2))
        edge_ok = _edges_free(
            workspace, cand_pts,
            new_pts.repeat_interleave(M, dim=-2)).reshape(top_cost.shape)
        top_cost = torch.where(edge_ok, top_cost, torch.inf)
        best = torch.argmin(top_cost, dim=-1, keepdim=True)
        parent_idx = torch.take_along_dim(top_idx, best, dim=-1)[..., 0]
        parent_cost = torch.take_along_dim(top_cost, best, dim=-1)[..., 0]
        ok = ok & torch.isfinite(parent_cost)

        # insert accepted
        slots, write = _compact_slots(ok, state.count, cap)
        verts = _insert(state.verts, slots, write, new_pts)
        parents = _insert(state.parents, slots, write, parent_idx)
        costs = _insert(state.costs, slots, write, parent_cost)
        count = torch.clamp_max(state.count + write.sum(-1), cap - 1)

        # rewire: for each new vertex, improve in-ball old vertices through it
        thru_cost = parent_cost[..., :, None] + dmat  # (..., K, cap)
        improve = (write[..., :, None] & in_ball
                   & (thru_cost < state.costs[..., None, :] - 1e-9))
        # check improving edges (restrict to best improvement per old vertex)
        gain = torch.where(improve, state.costs[..., None, :] - thru_cost,
                           -torch.inf)
        best_new = torch.argmax(gain, dim=-2)  # (..., cap) first maximum
        best_gain = torch.amax(gain, dim=-2)
        rewire_mask = torch.isfinite(best_gain) & (best_gain > 0)
        edge_ok2 = torch.zeros_like(rewire_mask)
        sel = torch.nonzero(rewire_mask.reshape(-1)).reshape(-1)
        if sel.numel():
            new_parents_pts = _rows_at(new_pts, best_new)
            edge_ok2.view(-1)[sel] = workspace.edge_free_batch(
                new_parents_pts.reshape(-1, n)[sel],
                state.verts.reshape(-1, n)[sel])
        via = torch.take_along_dim(dmat, best_new[..., None, :], dim=-2)
        new_cost = torch.where(edge_ok2, _at(parent_cost, best_new)
                               + via[..., 0, :], costs)
        parents = torch.where(edge_ok2, _at(slots, best_new), parents)
        costs = torch.where(edge_ok2, new_cost, costs)
        return _StarState(verts, parents, costs, count)

    return step


def _star_graph(state, cnt):
    """The motion graph of one tree (``rrt._graph``) and, beside it, the
    stored costs-to-come (``costs``: a rewired vertex's descendants keep
    the costs they had)."""
    graph = _graph(state.verts.cpu().numpy(), state.parents.cpu().numpy(),
                   cnt)
    graph["costs"] = state.costs[:cnt].cpu().numpy()
    return graph


def _best_goal_path(space, query, verts, costs, parents, cnt, goal):
    """(vertex index, path) of the least-cost vertex within the goal
    tolerance (cost-to-come + distance to goal), or (None, None)."""
    n = verts.shape[-1]
    d_goal = space.distance(verts[:cnt], goal.expand(cnt, n)).cpu().numpy()
    costs = costs.cpu().numpy()
    near_goal = d_goal <= query.goal_tolerance
    if not near_goal.any():
        return None, None
    cand = np.where(near_goal)[0]
    gi = cand[np.argmin(costs[cand] + d_goal[cand])]
    return gi, _trace(query.goal, verts.cpu().numpy(), parents.cpu().numpy(),
                      gi)


def rrt_star_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 150,
    step_size: float = 0.5,
    gamma: float = 3.0,
    goal_bias: float = 0.05,
    capacity: int = 4096,
    seed=0,
) -> PlanResult:
    space, device, start, goal = _endpoints(workspace, query)
    draws = as_draws(seed, device)
    state = _new_star(start, capacity)
    step = _make_star_step(space, workspace, step_size, gamma, goal_bias)
    t0 = time.perf_counter()
    for it in range(max_iters):
        state = step(state, goal, draws)

    # best goal connection; the motion graph rides along in ``stats`` (the
    # JAX package's single run returns none), so vlist_engine can dump it
    cnt = int(state.count)
    gi, path = _best_goal_path(space, query, state.verts, state.costs,
                               state.parents, cnt, goal)
    wall = time.perf_counter() - t0
    graph = _star_graph(state, cnt)
    if gi is None:
        return PlanResult(False, None, float("inf"), cnt, max_iters, wall,
                          stats=graph)
    return PlanResult(True, path, _path_cost(space, path), cnt, max_iters,
                      wall, stats=graph)


def rrt_star_plan_batch(
    workspace,
    query: PlanningQuery,
    n_runs: int = 8,
    max_iters: int = 150,
    step_size: float = 0.5,
    gamma: float = 3.0,
    goal_bias: float = 0.05,
    capacity: int = 4096,
    seed=0,
):
    """Batched Monte-Carlo RRT*: all runs advance together, ``max_iters``
    waves over a leading run axis of the tree tensors — replaces the serial
    MC loop of ref planner_exec_engines.hpp:125-160 like
    rrt.rrt_plan_batch.  Returns ``(results, wall_s_total)``; each result's
    ``stats`` holds its tree's ``verts``, ``parents`` and ``costs``."""
    space, device, start, goal = _endpoints(workspace, query)
    draws = as_draws(seed, device)
    step = _make_star_step(space, workspace, step_size, gamma, goal_bias)
    states = _new_star(start, capacity, (n_runs,))

    t0 = time.perf_counter()
    for _ in range(max_iters):
        states = step(states, goal, draws)
    _sync(device)
    wall = time.perf_counter() - t0

    results = []
    counts = states.count.cpu().numpy()
    for r in range(n_runs):
        cnt = int(counts[r])
        run = _StarState(*(x[r] for x in states))
        gi, path = _best_goal_path(space, query, run.verts, run.costs,
                                   run.parents, cnt, goal)
        graph = _star_graph(run, cnt)
        if gi is None:
            results.append(PlanResult(False, None, float("inf"), cnt,
                                      max_iters, wall / n_runs, stats=graph))
            continue
        results.append(PlanResult(True, path, _path_cost(space, path), cnt,
                                  max_iters, wall / n_runs, stats=graph))
    return results, wall
