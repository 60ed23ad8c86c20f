"""RRT / bidirectional RRT with batched expansion waves (port of
``reak_tpu/planning/rrt.py``).

(ref: ctrl/graph_alg/rr_tree.hpp:179 generate_rrt, :256 generate_bidirectional_rrt;
planner façade rrt_path_planner.hpp:64)

Per iteration, K samples expand simultaneously: one masked NN matrix, one
steer batch, one edge-collision batch (the reference draws ONE sample per
iteration, rr_tree.hpp:194-198).  Tree arrays live on the device at fixed
capacity, with any leading batch of runs; the host loop only orchestrates
and extracts the final path.

Every draw goes through a draw object (``planning/draws.py``): ``seed`` is
an int, a ``torch.Generator`` or a draw object.  Points accepted past a
tree's capacity are not written (JAX's scatter drops an index out of range;
here such rows write the scratch slot ``cap − 1`` back to itself).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from reak_tpu_torch.planning.draws import as_draws, space_like
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult, path_cost


class _TreeState(NamedTuple):
    verts: torch.Tensor  # (..., cap, n)
    parents: torch.Tensor  # (..., cap) int64
    count: torch.Tensor  # (...) int64
    goal_idx: torch.Tensor  # (...) int64, -1 until connected


def _rows_at(x, idx):
    """Rows ``idx (..., K)`` of ``x (..., cap, n)`` → (..., K, n)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _at(x, idx):
    """Entries ``idx (..., K)`` of ``x (..., cap)`` → (..., K)."""
    return torch.take_along_dim(x, idx, dim=-1)


def _insert(x, slots, write, vals):
    """``x (..., cap[, n])`` with ``vals (..., K[, n])`` written at ``slots
    (..., K)`` where ``write``; the written slots are distinct and below
    ``cap − 1``.  The other rows write the scratch slot ``cap − 1``'s own
    value back, so no index leaves the array."""
    dim = slots.dim() - 1
    tail = x.shape[dim + 1:]
    idx = torch.where(write, slots, x.shape[dim] - 1)
    idx = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    keep = torch.gather(x, dim, idx)
    w = write.reshape(write.shape + (1,) * len(tail))
    return torch.scatter(x, dim, idx, torch.where(w, vals, keep))


def _first(mask, values, fill=-1):
    """``values`` at the first True of ``mask`` along the last axis, else
    ``fill`` (JAX's ``where(any(m), v[argmax(m)], fill)``)."""
    i = torch.argmax(mask.to(torch.int32), dim=-1, keepdim=True)
    return torch.where(mask.any(-1), _at(values, i)[..., 0], fill)


def _masked_nn(verts, count, queries, dist_fn):
    """Nearest existing vertex for each query (..., K): masked brute-force
    argmin (ties to the lower index) — exact NN, replaces the DVP-tree
    (metric_space_search.hpp:172) with one device-wide distance matrix."""
    cap = verts.shape[-2]
    d = dist_fn(queries[..., :, None, :], verts[..., None, :, :])
    mask = torch.arange(cap, device=verts.device) < count[..., None, None]
    d = torch.where(mask, d, torch.inf)
    return torch.argmin(d, dim=-1)


def _steer(space, near, targets, step_size):
    """(distance, new point): from ``near`` toward ``targets`` by at most
    ``step_size``."""
    d = space.distance(near, targets)
    t = torch.clamp_max(step_size / torch.clamp_min(d, 1e-12), 1.0)
    return d, space.interpolate(near, targets, t)


def _edges_free(workspace, a, b):
    """``workspace.edge_free_batch`` over rows (..., n) of any leading
    shape."""
    n = a.shape[-1]
    return workspace.edge_free_batch(a.reshape(-1, n),
                                     b.reshape(-1, n)).reshape(a.shape[:-1])


def _compact_slots(ok, count, cap):
    """(slots, write): accepted points compacted into slots from ``count``
    on, rejected ones to the scratch slot ``cap − 1``; ``write`` where a
    slot is below it."""
    offs = torch.cumsum(ok.to(torch.int64), dim=-1) - 1
    slots = torch.where(ok, count[..., None] + offs, cap - 1)
    return slots, ok & (slots < cap - 1)


def _with_goal(samples, goal, n_bias):
    """The first ``n_bias`` samples replaced by the goal."""
    out = samples.clone()
    out[..., :n_bias, :] = goal
    return out


def _make_expand_step(space, workspace, step_size, goal_bias, goal_tol,
                      wave: int = 64):
    dist_fn = space.distance

    def expand(state: _TreeState, goal, draws):
        cap, n = state.verts.shape[-2:]
        K = wave  # expansion wave width
        samples = draws.sample(space, tuple(state.count.shape) + (K,))
        # goal bias: replace a slice of samples with the goal
        samples = _with_goal(samples, goal, max(1, int(K * goal_bias)))

        near_idx = _masked_nn(state.verts, state.count, samples, dist_fn)
        near = _rows_at(state.verts, near_idx)
        d, new_pts = _steer(space, near, samples, step_size)
        ok = _edges_free(workspace, near, new_pts) & (d > 1e-9)

        # compact accepted points into tree slots (capacity guarded)
        slots, write = _compact_slots(ok, state.count, cap)
        verts = _insert(state.verts, slots, write, new_pts)
        parents = _insert(state.parents, slots, write, near_idx)
        count = torch.clamp_max(state.count + ok.sum(-1), cap - 1)

        # goal connection test for accepted points
        hit = write & (dist_fn(new_pts, goal) <= goal_tol)
        goal_idx = torch.where(state.goal_idx >= 0, state.goal_idx,
                               _first(hit, slots))
        return _TreeState(verts, parents, count, goal_idx)

    return expand


def _endpoints(workspace, query):
    """(space, device, start, goal) of a query on the space's
    device, in its dtype."""
    space = workspace.space
    device, dtype = space_like(space)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                     device=device)
    return space, device, as_t(query.start), as_t(query.goal)


def _new_tree(root, capacity, batch=()):
    """A tree (or a batch of trees) of ``capacity`` slots holding ``root``."""
    n = root.shape[-1]
    verts = root.new_zeros(tuple(batch) + (capacity, n))
    verts[..., 0, :] = root
    z = dict(dtype=torch.int64, device=root.device)
    return (verts, torch.full(tuple(batch) + (capacity,), -1, **z),
            torch.ones(tuple(batch), **z))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _trace(goal, verts, parents, gi):
    """The path root → vertex ``gi`` → goal, as an (L, n) array."""
    return np.stack(_trace_to_root(verts, parents, gi)[::-1]
                    + [np.asarray(goal)])


def _path_cost(space, path):
    """``path_cost`` of a host path, on the space's device."""
    device, dtype = space_like(space)
    return path_cost(space, torch.as_tensor(path, dtype=dtype, device=device))


def _graph(verts, parents, cnt):
    """The motion graph of a tree for the vlist/differ engines, numpy on
    the host (parents int32, as in the JAX package)."""
    return {"verts": verts[:cnt], "parents": parents[:cnt].astype(np.int32)}


def rrt_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 200,
    step_size: float = 0.5,
    goal_bias: float = 0.05,
    capacity: int = 8192,
    seed=0,
    reporter=None,
) -> PlanResult:
    """Unidirectional RRT (ref: rr_tree.hpp:179 + rrt_path_planner.tpp:66)."""
    space, device, start, goal = _endpoints(workspace, query)
    draws = as_draws(seed, device)
    verts, parents, count = _new_tree(start, capacity)
    state = _TreeState(verts, parents, count, torch.full_like(count, -1))
    expand = _make_expand_step(space, workspace, step_size, goal_bias,
                               query.goal_tolerance)
    t0 = time.perf_counter()
    it = 0
    for it in range(max_iters):
        state = expand(state, goal, draws)
        if reporter is not None:
            reporter(it, state)
        if int(state.goal_idx) >= 0:
            break

    gi = int(state.goal_idx)
    wall = time.perf_counter() - t0
    cnt = int(state.count)
    verts_np = state.verts.cpu().numpy()
    parents_np = state.parents.cpu().numpy()
    # motion-graph dump for the vlist/differ engines (ref:
    # vlist_sbmp_report, planner_exec_engines.hpp:214)
    graph = _graph(verts_np, parents_np, cnt)
    if gi < 0:
        return PlanResult(False, None, float("inf"), cnt, it + 1, wall,
                          stats=graph)
    path = _trace(query.goal, verts_np, parents_np, gi)
    return PlanResult(True, path, _path_cost(space, path), cnt, it + 1, wall,
                      stats=graph)


def rrt_plan_batch(
    workspace,
    query: PlanningQuery,
    n_runs: int = 8,
    max_iters: int = 200,
    step_size: float = 0.5,
    goal_bias: float = 0.05,
    capacity: int = 4096,
    seed=0,
    wave: int = 64,
):
    """Batched Monte-Carlo RRT: ALL ``n_runs`` randomized runs advance
    together — one batched expansion wave a loop step, over a leading run
    axis of the tree tensors — instead of the reference's serial repetition
    loop (ref: planner_exec_engines.hpp:125-160, the loop this replaces).
    The loop ends when every run has connected or after ``max_iters``
    waves (one host read of the runs' goal flags a wave); runs that
    connected earlier keep expanding until then.

    Returns ``(results, wall_s_total)`` with one PlanResult per run
    (``wall_time_s`` already amortized).
    """
    space, device, start, goal = _endpoints(workspace, query)
    draws = as_draws(seed, device)
    expand = _make_expand_step(space, workspace, step_size, goal_bias,
                               query.goal_tolerance, wave=wave)
    verts, parents, count = _new_tree(start, capacity, (n_runs,))
    states = _TreeState(verts, parents, count, torch.full_like(count, -1))

    t0 = time.perf_counter()
    iters = 0
    while iters < max_iters and bool((states.goal_idx < 0).any()):
        states = expand(states, goal, draws)
        iters += 1
    _sync(device)
    wall = time.perf_counter() - t0

    results = []
    verts_np = states.verts.cpu().numpy()
    parents_np = states.parents.cpu().numpy()
    goal_np = states.goal_idx.cpu().numpy()
    count_np = states.count.cpu().numpy()
    for r in range(n_runs):
        gi, cnt = int(goal_np[r]), int(count_np[r])
        graph = _graph(verts_np[r], parents_np[r], cnt)
        if gi < 0:
            results.append(PlanResult(False, None, float("inf"), cnt, iters,
                                      wall / n_runs, stats=graph))
            continue
        path = _trace(query.goal, verts_np[r], parents_np[r], gi)
        results.append(PlanResult(True, path, _path_cost(space, path), cnt,
                                  iters, wall / n_runs, stats=graph))
    return results, wall


class _Tree(NamedTuple):
    verts: torch.Tensor  # (cap, n)
    parents: torch.Tensor  # (cap,) int64
    count: torch.Tensor  # () int64


def _make_birrt_round(space, workspace, step_size, connect_tol):
    """One alternating bi-RRT round, fully batched (ref: rr_tree.hpp:256):
    grow tree A toward K random samples, then grow tree B toward A's newly
    accepted vertices (the connect heuristic), and report any (a, b) vertex
    pair that came within ``connect_tol``."""
    dist_fn = space.distance

    def grow(tree: _Tree, targets, src_required=None):
        """Batched extension of ``tree`` toward ``targets`` (K, n).
        Returns (tree', slots, new_pts, accepted)."""
        cap = tree.verts.shape[-2]
        near_idx = _masked_nn(tree.verts, tree.count, targets, dist_fn)
        near = _rows_at(tree.verts, near_idx)
        d, new_pts = _steer(space, near, targets, step_size)
        ok = _edges_free(workspace, near, new_pts) & (d > 1e-9)
        if src_required is not None:
            ok = ok & src_required
        slots, write = _compact_slots(ok, tree.count, cap)
        verts = _insert(tree.verts, slots, write, new_pts)
        parents = _insert(tree.parents, slots, write, near_idx)
        count = torch.clamp_max(tree.count + ok.sum(-1), cap - 1)
        return _Tree(verts, parents, count), slots, new_pts, write

    def round_step(tree_a: _Tree, tree_b: _Tree, draws):
        K = 64
        samples = draws.sample(space, (K,))
        tree_a, slots_a, new_a, acc_a = grow(tree_a, samples)
        # connect wave: B extends toward A's accepted new vertices
        tree_b, slots_b, new_b, acc_b = grow(tree_b, new_a, src_required=acc_a)
        gap = dist_fn(new_b, new_a)
        hit = acc_a & acc_b & (gap <= connect_tol)
        bridge = torch.stack([_first(hit, slots_a), _first(hit, slots_b)])
        return tree_a, tree_b, bridge

    return round_step


def _trace_to_root(verts, parents, idx):
    path = []
    i = idx
    while i >= 0:
        path.append(verts[i])
        i = parents[i]
    return path  # leaf → root


def birrt_plan(
    workspace,
    query: PlanningQuery,
    max_iters: int = 200,
    step_size: float = 0.5,
    capacity: int = 8192,
    seed=0,
) -> PlanResult:
    """TRUE bidirectional RRT (ref: rr_tree.hpp:256 generate_bidirectional_rrt):
    two trees rooted at start and goal; each round one tree extends toward a
    batch of random samples and the OTHER tree extends toward the accepted
    new vertices (batched connect test); roles alternate every round; the
    path is spliced at the first vertex pair within ``goal_tolerance``."""
    space, device, start, goal = _endpoints(workspace, query)
    draws = as_draws(seed, device)
    tree_s = _Tree(*_new_tree(start, capacity))
    tree_g = _Tree(*_new_tree(goal, capacity))
    round_step = _make_birrt_round(space, workspace, step_size,
                                   query.goal_tolerance)
    t0 = time.perf_counter()
    bridge_sg = None  # (start_tree_idx, goal_tree_idx)
    it = 0
    for it in range(max_iters):
        if it % 2 == 0:  # start tree explores, goal tree connects
            tree_s, tree_g, bridge = round_step(tree_s, tree_g, draws)
            b = bridge.tolist()
            if b[0] >= 0:
                bridge_sg = (b[0], b[1])
                break
        else:  # alternate roles (the reference's alternation)
            tree_g, tree_s, bridge = round_step(tree_g, tree_s, draws)
            b = bridge.tolist()
            if b[0] >= 0:
                bridge_sg = (b[1], b[0])
                break

    wall = time.perf_counter() - t0
    n_verts = int(tree_s.count) + int(tree_g.count)
    if bridge_sg is None:
        return PlanResult(False, None, float("inf"), n_verts, it + 1, wall)
    sv, sp_ = tree_s.verts.cpu().numpy(), tree_s.parents.cpu().numpy()
    gv, gp = tree_g.verts.cpu().numpy(), tree_g.parents.cpu().numpy()
    half_s = _trace_to_root(sv, sp_, bridge_sg[0])[::-1]  # start → bridge
    half_g = _trace_to_root(gv, gp, bridge_sg[1])  # bridge → goal
    path = np.stack(half_s + half_g)
    return PlanResult(True, path, _path_cost(space, path), n_verts, it + 1,
                      wall)
