"""Lazy / pruned / branch-and-bound connection strategies (port of
``reak_tpu/planning/lazy_prm.py``).

(ref: ctrl/graph_alg/lazy_connector.hpp, pruned_connector.hpp,
branch_and_bound_connector.hpp, lazy_sbastar.hpp — the reference's family of
edge-evaluation-deferring and incumbent-pruning connectors.)

* ``lazy_prm_plan`` — Lazy-PRM: build the roadmap with OPTIMISTIC edges
  (no collision checks), A* on host, then batch-validate ONLY the edges on
  the candidate path in one device call; invalid edges are dropped and the
  search repeats.  Collision checking — the expensive device work — is spent
  exclusively on edges a shortest path actually wants to use (the
  lazy_connector idea, with the per-edge device round-trips of the reference
  replaced by one batched validation per repair round).

* ``bnb_prune`` — branch-and-bound vertex pruning: given an incumbent
  solution cost, discard every vertex whose g + h exceeds it (the
  branch_and_bound_connector rule) in one masked device pass; used by the
  anytime planners between improvement rounds.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from reak_tpu_torch.planning.draws import as_draws, space_like
from reak_tpu_torch.planning.graph_search import astar
from reak_tpu_torch.planning.prm import _goal_heuristic, _roadmap
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult


def lazy_prm_plan(
    workspace,
    query: PlanningQuery,
    n_samples: int = 512,
    k_neighbors: int = 8,
    max_repair_rounds: int = 30,
    seed=0,
) -> PlanResult:
    """Lazy-PRM: optimistic roadmap + on-demand batched edge validation."""
    space = workspace.space
    t0 = time.perf_counter()
    draws = as_draws(seed, space_like(space)[0])
    V, Vt, dmat, ii, jj = _roadmap(workspace, query, n_samples, k_neighbors,
                                   draws)
    n_v = V.shape[0]
    costs = dmat[ii, jj]

    # edge status: 0 = unknown (assumed valid), 1 = known-invalid
    known_invalid = np.zeros(len(ii), bool)
    edge_index = {(int(a), int(b)): e for e, (a, b) in enumerate(zip(ii, jj))}

    h = _goal_heuristic(space, Vt)
    n_checked = 0
    rounds = 0
    stats = lambda: {"edges_checked": n_checked, "edges_total": len(ii)}
    for rounds in range(1, max_repair_rounds + 1):
        live = ~known_invalid
        edges = np.stack([ii[live], jj[live]], axis=1)
        path_ids, cost = astar(n_v, edges, costs[live], 0, 1, heuristic=h)
        if path_ids is None:
            return PlanResult(False, None, float("inf"), n_v, rounds,
                              time.perf_counter() - t0, stats=stats())
        # validate ONLY the candidate path's edges, one device batch
        pairs = [(min(a, b), max(a, b))
                 for a, b in zip(path_ids[:-1], path_ids[1:])]
        eidx = np.array([edge_index[p] for p in pairs])
        unchecked = eidx  # unknown edges on the path (invalid ones are gone)
        ok = workspace.edge_free_batch(Vt[ii[unchecked]],
                                       Vt[jj[unchecked]]).cpu().numpy()
        n_checked += len(unchecked)
        if ok.all():
            return PlanResult(True, V[path_ids], cost, n_v, rounds,
                              time.perf_counter() - t0, stats=stats())
        known_invalid[unchecked[~ok]] = True
    return PlanResult(False, None, float("inf"), n_v, rounds,
                      time.perf_counter() - t0, stats=stats())


def bnb_prune(verts, costs, goal, incumbent_cost, space, count):
    """Branch-and-bound vertex mask: keep v iff g(v) + h(v) ≤ incumbent
    (ref: branch_and_bound_connector.hpp).  Returns a bool keep-mask; the
    caller compacts or masks its arrays (one masked device pass)."""
    cap = verts.shape[0]
    goal = torch.as_tensor(goal, dtype=verts.dtype, device=verts.device)
    h = space.distance(verts, goal.expand_as(verts))
    alive = torch.arange(cap, device=verts.device) < count
    return alive & (costs + h <= incumbent_cost)
