"""Probabilistic roadmap with fully-batched construction (port of
``reak_tpu/planning/prm.py``).

(ref: ctrl/graph_alg/probabilistic_roadmap.hpp:309 generate_prm;
façade prm_path_planner.hpp:65)

All sampling, validity filtering, k-NN candidate generation, and edge
collision checks happen in a handful of device batches; the neighbour
selection (numpy's ``argsort``, as in the JAX package) and the final
shortest-path search run on the host.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from reak_tpu_torch.planning.draws import as_draws, space_like
from reak_tpu_torch.planning.graph_search import astar
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult


def _roadmap(workspace, query, n_samples, k_neighbors, draws):
    """(V host, V on the device, distance matrix host, ii, jj): start, goal
    and the first ``n_samples`` free samples of ``2 n_samples`` draws, and
    the undirected k-NN candidate pairs (ii < jj)."""
    space = workspace.space
    device, dtype = space_like(space)
    pts = draws.sample(space, (2 * n_samples,))
    free = workspace.is_free_batch(pts).cpu().numpy()
    pts = pts.cpu().numpy()[free][:n_samples]
    V = np.concatenate([np.asarray(query.start)[None],
                        np.asarray(query.goal)[None], pts], axis=0)
    n_v = V.shape[0]
    Vt = torch.as_tensor(V, dtype=dtype, device=device)
    # k-NN candidate edges from the full distance matrix (one device call)
    dmat = space.distance(Vt[:, None, :], Vt[None, :, :]).cpu().numpy()
    np.fill_diagonal(dmat, np.inf)
    nbr = np.argsort(dmat, axis=1)[:, :k_neighbors]
    ii = np.repeat(np.arange(n_v), k_neighbors)
    jj = nbr.ravel()
    keep = ii < jj  # dedupe undirected pairs
    return V, Vt, dmat, ii[keep], jj[keep]


def _goal_heuristic(space, Vt):
    """h(v) = distance from vertex v to the goal (vertex 1), from one
    batched call."""
    h = space.distance(Vt, Vt[1].expand_as(Vt)).cpu().numpy()
    return lambda v: float(h[v])


def prm_plan(
    workspace,
    query: PlanningQuery,
    n_samples: int = 512,
    k_neighbors: int = 8,
    seed=0,
) -> PlanResult:
    space = workspace.space
    t0 = time.perf_counter()
    draws = as_draws(seed, space_like(space)[0])
    V, Vt, dmat, ii, jj = _roadmap(workspace, query, n_samples, k_neighbors,
                                   draws)
    n_v = V.shape[0]

    # batched edge collision checks
    ok = workspace.edge_free_batch(Vt[ii], Vt[jj]).cpu().numpy()
    edges = np.stack([ii[ok], jj[ok]], axis=1)
    costs = dmat[ii[ok], jj[ok]]

    path_ids, cost = astar(n_v, edges, costs, 0, 1,
                           heuristic=_goal_heuristic(space, Vt))
    wall = time.perf_counter() - t0
    if path_ids is None:
        return PlanResult(False, None, float("inf"), n_v, 1, wall,
                          stats={"edges": len(edges)})
    return PlanResult(True, V[path_ids], cost, n_v, 1, wall,
                      stats={"edges": len(edges)})
