"""FADPRM — Flexible Anytime-Dynamic PRM (port of
``reak_tpu/planning/fadprm.py``).

(ref: ctrl/graph_alg/fadprm.hpp generate_fadprm + façade
path_planning/fadprm_path_planner.hpp:64)

The reference couples a PRM roadmap with an AD* search whose heuristic is
inflated ("flexible" weight ε) and repaired when the world changes.  Split:
roadmap growth = batched device waves (sampling, validity, k-NN distances,
edge collision checks); search = host AD* (planning.adstar); dynamic changes
= batched edge re-validation feeding ADStar.update_edges.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from reak_tpu_torch.planning.adstar import ADStar
from reak_tpu_torch.planning.draws import as_draws, space_like
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult


class FADPRMPlanner:
    """Anytime-dynamic roadmap planner.

    ``grow(n)`` adds ≈n valid samples and their k-NN edges; ``solve(eps)``
    runs/refines AD*; ``revalidate(workspace)`` re-checks every edge against
    the (changed) workspace in one device batch and repairs the search.
    """

    def __init__(self, workspace, query: PlanningQuery, k_neighbors: int = 8,
                 max_edge_len: float = 1.5, seed=0):
        self.ws = workspace
        self.space = workspace.space
        self.query = query
        self.k = k_neighbors
        self.max_edge_len = max_edge_len
        self.device, self.dtype = space_like(self.space)
        self.draws = as_draws(seed, self.device)

        s, g = np.asarray(query.start, np.float64), np.asarray(query.goal, np.float64)
        self.verts = np.stack([s, g])
        self.edges = np.zeros((0, 2), np.int64)
        self.costs = np.zeros((0,), np.float64)
        self._search: Optional[ADStar] = None
        # connect start-goal directly if possible
        self._connect_new(np.array([0, 1]))

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _edge_batch(self, a_idx, b_idx):
        """(free, length) of the edges a → b, each in one device batch."""
        A = self._t(self.verts[a_idx])
        B = self._t(self.verts[b_idx])
        return (self.ws.edge_free_batch(A, B).cpu().numpy(),
                self.space.distance(A, B).cpu().numpy())

    # -- device waves ---------------------------------------------------------
    def _connect_new(self, new_idx):
        """k-NN connect new vertices against the whole roadmap, batched."""
        if len(new_idx) == 0:
            return
        V = self._t(self.verts)
        Nq = self._t(self.verts[new_idx])
        d = self.space.distance(Nq[:, None, :], V[None, :, :]).cpu().numpy()
        for row, vi in enumerate(new_idx):
            d[row, vi] = np.inf
        k = min(self.k, d.shape[1] - 1)
        nbrs = np.argsort(d, axis=1)[:, :k]
        cand_a, cand_b = [], []
        for row, vi in enumerate(new_idx):
            for nb in nbrs[row]:
                if d[row, nb] <= self.max_edge_len and nb != vi:
                    cand_a.append(vi)
                    cand_b.append(int(nb))
        if not cand_a:
            return
        free, dist = self._edge_batch(cand_a, cand_b)
        newe, newc = [], []
        seen = {(int(u), int(v)) for u, v in self.edges} | {
            (int(v), int(u)) for u, v in self.edges}
        for (u, v, ok, c) in zip(cand_a, cand_b, free, dist):
            u, v = int(u), int(v)
            if ok and (u, v) not in seen:
                seen.add((u, v)); seen.add((v, u))
                newe.append((u, v)); newc.append(float(c))
        if newe:
            self.edges = np.vstack([self.edges, np.asarray(newe, np.int64)])
            self.costs = np.concatenate([self.costs, np.asarray(newc)])
            self._search = None  # topology changed → rebuild search

    def grow(self, n_samples: int = 128):
        """One roadmap-growth wave (ref: prm expansion step of
        generate_fadprm)."""
        cand = self.draws.sample(self.space, (n_samples,))
        free = self.ws.is_free_batch(cand).cpu().numpy()
        pts = cand.cpu().numpy()[free]
        if pts.shape[0] == 0:
            return 0
        base = self.verts.shape[0]
        self.verts = np.vstack([self.verts, pts])
        self._connect_new(np.arange(base, self.verts.shape[0]))
        return pts.shape[0]

    # -- search ---------------------------------------------------------------
    def solve(self, eps: float = 1.0) -> PlanResult:
        t0 = time.perf_counter()
        if self._search is None:
            V = self._t(self.verts)
            goal = self._t(np.asarray(self.query.goal))
            h = self.space.distance(V, goal.expand_as(V)).cpu().numpy()
            self._search = ADStar(self.verts.shape[0], self.edges, self.costs,
                                  start=0, goal=1,
                                  heuristic=lambda v: float(h[v]))
        path_idx, cost = self._search.compute(eps=eps)
        n_v = self.verts.shape[0]
        wall = time.perf_counter() - t0
        if path_idx is None:
            return PlanResult(success=False, path=None, cost=float("inf"),
                              n_vertices=n_v, n_iterations=0,
                              wall_time_s=wall)
        return PlanResult(success=True, path=self.verts[path_idx], cost=cost,
                          n_vertices=n_v, n_iterations=0, wall_time_s=wall)

    # -- dynamic world ----------------------------------------------------------
    def revalidate(self, workspace=None):
        """World changed: re-check all edges in one device batch, feed cost
        changes to AD* for incremental repair (ref: fadprm.hpp dynamic
        re-validation path)."""
        if workspace is not None:
            self.ws = workspace
        if self.edges.shape[0] == 0:
            return
        free, dist = self._edge_batch(self.edges[:, 0], self.edges[:, 1])
        new_costs = np.where(free, dist, np.inf)
        if self._search is None:
            self.costs = new_costs
            return
        changed = np.nonzero(new_costs != self._search.costs)[0]
        if changed.size:
            self._search.update_edges(changed, new_costs[changed])
        self.costs = new_costs


def fadprm_plan(workspace, query: PlanningQuery, n_samples: int = 512,
                waves: int = 4, eps_schedule=(2.5, 1.5, 1.0),
                k_neighbors: int = 8, max_edge_len: float = 1.5,
                seed=0) -> PlanResult:
    """One-shot FADPRM: grow in waves, then anytime-refine."""
    p = FADPRMPlanner(workspace, query, k_neighbors, max_edge_len, seed)
    per = max(1, n_samples // waves)
    res = PlanResult(success=False, path=None, cost=float("inf"), n_vertices=0, n_iterations=0, wall_time_s=0.0)
    for w in range(waves):
        p.grow(per)
        res = p.solve(eps=eps_schedule[min(w, len(eps_schedule) - 1)])
        if res.path is not None and w >= len(eps_schedule) - 1:
            break
    if res.path is None:
        res = p.solve(eps=1.0)
    return res
