"""AD* — Anytime Dynamic A* over an explicit graph (port of
``reak_tpu/planning/adstar.py``, host code copied as it is).

Host/device split of the reference's AD* (ref: ctrl/graph_alg/adstar_search.hpp
:794-796,875-877 adstar_search overloads; consumed by
path_planning/fadprm_path_planner.hpp): the *search* is pointer-heavy host
work (numpy + heap), while edge costs/validity come from batched device
evaluation (the caller re-validates whole edge sets on the device and feeds
cost changes in via :meth:`ADStar.update_edges`).

AD* = anytime (inflated heuristic ε decreasing toward 1) + dynamic
(incremental repair of g/rhs after edge-cost changes, LPA*-style), per
Likhachev et al. — the same algorithm family the reference implements.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class ADStar:
    """Incremental anytime search from ``start`` to ``goal``.

    Graph is an undirected edge list with mutable costs; ``np.inf`` disables
    an edge (obstacle appeared).  Typical loop:

        s = ADStar(n, edges, costs, start, goal, heuristic)
        path, cost = s.compute(eps=2.5)      # fast, suboptimal
        path, cost = s.compute(eps=1.0)      # refine, optimal
        s.update_edges(idx, new_costs)       # world changed
        path, cost = s.compute(eps=1.5)      # repair + re-anytime
    """

    def __init__(self, n_vertices, edges, costs, start, goal,
                 heuristic: Optional[Callable[[int], float]] = None):
        self.n = int(n_vertices)
        self.edges = np.asarray(edges, np.int64).reshape(-1, 2)
        self.costs = np.asarray(costs, np.float64).copy()
        self.start = int(start)
        self.goal = int(goal)
        self.h = heuristic or (lambda v: 0.0)
        self.adj: List[List[Tuple[int, int]]] = [[] for _ in range(self.n)]
        for ei, (u, v) in enumerate(self.edges):
            self.adj[int(u)].append((int(v), ei))
            self.adj[int(v)].append((int(u), ei))
        # search state (search runs backward from goal so h() estimates
        # distance-to-start consistently under repair; here we search forward
        # with rhs one-step lookahead, the standard LPA* layout)
        self.g = np.full(self.n, np.inf)
        self.rhs = np.full(self.n, np.inf)
        self.rhs[self.start] = 0.0
        self.eps = 1.0
        self._open: List[Tuple[Tuple[float, float], int]] = []
        self._open_find: Dict[int, Tuple[float, float]] = {}
        self._incons: Dict[int, bool] = {}
        self._closed = set()
        self._push(self.start)

    # -- keys / queue -------------------------------------------------------
    def _key(self, v) -> Tuple[float, float]:
        m = min(self.g[v], self.rhs[v])
        return (m + self.eps * self.h(v), m)

    def _push(self, v):
        k = self._key(v)
        self._open_find[v] = k
        heapq.heappush(self._open, (k, v))

    def _pop(self) -> Optional[int]:
        while self._open:
            k, v = heapq.heappop(self._open)
            if self._open_find.get(v) == k:
                del self._open_find[v]
                return v
        return None

    def _peek_key(self):
        while self._open:
            k, v = self._open[0]
            if self._open_find.get(v) == k:
                return k
            heapq.heappop(self._open)
        return (np.inf, np.inf)

    # -- LPA* vertex update --------------------------------------------------
    def _update_vertex(self, v):
        if v != self.start:
            best = np.inf
            for u, ei in self.adj[v]:
                c = self.costs[ei]
                if np.isfinite(c):
                    best = min(best, self.g[u] + c)
            self.rhs[v] = best
        inconsistent = self.g[v] != self.rhs[v]
        if inconsistent:
            if v in self._closed:
                # AD*: under-consistent already-expanded vertices go to INCONS
                self._incons[v] = True
            else:
                self._push(v)
        else:
            self._open_find.pop(v, None)

    # -- main loop -----------------------------------------------------------
    def compute(self, eps: float = 1.0, max_expansions: int = 10**7):
        """Run/improve the search at inflation ``eps``.  Returns
        (path vertex list or None, cost)."""
        if eps != self.eps or self._incons:
            self.eps = eps
            # move INCONS into OPEN, rebuild all keys, clear CLOSED
            for v in self._incons:
                self._open_find[v] = None  # force re-push
            incons = list(self._incons)
            self._incons.clear()
            verts = set(list(self._open_find.keys()) + incons)
            self._open = []
            self._open_find = {}
            self._closed = set()
            for v in verts:
                if min(self.g[v], self.rhs[v]) < np.inf:
                    self._push(v)

        expansions = 0
        while expansions < max_expansions:
            k_top = self._peek_key()
            k_goal = self._key(self.goal)
            if not (k_top < k_goal or self.rhs[self.goal] != self.g[self.goal]):
                break
            v = self._pop()
            if v is None:
                break
            expansions += 1
            if self.g[v] > self.rhs[v]:
                self.g[v] = self.rhs[v]          # over-consistent → consistent
                self._closed.add(v)
                for u, _ in self.adj[v]:
                    self._update_vertex(u)
            else:
                self.g[v] = np.inf               # under-consistent → raise
                self._update_vertex(v)
                for u, _ in self.adj[v]:
                    self._update_vertex(u)
        return self.extract_path()

    def extract_path(self):
        if not np.isfinite(min(self.g[self.goal], self.rhs[self.goal])):
            return None, float("inf")
        path = [self.goal]
        v = self.goal
        guard = 0
        while v != self.start and guard < self.n + 1:
            guard += 1
            best_u, best_c = -1, np.inf
            for u, ei in self.adj[v]:
                c = self.costs[ei]
                if np.isfinite(c) and self.g[u] + c < best_c:
                    best_u, best_c = u, self.g[u] + c
            if best_u < 0:
                return None, float("inf")
            path.append(best_u)
            v = best_u
        path.reverse()
        return path, float(min(self.g[self.goal], self.rhs[self.goal]))

    # -- dynamic world --------------------------------------------------------
    def update_edges(self, edge_indices, new_costs):
        """Apply edge-cost changes (from a batched device re-validation pass)
        and schedule incremental repair (ref: adstar_search.hpp edge-change
        publishing loop)."""
        edge_indices = np.atleast_1d(np.asarray(edge_indices, np.int64))
        new_costs = np.broadcast_to(np.asarray(new_costs, np.float64),
                                    edge_indices.shape)
        for ei, c in zip(edge_indices, new_costs):
            self.costs[ei] = c
            u, v = self.edges[ei]
            self._update_vertex(int(u))
            self._update_vertex(int(v))


def adstar_search(n_vertices, edges, costs, start, goal, heuristic=None,
                  eps_schedule=(2.5, 1.5, 1.0)):
    """One-shot anytime run: returns the final (path, cost) plus all anytime
    solutions, mirroring the reference's anytime loop
    (adstar_search.hpp:794 simplified entry points)."""
    s = ADStar(n_vertices, edges, costs, start, goal, heuristic)
    history = []
    for eps in eps_schedule:
        path, cost = s.compute(eps=eps)
        history.append((eps, path, cost))
    return path, cost, history
