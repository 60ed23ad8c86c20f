"""Host-side graph search over device-built edge lists (port of
``reak_tpu/planning/graph_search.py``, host code copied as it is).

(ref: the BGL algorithms the reference drives through visitors —
adstar_search.hpp:794 AD*, plus plain Dijkstra/A* used by PRM solutions)

Edges come from batched device evaluation; the search itself is pointer-heavy
host work (numpy + heapq), exactly the host/device split of SURVEY.md §7.7.
"""
from __future__ import annotations

import heapq

import numpy as np


def astar(n_vertices, edges, costs, start, goal, heuristic=None):
    """A* over an undirected edge list.

    edges: (E, 2) int array; costs: (E,) float; heuristic: (v) → float
    (ref behavior: adstar_search with ε=1 / plain A*).
    Returns (path list of vertex ids or None, cost).
    """
    adj = [[] for _ in range(n_vertices)]
    for (u, v), c in zip(np.asarray(edges), np.asarray(costs)):
        adj[int(u)].append((int(v), float(c)))
        adj[int(v)].append((int(u), float(c)))
    h = heuristic or (lambda v: 0.0)
    dist = np.full(n_vertices, np.inf)
    parent = np.full(n_vertices, -1, np.int64)
    dist[start] = 0.0
    pq = [(h(start), start)]
    closed = np.zeros(n_vertices, bool)
    while pq:
        _, u = heapq.heappop(pq)
        if closed[u]:
            continue
        closed[u] = True
        if u == goal:
            break
        for v, c in adj[u]:
            nd = dist[u] + c
            if nd < dist[v] - 1e-12:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(pq, (nd + h(v), v))
    if not np.isfinite(dist[goal]):
        return None, float("inf")
    path = [goal]
    while path[-1] != start:
        path.append(int(parent[path[-1]]))
    return path[::-1], float(dist[goal])


def anytime_astar(n_vertices, edges, costs, start, goal, heuristic,
                  epsilons=(2.5, 1.5, 1.0)):
    """Anytime repairing A*: decreasing ε inflation, returning the best path
    found (the anytime behavior of AD*/anytime-SBA*,
    ref: adstar_search.hpp:794, anytime_sbastar.hpp:485)."""
    best = (None, float("inf"))
    for eps in epsilons:
        path, cost = astar(
            n_vertices, edges, costs, start, goal,
            heuristic=lambda v: eps * heuristic(v),
        )
        if path is not None and cost < best[1]:
            best = (path, cost)
    return best
