"""DVP-tree — dynamic vantage-point tree for metric-space NN queries (port
of ``reak_tpu/planning/dvp_tree.py``).

(ref: ctrl/path_planning/metric_space_search.hpp:172 dvp_tree,
dvp_tree_detail.hpp, multi_dvp_tree_search.hpp:61)

Host-side index over points whose metric is an arbitrary Space.distance;
distance evaluations are *batched on device* both at build time (one call per
tree node's split) and at query time (one call per visited node).  The
brute-force masked-linear NN (planning.rrt._masked_nn) wins below ~10⁵
points on an accelerator because one distance batch beats tree pointer
chasing; the DVP tree exists for the big-roadmap regime and for
host-resident query sets — the same trade the reference's
multi_dvp_tree_search vs linear_neighbor_search pair exposes
(topological_search.hpp:529).  The tree and its numpy rng stay on the host,
as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def _euclidean(q, P):
    return torch.linalg.vector_norm(P - q[None, :], dim=-1)


class DVPTree:
    """Vantage-point tree with arity 2 over an (N, n) point set."""

    def __init__(self, points, dist_batch: Optional[Callable] = None,
                 leaf_size: int = 16, seed: int = 0, device="cuda"):
        """``dist_batch(q (n,), P (K, n)) → (K,)`` on float64 tensors on
        ``device`` — defaults to Euclidean; pass ``lambda q, P:
        space.distance(q, P)`` for custom metrics."""
        self.pts = np.asarray(points, np.float64)
        self.N = self.pts.shape[0]
        self.device = torch.device(device)
        self._dist = _euclidean if dist_batch is None else dist_batch
        self.leaf_size = leaf_size
        rng = np.random.default_rng(seed)
        # node arrays (grown as lists of dicts for clarity; N is host-scale)
        self.nodes: List[dict] = []
        idx = np.arange(self.N)
        if self.N:
            self._build(idx, rng)

    def _d(self, q, idx):
        t = lambda x: torch.as_tensor(x, dtype=torch.float64,
                                      device=self.device)
        return self._dist(t(q), t(self.pts[idx])).cpu().numpy()

    def _build(self, idx, rng) -> int:
        node_id = len(self.nodes)
        self.nodes.append(None)
        if idx.size <= self.leaf_size:
            self.nodes[node_id] = dict(leaf=True, idx=idx)
            return node_id
        # vantage point: random choice (the reference partitions around the
        # median distance too, dvp_tree_detail.hpp partitioning)
        vp_pos = rng.integers(idx.size)
        vp = idx[vp_pos]
        rest = np.delete(idx, vp_pos)
        d = self._d(self.pts[vp], rest)
        mu = float(np.median(d))
        inner = rest[d <= mu]
        outer = rest[d > mu]
        if inner.size == 0 or outer.size == 0:  # degenerate split → leaf
            self.nodes[node_id] = dict(leaf=True, idx=idx)
            return node_id
        left = self._build(inner, rng)
        right = self._build(outer, rng)
        self.nodes[node_id] = dict(leaf=False, vp=vp, mu=mu,
                                   left=left, right=right)
        return node_id

    def find_nearest(self, q, k: int = 1):
        """k-NN: returns (indices (k,), distances (k,))
        (ref: dvp_tree::find_nearest, metric_space_search.hpp:433)."""
        q = np.asarray(q, np.float64)
        best_d = np.full(k, np.inf)
        best_i = np.full(k, -1, np.int64)

        def consider(ids, ds):
            nonlocal best_d, best_i
            alld = np.concatenate([best_d, ds])
            alli = np.concatenate([best_i, ids])
            order = np.argsort(alld)[:k]
            best_d, best_i = alld[order], alli[order]

        def visit(node_id):
            node = self.nodes[node_id]
            if node["leaf"]:
                if node["idx"].size:
                    consider(node["idx"], self._d(q, node["idx"]))
                return
            vp = node["vp"]
            dvp = float(self._d(q, np.array([vp]))[0])
            consider(np.array([vp]), np.array([dvp]))
            near_first = dvp <= node["mu"]
            first = node["left"] if near_first else node["right"]
            second = node["right"] if near_first else node["left"]
            visit(first)
            # triangle-inequality prune on the far side
            if abs(dvp - node["mu"]) <= best_d[-1]:
                visit(second)

        if self.N:
            visit(0)
        valid = best_i >= 0
        return best_i[valid], best_d[valid]

    def find_in_range(self, q, radius: float):
        """Range query: all indices within ``radius``
        (ref: dvp_tree::find_in_range)."""
        q = np.asarray(q, np.float64)
        out_i, out_d = [], []

        def visit(node_id):
            node = self.nodes[node_id]
            if node["leaf"]:
                if node["idx"].size:
                    ds = self._d(q, node["idx"])
                    m = ds <= radius
                    out_i.extend(node["idx"][m].tolist())
                    out_d.extend(ds[m].tolist())
                return
            vp = node["vp"]
            dvp = float(self._d(q, np.array([vp]))[0])
            if dvp <= radius:
                out_i.append(int(vp)); out_d.append(dvp)
            if dvp - radius <= node["mu"]:
                visit(node["left"])
            if dvp + radius > node["mu"]:
                visit(node["right"])

        if self.N:
            visit(0)
        return np.asarray(out_i, np.int64), np.asarray(out_d)


def linear_nn(q, points, dist_batch=None, k: int = 1, device="cuda"):
    """Exhaustive device-batched k-NN — the one-batch default
    (ref: linear_neighbor_search, topological_search.hpp:529); the k
    smallest by numpy's ``argsort`` on the host."""
    dist_batch = _euclidean if dist_batch is None else dist_batch
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=device)
    d = dist_batch(t(q), t(points)).cpu().numpy()
    order = np.argsort(d)[:k]
    return order, d[order]
