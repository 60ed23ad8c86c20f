"""Reachability-sorted point set for temporal planning (port of
``reak_tpu/planning/reach_sort.py``).

(ref: ctrl/path_planning/reachability_sort.hpp — a multi-index container
ordering temporal points by their backward/forward reach norms so that
"which stored points can reach p / are reachable from p" resolves by range
scan instead of all-pairs distance evaluation.)

Pruning property (triangle inequality of the base metric): if q is reachable
from p (t_q − t_p ≥ d(p, q)) then BOTH
    backward_reach(q) ≥ backward_reach(p)   (b = t − d(origin, ·))
    forward_reach(q)  ≥ forward_reach(p)    (f = t + d(origin, ·))
so candidates live in an upper-right quadrant of the (b, f) plane.  The
container keeps the set sorted by b (math/sorting.lexsort_2key): a
searchsorted gives the quadrant's start row, the f-mask trims it, and only
the surviving candidates get exact distance evaluations — all as masked
device ops.
"""
from __future__ import annotations

import numpy as np
import torch

from reak_tpu_torch.math.sorting import lexsort_2key
from reak_tpu_torch.spaces.temporal import TemporalPoint


class ReachabilitySortedSet:
    """Immutable reachability-sorted view of (times (N,), points (N, n)).
    Numpy or number arguments take the dtype and device of the space's
    origin (its first tensor; float64 on the CPU where it holds none)."""

    def __init__(self, space, times, points):
        """``space``: a spaces.ReachabilitySpace WITH origin (its reach norms
        anchor the sort keys)."""
        self.space = space
        org = space._require_origin()
        like = next((x for x in org if isinstance(x, torch.Tensor)),
                    torch.zeros((), dtype=torch.float64))
        as_t = lambda x: x if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x, np.float64), dtype=like.dtype,
                            device=like.device)
        times, points = as_t(times), as_t(points)
        tp = TemporalPoint(times, points)
        b = space.backward_reach(tp)
        f = space.forward_reach(tp)
        order = lexsort_2key(b, f)
        self.times = times[order]
        self.points = points[order]
        self.b = b[order]
        self.f = f[order]
        self.order = order

    @property
    def size(self):
        return self.times.shape[0]

    # -- pruning (no distance evaluations) --------------------------------
    def candidate_mask_from(self, tp: TemporalPoint):
        """Quadrant prune: stored points that COULD be reachable from tp."""
        bp = torch.as_tensor(self.space.backward_reach(tp), dtype=self.b.dtype,
                             device=self.b.device)
        fp = self.space.forward_reach(tp)
        start = torch.searchsorted(self.b, bp.reshape(1))[0]  # rows with b >= b(p)
        idx = torch.arange(self.size, device=self.b.device)
        return (idx >= start) & (self.f >= fp)

    # -- exact queries (distances only on request) ------------------------
    def _dt_d(self, tp: TemporalPoint):
        dt = self.times - tp.time
        d = self.space.base.distance(tp.point, self.points)
        return dt, d

    def reachable_from(self, tp: TemporalPoint):
        """Exact mask: t_q ≥ t_p and d(p, q) ≤ t_q − t_p."""
        dt, d = self._dt_d(tp)
        return (dt >= 0.0) & (d <= dt)

    def nearest_reachable(self, tp: TemporalPoint):
        """Index (into the sorted arrays) minimizing the directed
        reach_plus_time metric from tp, and its value — +inf if none.
        Exact distances are evaluated only where the quadrant prune passes
        (the masked lanes cost nothing extra on device; the prune preserves
        the reference's no-false-negative guarantee)."""
        cand = self.candidate_mask_from(tp)
        dt, d = self._dt_d(tp)
        ok = cand & (dt >= 0.0) & (d <= dt)
        metric = torch.where(ok, dt + d, torch.inf)
        i = torch.argmin(metric)
        return i, metric[i]
