"""Space protocol + product composition (port of
``reak_tpu/spaces/base.py``).

(ref: ctrl/topologies/metric_space_concept.hpp MetricSpaceConcept,
metric_space_tuple.hpp product spaces — the tuple machinery collapses into a
tuple of component points.)
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class Space(Protocol):
    """Structural protocol for metric spaces (duck-typed; no registry).

    Points are tensors (or tuples of them for product spaces) with arbitrary
    leading batch axes.  ``sample`` draws from a ``torch.Generator`` on the
    device it draws for.
    """

    def sample(self, generator, batch: tuple = ()):  # → point(s)
        ...

    def distance(self, a, b):  # → (...,) metric distance
        ...

    def interpolate(self, a, b, t):  # geodesic point at fraction t ∈ [0,1]
        ...

    def difference(self, a, b):  # tangent delta from b to a
        ...

    def clamp(self, p):  # project into bounds
        ...


class ProductSpace:
    """Cartesian product of spaces over a tuple of point components
    (ref: metric_space_tuple.hpp).  Metric: weighted L2 of component metrics."""

    def __init__(self, spaces: Sequence, weights: Sequence[float] | None = None):
        self.spaces = tuple(spaces)
        self.weights = tuple(weights) if weights is not None else (1.0,) * len(spaces)

    def sample(self, generator, batch=()):
        """One draw per component, in order, from the same generator."""
        return tuple(s.sample(generator, batch) for s in self.spaces)

    def distance(self, a, b):
        d2 = 0.0
        for s, w, ai, bi in zip(self.spaces, self.weights, a, b):
            d = s.distance(ai, bi)
            d2 = d2 + w * d * d
        return torch.sqrt(d2)

    def interpolate(self, a, b, t):
        return tuple(s.interpolate(ai, bi, t) for s, ai, bi in zip(self.spaces, a, b))

    def difference(self, a, b):
        return tuple(s.difference(ai, bi) for s, ai, bi in zip(self.spaces, a, b))

    def clamp(self, p):
        return tuple(s.clamp(pi) for s, pi in zip(self.spaces, p))
