"""Euclidean / bounded vector spaces (port of ``reak_tpu/spaces/vector.py``).

(ref: ctrl/topologies/hyperbox_topology.hpp, hyperball_topology.hpp,
line_topology.hpp, vector_topology.hpp, Ndof_spaces.hpp:138)

Bounds given as tensors keep their device and dtype; numbers, lists and
numpy arrays take the device and dtype of the first bound that is a tensor,
else ``device`` (the card unless the caller asks for the CPU) and ``dtype``.
``sample(generator, batch)`` draws with the generator on the space's
device, in its dtype.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.interp.hermite import _as_tensors, _lift


def _clip(p, lower, upper):
    return torch.minimum(torch.maximum(p, lower), upper)


class HyperboxSpace:
    """Axis-aligned box with uniform sampling and L2 (optionally weighted)
    metric (ref: hyperbox_topology.hpp)."""

    def __init__(self, lower, upper, weights=None, device="cuda",
                 dtype=torch.float64):
        self.lower, self.upper, self.weights = _as_tensors(
            lower, upper, weights, device=device, dtype=dtype)

    @property
    def dim(self):
        return self.lower.shape[-1]

    def sample(self, generator, batch=()):
        u = torch.rand(tuple(batch) + tuple(self.lower.shape),
                       generator=generator, dtype=self.lower.dtype,
                       device=self.lower.device)
        return self.lower + u * (self.upper - self.lower)

    def distance(self, a, b):
        d = a - b
        if self.weights is not None:
            d = d * self.weights
        return torch.linalg.vector_norm(d, dim=-1)

    def interpolate(self, a, b, t):
        return a + (b - a) * _lift(t)

    def difference(self, a, b):
        return a - b

    def clamp(self, p):
        return _clip(p, self.lower, self.upper)

    def contains(self, p):
        return torch.all((p >= self.lower) & (p <= self.upper), dim=-1)


class NdofSpace(HyperboxSpace):
    """Joint space of an N-DoF arm: a named hyperbox over joint coordinates
    (ref: Ndof_spaces.hpp:138 Ndof_0th_order_space)."""

    @staticmethod
    def from_chain(spec, lower, upper, device="cuda", dtype=torch.float64):
        return NdofSpace(lower, upper, device=device, dtype=dtype)


class LineSpace(HyperboxSpace):
    """1-D segment (ref: line_topology.hpp line_segment_topology)."""

    def __init__(self, lo: float, hi: float, device="cuda",
                 dtype=torch.float64):
        super().__init__([lo], [hi], device=device, dtype=dtype)


class HyperballSpace:
    """Ball of given radius with uniform interior sampling
    (ref: hyperball_topology.hpp)."""

    def __init__(self, center, radius: float, device="cuda",
                 dtype=torch.float64):
        self.center, = _as_tensors(center, device=device, dtype=dtype)
        self.radius = float(radius)

    @property
    def dim(self):
        return self.center.shape[-1]

    def sample(self, generator, batch=()):
        n = self.dim
        kw = dict(generator=generator, dtype=self.center.dtype,
                  device=self.center.device)
        v = torch.randn(tuple(batch) + (n,), **kw)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        r = self.radius * torch.rand(tuple(batch), **kw) ** (1.0 / n)
        return self.center + v * r[..., None]

    def distance(self, a, b):
        return torch.linalg.vector_norm(a - b, dim=-1)

    def interpolate(self, a, b, t):
        return a + (b - a) * _lift(t)

    def difference(self, a, b):
        return a - b

    def clamp(self, p):
        d = p - self.center
        r = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        scale = torch.clamp_max(self.radius / torch.clamp_min(r, 1e-30), 1.0)
        return self.center + d * scale
