"""The planners' random draws, behind one small interface.

The JAX planners split ``PRNGKey`` schedules inside their loops; a
``torch.Generator`` cannot reproduce those streams.  Every planner of the
port therefore takes each of its draws through a draw object with four
methods, in the order its JAX counterpart draws:

- ``sample(space, batch)``: points of ``space`` (``space.sample``);
- ``uniform(shape, like)``: U[0, 1) of ``like``'s dtype on its device;
- ``normal(shape, like)``: N(0, 1), likewise;
- ``randint(low, high, shape, device)``: int64 in [low, high).

``Draws`` (the default) draws from one seeded ``torch.Generator`` on the
planner's device.  ``HostDraws`` draws from a seeded numpy stream on the
host and moves the values to the device, so that the card and the CPU get
the same numbers.  ``ReplayDraws`` hands back given arrays in turn, e.g. a
JAX planner's own draws computed from its key schedule.
"""
from __future__ import annotations

import numpy as np
import torch


def space_like(space):
    """(device, dtype) of a space's bounds: the first tensor among its
    ``lower``, ``center``, ``base`` or ``spaces``; the CPU in float64 for a
    space that holds none."""
    for name in ("lower", "center"):
        x = getattr(space, name, None)
        if isinstance(x, torch.Tensor):
            return x.device, x.dtype
    base = getattr(space, "base", None)
    if base is not None:
        return space_like(base)
    for s in getattr(space, "spaces", ()):
        return space_like(s)
    return torch.device("cpu"), torch.float64


class Draws:
    """Draws from one ``torch.Generator`` on ``device``, seeded with
    ``seed`` (or the given ``generator``, whose device it takes)."""

    def __init__(self, seed: int = 0, device="cuda", generator=None):
        if generator is None:
            generator = torch.Generator(torch.device(device))
            generator.manual_seed(int(seed))
        self.generator = generator
        self.device = generator.device

    def sample(self, space, batch):
        return space.sample(self.generator, tuple(batch))

    def uniform(self, shape, like):
        return torch.rand(tuple(shape), generator=self.generator,
                          dtype=like.dtype, device=like.device)

    def normal(self, shape, like):
        return torch.randn(tuple(shape), generator=self.generator,
                           dtype=like.dtype, device=like.device)

    def randint(self, low, high, shape, device):
        return torch.randint(int(low), int(high), tuple(shape),
                             generator=self.generator, device=device)


class HostDraws:
    """Draws from ``numpy.random.default_rng(seed)`` on the host, moved to
    the device they are asked for.  ``sample`` takes a box space's bounds
    to the host (``lower + u (upper − lower)`` in numpy), so the points are
    the same bits on every device."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def sample(self, space, batch):
        lo = space.lower.detach().cpu().numpy()
        hi = space.upper.detach().cpu().numpy()
        u = self.rng.random(tuple(batch) + lo.shape)
        return torch.as_tensor(lo + u * (hi - lo), dtype=space.lower.dtype,
                               device=space.lower.device)

    def uniform(self, shape, like):
        return torch.as_tensor(self.rng.random(tuple(shape)),
                               dtype=like.dtype, device=like.device)

    def normal(self, shape, like):
        return torch.as_tensor(self.rng.standard_normal(tuple(shape)),
                               dtype=like.dtype, device=like.device)

    def randint(self, low, high, shape, device):
        return torch.as_tensor(self.rng.integers(low, high, tuple(shape)),
                               dtype=torch.int64, device=device)


class ReplayDraws:
    """Hands back ``arrays`` in turn, whatever is asked, as tensors on the
    asking device (points and uniforms in the space's or ``like``'s dtype,
    integers as int64).  An item may be a callable of the shape asked for
    (for draws whose shape the run decides), and a point may be a tuple of
    arrays (a record such as ``NdofPoint1``), which comes back as that
    record of tensors.  Each array's leading shape must be the shape asked
    for.  ``used`` counts the items handed back."""

    def __init__(self, arrays):
        self.arrays = list(arrays)
        self.used = 0

    def _next(self, shape):
        if self.used >= len(self.arrays):
            raise IndexError(f"replay exhausted after {self.used} draws")
        a = self.arrays[self.used]
        self.used += 1
        if callable(a):
            a = a(tuple(shape))
        for x in (a if isinstance(a, tuple) else (a,)):
            if tuple(np.shape(x)[:len(shape)]) != tuple(shape):
                raise ValueError(f"draw {self.used - 1}: replayed shape "
                                 f"{np.shape(x)}, asked for {tuple(shape)}")
        return a

    def sample(self, space, batch):
        device, dtype = space_like(space)
        a = self._next(batch)
        as_t = lambda x: torch.as_tensor(np.array(x), dtype=dtype,
                                         device=device)
        if isinstance(a, tuple):
            return type(a)(*(as_t(x) for x in a))
        return as_t(a)

    def uniform(self, shape, like):
        return torch.as_tensor(np.array(self._next(shape)), dtype=like.dtype,
                               device=like.device)

    normal = uniform

    def randint(self, low, high, shape, device):
        return torch.as_tensor(np.array(self._next(shape)),
                               dtype=torch.int64, device=device)


def as_draws(seed, device):
    """A draw object from a planner's ``seed`` argument: an int seeds a
    ``Draws`` on ``device``, a ``torch.Generator`` is wrapped, and anything
    with a ``sample`` method is a draw object already."""
    if hasattr(seed, "sample") and hasattr(seed, "uniform"):
        return seed
    if isinstance(seed, torch.Generator):
        return Draws(generator=seed)
    return Draws(int(seed), device)
