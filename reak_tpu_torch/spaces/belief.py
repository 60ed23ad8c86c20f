"""Gaussian belief-space topology — beliefs as a metric space for planners
(port of ``reak_tpu/spaces/belief.py``).

(ref: ctrl/ctrl_sys/gaussian_belief_space.hpp:64 gaussian_belief_space — a
 product of a mean-point topology and a covariance topology
 (covar_topology.hpp), with the symmetrized-KL belief distance; consumed by
 the topology-generic planning machinery.)

A belief point is a FLAT tensor ``[mean (n) | vech(S) (n(n+1)/2)]`` where S
is the lower-triangular square-root factor of the covariance (P = S Sᵀ) —
the reference's decomposed covariance storage
(decomp_covariance_matrix.hpp), chosen because linear interpolation of
square-root factors stays positive-semidefinite, so the array-backed
planners (``planning/rrt.py`` fixed-capacity vertex tables) treat beliefs
exactly like joint vectors.  Distance is the square root of the
symmetrized KL divergence of ``ctrl.belief``.  ``pack`` factors through ``math/linalg._cholesky``: a
covariance that is not positive definite packs to NaN in its own row, with
no host read.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from reak_tpu_torch.ctrl.belief import GaussianBelief, belief_distance
from reak_tpu_torch.interp.hermite import _as_tensors, _lift
from reak_tpu_torch.math.linalg import _cholesky


@lru_cache(maxsize=None)
def _tril_table(n: int):
    """Row and column of each packed entry of the lower triangle, row by
    row (``numpy.tril_indices``), and the packed positions of the
    diagonal."""
    i, j = np.tril_indices(n)
    return i, j, np.nonzero(i == j)[0]


@lru_cache(maxsize=None)
def _tril_indices(n: int, device: torch.device):
    """``_tril_table(n)`` as int64 tensors on ``device``, made once per
    (n, device)."""
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in _tril_table(n))


class GaussianBeliefSpace:
    """Metric space over Gaussian beliefs on an n-dim mean box.

    ``sigma_range = (s_min, s_max)``: sampled beliefs carry diagonal
    square-root factors with per-axis scales in this interval (the covariance
    "topology" of covar_topology.hpp — a bounded PSD cone chart).  Bounds
    follow ``spaces/vector``'s rule (``device``, the card unless the caller
    asks for the CPU, and ``dtype`` for numbers and numpy arrays).
    """

    order = 0

    def __init__(self, mean_lower, mean_upper, sigma_range=(0.05, 1.0),
                 mean_weight: float = 1.0, device="cuda",
                 dtype=torch.float64):
        lower, upper = _as_tensors(mean_lower, mean_upper, device=device,
                                   dtype=dtype)
        self.mean_lower = torch.atleast_1d(lower)
        self.mean_upper = torch.atleast_1d(upper)
        self.n = self.mean_lower.shape[-1]
        self.s_min, self.s_max = float(sigma_range[0]), float(sigma_range[1])
        self.mean_weight = float(mean_weight)
        self.n_tril = self.n * (self.n + 1) // 2

    # ---- packing ---------------------------------------------------------
    @property
    def dim(self):
        return self.n + self.n_tril

    def pack(self, b: GaussianBelief):
        """GaussianBelief → flat point (works on batches)."""
        eye = torch.eye(self.n, dtype=b.cov.dtype, device=b.cov.device)
        S = _cholesky(b.cov + 1e-12 * eye)
        i, j, _ = _tril_indices(self.n, S.device)
        return torch.cat([b.mean, S[..., i, j]], dim=-1)

    def unpack(self, x) -> GaussianBelief:
        """Flat point → GaussianBelief (works on batches)."""
        mean = x[..., : self.n]
        i, j, _ = _tril_indices(self.n, x.device)
        S = x.new_zeros(x.shape[:-1] + (self.n, self.n))
        S[..., i, j] = x[..., self.n:]
        # keep the diagonal positive under interpolation/packing noise
        d = torch.abs(torch.diagonal(S, dim1=-2, dim2=-1)) + 1e-9
        S = torch.diagonal_scatter(S, d, dim1=-2, dim2=-1)
        return GaussianBelief(mean, S @ S.mT)

    # ---- Space interface (planners) --------------------------------------
    def sample(self, generator, batch=()):
        """Uniform means in the box and diagonal square-root factors in
        ``sigma_range``, drawn from ``generator`` (on the bounds' device)
        in the bounds' dtype: the means first, as the JAX package's
        ``k1``."""
        kw = dict(generator=generator, dtype=self.mean_lower.dtype,
                  device=self.mean_lower.device)
        shape = tuple(batch) + (self.n,)
        mean = self.mean_lower + torch.rand(shape, **kw) * (
            self.mean_upper - self.mean_lower)
        sig = self.s_min + torch.rand(shape, **kw) * (self.s_max - self.s_min)
        _, _, diag = _tril_indices(self.n, mean.device)
        v = mean.new_zeros(tuple(batch) + (self.n_tril,))
        v[..., diag] = sig
        return torch.cat([mean, v], dim=-1)

    def distance(self, a, b):
        """The square root of the symmetrized KL divergence (ref:
        gaussian_belief_space.hpp:64 — the belief metric; the JAX docstring
        says the divergence itself), with the mean part optionally
        re-weighted; ``a`` and ``b`` broadcast against each other first."""
        ba, bb = map(self.unpack, torch.broadcast_tensors(a, b))
        d = belief_distance(ba, bb)
        if self.mean_weight != 1.0:
            dm = torch.sum((ba.mean - bb.mean) ** 2, dim=-1)
            d = d + (self.mean_weight - 1.0) * dm
        return torch.sqrt(torch.clamp_min(d, 0.0))

    def interpolate(self, a, b, t):
        """Linear on (mean, sqrt-factor): the PSD-cone geodesic chart the
        square-root storage makes linear."""
        return a + (b - a) * _lift(t)

    def difference(self, a, b):
        return a - b

    def clamp(self, x):
        mean = torch.minimum(torch.maximum(x[..., : self.n], self.mean_lower),
                             self.mean_upper)
        return torch.cat([mean, x[..., self.n:]], dim=-1)
