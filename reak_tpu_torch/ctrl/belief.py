"""Gaussian belief states (port of ``reak_tpu/ctrl/belief.py``; ref:
ctrl/ctrl_sys/gaussian_belief_state.hpp:603, covariance_matrix.hpp:59,
covariance_info_matrix.hpp, decomp_covariance_matrix.hpp).

A belief is ``GaussianBelief(mean, cov)`` with leading batch axes allowed;
the reference's covariance storage policies (matrix / information /
square-root decomposed) are conversions on it.  Everything computes on the
device of the belief's tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reak_tpu_torch.math.linalg import _cholesky, invert_pd, logdet_pd, \
    solve_pd, sqrtm_psd


class GaussianBelief(NamedTuple):
    mean: torch.Tensor  # (..., n)
    cov: torch.Tensor  # (..., n, n)

    @property
    def information_matrix(self):
        """(ref: covariance_info_matrix.hpp)"""
        return invert_pd(self.cov)

    @property
    def sqrt_cov(self):
        """Symmetric square-root factor (ref: decomp_covariance_matrix.hpp)."""
        return sqrtm_psd(self.cov)

    def logpdf(self, x):
        """(ref: gaussian_belief_state.hpp gaussian_pdf)"""
        n = self.mean.shape[-1]
        r = x - self.mean
        maha = torch.einsum("...i,...i->...", r, solve_pd(self.cov, r))
        return -0.5 * (maha + logdet_pd(self.cov) + n * math.log(2 * math.pi))

    def sample(self, generator: torch.Generator, shape=()):
        """Draw samples with ``generator`` (on the belief's device; JAX takes
        a key) (ref: gaussian_belief_state.hpp:491 sample_gaussian_point)."""
        L = _cholesky(self.cov)
        z = torch.randn(tuple(shape) + tuple(self.mean.shape),
                        generator=generator, dtype=self.mean.dtype,
                        device=self.mean.device)
        return self.mean + torch.einsum("...ij,...j->...i", L, z)


def mahalanobis(b: GaussianBelief, x):
    r = x - b.mean
    return torch.sqrt(torch.einsum("...i,...i->...", r, solve_pd(b.cov, r)))


def symmetrized(b: GaussianBelief) -> GaussianBelief:
    return GaussianBelief(b.mean, 0.5 * (b.cov + b.cov.transpose(-1, -2)))


def kl_divergence(b1: GaussianBelief, b2: GaussianBelief):
    """KL(b1 ‖ b2) — the belief-space distance used by gaussian_belief_space
    (ref: gaussian_belief_space.hpp:64 symmetrized KL metric)."""
    n = b1.mean.shape[-1]
    d = b2.mean - b1.mean
    tr = torch.diagonal(solve_pd(b2.cov, b1.cov), dim1=-2, dim2=-1).sum(-1)
    maha = torch.einsum("...i,...i->...", d, solve_pd(b2.cov, d))
    return 0.5 * (tr + maha - n + logdet_pd(b2.cov) - logdet_pd(b1.cov))


def belief_distance(b1: GaussianBelief, b2: GaussianBelief):
    """Symmetrized KL (the reference's belief-space metric)."""
    return kl_divergence(b1, b2) + kl_divergence(b2, b1)
