"""Unscented Kalman filter (port of ``reak_tpu/ctrl/ukf.py``; ref:
ctrl/ctrl_sys/unscented_kalman_filter.hpp:65).

Sigma points from the Cholesky factor of the covariance; the propagation
of all 2n+1 points is one ``torch.func.vmap`` of the system function, which
takes one state.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.math.linalg import _cholesky, solve_pd, symmetrize


def sigma_points(b: GaussianBelief, alpha=1e-1, beta=2.0, kappa=0.0):
    """Merwe scaled sigma points: (points (2n+1, n), wm, wc)."""
    n = b.mean.shape[-1]
    lam = alpha * alpha * (n + kappa) - n
    L = _cholesky((n + lam) * b.cov)
    m = b.mean[None, :]
    pts = torch.cat([m, m + L.mT, m - L.mT], dim=0)
    rest = torch.full((2 * n,), 0.5 / (n + lam), dtype=b.mean.dtype,
                      device=b.mean.device)
    wm = torch.cat([rest.new_full((1,), lam / (n + lam)), rest])
    wc = torch.cat([rest.new_full((1,), lam / (n + lam)
                                  + (1 - alpha * alpha + beta)), rest])
    return pts, wm, wc


def ukf_predict(F: Callable, b, u, Q, t=0.0, alpha=1e-1, beta=2.0,
                kappa=0.0):
    """(ref: unscented_kalman_filter.hpp unscented_kalman_predict)"""
    pts, wm, wc = sigma_points(b, alpha, beta, kappa)
    prop = vmap(lambda p: F(p, u, t))(pts)
    mean = wm @ prop
    d = prop - mean
    cov = torch.einsum("k,ki,kj->ij", wc, d, d) + Q
    return GaussianBelief(mean, symmetrize(cov))


def ukf_update(h: Callable, b, z, R, t=0.0, alpha=1e-1, beta=2.0,
               kappa=0.0):
    """(ref: unscented_kalman_filter.hpp unscented_kalman_update)"""
    pts, wm, wc = sigma_points(b, alpha, beta, kappa)
    zs = vmap(lambda p: h(p, t))(pts)
    z_hat = wm @ zs
    dz = zs - z_hat
    dx = pts - b.mean
    S = torch.einsum("k,ki,kj->ij", wc, dz, dz) + R
    Pxz = torch.einsum("k,ki,kj->ij", wc, dx, dz)
    K = solve_pd(S, Pxz.mT).mT
    mean = b.mean + K @ (z - z_hat)
    cov = b.cov - K @ S @ K.mT
    return GaussianBelief(mean, symmetrize(cov))


def ukf_step(F, h, b, u, z, Q, R, t=0.0, **kw):
    """Predict + update (the reference's per-row UKF loop)."""
    return ukf_update(h, ukf_predict(F, b, u, Q, t, **kw), z, R, t, **kw)
