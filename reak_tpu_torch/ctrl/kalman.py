"""Kalman-family filters as pure (belief, u, z) → belief functions (port of
``reak_tpu/ctrl/kalman.py``; ref: ctrl/ctrl_sys/kalman_filter.hpp:88
kalman_predict, :144 kalman_update, :214 kalman_filter_step,
kalman_bucy_filter.hpp, hybrid_kalman_filter.hpp).

Systems are functions of one state; Jacobians come from
``torch.func.jacfwd`` at the belief mean.  A filter takes one belief, and
``torch.func.vmap`` maps it over Monte-Carlo runs.

The manifold hook: ``adjust(x, dx)`` / ``diff(z, ẑ)`` default to vector
addition / subtraction and may implement a retraction (ref: the
``state_space.adjust`` of kalman_filter.hpp:170-179).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd

from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.math.linalg import solve_pd, symmetrize


def _default_adjust(x, dx):
    return x + dx


def _default_diff(a, b):
    return a - b


def ekf_predict(F: Callable, b: GaussianBelief, u, Q, t=0.0,
                adjust=_default_adjust) -> GaussianBelief:
    """EKF prediction (ref: kalman_filter.hpp:88-110 kalman_predict):
    x⁺ = F(x, u),  P⁺ = A P Aᵀ + Q  with A = ∂F/∂x."""
    x = b.mean
    A = jacfwd(lambda xx: F(xx, u, t))(x)
    x1 = F(x, u, t)
    P1 = A @ b.cov @ A.mT + Q
    return GaussianBelief(x1, symmetrize(P1))


def ekf_update(h: Callable, b: GaussianBelief, z, R, t=0.0,
               adjust=_default_adjust, diff=_default_diff) -> GaussianBelief:
    """EKF measurement update (ref: kalman_filter.hpp:144-179
    kalman_update): innovation y = diff(z, h(x)); S = C P Cᵀ + R;
    K = P Cᵀ S⁻¹ (Cholesky); mean ← adjust(x, K y); P in Joseph form."""
    x, P = b.mean, b.cov
    C = jacfwd(lambda xx: h(xx, t))(x)
    y = diff(z, h(x, t))
    S = C @ P @ C.mT + R
    K = solve_pd(S, C @ P).mT  # P Cᵀ S⁻¹
    x1 = adjust(x, K @ y)
    n = x.shape[-1]
    IKC = torch.eye(n, dtype=P.dtype, device=P.device) - K @ C
    # Joseph form for covariance (symmetric, PSD-preserving)
    P1 = IKC @ P @ IKC.mT + K @ R @ K.mT
    return GaussianBelief(x1, symmetrize(P1))


def ekf_step(F, h, b, u, z, Q, R, t=0.0, adjust=_default_adjust,
             diff=_default_diff):
    """Predict + update (ref: kalman_filter.hpp:214 kalman_filter_step)."""
    return ekf_update(h, ekf_predict(F, b, u, Q, t, adjust), z, R, t, adjust,
                      diff)


def kalman_bucy_step(f: Callable, h: Callable, b: GaussianBelief, u, z, Q,
                     R, dt, t=0.0) -> GaussianBelief:
    """Continuous-time Kalman-Bucy filter, one Euler step of the joint mean
    and covariance ODE (ref: ctrl/ctrl_sys/kalman_bucy_filter.hpp):
      ẋ = f(x,u) + K(z − h(x)),  Ṗ = AP + PAᵀ + Q − P Cᵀ R⁻¹ C P,
      K = P Cᵀ R⁻¹."""
    x, P = b.mean, b.cov
    A = jacfwd(lambda xx: f(xx, u, t))(x)
    C = jacfwd(lambda xx: h(xx, t))(x)
    K = solve_pd(R, C @ P).mT
    xdot = f(x, u, t) + K @ (z - h(x, t))
    Pdot = A @ P + P @ A.mT + Q - K @ C @ P
    return GaussianBelief(x + dt * xdot, symmetrize(P + dt * Pdot))


def hybrid_ekf_step(f, h, b, u, z, Q, R, dt, t=0.0, substeps: int = 1):
    """Hybrid continuous-predict / discrete-update EKF (ref:
    ctrl/ctrl_sys/hybrid_kalman_filter.hpp): RK4 on the mean, Lyapunov
    Euler substeps on the covariance, then a discrete update."""
    x, P = b.mean, b.cov
    h_dt = dt / substeps
    for _ in range(substeps):
        A = jacfwd(lambda xx: f(xx, u, t))(x)
        k1 = f(x, u, t)
        k2 = f(x + 0.5 * h_dt * k1, u, t)
        k3 = f(x + 0.5 * h_dt * k2, u, t)
        k4 = f(x + h_dt * k3, u, t)
        x = x + h_dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        P = P + h_dt * (A @ P + P @ A.mT + Q)
        t = t + h_dt
    return ekf_update(h, GaussianBelief(x, symmetrize(P)), z, R, t)


def filter_trajectory(step_fn, b0: GaussianBelief, us, zs, **kw):
    """Run a filter over measurement sequences; returns the beliefs after
    each step stacked on a leading time axis, means (T, n) and covariances
    (T, n, n) (the batch_KF_on_meas_vector loop of
    estimate_satellite3D.cpp:406)."""
    b, means, covs = b0, [], []
    for u, z in zip(us, zs):
        b = step_fn(b, u, z, **kw)
        means.append(b.mean)
        covs.append(b.cov)
    return GaussianBelief(torch.stack(means), torch.stack(covs))
