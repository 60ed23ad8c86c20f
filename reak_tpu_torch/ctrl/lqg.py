"""LQR / LQG controllers (port of ``reak_tpu/ctrl/lqg.py``; ref:
ctrl/ctrl_sys/lqr_controllers.hpp:58 IHDT_LQR, :259 IHCT_LQR; LQG = LQR +
steady-state Kalman gain by duality).

A thin layer over the ARE solvers of :mod:`reak_tpu_torch.math.are`;
finite-horizon time-varying LQR is a backward Riccati loop.  Every function
broadcasts over leading batch axes.  ``dlqg``'s estimator gain is
transposed on its last two axes: the JAX function transposes every axis
(``.T``), which reverses a batch's axes (fault F12 of the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.math.are import clqr, dlqr, solve_care, solve_dare
from reak_tpu_torch.math.linalg import _inv, solve_pd


class LQGGains(NamedTuple):
    K: torch.Tensor  # control gain, u = −K x̂
    L: torch.Tensor  # estimator gain
    P: torch.Tensor  # control cost-to-go
    S: torch.Tensor  # estimation error covariance


def dlqg(A, B, C, Q, R, W, V, iters: int = 30) -> LQGGains:
    """Discrete-time LQG: LQR gain + steady-state Kalman gain (dual DARE).
    W = process noise covariance, V = measurement noise covariance."""
    K, P = dlqr(A, B, Q, R, iters)
    # estimation DARE on the dual system (Aᵀ, Cᵀ)
    S = solve_dare(A.mT, C.mT, W, V, iters)
    L = solve_pd(C @ S @ C.mT + V, C @ S).mT  # S Cᵀ (CSCᵀ+V)⁻¹
    return LQGGains(K=K, L=L, P=P, S=S)


def clqg(A, B, C, Q, R, W, V, iters: int = 40) -> LQGGains:
    """Continuous-time LQG (ref: lqr_controllers.hpp:259 + Kalman-Bucy
    dual)."""
    K, P = clqr(A, B, Q, R, iters)
    S = solve_care(A.mT, C.mT, W, V, iters)
    L = S @ C.mT @ _inv(V)
    return LQGGains(K=K, L=L, P=P, S=S)


def finite_horizon_dlqr(A, B, Q, R, QN, horizon: int):
    """Time-varying LQR gains by a backward Riccati loop: Ks (H, ..., m, n),
    first stage first, and the cost-to-go P0."""
    P, Ks = QN, []
    Bt = B.mT
    for _ in range(horizon):
        K = solve_pd(R + Bt @ P @ B, Bt @ P @ A)
        AK = A - B @ K
        P = Q + K.mT @ R @ K + AK.mT @ P @ AK
        Ks.append(K)
    return torch.stack(Ks).flip(0), P
