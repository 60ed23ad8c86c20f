"""Algebraic Riccati equation solvers (CARE / DARE), batched (port of
``reak_tpu/math/are.py``; ref: core/lin_alg/mat_are_solver.hpp:1449,1598).

Iteration schemes with fixed iteration counts, made of batched matrix
products and solves, as the JAX package has them:

- DARE: the structure-preserving doubling algorithm (SDA), quadratically
  convergent; ~25 doublings reach f64 machine precision.
- CARE: the matrix sign function of the Hamiltonian with determinant
  scaling, then a least-squares extraction of the stabilizing solution.

Every function broadcasts over leading batch axes and computes on the
device of its inputs; a ``lax.scan`` of the JAX package is a Python loop.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.math.linalg import _inv, _solve, solve_pd, symmetrize


def _eye_like(A):
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)


def solve_dare(A, B, Q, R, iters: int = 30):
    """Stabilizing solution of  AᵀXA − X − AᵀXB(R + BᵀXB)⁻¹BᵀXA + Q = 0.

    Structure-preserving doubling:  with G₀ = B R⁻¹ Bᵀ, H₀ = Q, A₀ = A,
      A_{k+1} = A_k (I + G_k H_k)⁻¹ A_k
      G_{k+1} = G_k + A_k (I + G_k H_k)⁻¹ G_k A_kᵀ
      H_{k+1} = H_k + A_kᵀ H_k (I + G_k H_k)⁻¹ A_k
    H_k → X quadratically.  (ref behavior: mat_are_solver.hpp
    solve_dare_problem)
    """
    eye = _eye_like(A)
    Ak, Gk, Hk = A, B @ solve_pd(R, B.mT), Q
    for _ in range(iters):
        W = eye + Gk @ Hk
        WinvA = _solve(W, Ak)
        WinvG = _solve(W, Gk)
        A1 = Ak @ WinvA
        G1 = Gk + Ak @ WinvG @ Ak.mT
        H1 = Hk + WinvA.mT @ Hk @ Ak
        Ak, Gk, Hk = A1, symmetrize(G1), symmetrize(H1)
    return symmetrize(Hk)


def solve_care(A, B, Q, R, iters: int = 40):
    """Stabilizing solution of  AᵀX + XA − XBR⁻¹BᵀX + Q = 0.

    Matrix-sign-function method on the Hamiltonian
    H = [[A, −G], [−Q, −Aᵀ]], G = B R⁻¹ Bᵀ: Newton iteration
    Z ← ½(c⁻¹ Z + c Z⁻¹) with determinant scaling c = |det Z|^{1/2n} (1
    where that is not finite and positive, per batch entry); then X solves
    [S₁₂; S₂₂ + I] X = −[S₁₁ + I; S₂₁]  in the least-squares sense.
    (ref behavior: mat_are_solver.hpp solve_care_problem)
    """
    n = A.shape[-1]
    G = B @ solve_pd(R, B.mT)
    top = torch.cat([A, -G], dim=-1)
    bot = torch.cat([-Q, -A.mT], dim=-1)
    Z = torch.cat([top, bot], dim=-2)
    for _ in range(iters):
        Zinv = _inv(Z)
        _, logabsdet = torch.linalg.slogdet(Z)
        c = torch.exp(logabsdet / (2 * n))
        c = torch.where(torch.isfinite(c) & (c > 0), c, torch.ones_like(c))
        c = c[..., None, None]
        Z = 0.5 * (Z / c + c * Zinv)
    S11, S12 = Z[..., :n, :n], Z[..., :n, n:]
    S21, S22 = Z[..., n:, :n], Z[..., n:, n:]
    eye = _eye_like(A)
    M = torch.cat([S12, S22 + eye], dim=-2)          # (2n, n)
    rhs = -torch.cat([S11 + eye, S21], dim=-2)       # (2n, n)
    X = _solve(M.mT @ M, M.mT @ rhs)
    return symmetrize(X)


def dlqr(A, B, Q, R, iters: int = 30):
    """Discrete-time infinite-horizon LQR gain K (u = −K x) and cost-to-go
    P (ref: ctrl/ctrl_sys/lqr_controllers.hpp:58 IHDT_LQR_controller)."""
    P = solve_dare(A, B, Q, R, iters)
    Bt = B.mT
    K = solve_pd(R + Bt @ P @ B, Bt @ P @ A)
    return K, P


def clqr(A, B, Q, R, iters: int = 40):
    """Continuous-time infinite-horizon LQR gain K (u = −K x) and
    cost-to-go P (ref: ctrl/ctrl_sys/lqr_controllers.hpp:259
    IHCT_LQR_controller)."""
    P = solve_care(A, B, Q, R, iters)
    K = solve_pd(R, B.mT @ P)
    return K, P


# ---------------------------------------------------------------------------
# Spectral factorization & infinite-horizon LQG
# (ref: mat_are_solver.hpp:2624 solve_ctsf_problem, :2754 solve_dtsf_problem,
#  :2136 solve_IHCT_LQG, :2606 solve_IHDT_LQG; here the same solutions by
#  the CARE/DARE reductions below.)
# ---------------------------------------------------------------------------


def solve_ctsf(A, B, C, D, iters: int = 40):
    """Continuous-time spectral factorization: the P ⪰ 0 solving

        B E⁻¹ Bᵀ + P Āᵀ + Ā P + P Cᵀ E⁻¹ C P = 0,
        E = D + Dᵀ,  Ā = A − B E⁻¹ C

    (ref: mat_are_solver.hpp:2624).  Reduction: X = −P solves the standard
    CARE with A_c = Āᵀ, S = CᵀE⁻¹C and the indefinite Q_c = −BE⁻¹Bᵀ, which
    the sign-function solver takes (it needs only the Hamiltonian off the
    imaginary axis)."""
    E = D + D.mT
    Abar = A - B @ solve_pd(E, C)
    W = B @ solve_pd(E, B.mT)
    X = solve_care(Abar.mT, C.mT, -W, E, iters=iters)
    return symmetrize(-X)


def solve_dtsf(A, B, C, D, iters: int = 30):
    """Discrete-time spectral factorization: the P ⪰ 0 solving

        P = F P Fᵀ + (G − F P Hᵀ)(E − H P Hᵀ)⁻¹(Gᵀ − H P Fᵀ),
        E = J + Jᵀ   (F = A, G = B, H = C, J = D in the reference's naming)

    (ref: mat_are_solver.hpp:2754).  Reduction: Y = −P solves the
    cross-term-free filter DARE with F̄ = F − G E⁻¹ H, R = E and the
    indefinite Q̄ = −G E⁻¹ Gᵀ: ``solve_dare(F̄ᵀ, Hᵀ, Q̄, E)``."""
    F, G, H, J = A, B, C, D
    E = J + J.mT
    Fbar = F - G @ solve_pd(E, H)
    Qbar = -G @ solve_pd(E, G.mT)
    Y = solve_dare(Fbar.mT, H.mT, Qbar, E, iters=iters)
    return symmetrize(-Y)


def solve_ihct_lqg(A, B, C, V, W, Q, R, iters: int = 40):
    """Infinite-horizon continuous-time LQG: (K, P, L, S), the LQR gain K
    (u = −Kx̂) with cost-to-go P, and the steady-state Kalman-Bucy gain L
    with error covariance S (ref: mat_are_solver.hpp:2136 solve_IHCT_LQG;
    one control CARE and one filter CARE)."""
    K, P = clqr(A, B, Q, R, iters)
    S = solve_care(A.mT, C.mT, V, W, iters)
    L = solve_pd(W, C @ S).mT
    return K, P, L, S


def solve_ihdt_lqg(F, G, H, V, W, Q, R, iters: int = 30):
    """Infinite-horizon discrete-time LQG: (K, P, L, S) with K the LQR gain,
    S the steady-state predicted error covariance and L = SHᵀ(W+HSHᵀ)⁻¹ the
    Kalman gain (ref: mat_are_solver.hpp:2606 solve_IHDT_LQG)."""
    K, P = dlqr(F, G, Q, R, iters)
    S = solve_dare(F.mT, H.mT, V, W, iters)
    L = solve_pd(W + H @ S @ H.mT, H @ S).mT
    return K, P, L, S
