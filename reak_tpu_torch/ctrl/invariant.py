"""Invariant / manifold (multiplicative) EKF (port of
``reak_tpu/ctrl/invariant.py``; ref: ctrl/ctrl_sys/
invariant_kalman_filter.hpp:278, invariant_system_concept.hpp:209,
aggregate_kalman_filter.hpp:278, symplectic_kalman_filter.hpp:285).

The manifold structure is a retraction pair and the error-state Jacobians
come by forward-mode AD (``torch.func.jacfwd``) through the retraction:

    A = ∂/∂e  local(F(retract(x, e), u),  F(x, u)) |_{e=0}
    C = ∂/∂e  h(retract(x, e))                     |_{e=0}

A retraction indexes the LAST axis of the state and the tangent
(``x[..., :qi]``), where the JAX one slices a single state and relies on
``vmap``: one call serves a single state and a batch of them, with the
same values for a single state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd

from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.math import rotations as rot
from reak_tpu_torch.math.linalg import _inv, solve_pd, symmetrize


class Retraction(NamedTuple):
    """Manifold chart: ``retract(x, e)`` perturbs state x by tangent e;
    ``local(x1, x0)`` is its inverse: the tangent taking x0 to x1.
    ``dim``: tangent dimension (may differ from the ambient state's)."""

    retract: Callable
    local: Callable
    dim: int


def vector_retraction(n: int) -> Retraction:
    return Retraction(retract=lambda x, e: x + e, local=lambda a, b: a - b,
                      dim=n)


def quat_state_retraction(quat_index: int, n_state: int,
                          n_tangent: int) -> Retraction:
    """Retraction for states embedding one unit quaternion at
    ``x[..., quat_index:quat_index+4]``; the tangent uses a 3-vector rotation
    error (right-multiplicative, body frame — the reference's invariant
    error frame, ref: satellite_invar_models.hpp:296)."""
    qi = quat_index

    def retract(x, e):
        # tangent: [pre (maps to x[..., :qi]), δθ (3,), post]
        q_new = rot.qmul(x[..., qi:qi + 4], rot.q_exp(e[..., qi:qi + 3]))
        return torch.cat([x[..., :qi] + e[..., :qi], q_new,
                          x[..., qi + 4:] + e[..., qi + 3:]], dim=-1)

    def local(x1, x0):
        dth = rot.q_log(rot.qmul(rot.qconj(x0[..., qi:qi + 4]),
                                 x1[..., qi:qi + 4]))
        return torch.cat([x1[..., :qi] - x0[..., :qi], dth,
                          x1[..., qi + 4:] - x0[..., qi + 4:]], dim=-1)

    return Retraction(retract=retract, local=local, dim=n_tangent)


def iekf_predict(F: Callable, ret: Retraction, b: GaussianBelief, u, Q,
                 t=0.0):
    """Invariant/multiplicative EKF predict: the mean by full nonlinear
    propagation, the covariance in the tangent space (ref:
    invariant_kalman_filter.hpp predict)."""
    x1 = F(b.mean, u, t)
    zero = torch.zeros(ret.dim, dtype=b.mean.dtype, device=b.mean.device)
    A = jacfwd(lambda e: ret.local(F(ret.retract(b.mean, e), u, t), x1))(zero)
    P1 = A @ b.cov @ A.T + Q
    return GaussianBelief(x1, symmetrize(P1))


def iekf_update(h: Callable, ret: Retraction, b: GaussianBelief, z, R,
                t=0.0, diff=None):
    """Invariant update with manifold mean correction (ref:
    invariant_kalman_filter.hpp:278 update).  With ``diff`` (manifold-valued
    outputs such as a quaternion pose) the innovation itself is linearized,
    y(e) = diff(z, h(retract(x, e))) ≈ y0 − C·e."""
    zero = torch.zeros(ret.dim, dtype=b.mean.dtype, device=b.mean.device)
    z_hat = h(b.mean, t)
    if diff is None:
        C = jacfwd(lambda e: h(ret.retract(b.mean, e), t))(zero)
        y = z - z_hat
    else:
        C = -jacfwd(lambda e: diff(z, h(ret.retract(b.mean, e), t)))(zero)
        y = diff(z, z_hat)
    S = C @ b.cov @ C.T + R
    K = solve_pd(S, C @ b.cov).T
    x1 = ret.retract(b.mean, K @ y)
    eye = torch.eye(ret.dim, dtype=b.cov.dtype, device=b.cov.device)
    IKC = eye - K @ C
    P1 = IKC @ b.cov @ IKC.T + K @ R @ K.T
    return GaussianBelief(x1, symmetrize(P1))


def iekf_step(F, h, ret, b, u, z, Q, R, t=0.0, diff=None):
    """(ref: invariant_kalman_filter.hpp invariant_kalman_filter_step)"""
    return iekf_update(h, ret, iekf_predict(F, ret, b, u, Q, t), z, R, t,
                       diff)


# ---------------------------------------------------------------------------
# Symplectic / aggregate covariance propagation
# (ref: ctrl/ctrl_sys/aggregate_kalman_filter.hpp:278,
#  symplectic_kalman_filter.hpp:285, mat_star_product.hpp)
# ---------------------------------------------------------------------------


class HamiltonianMap(NamedTuple):
    """Blocks ((T11, T12), (T21, T22)) of the symplectic covariance flow."""

    blocks: tuple


def hamiltonian_predict_map(A, Q) -> HamiltonianMap:
    """Prediction as a Hamiltonian map: P⁺ = (T21 + T22 P)(T11 + T12 P)⁻¹
    with T = [[A⁻ᵀ, 0], [Q A⁻ᵀ, A]]."""
    Ait = _inv(A).transpose(-1, -2)
    z = torch.zeros_like(A)
    return HamiltonianMap(((Ait, z), (Q @ Ait, A)))


def hamiltonian_update_map(C, R) -> HamiltonianMap:
    """Update as a Hamiltonian map: T = [[I, CᵀR⁻¹C], [0, I]]."""
    n = C.shape[-1]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    z = torch.zeros_like(eye)
    CtRC = C.transpose(-1, -2) @ solve_pd(R, C)
    return HamiltonianMap(((eye, CtRC), (z, eye)))


def apply_hamiltonian(T: HamiltonianMap, P):
    """Propagate a covariance through a Hamiltonian map."""
    (T11, T12), (T21, T22) = T.blocks
    num = T21 + T22 @ P
    den = T11 + T12 @ P
    return symmetrize(num @ _inv(den))


def compose_hamiltonian(T2: HamiltonianMap,
                        T1: HamiltonianMap) -> HamiltonianMap:
    """Aggregate two covariance flows (T2 ∘ T1), the product of the 2n×2n
    block matrices (ref: aggregate_kalman_filter.hpp)."""
    (A11, A12), (A21, A22) = T2.blocks
    (B11, B12), (B21, B22) = T1.blocks
    return HamiltonianMap((
        (A11 @ B11 + A12 @ B21, A11 @ B12 + A12 @ B22),
        (A21 @ B11 + A22 @ B21, A21 @ B12 + A22 @ B22),
    ))
