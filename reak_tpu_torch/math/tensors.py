"""Order-3/4 tensor algebra, mode-n products and the HOSVD / CP-ALS
decompositions (port of ``reak_tpu/math/tensors.py``; ref:
core/tensors/tensor_alg_rectangular.hpp, tensor_alg_square.hpp,
tensor_alg_nil.hpp).

A "tensor type" is a tensor with contraction conventions: the named
contractions below are einsums, batched over leading axes where the JAX
functions are.  Plain torch on the device of the inputs.

Planned differences: ``identity3`` takes a ``device`` (default ``"cuda"``),
as the port's functions that make tensors from nothing do; ``cp_als`` takes
a ``torch.Generator`` where the JAX function takes a PRNG key, so its random
start, and the small columns that pad a short HOSVD factor, are torch draws,
not JAX's (see ``cp_als``).  The signs of singular vectors differ between
LAPACK, cuSOLVER and XLA, so ``hosvd``'s factors agree with JAX's up to the
sign of each column; its reconstructions and projectors U Uᵀ agree.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.math.linalg import _solve, _svd


def tensor3_vec(T, v):
    """Mode-3 contraction: (..., i, j, k) × (..., k) → (..., i, j)
    (the reference's tensor-from-matrix adaptor applied in reverse)."""
    return torch.einsum("...ijk,...k->...ij", T, v)


def tensor3_mat(T, M):
    """Mode-3 matrix product: (..., i, j, k) × (..., k, l) → (..., i, j, l)."""
    return torch.einsum("...ijk,...kl->...ijl", T, M)


def vec_tensor3(v, T):
    """Mode-1 contraction: (..., i) × (..., i, j, k) → (..., j, k)."""
    return torch.einsum("...i,...ijk->...jk", v, T)


def tensor4_mat(T, M):
    """Double contraction: (..., i, j, k, l) × (..., k, l) → (..., i, j)
    (e.g. an elasticity tensor applied to a strain matrix)."""
    return torch.einsum("...ijkl,...kl->...ij", T, M)


def outer3(a, b, c):
    """Rank-1 order-3 tensor a ⊗ b ⊗ c."""
    return torch.einsum("...i,...j,...k->...ijk", a, b, c)


def identity3(n, dtype=torch.float32, device="cuda"):
    """δ_ij e_k-style 'nil + diagonal' helper (ref: tensor_alg_nil.hpp role:
    structural zero/identity tensors collapse into explicit arrays here)."""
    eye = torch.eye(n, dtype=dtype, device=device)
    return torch.einsum("ij,k->ijk", eye,
                        torch.ones(n, dtype=dtype, device=device))


def sym_part3(T):
    """Symmetrize an order-3 tensor over its last two indices."""
    return 0.5 * (T + T.transpose(-1, -2))


# ---------------------------------------------------------------------------
# generic mode-n machinery (the reference's adaptor layer — a tensor viewed
# as a matrix along any mode — as explicit unfold/fold and mode products)
# ---------------------------------------------------------------------------


def unfold(T, mode: int):
    """Mode-n matricization: move ``mode`` first, flatten the rest →
    (I_mode, prod(other dims)), the remaining modes row-major."""
    return torch.movedim(T, mode, 0).reshape(T.shape[mode], -1)


def fold(M, mode: int, shape):
    """Inverse of :func:`unfold` back to ``shape``."""
    full = (shape[mode],) + tuple(s for i, s in enumerate(shape) if i != mode)
    return torch.movedim(M.reshape(full), 0, mode)


def mode_dot(T, M, mode: int):
    """Mode-n product T ×_n M: contract tensor mode ``mode`` with the last
    axis of matrix ``M`` — T'(..., a, ...) = Σ_b M[a, b] T(..., b, ...)."""
    out = torch.tensordot(M, T, dims=([1], [mode]))
    return torch.movedim(out, 0, mode)


def multi_mode_dot(T, mats):
    """Apply ``mats[i]`` along mode i for every non-None entry (Tucker-style
    multilinear transform; e.g. rotating every index of a stiffness tensor
    into a new frame)."""
    for i, M in enumerate(mats):
        if M is not None:
            T = mode_dot(T, M, i)
    return T


def ttt(A, B, modes_a, modes_b):
    """Tensor-times-tensor contraction over the given mode lists
    (the general contraction of core/tensors/tensor_concepts.hpp)."""
    return torch.tensordot(A, B, dims=(list(modes_a), list(modes_b)))


def tensor3_rotate(T, R):
    """Rotate all three indices of an order-3 tensor into the frame of R:
    T'_{abc} = R_{ai} R_{bj} R_{ck} T_{ijk}."""
    return multi_mode_dot(T, [R, R, R])


def tensor4_rotate(T, R):
    """Rotate all four indices: T'_{abcd} = R_{ai}R_{bj}R_{ck}R_{dl} T_{ijkl}."""
    return multi_mode_dot(T, [R, R, R, R])


# ---------------------------------------------------------------------------
# decompositions: HOSVD / Tucker truncation and CP-ALS (fixed iteration
# counts, no data-dependent shapes)
# ---------------------------------------------------------------------------


def hosvd(T, ranks=None):
    """Higher-order SVD (Tucker via mode-wise SVDs).

    ``ranks``: optional per-mode truncation (defaults to full).  Returns
    ``(core, factors)`` with ``T ≈ multi_mode_dot(core, factors)``; factors
    have orthonormal columns (left singular vectors of each unfolding, each
    column's sign as the linear-algebra library gives it).  The full-rank
    reconstruction is exact to machine precision.  A tensor that is not
    finite gives NaN factors and core (``math/linalg._svd``), where
    ``torch.linalg.svd`` would raise for a batch under vmap."""
    if ranks is None:
        ranks = T.shape
    factors = []
    for mode in range(T.ndim):
        U, _, _ = _svd(unfold(T, mode), full_matrices=False)
        factors.append(U[:, : ranks[mode]])
    core = multi_mode_dot(T, [U.T for U in factors])
    return core, factors


def tucker_reconstruct(core, factors):
    """Inverse of :func:`hosvd`: core ×_0 U_0 ×_1 U_1 ⋯."""
    return multi_mode_dot(core, factors)


def _khatri_rao(mats):
    out = mats[0]
    for M in mats[1:]:
        out = (out[:, None, :] * M[None, :, :]).reshape(-1, M.shape[1])
    return out


def cp_als(T, rank: int, n_iters: int = 50, generator=None):
    """CP decomposition by alternating least squares.

    Returns ``(weights (rank,), factors [(I_i, rank)])`` with
    ``T ≈ Σ_r weights[r] · ⊗_i factors[i][:, r]``.  Fixed ``n_iters``
    sweeps (no convergence branch).  Normalization is folded into
    ``weights`` each sweep — the standard Kolda-Bader ALS recursion.

    With ``generator=None`` the factors start from the HOSVD's leading
    vectors.  A mode shorter than ``rank`` pads its factor with small
    pseudo-random columns, not zeros: if two or more modes padded with
    zeros, the padded component's Khatri-Rao column would be identically
    zero and the component could never leave zero.  The pad of mode i is
    0.1 × standard normal draws of a CPU ``torch.Generator`` seeded i, the
    same on every device (the JAX package draws them from
    ``fold_in(PRNGKey(0), i)``; a planned difference).  With a
    ``torch.Generator`` (where the JAX function takes ``key``), every factor
    starts from standard normal draws of that generator, on its device."""
    d = T.ndim
    if generator is None:
        _, factors = hosvd(T, ranks=[min(rank, s) for s in T.shape])
        padded = []
        for mode, U in enumerate(factors):
            if U.shape[1] < rank:
                extra = 0.1 * torch.randn(
                    (U.shape[0], rank - U.shape[1]), dtype=T.dtype,
                    generator=torch.Generator().manual_seed(mode))
                U = torch.cat([U, extra.to(T.device)], dim=1)
            padded.append(U[:, :rank])
        factors = padded
    else:
        factors = [torch.randn((s, rank), dtype=T.dtype,
                               generator=generator,
                               device=generator.device).to(T.device)
                   for s in T.shape]
    weights = torch.ones((rank,), dtype=T.dtype, device=T.device)
    ridge = 1e-10 * torch.eye(rank, dtype=T.dtype, device=T.device)

    for _ in range(n_iters):
        for mode in range(d):
            others = [factors[i] for i in range(d) if i != mode]
            # gram of the Khatri-Rao product = Hadamard of the grams
            G = torch.ones((rank, rank), dtype=T.dtype, device=T.device)
            for M in others:
                G = G * (M.T @ M)
            # unfold() flattens the remaining modes row-major (first
            # remaining mode slowest), so the Khatri-Rao runs in ascending
            # mode order (Kolda-Bader's reversed order assumes the
            # column-major unfolding convention)
            rhs = unfold(T, mode) @ _khatri_rao(others)     # (I_mode, rank)
            F = _solve(G + ridge, rhs.T).T
            norms = torch.clamp(torch.linalg.vector_norm(F, dim=0),
                                min=1e-30)
            factors[mode] = F / norms
            weights = norms
    return weights, factors


def cp_reconstruct(weights, factors):
    """Σ_r weights[r] · ⊗_i factors[i][:, r]."""
    d = len(factors)
    letters = "abcdefgh"[:d]
    spec = ",".join(f"{c}r" for c in letters) + ",r->" + letters
    return torch.einsum(spec, *factors, weights)
