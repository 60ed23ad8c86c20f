"""Batched dense numerics: PD solves, least squares, matrix exponential,
norms (port of ``reak_tpu/math/linalg.py``).

Every function takes ``(..., n, n)`` / ``(..., n, m)`` tensors and
broadcasts over leading batch dimensions, as the JAX functions do; plain
torch, no kernel.  ``small_chol_solve`` is the plain path of
``ops/chol_lanes.chol_solve_auto`` (the unrolled Cholesky recurrence of the
JAX package).
"""
from __future__ import annotations

import torch


def _cholesky(A):
    """Lower Cholesky factor of each matrix of A, NaN where a matrix is not
    positive definite: the JAX package's ``jnp.linalg.cholesky`` on a
    batch.  ``torch.linalg.cholesky`` would raise for the whole batch and,
    on a card, read the status back to the host at every call;
    ``cholesky_ex`` leaves the status on the device and the factor of a
    positive-definite matrix bit for bit the same."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _nan_where_failed(X, info, core=2):
    """X, NaN throughout each batch entry whose ``info`` is not 0; ``info``
    has the batch shape of the factored matrices, X a batch shape that
    shape broadcasts to and ``core`` trailing axes."""
    bad = (info != 0).reshape(info.shape + (1,) * core)
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def _solve(A, B):
    """``torch.linalg.solve(A, B)``, NaN for each batch entry whose A is
    singular: the JAX package's ``jnp.linalg.solve`` gives non-finite values
    for that entry alone, where ``torch.linalg.solve`` raises for the whole
    batch and, on a card, reads the status back to the host at every call.
    ``solve_ex`` leaves the status on the device; on the other entries the
    result is ``solve``'s bit for bit."""
    X, info = torch.linalg.solve_ex(A, B)
    # B is a vector (or a batch of them) as torch.linalg.solve reads it
    vec = B.ndim == 1 or (B.ndim == A.ndim - 1 and B.shape == A.shape[:-1])
    return _nan_where_failed(X, info, 1 if vec else 2)


def _inv(A):
    """``torch.linalg.inv(A)`` with the rule of ``_solve``: NaN for each
    singular matrix of the batch, ``inv``'s values bit for bit elsewhere."""
    X, info = torch.linalg.inv_ex(A)
    return _nan_where_failed(X, info)


def _lu_factor(A):
    """``(LU, pivots)`` of ``torch.linalg.lu_factor_ex``, LU NaN for each
    singular matrix of the batch (``jax.scipy.linalg.lu_factor`` returns a
    factor with a zero pivot there, which its solve turns into non-finite
    values); for ``_lu_solve``."""
    LU, pivots, info = torch.linalg.lu_factor_ex(A)
    return _nan_where_failed(LU, info), pivots


def _lu_solve(LU, pivots, B):
    """Solve with the factor of ``_lu_factor``; ``B`` is (..., n) or
    (..., n, k).  An entry whose factor failed comes out NaN."""
    vec = B.ndim == LU.ndim - 1
    X = torch.linalg.lu_solve(LU, pivots, B[..., None] if vec else B)
    return X[..., 0] if vec else X


def _finite_or_eye(A):
    """(A with each non-finite matrix of the batch replaced by the identity,
    the batch's mask of finite matrices), the mask computed on the device."""
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-2], A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None, None], A, eye), ok


def _nan_unless(X, ok, core):
    """X, NaN throughout each batch entry where ``ok`` is false; X has
    ``core`` trailing axes past the batch shape of ``ok``."""
    keep = ok.reshape(ok.shape + (1,) * core)
    return torch.where(keep, X, torch.full_like(X, float("nan")))


def _eigh(A):
    """``torch.linalg.eigh(A)`` that never raises for the batch: each
    non-finite matrix is decomposed as the identity and its eigenvalues and
    vectors come out NaN, as the JAX package's ``jnp.linalg.eigh`` gives
    NaN for that entry alone; the other entries are ``eigh``'s bit for bit.
    ``torch.linalg.eigh`` has no ``_ex`` form, so on a card torch still
    reads its convergence status back to the host at every call: this
    removes the raise, not the read."""
    A_, ok = _finite_or_eye(A)
    w, V = torch.linalg.eigh(A_)
    return _nan_unless(w, ok, 1), _nan_unless(V, ok, 2)


def _eigvalsh(A):
    """``torch.linalg.eigvalsh(A)`` with the rule of ``_eigh``: NaN for each
    non-finite matrix, ``eigvalsh``'s values bit for bit elsewhere (the host
    read of the status stays on a card)."""
    A_, ok = _finite_or_eye(A)
    return _nan_unless(torch.linalg.eigvalsh(A_), ok, 1)


def _svd(A, full_matrices: bool = True):
    """``torch.linalg.svd(A, full_matrices)`` with the rule of ``_eigh``:
    (U, S, Vh) NaN for each non-finite matrix, ``svd``'s values bit for bit
    elsewhere (the host read of the status stays on a card)."""
    A_, ok = _finite_or_eye(A)
    U, S, Vh = torch.linalg.svd(A_, full_matrices=full_matrices)
    return (_nan_unless(U, ok, 2), _nan_unless(S, ok, 1),
            _nan_unless(Vh, ok, 2))


def symmetrize(A):
    """½(A + Aᵀ)."""
    return 0.5 * (A + A.transpose(-1, -2))


def solve_pd(A, b):
    """Solve A x = b for symmetric positive-definite A via Cholesky; ``b``
    is (..., n) or (..., n, k)."""
    L = _cholesky(A)
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def invert_pd(A):
    """Inverse of an SPD matrix via Cholesky."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return solve_pd(A, eye)


def logdet_pd(A):
    """log det of an SPD matrix."""
    L = _cholesky(A)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


def solve_lstsq(A, b):
    """Least-squares solve via QR."""
    q, r = torch.linalg.qr(A)
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    x = torch.linalg.solve_triangular(r, q.transpose(-1, -2) @ b,
                                      upper=True)
    return x[..., 0] if vec else x


def solve_minnorm(A, b):
    """Minimum-norm solution of underdetermined A x = b."""
    At = A.transpose(-1, -2)
    y = solve_pd(A @ At, b)
    if y.ndim == A.ndim - 1:
        return (At @ y[..., None])[..., 0]
    return At @ y


def _matpow(A2, p, eye):
    out = eye
    for _ in range(p):
        out = out @ A2
    return out


def expm_pade(A, order: int = 7, squarings: int = 8):
    """Matrix exponential by scaling and squaring with a diagonal Padé
    approximant, at a fixed squaring count (no norm-dependent branch)."""
    n = A.shape[-1]
    A = A / (2.0 ** squarings)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    c = [1.0]
    for k in range(1, order + 1):
        c.append(c[-1] * (order + 1 - k) / (k * (2 * order + 1 - k)))
    A2 = A @ A
    V = sum(c[k] * _matpow(A2, k // 2, eye) for k in range(0, order + 1, 2))
    U = A @ sum(c[k] * _matpow(A2, (k - 1) // 2, eye)
                for k in range(1, order + 1, 2))
    F = _solve(V - U, V + U)
    for _ in range(squarings):
        F = F @ F
    return F


def frobenius_norm(A):
    return torch.sqrt(torch.sum(A * A, dim=(-2, -1)))


def one_norm(A):
    """Max column abs sum."""
    return torch.amax(torch.sum(torch.abs(A), dim=-2), dim=-1)


def inf_norm(A):
    """Max row abs sum."""
    return torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)


def sqrtm_psd(A):
    """Symmetric PSD matrix square root via eigh (``_eigh``: NaN for a
    non-finite matrix of the batch, the others unaffected)."""
    w, V = _eigh(A)
    w = torch.clamp(w, min=0.0)
    return (V * torch.sqrt(w)[..., None, :]) @ V.transpose(-1, -2)


def small_chol_solve(G, rhs, unroll_max: int = 16):
    """SPD solve of tiny matrices: the unrolled Cholesky recurrence and
    substitutions as elementwise ops (up to ``unroll_max``; above it a
    library factor and triangular solves).  ``G``: (..., n, n), ``rhs``:
    (..., n, k) or (..., n)."""
    n = G.shape[-1]
    vec = rhs.ndim == G.ndim - 1
    if vec:
        rhs = rhs[..., None]
    if n > unroll_max:
        L = _cholesky(G)
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                          upper=True)
        return x[..., 0] if vec else x

    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = G[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def block_2x2(A, B, C, D):
    """Assemble [[A, B], [C, D]]."""
    top = torch.cat([A, B], dim=-1)
    bot = torch.cat([C, D], dim=-1)
    return torch.cat([top, bot], dim=-2)


def star_product(M1, M2):
    """Redheffer star product of 2x2-blocked symplectic maps; each argument
    is ((A, B), (C, D))."""
    (A1, B1), (C1, D1) = M1
    (A2, B2), (C2, D2) = M2
    n = A1.shape[-1]
    eye = torch.eye(n, dtype=A1.dtype, device=A1.device).expand(A1.shape)
    W = _solve(eye - B1 @ C2, A1)
    A = A2 @ W
    B = B2 + A2 @ _solve(eye - B1 @ C2, B1 @ D2)
    C = C1 + D1 @ C2 @ W
    D = D1 @ _solve(eye - C2 @ B1, D2)
    return ((A, B), (C, D))
