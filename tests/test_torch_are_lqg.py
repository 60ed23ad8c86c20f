"""The port's Riccati solvers (reak_tpu_torch.math.are) and LQR/LQG layer
(ctrl.lqg) against the JAX package on the same numpy inputs, f64 on the
CPU: every function at batch shapes () and (3,), ≤1e-9 relative, on the
systems of ``tests/test_are_spectral.py`` and ``tests/test_filters.py:
184-205``; each solution also holds its defining equation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import lqg as jlqg
from reak_tpu.math import are as jare
from reak_tpu_torch.ctrl import lqg
from reak_tpu_torch.math import are

torch.set_num_threads(1)


def _close(got, want, rtol=1e-9):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)),
                                                    1e-300)


def _stack(make, shape, rng):
    """``make(rng)`` once, or once for each of 3 batch entries, stacked."""
    if shape == ():
        return make(rng)
    return tuple(np.stack(a) for a in zip(*(make(rng) for _ in range(3))))


def _spr_cont_system(rng, n=5, m=2):
    """tests/test_are_spectral.py:10-19: strictly positive-real."""
    M = rng.standard_normal((n, n))
    A = -(M @ M.T) - 0.7 * np.eye(n) + 0.3 * rng.standard_normal((n, n))
    B = rng.standard_normal((n, m))
    C = B.T @ (np.eye(n) * 2.0)
    D = np.eye(m) * 1.5 + 0.2 * rng.standard_normal((m, m))
    return A, B, C, D


def _dtsf_system(rng, n=5, m=2):
    """tests/test_are_spectral.py:49-58, drawn again until the spectral
    density E + H(zI−F)⁻¹G + (H(zI−F)⁻¹G)ᴴ is positive definite on the unit
    circle (1,441 points), the condition for the factorization to exist;
    the construction alone does not ensure it."""
    while True:
        F = 0.5 * rng.standard_normal((n, n))
        F = F / max(1.0, 1.3 * np.max(np.abs(np.linalg.eigvals(F))))
        G = 0.5 * rng.standard_normal((n, m))
        H, J = G.T @ (np.eye(n) * 0.6), np.eye(m) * 2.0
        z = np.exp(1j * np.linspace(0.0, np.pi, 1441))[:, None, None]
        T = H @ np.linalg.solve(z * np.eye(n) - F, G)
        phi = J + J.T + T + np.conj(np.swapaxes(T, -1, -2))
        if np.min(np.linalg.eigvalsh(phi)) > 0.0:
            return F, G, H, J


def _lqg_system(rng, n=4, m=2, p=3):
    """tests/test_are_spectral.py:69-77 (continuous) with the weights of
    :91-97."""
    return (rng.standard_normal((n, n)), rng.standard_normal((n, m)),
            rng.standard_normal((p, n)), np.eye(n) * 0.3, np.eye(p) * 0.2,
            np.eye(n) * 2.0, np.eye(m) * 0.5)


def _dlqg_system(rng, n=4, m=2, p=3):
    """tests/test_are_spectral.py:86-97."""
    return (0.9 * rng.standard_normal((n, n)) / np.sqrt(n),
            rng.standard_normal((n, m)), rng.standard_normal((p, n)),
            np.eye(n) * 0.3, np.eye(p) * 0.2, np.eye(n), np.eye(m) * 0.4)


def _lin_sys(rng, dt=0.1):
    """tests/test_filters.py:13-17 and the weights of :184-205."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    C = np.array([[1.0, 0.0]])
    return A, B, C, np.eye(2), np.eye(1) * 0.1, np.eye(2) * 1e-3, \
        np.eye(1) * 1e-2


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*(torch.as_tensor(a) for a in arrays))
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    return got, want


SHAPES = [(), (3,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_solve_care_dare_and_lqr(shape):
    rng = np.random.default_rng(0)
    A, B, _, _, _, Q, R = _stack(_lqg_system, shape, rng)
    F, G, _, _, _, Qd, Rd = _stack(_dlqg_system, shape, rng)
    for fn in ("solve_care", "clqr"):
        got, want = _both(getattr(are, fn), getattr(jare, fn), A, B, Q, R)
        for g, w in zip(*((got, want) if fn == "clqr" else ((got,),
                                                             (want,)))):
            _close(g, w)
    for fn in ("solve_dare", "dlqr"):
        got, want = _both(getattr(are, fn), getattr(jare, fn), F, G, Qd, Rd)
        for g, w in zip(*((got, want) if fn == "dlqr" else ((got,),
                                                            (want,)))):
            _close(g, w)
    # the defining equations
    P = are.solve_care(*(torch.as_tensor(a) for a in (A, B, Q, R))).numpy()
    res = (np.swapaxes(A, -1, -2) @ P + P @ A
           - P @ B @ np.linalg.solve(R, np.swapaxes(B, -1, -2)) @ P + Q)
    assert np.max(np.abs(res)) < 1e-8
    X = are.solve_dare(*(torch.as_tensor(a) for a in (F, G, Qd, Rd))).numpy()
    Ft, Gt = np.swapaxes(F, -1, -2), np.swapaxes(G, -1, -2)
    res = (Ft @ X @ F - X - Ft @ X @ G @ np.linalg.solve(
        Rd + Gt @ X @ G, Gt @ X @ F) + Qd)
    assert np.max(np.abs(res)) < 1e-8


@pytest.mark.parametrize("shape", SHAPES)
def test_spectral_factorizations(shape):
    # each system from the seed of tests/conftest.py's ``rng`` fixture, as
    # tests/test_are_spectral.py draws it
    rng = np.random.default_rng(42)
    A, B, C, D = _stack(_spr_cont_system, shape, rng)
    got, want = _both(are.solve_ctsf, jare.solve_ctsf, A, B, C, D)
    _close(got, want)
    E = D + np.swapaxes(D, -1, -2)
    Abar = A - B @ np.linalg.solve(E, C)
    P = got.numpy()
    res = (B @ np.linalg.solve(E, np.swapaxes(B, -1, -2))
           + P @ np.swapaxes(Abar, -1, -2) + Abar @ P
           + P @ np.swapaxes(C, -1, -2) @ np.linalg.solve(E, C) @ P)
    assert np.max(np.abs(res)) < 1e-10
    F, G, H, J = _stack(_dtsf_system, shape, np.random.default_rng(42))
    got, want = _both(are.solve_dtsf, jare.solve_dtsf, F, G, H, J)
    _close(got, want)
    P = got.numpy()
    E = J + np.swapaxes(J, -1, -2)
    Ht, Ft = np.swapaxes(H, -1, -2), np.swapaxes(F, -1, -2)
    res = (-P + F @ P @ Ft + (G - F @ P @ Ht) @ np.linalg.solve(
        E - H @ P @ Ht, np.swapaxes(G, -1, -2) - H @ P @ Ft))
    assert np.max(np.abs(res)) < 1e-10


@pytest.mark.parametrize("shape", SHAPES)
def test_infinite_horizon_lqg(shape):
    rng = np.random.default_rng(2)
    sys_c = _stack(_lqg_system, shape, rng)
    got, want = _both(are.solve_ihct_lqg, jare.solve_ihct_lqg, *sys_c)
    for g, w in zip(got, want):
        _close(g, w)
    sys_d = _stack(_dlqg_system, shape, rng)
    got, want = _both(are.solve_ihdt_lqg, jare.solve_ihdt_lqg, *sys_d)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_dlqg_clqg(shape):
    """At a batch the JAX ``dlqg`` transposes every axis of its estimator
    gain (``.T``, fault F12 of the reference), so the reference there is
    ``jax.vmap`` of the function, entry by entry."""
    rng = np.random.default_rng(3)
    A, B, C, Q, R, W, V = _stack(_lin_sys, shape, rng)
    args = (A, B, C, Q, R, W, V)
    for fn in ("dlqg", "clqg"):
        jfn = getattr(jlqg, fn)
        if shape:
            jfn = jax.vmap(jfn)
        got, want = _both(getattr(lqg, fn), jfn, *args)
        for f in ("K", "L", "P", "S"):
            _close(getattr(got, f), getattr(want, f))
    g = lqg.dlqg(*(torch.as_tensor(a) for a in args))
    eig = np.linalg.eigvals(A - B @ g.K.numpy())
    assert np.all(np.abs(eig) < 1)
    eig = np.linalg.eigvals((np.eye(2) - g.L.numpy() @ C) @ A)
    assert np.all(np.abs(eig) < 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_finite_horizon_dlqr(shape):
    rng = np.random.default_rng(4)
    A, B, _, Q, R, _, _ = _stack(_lin_sys, shape, rng)
    args = (A, B, Q, R, Q)
    Ks, P0 = lqg.finite_horizon_dlqr(*(torch.as_tensor(a) for a in args),
                                     40)
    jKs, jP0 = jlqg.finite_horizon_dlqr(*(jnp.asarray(a) for a in args), 40)
    _close(Ks, jKs)
    _close(P0, jP0)
    # the first gain of a long horizon is the infinite-horizon gain
    Ks, _ = lqg.finite_horizon_dlqr(*(torch.as_tensor(a) for a in args), 200)
    Kinf, _ = are.dlqr(*(torch.as_tensor(a) for a in (A, B, Q, R)))
    assert float((Ks[0] - Kinf).abs().max()) < 1e-8
