"""A failed Cholesky factor in the port: NaN for that batch entry and the
values of the JAX package for the others, where ``torch.linalg.cholesky``
raises for the whole batch (fault F9, repaired in the port).  Every port
site whose JAX counterpart calls ``jnp.linalg.cholesky`` goes through
``math/linalg._cholesky``; on positive-definite inputs its factor is
``torch.linalg.cholesky``'s bit for bit.  f64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import belief as jbel
from reak_tpu.math import linalg as jla
from reak_tpu_torch.ctrl import belief as bel, mpc_manifold as mm, \
    ss_systems as ss
from reak_tpu_torch.kte import dynamics, models
from reak_tpu_torch.math import linalg as la

torch.set_num_threads(1)


def _spd(rng, n, shape=()):
    g = rng.standard_normal(shape + (n, n))
    return g @ np.swapaxes(g, -1, -2) + n * np.eye(n)


def _batch_with_one_bad(rng, n, B=4, bad=2):
    """B SPD matrices, entry ``bad`` made indefinite."""
    A = _spd(rng, n, (B,))
    A[bad] = -A[bad]
    return A


def _check(got, want, bad):
    """NaN throughout entry ``bad`` (as JAX gives), the JAX values
    elsewhere (≤1e-12 relative)."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isnan(got[bad])) and np.all(np.isnan(want[bad]))
    keep = np.arange(got.shape[0]) != bad
    g, w = got[keep], want[keep]
    assert np.all(np.isfinite(g))
    assert np.max(np.abs(g - w)) <= 1e-12 * np.max(np.abs(w))


def test_solve_pd_and_logdet_pd():
    rng = np.random.default_rng(0)
    A = _batch_with_one_bad(rng, 5)
    b = rng.standard_normal((4, 5))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.as_tensor(A))
    _check(la.solve_pd(torch.as_tensor(A), torch.as_tensor(b)),
           jla.solve_pd(jnp.asarray(A), jnp.asarray(b)), 2)
    _check(la.logdet_pd(torch.as_tensor(A)), jla.logdet_pd(jnp.asarray(A)), 2)
    # solve_pd(stack([I₃, −I₃]), ones): the second entry all NaN
    eye = np.eye(3)
    got = la.solve_pd(torch.as_tensor(np.stack([eye, -eye])),
                      torch.ones(2, 3, dtype=torch.float64))
    assert torch.equal(got[0], torch.ones(3, dtype=torch.float64))
    assert bool(torch.isnan(got[1]).all())


def test_small_chol_solve_above_unroll():
    """n = 20 takes the library factor (above ``unroll_max`` = 16)."""
    rng = np.random.default_rng(1)
    G = _batch_with_one_bad(rng, 20, B=3, bad=0)
    rhs = rng.standard_normal((3, 20, 2))
    _check(la.small_chol_solve(torch.as_tensor(G), torch.as_tensor(rhs)),
           jla.small_chol_solve(jnp.asarray(G), jnp.asarray(rhs)), 0)


def test_belief_sample_and_sqrt_cov():
    """``sample`` draws through the factor: NaN for the indefinite
    covariance, ``mean + L z`` for the others.  ``sqrt_cov`` (eigh, its
    negative eigenvalues clamped, in both packages) does not raise and
    equals JAX's."""
    rng = np.random.default_rng(2)
    P = _batch_with_one_bad(rng, 4, B=3, bad=1)
    m = rng.standard_normal((3, 4))
    b = bel.GaussianBelief(torch.as_tensor(m), torch.as_tensor(P))
    got = b.sample(torch.Generator().manual_seed(3))
    z = torch.randn((3, 4), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).numpy()
    want = m.copy()
    for i in (0, 2):
        want[i] = m[i] + np.linalg.cholesky(P[i]) @ z[i]
    want[1] = np.nan
    _check(got, want, 1)
    sq = b.sqrt_cov.numpy()
    jsq = np.asarray(jbel.GaussianBelief(jnp.asarray(m),
                                         jnp.asarray(P)).sqrt_cov)
    assert np.max(np.abs(sq - jsq)) <= 1e-10 * np.max(np.abs(jsq))


def test_sampled_states_from_an_indefinite_covariance_are_nan():
    """``ctrl/mpc_manifold``'s draws: NaN states, no exception."""
    cov = -torch.eye(12, dtype=torch.float64)
    b = bel.GaussianBelief(ss.default_state(device="cpu"), cov)
    x0s = mm.sample_belief_states(torch.Generator().manual_seed(0), b, 5,
                                  ret=ss.sat3D_retraction())
    assert x0s.shape == (5, 13) and bool(torch.isnan(x0s).all())


def test_factor_bitwise_on_positive_definite_inputs():
    rng = np.random.default_rng(4)
    for n, shape in ((1, ()), (6, (7,)), (20, (2, 3))):
        A = torch.as_tensor(_spd(rng, n, shape))
        assert torch.equal(la._cholesky(A), torch.linalg.cholesky(A))
        assert torch.equal(la._cholesky(A.float()),
                           torch.linalg.cholesky(A.float()))


def test_linearize_fd_factor_unchanged():
    """``kte/dynamics.linearize_fd`` factors M through the helper: q̈ is bit
    for bit the solve with ``torch.linalg.cholesky``'s factor."""
    spec = models.planar_2link()
    q = torch.tensor([0.3, -0.4], dtype=torch.float64)
    qd = torch.tensor([0.1, 0.2], dtype=torch.float64)
    qdd, _, _, _ = dynamics.linearize_fd(spec, q, qd)
    M, f = dynamics.dynamics_terms(spec, q, qd)
    L = torch.linalg.cholesky(M)
    y = torch.linalg.solve_triangular(L, f[:, None], upper=False)
    want = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    assert torch.equal(qdd, want)
