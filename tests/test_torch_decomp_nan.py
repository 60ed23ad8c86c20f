"""A non-finite matrix in the port's eigen- and singular-value
decompositions: NaN for that batch entry and, for the others, the values
of the batch without it, bit for bit — where ``torch.linalg.eigh``,
``eigvalsh`` and ``svd`` raise for the whole batch (fault F14, repaired in
the port by ``math/linalg._eigh``, ``_eigvalsh`` and ``_svd``).  The JAX
package gives NaN for that entry alone; the port's values on the others
match it to 1e-12 (eigenvectors and singular vectors up to sign, so
through what they reconstruct).  The three sites: ``math/linalg.
sqrtm_psd``, ``math/tensors.hosvd`` and ``opt/nlp.pd_shift`` (and through
it ``newton_method`` and ``augmented_lagrangian``).  f64 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.math import linalg as jla, tensors as jtensors
from reak_tpu.opt import nlp as jnlp
from reak_tpu_torch import opt
from reak_tpu_torch.math import linalg as la, tensors
from reak_tpu_torch.opt import nlp

torch.set_num_threads(1)
vmap = torch.func.vmap


def _spd(rng, B=4, n=4):
    g = rng.standard_normal((B, n, n))
    return g @ g.transpose(0, 2, 1) + n * np.eye(n)


def _without(x, bad):
    return torch.cat([x[:bad], x[bad + 1:]])


def _close(got, want, tol=1e-12):
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= tol


@pytest.mark.parametrize("bad_value", [float("nan"), float("inf")])
@pytest.mark.parametrize("name", ["eigh", "eigvalsh", "svd", "svd_thin"])
def test_helpers_nan_for_the_nonfinite_entry_only(name, bad_value):
    rng = np.random.default_rng(0)
    A = _spd(rng) if name.startswith("eig") else rng.standard_normal((4, 5,
                                                                       3))
    A[1, 0, 1] = bad_value
    if name.startswith("eig"):
        A[1, 1, 0] = bad_value
    A = torch.as_tensor(A)
    kw = {"full_matrices": False} if name == "svd_thin" else {}
    plain = getattr(torch.linalg, name[:3] if name == "svd_thin" else name)
    helper = getattr(la, "_" + (name[:3] if name == "svd_thin" else name))
    if bad_value != bad_value:  # LAPACK fails on NaN; inf may go through
        with pytest.raises(torch.linalg.LinAlgError):
            plain(A, **kw)
    got = helper(A, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = plain(_without(A, 1), **kw)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert bool(torch.isnan(g[1]).all())
        assert torch.equal(_without(g, 1), w)
    # the JAX package: NaN for entry 1 alone, the port's values elsewhere
    jA = jnp.asarray(A.numpy())
    keep = [0, 2, 3]
    if name == "eigvalsh":
        jw = np.asarray(jnp.linalg.eigvalsh(jA))
        assert not np.all(np.isfinite(jw[1]))
        _close(got[0][keep], jw[keep])
    elif name == "eigh":
        jw, jV = map(np.asarray, jnp.linalg.eigh(jA))
        assert not np.all(np.isfinite(jw[1]))
        _close(got[0][keep], jw[keep])
        rec = lambda w, V: V @ (w[..., None] * np.swapaxes(V, -1, -2))
        _close(rec(got[0].numpy(), got[1].numpy())[keep],
               rec(jw, jV)[keep], 1e-11)
    else:
        jU, jS, jVh = map(np.asarray, jnp.linalg.svd(jA, **kw))
        assert not np.all(np.isfinite(jS[1]))
        _close(got[1][keep], jS[keep])
        k = jS.shape[-1]
        rec = lambda U, S, Vh: (U[..., :k] * S[..., None, :]) @ Vh[..., :k, :]
        _close(rec(*(g.numpy() for g in got))[keep],
               rec(jU, jS, jVh)[keep], 1e-11)


def test_helpers_bitwise_on_finite_inputs():
    rng = np.random.default_rng(1)
    for shape in ((), (3,), (2, 3)):
        S = torch.as_tensor(_spd(rng, B=1, n=5)[0]).expand(shape + (5, 5))
        G = torch.as_tensor(rng.standard_normal(shape + (5, 3)))
        for dt in (torch.float64, torch.float32):
            S_, G_ = S.to(dt), G.to(dt)
            for g, w in zip(la._eigh(S_), torch.linalg.eigh(S_)):
                assert torch.equal(g, w)
            assert torch.equal(la._eigvalsh(S_), torch.linalg.eigvalsh(S_))
            for fm in (True, False):
                for g, w in zip(la._svd(G_, full_matrices=fm),
                                torch.linalg.svd(G_, full_matrices=fm)):
                    assert torch.equal(g, w)


def test_sqrtm_psd_and_sqrt_cov():
    """``sqrtm_psd`` (``ctrl/belief.GaussianBelief.sqrt_cov``) on four
    covariances, the third holding a NaN."""
    from reak_tpu_torch.ctrl.belief import GaussianBelief

    rng = np.random.default_rng(2)
    P = _spd(rng)
    P[2, 3, 3] = np.nan
    P = torch.as_tensor(P)
    got = la.sqrtm_psd(P)
    assert bool(torch.isnan(got[2]).all())
    assert torch.equal(_without(got, 2), la.sqrtm_psd(_without(P, 2)))
    assert torch.allclose(GaussianBelief(mean=torch.zeros(
        4, 4, dtype=torch.float64), cov=P).sqrt_cov, got, rtol=0, atol=0,
        equal_nan=True)
    want = np.asarray(jla.sqrtm_psd(jnp.asarray(P.numpy())))
    assert not np.all(np.isfinite(want[2]))
    _close(got[[0, 1, 3]], want[[0, 1, 3]], 1e-11)


def test_hosvd_batch_with_one_nan_tensor():
    """``hosvd`` under ``vmap`` over three (6, 5, 4) tensors, the second
    holding a NaN; the reconstructions against the JAX package's."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((3, 6, 5, 4))
    X[1, 2, 2, 2] = np.nan
    X = torch.as_tensor(X)
    core, factors = vmap(tensors.hosvd)(X)
    for a in (core, *factors):
        assert bool(torch.isnan(a[1]).all())
    core_ok, factors_ok = vmap(tensors.hosvd)(_without(X, 1))
    for a, b in zip((core, *factors), (core_ok, *factors_ok)):
        assert torch.equal(_without(a, 1), b)
    rec = vmap(tensors.tucker_reconstruct)(core, factors)
    jcore, jfactors = jax.vmap(jtensors.hosvd)(jnp.asarray(X.numpy()))
    jrec = np.asarray(jax.vmap(jtensors.tucker_reconstruct)(jcore, jfactors))
    assert not np.all(np.isfinite(jrec[1]))
    _close(rec[[0, 2]], jrec[[0, 2]], 1e-11)


def _ros(c):
    return lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                               + (c - x[:-1]) ** 2)


def _nan_batch(rng, B=6, bad=3):
    c = rng.uniform(0.5, 1.5, B)
    x0 = np.array([-1.2, 1.0]) + rng.uniform(-0.1, 0.1, (B, 2))
    c[bad] = x0[bad, 0] = np.nan
    return torch.as_tensor(c), torch.as_tensor(x0), bad


@pytest.mark.parametrize("site", ["pd_shift", "newton_method",
                                  "augmented_lagrangian"])
def test_opt_sites_keep_the_batch(site):
    """One problem with a NaN parameter comes out NaN; the other problems
    equal the batch without it, bit for bit."""
    c, x0, bad = _nan_batch(np.random.default_rng(4))
    if site == "pd_shift":
        run = lambda c, x: nlp.pd_shift(torch.func.hessian(_ros(c))(x))
    elif site == "newton_method":
        run = lambda c, x: opt.newton_method(_ros(c), x, iters=20).x
    else:
        run = lambda c, x: opt.augmented_lagrangian(
            lambda y: torch.sum((y - c) ** 2), x,
            ce=lambda y: torch.stack([y[0] + y[1] - 1.0]), outer_iters=4,
            inner_iters=8).x
    got = vmap(run)(c, x0)
    assert bool(torch.isnan(got[bad]).all())
    assert torch.equal(_without(got, bad), vmap(run)(_without(c, bad),
                                                     _without(x0, bad)))
    if site == "pd_shift":
        jros = lambda c: lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                           + (c - x[:-1]) ** 2)
        want = np.asarray(jax.vmap(lambda c, x: jnlp.pd_shift(
            jax.hessian(jros(c))(x)))(jnp.asarray(c.numpy()),
                                      jnp.asarray(x0.numpy())))
        assert np.isnan(want[bad])
        keep = [i for i in range(len(want)) if i != bad]
        _close(got[keep], want[keep], 1e-9)
