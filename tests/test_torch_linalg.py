"""The port's batched dense numerics (reak_tpu_torch.math.linalg) and the
batch-first Cholesky dispatch ``ops/chol_lanes.chol_solve_auto`` against
the JAX package on the same seeded numpy inputs, f64 on the CPU.  Bar:
≤1e-12 relative for every function of ``math/linalg.py``; for
``chol_solve_auto``, batched (against ``jax.vmap`` of the JAX function) and
unbatched, ≤1e-12 relative, and no kernel launch on CPU tensors (the plain
``small_chol_solve``, as the JAX function takes off the TPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.math import linalg as jla
from reak_tpu.ops import chol_lanes as jchol
from reak_tpu_torch.math import linalg as la
from reak_tpu_torch.ops import chol_lanes

torch.set_num_threads(1)

BATCH = (3, 2)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _spd(rng, n, batch=BATCH):
    a = rng.standard_normal(batch + (n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _cases(rng):
    """{name: (jax function, port function, numpy arguments)}."""
    n = 5
    A = _spd(rng, n)
    b = rng.standard_normal(BATCH + (n,))
    Bk = rng.standard_normal(BATCH + (n, 3))
    tall = rng.standard_normal(BATCH + (7, n))
    wide = rng.standard_normal(BATCH + (3, n))
    small = 0.3 * rng.standard_normal(BATCH + (n, n))
    blocks = [rng.standard_normal(BATCH + (2, 2)) for _ in range(4)]
    s1 = tuple(tuple(0.2 * rng.standard_normal((n, n)) + (np.eye(n) if i == j
                                                         else 0)
                     for j in range(2)) for i in range(2))
    s2 = tuple(tuple(0.2 * rng.standard_normal((n, n)) + (np.eye(n) if i == j
                                                         else 0)
                     for j in range(2)) for i in range(2))
    G20 = _spd(rng, 20)
    return {
        "symmetrize": (jla.symmetrize, la.symmetrize, (small,)),
        "solve_pd_vector": (jla.solve_pd, la.solve_pd, (A, b)),
        "solve_pd_matrix": (jla.solve_pd, la.solve_pd, (A, Bk)),
        "invert_pd": (jla.invert_pd, la.invert_pd, (A,)),
        "logdet_pd": (jla.logdet_pd, la.logdet_pd, (A,)),
        "solve_lstsq_vector": (jla.solve_lstsq, la.solve_lstsq,
                               (tall, rng.standard_normal(BATCH + (7,)))),
        "solve_lstsq_matrix": (jla.solve_lstsq, la.solve_lstsq,
                               (tall, rng.standard_normal(BATCH + (7, 2)))),
        "solve_minnorm_vector": (jla.solve_minnorm, la.solve_minnorm,
                                 (wide, rng.standard_normal(BATCH + (3,)))),
        "solve_minnorm_matrix": (jla.solve_minnorm, la.solve_minnorm,
                                 (wide, rng.standard_normal(BATCH + (3, 2)))),
        "expm_pade": (jla.expm_pade, la.expm_pade, (small,)),
        "frobenius_norm": (jla.frobenius_norm, la.frobenius_norm, (small,)),
        "one_norm": (jla.one_norm, la.one_norm, (small,)),
        "inf_norm": (jla.inf_norm, la.inf_norm, (small,)),
        "sqrtm_psd": (jla.sqrtm_psd, la.sqrtm_psd, (A,)),
        "small_chol_solve_vector": (jla.small_chol_solve, la.small_chol_solve,
                                    (A, b)),
        "small_chol_solve_matrix": (jla.small_chol_solve, la.small_chol_solve,
                                    (A, Bk)),
        "small_chol_solve_past_unroll": (
            jla.small_chol_solve, la.small_chol_solve,
            (G20, rng.standard_normal(BATCH + (20, 2)))),
        "block_2x2": (jla.block_2x2, la.block_2x2, tuple(blocks)),
        "star_product": (jla.star_product, la.star_product, (s1, s2)),
    }


CASES = list(_cases(np.random.default_rng(0)))


def _to(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_to(fn, t) for t in tree)
    return fn(tree)


@pytest.mark.parametrize("name", CASES)
def test_linalg_matches_jax(name):
    jfn, tfn, args = _cases(np.random.default_rng(0))[name]
    want = jfn(*_to(jnp.asarray, args))
    got = tfn(*_to(torch.as_tensor, args))
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = jax.tree_util.tree_leaves(_to(lambda t: t.numpy(), got))
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        assert _rel(g, w) <= 1e-12, name


@pytest.mark.parametrize("k", [1, 4], ids=["one_rhs", "four_rhs"])
@pytest.mark.parametrize("n", [6, 17])
def test_chol_solve_auto_batched_matches_jax_vmap(n, k):
    """G (B, n, n), rhs (B, n, k): one call over the batch, against the JAX
    function under ``jax.vmap`` (its custom vmap rule; off the TPU the
    unrolled solve); no kernel launches on CPU tensors."""
    rng = np.random.default_rng(n + k)
    G = _spd(rng, n, (7,))
    rhs = rng.standard_normal((7, n, k))
    want = jax.vmap(jchol.chol_solve_auto)(jnp.asarray(G), jnp.asarray(rhs))
    before = dict(chol_lanes.launches)
    got = chol_lanes.chol_solve_auto(torch.as_tensor(G), torch.as_tensor(rhs))
    assert chol_lanes.launches == before
    assert _rel(got.numpy(), want) <= 1e-12


def test_chol_solve_auto_unbatched_and_broadcast():
    """One system (B = 1), a vector right-hand side, and leading axes that
    broadcast (one G for every right-hand side) take the same solve."""
    rng = np.random.default_rng(3)
    G = _spd(rng, 6, ())
    rhs = rng.standard_normal((6, 2))
    want = jchol.chol_solve_auto(jnp.asarray(G), jnp.asarray(rhs))
    got = chol_lanes.chol_solve_auto(torch.as_tensor(G), torch.as_tensor(rhs))
    assert _rel(got.numpy(), want) <= 1e-12
    vec = rng.standard_normal(6)
    assert _rel(chol_lanes.chol_solve_auto(torch.as_tensor(G),
                                           torch.as_tensor(vec)).numpy(),
                np.linalg.solve(G, vec)) <= 1e-12
    many = rng.standard_normal((4, 6, 2))
    got = chol_lanes.chol_solve_auto(torch.as_tensor(G), torch.as_tensor(many))
    assert got.shape == (4, 6, 2)
    assert _rel(got.numpy(), np.linalg.solve(G, many)) <= 1e-12


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float64, device="meta")


@pytest.mark.parametrize("rhs_shape,entry", [((5, 6, 1), "solve_lanes"),
                                             ((5, 6), "solve_lanes"),
                                             ((5, 6, 3), "solve_lanes_multi")])
def test_chol_solve_auto_on_a_device_takes_the_kernels(monkeypatch, rhs_shape,
                                                       entry):
    """On a device tensor (a meta tensor stands in for a CUDA one) the
    batch is moved to the lanes layout, (n, n, B) and (n, [k,] B), and one
    kernel entry is called: K3a for one right-hand side, K3b for several;
    the result comes back batch first."""
    calls = []

    def fake(name):
        def run(G, rhs):
            calls.append((name, tuple(G.shape), tuple(rhs.shape)))
            return torch.empty_like(rhs)
        return run

    monkeypatch.setattr(chol_lanes, "solve_lanes", fake("solve_lanes"))
    monkeypatch.setattr(chol_lanes, "solve_lanes_multi",
                        fake("solve_lanes_multi"))
    out = chol_lanes.chol_solve_auto(_meta(5, 6, 6), _meta(*rhs_shape))
    assert out.shape == rhs_shape
    k = rhs_shape[-1] if len(rhs_shape) == 3 else 1
    assert len(calls) == 1 and calls[0][0] == entry
    assert calls[0][1] == (6, 6, 5)
    assert calls[0][2] == ((6, 5) if k == 1 else (6, k, 5))
