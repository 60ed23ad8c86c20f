"""The port's sorting (reak_tpu_torch.math.sorting) and tensor algebra
(math.tensors) against the JAX package on the same numpy inputs, f64 on the
CPU: the cases of ``tests/test_tensors_sorting.py``, with ties.  The sorts
and selections give JAX's results exactly (stable argsorts, ties toward the
lower index, the averaging median); contractions ≤1e-12; the HOSVD and CP
factorizations are compared by reconstruction and projector U Uᵀ, never by
factor (the signs of singular vectors are the library's)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.math import sorting as jsrt, tensors as jtn
from reak_tpu_torch.math import sorting as srt, tensors as tn

torch.set_num_threads(1)


def _tied(rng, shape):
    x = rng.standard_normal(shape)
    x[..., ::3] = x[..., ::3].round(1)  # ties
    x[..., 1::4] = x[..., 0:1]          # more ties, with the first entry
    return x


def _eq(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(8,), (5,), (3, 17), (4, 2, 33)])
def test_surface_matches_jax_with_ties(shape):
    rng = np.random.default_rng(0)
    x = _tied(rng, shape)
    t, j = torch.as_tensor(x), jnp.asarray(x)
    _eq(srt.sort(t), jsrt.sort(j))
    _eq(srt.argsort(t), jsrt.argsort(j))
    _eq(srt.rank(t), jsrt.rank(j))
    for k in (1, 3):
        for ours, theirs in ((srt.top_k, jsrt.top_k),
                             (srt.smallest_k, jsrt.smallest_k)):
            v, i = ours(t, k)
            jv, ji = theirs(j, k)
            _eq(v, jv)
            _eq(i, ji)


@pytest.mark.parametrize("n", [31, 32, 6])
def test_median_partition(n):
    """Odd and even lengths (JAX averages the two middle values) and a
    slice holding a NaN."""
    rng = np.random.default_rng(1)
    x = _tied(rng, (3, n))
    x[2, 1] = np.nan
    med, below = srt.median_partition(torch.as_tensor(x))
    jmed, jbelow = jsrt.median_partition(jnp.asarray(x))
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    _eq(below, jbelow)


def test_lexsort_2key():
    p = np.array([2.0, 1.0, 2.0, 1.0, 1.0, 2.0])
    s = np.array([0.5, 9.0, 0.1, 1.0, 1.0, 0.5])
    order = srt.lexsort_2key(torch.as_tensor(p), torch.as_tensor(s))
    _eq(order, jsrt.lexsort_2key(jnp.asarray(p), jnp.asarray(s)))
    rng = np.random.default_rng(2)
    P, S = rng.integers(0, 3, (4, 40)).astype(float), _tied(rng, (4, 40))
    _eq(srt.lexsort_2key(torch.as_tensor(P), torch.as_tensor(S)),
        jsrt.lexsort_2key(jnp.asarray(P), jnp.asarray(S)))


@pytest.mark.parametrize("shape", [(8,), (5,), (3, 17), (4, 2, 33), (128,)])
def test_bitonic_networks(shape):
    rng = np.random.default_rng(3)
    x = _tied(rng, shape)
    t, j = torch.as_tensor(x), jnp.asarray(x)
    _eq(srt.bitonic_sort(t), jsrt.bitonic_sort(j))
    _eq(srt.bitonic_sort(t), torch.sort(t).values)
    _eq(srt.bitonic_argsort(t), jsrt.bitonic_argsort(j))
    _eq(srt.bitonic_argsort(t), torch.argsort(t, stable=True))
    k, v = srt.bitonic_sort_kv(t, 3.0 * t)
    jk, jv = jsrt.bitonic_sort_kv(j, 3.0 * j)
    _eq(k, jk)
    _eq(v, jv)
    # along another axis
    if len(shape) > 1:
        _eq(srt.bitonic_sort(t, axis=0), jsrt.bitonic_sort(j, axis=0))


def test_bitonic_argsort_stable_on_ties_and_schedule_cached():
    x = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0])
    assert srt.bitonic_argsort(x).tolist() == [1, 3, 0, 2, 4]
    waves = srt._bitonic_schedule(8, x.device)
    assert srt._bitonic_schedule(8, x.device) is waves
    assert len(waves) == 6  # log₂8 (log₂8 + 1) / 2


def test_contractions(rng):
    T = rng.standard_normal((4, 3, 5))
    v, M, u = (rng.standard_normal(5), rng.standard_normal((5, 2)),
               rng.standard_normal(4))
    T4, M4 = rng.standard_normal((2, 3, 4, 5)), rng.standard_normal((4, 5))
    a, b, c = (rng.standard_normal(3) for _ in range(3))
    t = torch.as_tensor
    cases = [(tn.tensor3_vec(t(T), t(v)), jtn.tensor3_vec(T, v)),
             (tn.tensor3_mat(t(T), t(M)), jtn.tensor3_mat(T, M)),
             (tn.vec_tensor3(t(u), t(T)), jtn.vec_tensor3(u, T)),
             (tn.tensor4_mat(t(T4), t(M4)), jtn.tensor4_mat(T4, M4)),
             (tn.outer3(t(a), t(b), t(c)), jtn.outer3(a, b, c)),
             (tn.sym_part3(t(T[..., :3])), jtn.sym_part3(T[..., :3])),
             (tn.identity3(4, torch.float64, device="cpu"),
              jtn.identity3(4, jnp.float64))]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
    Mm = rng.standard_normal((7, 3))
    np.testing.assert_allclose(
        tn.mode_dot(t(T), t(Mm), 1).numpy(),
        np.asarray(jtn.mode_dot(jnp.asarray(T), jnp.asarray(Mm), 1)),
        rtol=0, atol=1e-12)
    B = rng.standard_normal((5, 3, 2))
    np.testing.assert_allclose(
        tn.ttt(t(T), t(B), [1, 2], [1, 0]).numpy(),
        np.asarray(jtn.ttt(jnp.asarray(T), jnp.asarray(B), [1, 2], [1, 0])),
        rtol=0, atol=1e-12)
    for mode in range(3):
        np.testing.assert_array_equal(
            tn.unfold(t(T), mode).numpy(),
            np.asarray(jtn.unfold(jnp.asarray(T), mode)))
        assert torch.equal(tn.fold(tn.unfold(t(T), mode), mode, T.shape),
                           t(T))
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    T3, T4r = rng.standard_normal((3, 3, 3)), rng.standard_normal((3,) * 4)
    np.testing.assert_allclose(
        tn.tensor3_rotate(t(T3), t(R)).numpy(),
        np.asarray(jtn.tensor3_rotate(jnp.asarray(T3), jnp.asarray(R))),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tn.tensor4_rotate(t(T4r), t(R)).numpy(),
        np.asarray(jtn.tensor4_rotate(jnp.asarray(T4r), jnp.asarray(R))),
        rtol=0, atol=1e-12)


def test_hosvd_by_reconstruction_and_projectors(rng):
    T = rng.standard_normal((5, 6, 7))
    for ranks in (None, (2, 4, 5)):
        core, Us = tn.hosvd(torch.as_tensor(T), ranks)
        jcore, jUs = jtn.hosvd(jnp.asarray(T), ranks)
        np.testing.assert_allclose(
            tn.tucker_reconstruct(core, Us).numpy(),
            np.asarray(jtn.tucker_reconstruct(jcore, jUs)), rtol=0,
            atol=1e-10)
        for U, jU in zip(Us, jUs):
            jU = np.asarray(jU)
            np.testing.assert_allclose((U @ U.T).numpy(), jU @ jU.T, rtol=0,
                                       atol=1e-10)
            np.testing.assert_allclose((U.T @ U).numpy(),
                                       np.eye(U.shape[1]), atol=1e-10)
    core, Us = tn.hosvd(torch.as_tensor(T))
    np.testing.assert_allclose(tn.tucker_reconstruct(core, Us).numpy(), T,
                               atol=1e-10)


def test_cp_als_low_rank_against_jax(rng):
    """An exactly rank-3 tensor: the port recovers it in 300 sweeps
    (``tests/test_tensors_sorting.py``'s bar 1e-8), and its reconstruction
    after 30 sweeps is JAX's (both start from the HOSVD, whose column signs
    do not change the reconstruction)."""
    A, B, C = (rng.standard_normal((s, 3)) for s in (6, 5, 4))
    T = np.einsum("ar,br,cr->abc", A, B, C)
    w, Fs = tn.cp_als(torch.as_tensor(T), rank=3, n_iters=300)
    rec = tn.cp_reconstruct(w, Fs).numpy()
    assert np.linalg.norm(rec - T) / np.linalg.norm(T) < 1e-8
    w, Fs = tn.cp_als(torch.as_tensor(T), rank=3, n_iters=30)
    jw, jFs = jtn.cp_als(jnp.asarray(T), rank=3, n_iters=30)
    rec = tn.cp_reconstruct(w, Fs).numpy()
    jrec = np.asarray(jtn.cp_reconstruct(jw, jFs))
    assert np.linalg.norm(rec - jrec) / np.linalg.norm(T) < 1e-8


def test_cp_als_padded_modes_have_no_dead_component(rng):
    """Rank 4 above two mode sizes of 3 (the reference's ADVICE r4 case):
    the pad columns are the port's own draws, so factors differ from JAX's,
    but no component is dead and the fit is JAX's within 1e-6."""
    R = 4
    A, B, C = (rng.standard_normal((s, R)) for s in (3, 3, 6))
    T = np.einsum("ar,br,cr->abc", A, B, C)
    w, Fs = tn.cp_als(torch.as_tensor(T), rank=R, n_iters=1500)
    jw, jFs = jtn.cp_als(jnp.asarray(T), rank=R, n_iters=1500)
    fit = (np.linalg.norm(tn.cp_reconstruct(w, Fs).numpy() - T)
           / np.linalg.norm(T))
    jfit = (np.linalg.norm(np.asarray(jtn.cp_reconstruct(jw, jFs)) - T)
            / np.linalg.norm(T))
    assert fit < 1e-3 and abs(fit - jfit) < 1e-6
    assert float(w.abs().min()) > 1e-6 * float(w.abs().max())


def test_cp_als_random_start_from_a_generator(rng):
    """The port takes a ``torch.Generator`` where JAX takes a key
    (``tests/test_tensors_sorting.py``'s random-init case, bar 1e-6).  ALS
    from a random start converges linearly on this small tensor, as the JAX
    test notes: its key's draws reach the bar in 800 sweeps, seed 0's
    torch draws in 3000 (5.3e-3 at 800; seeds 0-7 all reach ≤1.4e-9 at
    3000).  The same seed gives the same factors."""
    R = 2
    A, B, C = (rng.standard_normal((s, R)) for s in (3, 4, 2))
    T = torch.as_tensor(np.einsum("ar,br,cr->abc", A, B, C))
    w, Fs = tn.cp_als(T, rank=R, n_iters=3000,
                      generator=torch.Generator().manual_seed(0))
    rel = float(torch.linalg.vector_norm(tn.cp_reconstruct(w, Fs) - T)
                / torch.linalg.vector_norm(T))
    assert rel < 1e-6
    w2, _ = tn.cp_als(T, rank=R, n_iters=3000,
                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, w2)
