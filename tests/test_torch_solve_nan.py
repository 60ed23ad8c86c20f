"""A singular system in the port: NaN for that batch entry and the values
of the JAX package for the others, where ``torch.linalg.solve`` and
``torch.linalg.inv`` raise for the whole batch (fault F13, repaired in the
port).  Every port site whose JAX counterpart calls ``jnp.linalg.solve``,
``jnp.linalg.inv`` or ``jax.scipy.linalg.lu_factor``/``lu_solve`` goes
through ``math/linalg._solve``, ``_inv``, ``_lu_factor`` and ``_lu_solve``;
on nonsingular inputs their values are torch's bit for bit.  JAX's own
pattern of NaN and inf on a singular entry depends on its LU and is not
pinned: only "not finite" is.  f64 on the CPU."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import invariant as jinv
from reak_tpu.math import linalg as jla
from reak_tpu_torch.ctrl import invariant as inv
from reak_tpu_torch.math import linalg as la

torch.set_num_threads(1)
PORT = pathlib.Path(__file__).resolve().parents[1] / "reak_tpu_torch"


def _batch_with_one_singular(rng, n, B=4, bad=2):
    A = rng.standard_normal((B, n, n)) + n * np.eye(n)
    A[bad, :, -1] = 0.0  # a zero column: the LU meets an exactly zero pivot
    return A


def _good(x, bad):
    return torch.cat([x[:bad], x[bad + 1:]])


@pytest.mark.parametrize("rhs_shape", [(4, 5), (4, 5, 3), (2, 4, 5, 3)],
                         ids=["vector", "matrix", "broadcast_batch"])
def test_solve_nan_for_the_singular_entry_only(rhs_shape):
    rng = np.random.default_rng(0)
    A = torch.as_tensor(_batch_with_one_singular(rng, 5))
    b = torch.as_tensor(rng.standard_normal(rhs_shape))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.solve(A, b)
    got = la._solve(A, b)
    batch_axis = got.ndim - (2 if len(rhs_shape) == 2 else 3)
    sel = lambda x, i: x.select(batch_axis, i)
    assert bool(torch.isnan(sel(got, 2)).all())
    keep = [i for i in range(4) if i != 2]
    A_ok = A[keep]
    b_ok = b[:, keep] if len(rhs_shape) == 4 else b[keep]
    want = torch.linalg.solve(A_ok, b_ok)
    assert torch.equal(got.index_select(batch_axis, torch.tensor(keep)),
                       want)
    jb = jnp.asarray(b.numpy())
    if len(rhs_shape) == 2:  # JAX takes a batch of vectors as (..., n, 1)
        jw = np.asarray(jnp.linalg.solve(jnp.asarray(A.numpy()),
                                         jb[..., None]))[..., 0]
    else:
        jw = np.asarray(jnp.linalg.solve(jnp.asarray(A.numpy()), jb))
    assert not np.all(np.isfinite(np.take(jw, 2, axis=batch_axis)))
    np.testing.assert_allclose(want.numpy(), np.take(jw, keep,
                                                     axis=batch_axis),
                               rtol=1e-12, atol=1e-12)


def test_inv_nan_for_the_singular_entry_only():
    rng = np.random.default_rng(1)
    A = torch.as_tensor(_batch_with_one_singular(rng, 6, B=3, bad=1))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.inv(A)
    got = la._inv(A)
    assert bool(torch.isnan(got[1]).all())
    assert torch.equal(_good(got, 1), torch.linalg.inv(_good(A, 1)))
    jw = np.asarray(jnp.linalg.inv(jnp.asarray(A.numpy())))
    assert not np.all(np.isfinite(jw[1]))
    np.testing.assert_allclose(_good(got, 1).numpy(), jw[[0, 2]],
                               rtol=1e-12, atol=1e-12)


def test_lu_factor_and_solve():
    """The LU helpers of ``integrators/implicit.rosenbrock23_step``: a
    singular matrix solves to NaN; the others match ``lu_solve`` on
    ``lu_factor`` and the JAX package's ``jax.scipy.linalg`` pair."""
    from jax.scipy.linalg import lu_factor, lu_solve

    rng = np.random.default_rng(2)
    A = torch.as_tensor(_batch_with_one_singular(rng, 4, B=3, bad=0))
    b = torch.as_tensor(rng.standard_normal((3, 4)))
    LU, piv = la._lu_factor(A)
    x = la._lu_solve(LU, piv, b)
    assert x.shape == (3, 4) and bool(torch.isnan(x[0]).all())
    LU1, piv1 = torch.linalg.lu_factor(A[1:])
    assert torch.equal(x[1:], torch.linalg.lu_solve(LU1, piv1,
                                                    b[1:, :, None])[..., 0])
    for i in (1, 2):
        jlu = lu_factor(jnp.asarray(A[i].numpy()))
        np.testing.assert_allclose(
            x[i].numpy(), np.asarray(lu_solve(jlu, jnp.asarray(b[i].numpy()))),
            rtol=1e-12, atol=1e-12)
    X = la._lu_solve(LU, piv, b[:, :, None].expand(3, 4, 2))
    assert X.shape == (3, 4, 2) and torch.equal(X[1:, :, 0], x[1:])


def test_helpers_bitwise_on_nonsingular_inputs():
    rng = np.random.default_rng(3)
    for n, shape in ((1, ()), (6, (7,)), (12, (2, 3))):
        A = torch.as_tensor(rng.standard_normal(shape + (n, n))
                            + n * np.eye(n))
        b = torch.as_tensor(rng.standard_normal(shape + (n, 2)))
        for dt in (torch.float64, torch.float32):
            assert torch.equal(la._solve(A.to(dt), b.to(dt)),
                               torch.linalg.solve(A.to(dt), b.to(dt)))
            assert torch.equal(la._inv(A.to(dt)), torch.linalg.inv(A.to(dt)))


def test_apply_hamiltonian_two_map_batch():
    """ROADMAP's check of F13: two Hamiltonian maps, the second with a
    singular ``den``; JAX gives a finite first entry and NaN for the second,
    and so does the port, where it raised before."""
    rng = np.random.default_rng(4)
    n = 3
    g = rng.standard_normal((n, n))
    P = np.stack([g @ g.T + np.eye(n), np.eye(n)])
    eye = np.eye(n)
    blocks = ((np.stack([eye, eye]), np.stack([0.1 * eye, -eye])),
              (np.stack([0.2 * eye, eye]), np.stack([eye, eye])))
    T = inv.HamiltonianMap(tuple(tuple(torch.as_tensor(b) for b in row)
                                 for row in blocks))
    jT = jinv.HamiltonianMap(tuple(tuple(jnp.asarray(b) for b in row)
                                   for row in blocks))
    got = inv.apply_hamiltonian(T, torch.as_tensor(P)).numpy()
    want = np.asarray(jinv.apply_hamiltonian(jT, jnp.asarray(P)))
    assert np.all(np.isfinite(got[0])) and np.all(np.isnan(got[1]))
    assert not np.all(np.isfinite(want[1]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12)


def test_star_product_and_expm_keep_the_batch():
    """Two more of the fourteen sites: a Redheffer star product whose
    second entry has a singular I − B₁C₂, and ``expm_pade`` on a batch, each
    against the JAX package."""
    rng = np.random.default_rng(5)
    n = 3
    mats = rng.standard_normal((8, 2, n, n)) * 0.3
    mats[1, 1] = np.eye(n)   # B1 of entry 1
    mats[6, 1] = np.eye(n)   # C2 of entry 1: I − B1 C2 = 0
    M1 = ((mats[0], mats[1]), (mats[2], mats[3]))
    M2 = ((mats[4], mats[5]), (mats[6], mats[7]))
    t = lambda M: tuple(tuple(torch.as_tensor(b) for b in row) for row in M)
    j = lambda M: tuple(tuple(jnp.asarray(b) for b in row) for row in M)
    got = la.star_product(t(M1), t(M2))
    want = jla.star_product(j(M1), j(M2))
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            g, w = g.numpy(), np.asarray(w)
            np.testing.assert_allclose(g[0], w[0], rtol=1e-12, atol=1e-12)
            assert not np.all(np.isfinite(g[1]))
    A = rng.standard_normal((4, n, n))
    np.testing.assert_allclose(la.expm_pade(torch.as_tensor(A)).numpy(),
                               np.asarray(jla.expm_pade(jnp.asarray(A))),
                               rtol=1e-12, atol=1e-12)


def test_no_port_module_calls_the_raising_forms():
    """No call of ``torch.linalg.solve``, ``inv`` or ``lu_factor`` is left
    in the port (its helpers call the ``_ex`` forms), and no call of
    ``torch.linalg.eigh``, ``eigvalsh`` or ``svd`` outside
    ``math/linalg.py``, whose ``_eigh``, ``_eigvalsh`` and ``_svd`` every
    other module goes through (fault F14: those three have no ``_ex``
    form and raise for the whole batch on one non-finite matrix).  The
    numpy inverses of constant inertia data (``ctrl/manifold_lanes.py``,
    ``ss_systems.py``) are not torch calls."""
    raising = {"solve", "inv", "lu_factor", "eigh", "eigvalsh", "svd"}
    helpers_only = {"eigh", "eigvalsh", "svd"}
    found = []
    for path in PORT.rglob("*.py"):
        in_helpers = path.relative_to(PORT).as_posix() == "math/linalg.py"
        for node in ast.walk(ast.parse(path.read_text())):
            f = getattr(node, "func", None)
            if (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
                    and f.attr in raising and isinstance(f.value,
                                                         ast.Attribute)
                    and f.value.attr == "linalg"
                    and getattr(f.value.value, "id", None) == "torch"
                    and not (in_helpers and f.attr in helpers_only)):
                found.append(f"{path.relative_to(PORT)}:{node.lineno}")
    assert not found, found
