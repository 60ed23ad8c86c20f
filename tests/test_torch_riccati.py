"""The port's batch-first Riccati PDIP (reak_tpu_torch.ctrl.riccati) against
the JAX package's ``reak_tpu/ctrl/riccati.py`` on the same seeded numpy
inputs, f64 on the CPU.  Each function per scenario (the JAX function
called on one scenario) and batched (the JAX function under ``jax.vmap``,
the port's with a leading batch axis), ≤1e-10 relative.  The JAX functions
are per scenario and reach their Schur solves through ``chol_solve_auto``;
the port's take the batch axis and make one ``chol_solve_auto`` over it a
stage."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import riccati as jr
from reak_tpu_torch.ctrl import riccati as tr
from reak_tpu_torch.ops import chol_lanes

torch.set_num_threads(1)

H, N, M, BATCH = 5, 4, 2, 3


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(21)
    B = BATCH
    D = rng.uniform(0.5, 2.0, (B, H, M))
    return dict(
        A=rng.standard_normal((B, H, N, N)) * 0.2 + np.eye(N),
        Bm=rng.standard_normal((B, H, N, M)) * 0.3,
        c=rng.standard_normal((B, H, N)) * 0.05,
        x0=rng.standard_normal((B, N)),
        us=rng.standard_normal((B, H, M)),
        r=rng.standard_normal((B, H, M)),
        x_ref=0.1 * rng.standard_normal((B, H, N)),
        u_ref=0.2 * rng.standard_normal((B, H, M)),
        Rs=np.eye(M) * 0.1 + D[..., :, None] * np.eye(M),
        Q=np.diag(rng.uniform(1.0, 3.0, N)), QN=np.eye(N) * 5.0,
        R=np.eye(M) * 0.1, lb=np.full(M, -1.0), ub=np.full(M, 1.0))


def _pick(p, names, b):
    """The arguments ``names`` of scenario b (None: the whole batch)."""
    per = {"A", "Bm", "c", "x0", "us", "r", "x_ref", "u_ref", "Rs"}
    return [p[k] if k not in per or b is None else p[k][b] for k in names]


def _run(p, names, jfn, tfn, b, in_axes):
    """The JAX function on scenario b, or vmapped over the batch, and the
    port's on the same numpy arguments."""
    args = _pick(p, names, b)
    jargs = [jnp.asarray(a) for a in args]
    if b is None:
        want = jax.vmap(jfn, in_axes=in_axes)(*jargs)
    else:
        want = jfn(*jargs)
    got = tfn(*[torch.as_tensor(a) for a in args])
    return jax.tree_util.tree_leaves(want), [t.numpy() for t in (
        got if isinstance(got, (tuple, list)) else (got,))]


SCOPES = [0, None]
IDS = ["one_scenario", "batched"]


@pytest.mark.parametrize("b", SCOPES, ids=IDS)
def test_lqr_backward(prob, b):
    names = ["A", "Bm", "Q", "QN", "Rs"]
    want, got = _run(prob, names, jr.lqr_backward, tr.lqr_backward, b,
                     (0, 0, None, None, 0))
    assert len(want) == len(got) == 3
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10


@pytest.mark.parametrize("b", SCOPES, ids=IDS)
def test_lqr_solve_rhs(prob, b):
    def jfn(A, Bm, Q, QN, Rs, r, x0):
        return jr.lqr_solve_rhs(jr.lqr_backward(A, Bm, Q, QN, Rs), A, Bm, r,
                                x0)

    def tfn(A, Bm, Q, QN, Rs, r, x0):
        return tr.lqr_solve_rhs(tr.lqr_backward(A, Bm, Q, QN, Rs), A, Bm, r,
                                x0)

    want, got = _run(prob, ["A", "Bm", "Q", "QN", "Rs", "r", "x0"], jfn, tfn,
                     b, (0, 0, None, None, 0, 0, 0))
    assert _rel(got[0], want[0]) <= 1e-10


@pytest.mark.parametrize("b", SCOPES, ids=IDS)
def test_rollout_affine(prob, b):
    want, got = _run(prob, ["A", "Bm", "c", "x0", "us"], jr.rollout_affine,
                     tr.rollout_affine, b, 0)
    assert _rel(got[0], want[0]) <= 1e-10


@pytest.mark.parametrize("refs", [False, True], ids=["regulator", "tracking"])
@pytest.mark.parametrize("b", SCOPES, ids=IDS)
def test_qp_gradient(prob, b, refs):
    names = ["A", "Bm", "c", "Q", "QN", "R", "x0", "us"]
    axes = (0, 0, 0, None, None, None, 0, 0)
    if refs:
        names += ["x_ref", "u_ref"]
        axes += (0, 0)
    want, got = _run(prob, names, jr.qp_gradient, tr.qp_gradient, b, axes)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10


@pytest.mark.parametrize("refs", [False, True], ids=["regulator", "tracking"])
@pytest.mark.parametrize("b", SCOPES, ids=IDS)
def test_solve_box_mpc_riccati(prob, b, refs):
    """The whole PDIP, 8 iterations; no kernel launch on CPU tensors."""
    names = ["A", "Bm", "c", "Q", "QN", "R", "x0", "lb", "ub"]
    axes = (0, 0, 0, None, None, None, 0, None, None)
    if refs:
        names += ["x_ref", "u_ref"]
        axes += (0, 0)
    before = dict(chol_lanes.launches)
    want, got = _run(prob, names, jr.solve_box_mpc_riccati,
                     tr.solve_box_mpc_riccati, b, axes)
    assert chol_lanes.launches == before
    assert len(got) == 2
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10
    assert np.all(np.abs(got[0]) <= 1.0 + 1e-12)


def test_a_scenario_never_mixes_with_another(prob):
    """The step lengths and the centering are per scenario, as under vmap:
    a scenario's controls do not move when another scenario changes, and a
    scenario with a non-finite x0 is NaN alone (the reference's vary0 =
    0·Σx0, kept per scenario)."""
    names = ["A", "Bm", "c", "Q", "QN", "R", "x0", "lb", "ub"]
    args = [torch.as_tensor(a) for a in _pick(prob, names, None)]
    u_all, _ = tr.solve_box_mpc_riccati(*args)
    u_one, _ = tr.solve_box_mpc_riccati(*[
        a[1:2] if a.dim() >= 2 and a.shape[0] == BATCH else a for a in args])
    assert _rel(u_one[0].numpy(), u_all[1].numpy()) <= 1e-14
    bad = [a.clone() for a in args]
    bad[6][0, 0] = float("nan")
    u_bad, xs_bad = tr.solve_box_mpc_riccati(*bad)
    assert torch.isnan(u_bad[0]).all() and torch.isnan(xs_bad[0]).all()
    assert torch.equal(u_bad[1:], u_all[1:])
