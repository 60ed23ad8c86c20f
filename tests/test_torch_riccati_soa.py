"""The port's plain whole-solve PDIP (reak_tpu_torch.ctrl.riccati_soa, the
plain version of the CUDA kernel) against the JAX package's whole-solve
Pallas kernel run in interpret mode, on the same numpy inputs at f64, in the
regulator, x_ref and x_ref + u_ref modes.  Shapes and monkeypatching as in
tests/test_riccati_soa.py::test_pdip_whole_solve_kernel_matches_scan.
Bar: ≤1e-9 absolute on u and xs.  Also the per-pass path, the unfused
solver and its passes against the JAX package's (≤1e-10), and the port's
fused solver against its unfused one (the JAX package's own cross-check)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu_torch.ctrl import riccati_soa
from reak_tpu_torch.ops import pdip_whole

torch.set_num_threads(1)

MODES = {"regulator": (), "x_ref": ("x_ref",), "x_ref+u_ref": ("x_ref",
                                                               "u_ref")}


def _problem(rng, H=6, n=4, m=2, B=4):
    return dict(
        A=rng.standard_normal((H, n, n, B)) * 0.1 + np.eye(n)[None, :, :, None],
        Bm=rng.standard_normal((H, n, m, B)) * 0.2,
        c=rng.standard_normal((H, n, B)) * 0.05,
        x0=rng.standard_normal((n, B)),
        Q=np.eye(n), QN=np.eye(n) * 5.0, R=np.eye(m) * 0.1,
        lb=np.full(m, -1.5), ub=np.full(m, 1.5),
        x_ref=rng.standard_normal((H, n, B)) * 0.1,
        u_ref=rng.standard_normal((H, m, B)) * 0.1)


def _args(p, conv):
    return [conv(p[k]) for k in ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb",
                                 "ub")]


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_pdip_matches_jax_whole_kernel(rng, monkeypatch, mode):
    import reak_tpu.ops.pdip_whole_pallas as pwp
    from reak_tpu.ctrl.riccati_soa import \
        solve_box_mpc_riccati_soa_fused as jax_fused

    monkeypatch.setattr(pwp, "_TILE", 2)
    monkeypatch.setattr(pwp, "FORCE_INTERPRET", True)
    p = _problem(rng)
    refs = {k: p[k] for k in MODES[mode]}
    u_j, x_j = jax_fused(*_args(p, jnp.asarray), iters=6, use_kernels="whole",
                         **{k: jnp.asarray(v) for k, v in refs.items()})
    u_t, x_t = riccati_soa.solve_box_mpc_riccati_soa_fused(
        *_args(p, torch.as_tensor), iters=6,
        **{k: torch.as_tensor(v) for k, v in refs.items()})
    assert np.max(np.abs(u_t.numpy() - np.asarray(u_j))) <= 1e-9
    assert np.max(np.abs(x_t.numpy() - np.asarray(x_j))) <= 1e-9
    # the instance has active box constraints
    assert np.any(np.abs(u_t.numpy()) > 1.5 - 1e-6)


@pytest.mark.parametrize("use_kernels", ["whole", "never"])
def test_cpu_dispatch_is_the_plain_scan(rng, use_kernels):
    """On CPU tensors "whole" goes through the kernel's wrapper, which takes
    the plain scan: the same numbers as "never", and no launch counted."""
    p = _problem(rng)
    args = _args(p, torch.as_tensor)
    before = pdip_whole.launches
    u1, x1 = riccati_soa.solve_box_mpc_riccati_soa_fused(
        *args, iters=4, use_kernels=use_kernels)
    u2, x2 = riccati_soa._fused_scan(*args, iters=4)
    assert torch.equal(u1, u2) and torch.equal(x1, x2)
    assert pdip_whole.launches == before


def test_passes_route_on_cpu_matches_jax_scan(rng):
    """``use_kernels="passes"`` on CPU tensors in x_ref mode against the JAX
    package's scan (``use_kernels="never"``) at f64 (≤1e-10), with an active
    bound and no kernel launch."""
    from reak_tpu.ctrl.riccati_soa import \
        solve_box_mpc_riccati_soa_fused as jax_fused
    from reak_tpu_torch.ops import riccati_bwd

    p = _problem(rng)
    u_j, x_j = jax_fused(*_args(p, jnp.asarray), iters=6, use_kernels="never",
                         x_ref=jnp.asarray(p["x_ref"]))
    before = dict(riccati_bwd.launches)
    u_t, x_t = riccati_soa.solve_box_mpc_riccati_soa_fused(
        *_args(p, torch.as_tensor), iters=6, use_kernels="passes",
        x_ref=torch.as_tensor(p["x_ref"]))
    assert riccati_bwd.launches == before
    assert np.max(np.abs(u_t.numpy() - np.asarray(u_j))) <= 1e-10
    assert np.max(np.abs(x_t.numpy() - np.asarray(x_j))) <= 1e-10
    assert np.any(np.abs(u_t.numpy()) > 1.5 - 1e-6)


@pytest.mark.parametrize("mode", ["regulator", "x_ref+u_ref"])
def test_unfused_solver_matches_jax(rng, mode):
    """The unfused PDIP (gradient, Riccati matrix pass and two vector passes
    per iteration) against the JAX package's ``solve_box_mpc_riccati_soa``
    at f64 (≤1e-10); on CPU tensors its Schur solves take the plain
    Cholesky and count no launch of K3b."""
    from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa as jax_unf
    from reak_tpu_torch.ops import chol_lanes

    p = _problem(rng)
    refs = MODES[mode]
    u_j, x_j = jax_unf(*_args(p, jnp.asarray), iters=6,
                       **{k: jnp.asarray(p[k]) for k in refs})
    before = dict(chol_lanes.launches)
    u_t, x_t = riccati_soa.solve_box_mpc_riccati_soa(
        *_args(p, torch.as_tensor), iters=6,
        **{k: torch.as_tensor(p[k]) for k in refs})
    assert chol_lanes.launches == before
    assert np.max(np.abs(u_t.numpy() - np.asarray(u_j))) <= 1e-10
    assert np.max(np.abs(x_t.numpy() - np.asarray(x_j))) <= 1e-10
    assert np.any(np.abs(u_t.numpy()) > 1.5 - 1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_matches_unfused(rng, mode):
    """The JAX package's own cross-check (tests/test_riccati_soa.py::
    test_fused_pdip_matches_unfused_f64) on the port: the scan-fused PDIP
    equals the unfused one at f64, rtol 1e-10, atol 1e-12."""
    p = _problem(rng)
    kw = {k: torch.as_tensor(p[k]) for k in MODES[mode]}
    args = _args(p, torch.as_tensor)
    u1, x1 = riccati_soa.solve_box_mpc_riccati_soa(*args, iters=12, **kw)
    u2, x2 = riccati_soa.solve_box_mpc_riccati_soa_fused(*args, iters=12,
                                                         **kw)
    np.testing.assert_allclose(u1.numpy(), u2.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-10, atol=1e-12)


def test_unfused_passes_match_jax(rng):
    """``lqr_backward_soa``, ``lqr_solve_rhs_soa`` and ``qp_gradient_soa``
    against the JAX package's at f64 (≤1e-12)."""
    from reak_tpu.ctrl import riccati_soa as jrs

    p = _problem(rng)
    H, m, Bl = p["Bm"].shape[0], p["Bm"].shape[2], p["Bm"].shape[3]
    R_seq = (p["R"][None, :, :, None]
             + np.eye(m)[None, :, :, None] * rng.uniform(0.5, 2.0,
                                                         (H, m, 1, Bl)))
    us = rng.standard_normal((H, m, Bl))
    r = rng.standard_normal((H, m, Bl))
    j, t = jnp.asarray, torch.as_tensor
    Ks_j, Gs_j = jrs.lqr_backward_soa(j(p["A"]), j(p["Bm"]), j(p["Q"]),
                                      j(p["QN"]), j(R_seq))
    Ks_t, Gs_t = riccati_soa.lqr_backward_soa(t(p["A"]), t(p["Bm"]),
                                              t(p["Q"]), t(p["QN"]), t(R_seq))
    du_j = jrs.lqr_solve_rhs_soa(Ks_j, Gs_j, j(p["A"]), j(p["Bm"]), j(r),
                                 j(p["x0"]))
    du_t = riccati_soa.lqr_solve_rhs_soa(Ks_t, Gs_t, t(p["A"]), t(p["Bm"]),
                                         t(r), t(p["x0"]))
    g_j = jrs.qp_gradient_soa(j(p["A"]), j(p["Bm"]), j(p["c"]), j(p["Q"]),
                              j(p["QN"]), j(p["R"]), j(p["x0"]), j(us),
                              j(p["x_ref"]), j(p["u_ref"]))
    g_t = riccati_soa.qp_gradient_soa(t(p["A"]), t(p["Bm"]), t(p["c"]),
                                      t(p["Q"]), t(p["QN"]), t(p["R"]),
                                      t(p["x0"]), t(us), t(p["x_ref"]),
                                      t(p["u_ref"]))
    for got, want in ((Ks_t, Ks_j), (Gs_t, Gs_j), (du_t, du_j),
                      (g_t[0], g_j[0]), (g_t[1], g_j[1])):
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-12


def test_lanes_algebra_matches_numpy(rng):
    """The one copy of the lanes algebra against numpy einsum."""
    X = rng.standard_normal((3, 4, 5))
    Y = rng.standard_normal((4, 2, 5))
    Z = rng.standard_normal((3, 2, 5))
    v = rng.standard_normal((4, 5))
    w = rng.standard_normal((3, 5))
    t = torch.as_tensor
    np.testing.assert_allclose(riccati_soa._mm(t(X), t(Y)).numpy(),
                               np.einsum("ikb,kjb->ijb", X, Y), rtol=1e-13)
    np.testing.assert_allclose(riccati_soa._mTm(t(X), t(Z)).numpy(),
                               np.einsum("kib,kjb->ijb", X, Z), rtol=1e-13)
    np.testing.assert_allclose(riccati_soa._mv(t(X), t(v)).numpy(),
                               np.einsum("ikb,kb->ib", X, v), rtol=1e-13)
    np.testing.assert_allclose(riccati_soa._mTv(t(X), t(w)).numpy(),
                               np.einsum("kib,kb->ib", X, w), rtol=1e-13)
    G = rng.standard_normal((4, 4, 5))
    G = np.einsum("ikb,jkb->ijb", G, G) + 2.0 * np.eye(4)[:, :, None]
    rhs = rng.standard_normal((4, 3, 5))
    got = riccati_soa._chol_solve_lanes(t(G), t(rhs)).numpy()
    want = np.linalg.solve(np.moveaxis(G, -1, 0), np.moveaxis(rhs, -1, 0))
    np.testing.assert_allclose(np.moveaxis(got, -1, 0), want, rtol=1e-10,
                               atol=1e-12)


def test_wide_instance_matches_jax_scan(rng):
    """Fault F6: the whole-solve kernel was capped at n ≤ 16, m ≤ 8, while
    the JAX package's takes the floating arm's tangent (24, 12).  The
    wrapper now builds for it; on CPU tensors it is the plain scan, held to
    the JAX package's scan (the reference its own tests hold the Pallas
    kernel to) at f64."""
    from reak_tpu.ctrl.riccati_soa import \
        solve_box_mpc_riccati_soa_fused as jax_fused

    H, n, m = 4, 24, 12
    p = _problem(rng, H=H, n=n, m=m)
    whole = pdip_whole.make_whole_pdip(H, n, m, iters=8, with_xref=True)
    a = _args(p, torch.as_tensor)
    before = pdip_whole.launches
    u_t, x_t = whole(*a[:3], torch.as_tensor(p["x_ref"]), a[6], *a[3:6],
                     *a[7:])
    assert pdip_whole.launches == before
    u_j, x_j = jax_fused(*_args(p, jnp.asarray), iters=8, use_kernels="never",
                         x_ref=jnp.asarray(p["x_ref"]))
    assert np.max(np.abs(u_t.numpy() - np.asarray(u_j))) <= 1e-9
    assert np.max(np.abs(x_t.numpy() - np.asarray(x_j))) <= 1e-9
    assert np.any(np.abs(u_t.numpy()) > 1.5 - 1e-6)


@pytest.mark.parametrize("nm,bound", [((12, 6), (16, 8)), ((16, 8), (16, 8)),
                                      ((16, 9), (24, 12)),
                                      ((24, 12), (24, 12)),
                                      ((25, 6), (32, 16)),
                                      ((12, 13), (32, 16)),
                                      ((32, 16), (32, 16))])
def test_smallest_instance_that_holds_the_problem(nm, bound):
    """The flagship (12, 6) keeps the (16, 8) instance; a 16-segment beam,
    (32, 16), has an instance of its own."""
    assert pdip_whole.instance_for(*nm) == bound
    assert pdip_whole.entry_point(bound, torch.float32) in pdip_whole.SIGNATURES


@pytest.mark.parametrize("nm", [(33, 6), (12, 17)])
def test_beyond_the_widest_instance_raises(rng, nm):
    """Past (32, 16) the whole-solve wrapper builds (fault F7 repaired): the
    runtime-width instance of each type takes the width (its entry point
    declared), and on CPU tensors the wrapper is the plain scan."""
    assert pdip_whole.instance_for(*nm) is None
    for dtype in (torch.float32, torch.float64):
        name = pdip_whole.library(None, dtype)
        assert pdip_whole.entry_point(None, dtype) in \
            pdip_whole.LIBRARIES[name]
    n, m = nm
    whole = pdip_whole.make_whole_pdip(2, n, m, iters=2)
    A = torch.as_tensor(np.eye(n)[None, :, :, None].repeat(2, 0).repeat(
        3, -1))
    Bm = torch.as_tensor(0.1 * rng.standard_normal((2, n, m, 3)))
    c = torch.zeros(2, n, 3, dtype=torch.float64)
    x0 = torch.as_tensor(rng.standard_normal((n, 3)))
    eye = lambda k: torch.eye(k, dtype=torch.float64)
    lim = torch.full((m,), 1.0, dtype=torch.float64)
    before = pdip_whole.launches
    u, xs = whole(A, Bm, c, x0, eye(n), eye(n), eye(m), -lim, lim)
    assert pdip_whole.launches == before
    want = riccati_soa._fused_scan(A, Bm, c, eye(n), eye(n), eye(m), x0,
                                   -lim, lim, iters=2)
    assert torch.equal(u, want[0]) and torch.equal(xs, want[1])
