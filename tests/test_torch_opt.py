"""The port's optimization toolbox (reak_tpu_torch.opt: the 28 names of
its ``__init__``, and ``opt.lp``'s ``solve_lp`` and
``solve_lp_inequality``) against the JAX package, f64 on the CPU, on the
problems of ``tests/test_opt.py`` and ``tests/test_lp.py`` at their
iteration counts: ≤1e-10 relative (the iteration counts are fixed and the
arithmetic is the same), ≤1e-9 where a solve or ``eigvalsh`` of LAPACK
enters.  Each port result also meets its reference test's own bar.
``nonlinear_cg`` is held to 1e-10 over its first 20 iterations: XLA's dot
product rounds as one fused multiply-add (``jnp.vdot`` of two 2-vectors is
fma(a₁, b₁, a₀b₀)), torch's as a product and a sum, and over the 400 and
1,600 iterations of the reference test (an Armijo search that stops
mid-valley) that last-bit difference grows far past 1e-10 in x; there
both meet the test's bar.  A batch of 16 problems under
``torch.func.vmap`` is held to ``jax.vmap`` of the same function.  The JAX
functions run op by op (their loops compile as they always do)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu import opt as J
from reak_tpu.opt import lp as jlp
from reak_tpu_torch import opt as T
from reak_tpu_torch.opt import lp as tlp, nlp as tnlp
from reak_tpu.opt import nlp as jnlp

torch.set_num_threads(1)
scipy_opt = pytest.importorskip("scipy.optimize")
f64 = torch.float64
vmap = torch.func.vmap


def _rel(got, want):
    got = np.concatenate([np.ravel(np.asarray(g)) for g in got])
    want = np.concatenate([np.ravel(np.asarray(w)) for w in want])
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _t(x):
    return torch.tensor(x, dtype=f64)


def test_all_names_ported():
    assert T.__all__ == J.__all__
    assert all(hasattr(T, n) for n in J.__all__)
    assert hasattr(tlp, "solve_lp") and hasattr(tlp, "solve_lp_inequality")


# ---------------------------------------------------------------- roots
ROOTS = {
    "bisection": (lambda x: torch.cos(x) - x, lambda x: jnp.cos(x) - x,
                  lambda m: m.bisection, (np.zeros(3), np.full(3, 1.5)),
                  0.7390851332, 1e-9),
    "secant": (lambda x: x**3 - 2 * x - 5.0, lambda x: x**3 - 2 * x - 5.0,
               lambda m: m.secant, (2.0, 3.0), 2.0945514815, 1e-8),
    "illinois": (lambda x: x**3 - 2 * x - 5.0, lambda x: x**3 - 2 * x - 5.0,
                 lambda m: m.illinois, (1.0, 3.0), 2.0945514815, 1e-8),
    "ridders": (lambda x: torch.exp(x) - 2.0, lambda x: jnp.exp(x) - 2.0,
                lambda m: m.ridders, (0.0, 2.0), np.log(2.0), 1e-8),
    "brent": (lambda x: torch.exp(x) - 2.0, lambda x: jnp.exp(x) - 2.0,
              lambda m: m.brent, (0.0, 2.0), np.log(2.0), 1e-6),
    "newton_raphson": (lambda x: x * x - 2.0, lambda x: x * x - 2.0,
                       lambda m: m.newton_raphson, (1.0,), np.sqrt(2.0),
                       1e-12),
}


@pytest.mark.parametrize("name", list(ROOTS))
def test_scalar_roots(name):
    ft, fj, fn, args, root, bar = ROOTS[name]
    got = fn(T)(ft, *(_t(a) for a in args))
    want = fn(J)(fj, *(jnp.asarray(a) for a in args))
    assert _rel([got], [want]) <= 1e-10
    np.testing.assert_allclose(got.numpy(), root, atol=bar,
                               rtol=bar if name == "newton_raphson" else 0)


def test_broyden_2d_system():
    got = T.broyden(lambda x: torch.stack([x[0]**2 + x[1]**2 - 4.0,
                                           x[0] - x[1]]), _t([1.0, 2.0]),
                    iters=60)
    want = J.broyden(lambda x: jnp.array([x[0]**2 + x[1]**2 - 4.0,
                                          x[0] - x[1]]),
                     jnp.array([1.0, 2.0]), iters=60)
    assert _rel([got], [want]) <= 1e-10
    np.testing.assert_allclose(got.numpy(), np.sqrt(2.0), atol=1e-7)
    # with a starting Jacobian (its inverse through math/linalg._inv)
    J0 = np.array([[2.0, 4.0], [1.0, -1.0]])
    got = T.broyden(lambda x: torch.stack([x[0]**2 + x[1]**2 - 4.0,
                                           x[0] - x[1]]), _t([1.0, 2.0]),
                    J0=_t(J0))
    want = J.broyden(lambda x: jnp.array([x[0]**2 + x[1]**2 - 4.0,
                                          x[0] - x[1]]),
                     jnp.array([1.0, 2.0]), J0=jnp.asarray(J0))
    assert _rel([got], [want]) <= 1e-10


# ---------------------------------------------------------------- line search
def test_golden_and_dichotomous():
    got = T.golden_section(lambda x: (x - 1.3) ** 2, torch.zeros(4, dtype=f64),
                           torch.full((4,), 3.0, dtype=f64))
    want = J.golden_section(lambda x: (x - 1.3) ** 2, jnp.zeros(4),
                            jnp.full(4, 3.0))
    assert _rel([got], [want]) <= 1e-10
    np.testing.assert_allclose(got.numpy(), 1.3, atol=1e-7)
    got = T.dichotomous_search(lambda x: torch.abs(x - 0.25), _t(-1.0),
                               _t(1.0))
    want = J.dichotomous_search(lambda x: jnp.abs(x - 0.25), -1.0, 1.0)
    assert _rel([got], [want]) <= 1e-10
    assert abs(float(got) - 0.25) < 1e-5


@pytest.mark.parametrize("search", ["wolfe_zoom", "backtracking_armijo"])
def test_directional_searches(search):
    ft = lambda x: torch.sum((x - 2.0) ** 2)
    fj = lambda x: jnp.sum((x - 2.0) ** 2)
    x, xj = torch.zeros(2, dtype=f64), jnp.zeros(2)
    g, gj = torch.func.grad(ft)(x), jax.grad(fj)(xj)
    if search == "wolfe_zoom":
        got = T.wolfe_zoom(lambda y: (ft(y), torch.func.grad(ft)(y)), x, -g,
                           ft(x), g)
        want = J.wolfe_zoom(lambda y: (fj(y), jax.grad(fj)(y)), xj, -gj,
                            fj(xj), gj)
    else:
        got = T.backtracking_armijo(ft, x, -g, ft(x), g, alpha0=_t(0.8))
        want = J.backtracking_armijo(fj, xj, -gj, fj(xj), gj, alpha0=0.8)
    assert _rel(got, want) <= 1e-10
    assert float(got[1]) < float(ft(x))


# ---------------------------------------------------------------- NLLSQ
T_FIT = np.linspace(0, 1, 25)
Y_FIT = 2.0 * np.exp(-1.5 * T_FIT)


def _fit_t(p):
    return p[0] * torch.exp(p[1] * torch.as_tensor(T_FIT)) - \
        torch.as_tensor(Y_FIT)


def _fit_j(p):
    return p[0] * jnp.exp(p[1] * T_FIT) - Y_FIT


@pytest.mark.parametrize("name,x0,kw", [
    ("levenberg_marquardt", [1.0, 0.0], dict(iters=40)),
    ("gauss_newton", [1.5, -1.0], dict(iters=25)),
    ("gauss_newton", [1.5, -1.0], dict(iters=25, step_clip=0.3)),
])
def test_nllsq_curve_fit(name, x0, kw):
    got = getattr(T, name)(_fit_t, _t(x0), **kw)
    want = getattr(J, name)(_fit_j, jnp.asarray(x0), **kw)
    assert _rel(got, want) <= 1e-9
    np.testing.assert_allclose(got.x.numpy(), [2.0, -1.5], atol=1e-6)


def test_jacobian_transpose():
    rt = lambda p: torch.stack([p[0] - 1.0, 2.0 * (p[1] + 0.5)])
    rj = lambda p: jnp.array([p[0] - 1.0, 2.0 * (p[1] + 0.5)])
    for rate in (None, 0.1):
        got = T.jacobian_transpose(rt, torch.zeros(2, dtype=f64), iters=300,
                                   rate=rate)
        want = J.jacobian_transpose(rj, jnp.zeros(2), iters=300, rate=rate)
        assert _rel(got, want) <= 1e-10
        np.testing.assert_allclose(got.x.numpy(), [1.0, -0.5], atol=1e-4)


# ---------------------------------------------------------------- NLP
def _ros_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _ros_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


@pytest.mark.parametrize("name,kw,tol", [
    ("bfgs", dict(iters=120), 1e-10),
    ("newton_method", dict(iters=60), 1e-9),
    ("sr1_trust_region", dict(iters=200), 1e-9),
])
def test_rosenbrock_2d(name, kw, tol):
    got = getattr(T, name)(_ros_t, _t([-1.2, 1.0]), **kw)
    want = getattr(J, name)(_ros_j, jnp.array([-1.2, 1.0]), **kw)
    assert _rel(got, want) <= tol
    np.testing.assert_allclose(got.x.numpy(), 1.0, atol=2e-3)


@pytest.mark.parametrize("variant,iters", [("fr", 400), ("pr", 1600)])
def test_nonlinear_cg(variant, iters):
    """1e-10 over the first 20 iterations; at the reference test's counts
    both meet its bar (the module docstring says why not 1e-10 there)."""
    got = T.nonlinear_cg(_ros_t, _t([-1.2, 1.0]), iters=20, variant=variant)
    want = J.nonlinear_cg(_ros_j, jnp.array([-1.2, 1.0]), iters=20,
                          variant=variant)
    assert _rel(got, want) <= 1e-10
    got = T.nonlinear_cg(_ros_t, _t([-1.2, 1.0]), iters=iters,
                         variant=variant)
    want = J.nonlinear_cg(_ros_j, jnp.array([-1.2, 1.0]), iters=iters,
                          variant=variant)
    np.testing.assert_allclose(got.x.numpy(), 1.0, atol=2e-3)
    np.testing.assert_allclose(np.asarray(want.x), 1.0, atol=2e-3)


def test_nelder_mead_quadratic():
    c = np.array([0.3, -0.7, 1.1])
    got = T.nelder_mead(lambda x: torch.sum((x - _t(c)) ** 2),
                        torch.zeros(3, dtype=f64), iters=300)
    want = J.nelder_mead(lambda x: jnp.sum((x - c) ** 2), jnp.zeros(3),
                         iters=300)
    assert _rel(got, want) <= 1e-10
    np.testing.assert_allclose(got.x.numpy(), c, atol=1e-4)


def test_pd_shift():
    rng = np.random.default_rng(0)
    H = rng.standard_normal((5, 4, 4))
    got = vmap(tnlp.pd_shift)(torch.as_tensor(H))
    want = jax.vmap(jnlp.pd_shift)(jnp.asarray(H))
    assert _rel([got], [want]) <= 1e-9


# ---------------------------------------------------------------- constrained
CONSTRAINED = {
    "al_equality": (
        lambda m, a: m.augmented_lagrangian(
            lambda x: a.sum(x ** 2), a.zeros(2, dtype=a.float64),
            ce=lambda x: a.stack([x[0] + x[1] - 1.0])),
        lambda r: (np.testing.assert_allclose(r.x.numpy(), 0.5, atol=1e-5),
                   float(r.eq_violation) < 1e-6)),
    "al_inequality": (
        lambda m, a: m.augmented_lagrangian(
            lambda x: a.sum((x - 2.0) ** 2), a.zeros(1, dtype=a.float64),
            ci=lambda x: a.stack([1.0 - x[0]])),
        lambda r: (np.testing.assert_allclose(float(r.x[0]), 1.0,
                                              atol=1e-4), True)),
    "sqp_equality": (
        lambda m, a: m.sqp_equality(
            lambda x: x[0] + x[1], lambda x: a.stack([x[0]**2 + x[1]**2
                                                      - 2.0]),
            a.asarray([1.5, 0.1], dtype=a.float64), iters=40),
        lambda r: (np.testing.assert_allclose(r.x.numpy(), -1.0, atol=1e-5),
                   True)),
    "log_barrier": (
        lambda m, a: m.log_barrier(
            lambda x: a.sum((x + 1.0) ** 2), lambda x: x,
            a.asarray([0.5], dtype=a.float64)),
        lambda r: (np.testing.assert_allclose(float(r.x[0]), 0.0, atol=1e-3),
                   True)),
}


@pytest.mark.parametrize("name", list(CONSTRAINED))
def test_constrained(name):
    run, bar = CONSTRAINED[name]
    got, want = run(T, torch), run(J, jnp)
    assert _rel(got, want) <= 1e-9
    assert bar(got)[1]


# ---------------------------------------------------------------- finite diff
def test_finite_differences():
    x = np.array([0.3, -1.2, 0.7])
    ft = lambda x: torch.sin(x[0]) * x[1] ** 2 + x[2]
    fj = lambda x: jnp.sin(x[0]) * x[1] ** 2 + x[2]
    vt = lambda x: torch.stack([x[0] * x[1], torch.cos(x[2])])
    vj = lambda x: jnp.array([x[0] * x[1], jnp.cos(x[2])])
    for order in (2, 4):
        got = T.fd_gradient(ft, _t(x), eps=1e-4, order=order)
        assert _rel([got], [J.fd_gradient(fj, jnp.asarray(x), eps=1e-4,
                                          order=order)]) <= 1e-10
        np.testing.assert_allclose(got.numpy(),
                                   torch.func.grad(ft)(_t(x)).numpy(),
                                   atol=1e-5 if order == 4 else 1e-7)
        got = T.fd_jacobian(vt, _t(x), eps=1e-4, order=order)
        assert _rel([got], [J.fd_jacobian(vj, jnp.asarray(x), eps=1e-4,
                                          order=order)]) <= 1e-10
        np.testing.assert_allclose(got.numpy(),
                                   torch.func.jacfwd(vt)(_t(x)).numpy(),
                                   atol=1e-5)
    got = T.fd_hessian(ft, _t(x))
    assert _rel([got], [J.fd_hessian(fj, jnp.asarray(x))]) <= 1e-10
    np.testing.assert_allclose(got.numpy(),
                               torch.func.hessian(ft)(_t(x)).numpy(),
                               atol=1e-5)


# ---------------------------------------------------------------- LP
def _random_standard_lp(rng, m, n):
    """tests/test_lp.py's draw: feasible, bounded standard-form LP."""
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.5, 2.0, n)
    y = rng.standard_normal(m)
    s = rng.uniform(0.1, 1.0, n)
    s[rng.choice(n, size=m, replace=False)] = 0.0
    return A, b, A.T @ y + s


@pytest.mark.parametrize("m,n", [(3, 7), (5, 12), (10, 25)])
def test_standard_form_lp(m, n):
    A, b, c = _random_standard_lp(np.random.default_rng(42), m, n)
    got = tlp.solve_lp(torch.as_tensor(A), torch.as_tensor(b),
                       torch.as_tensor(c), iters=40)
    want = jlp.solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                        iters=40)
    assert _rel(got, want) <= 1e-9
    sp = scipy_opt.linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                           method="highs")
    assert float(got.primal_res) < 1e-7 and float(got.dual_res) < 1e-7
    assert float(got.gap) < 1e-8
    np.testing.assert_allclose(float(got.obj), sp.fun, rtol=1e-6, atol=1e-7)


def test_inequality_lp_and_degenerate_vertex():
    rng = np.random.default_rng(42)
    n, m = 6, 14
    G = rng.standard_normal((m, n))
    h = G @ rng.standard_normal(n) + rng.uniform(0.1, 1.0, m)
    c = rng.standard_normal(n)
    G = np.vstack([G, np.eye(n), -np.eye(n)])
    h = np.concatenate([h, np.full(n, 5.0), np.full(n, 5.0)])
    got = tlp.solve_lp_inequality(torch.as_tensor(c), torch.as_tensor(G),
                                  torch.as_tensor(h), iters=50)
    want = jlp.solve_lp_inequality(jnp.asarray(c), jnp.asarray(G),
                                   jnp.asarray(h), iters=50)
    assert _rel(got, want) <= 1e-9
    sp = scipy_opt.linprog(c, A_ub=G, b_ub=h, bounds=(None, None),
                           method="highs")
    np.testing.assert_allclose(float(got.obj), sp.fun, rtol=1e-6, atol=1e-6)
    c = np.array([-1.0, -1.0])
    G = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0],
                  [0.0, -1.0]])
    h = np.array([1.0, 1.0, 1.0, 0.0, 0.0])
    # every point of the face x₁ + x₂ = 1 is optimal: where on it the
    # iterates freeze (μ < 1e-13) is decided by rounding, and the port's x
    # and JAX's differ there; the objective and the residuals do not
    got = tlp.solve_lp_inequality(*map(torch.as_tensor, (c, G, h)), iters=50)
    want = jlp.solve_lp_inequality(c, G, h, iters=50)
    assert _rel([got.obj], [want.obj]) <= 1e-9
    assert float(got.primal_res) < 1e-12 and float(got.dual_res) < 1e-12
    np.testing.assert_allclose(float(got.obj), -1.0, atol=1e-7)


# ---------------------------------------------------------------- vmap
def _batch(seed):
    return np.random.default_rng(seed)


BATCHED = {
    # name: (port call under vmap, JAX call under vmap, inputs, tolerance)
    "newton_raphson": (
        lambda c: T.newton_raphson(lambda x: x**3 - 2 * x - c, 2.0 + 0 * c),
        lambda c: J.newton_raphson(lambda x: x**3 - 2 * x - c, 2.0 + 0 * c),
        lambda r: (r.uniform(4.0, 6.0, 16),), 1e-10),
    "broyden": (
        lambda r2: T.broyden(lambda x: torch.stack([x[0]**2 + x[1]**2 - r2,
                                                    x[0] - x[1]]),
                             torch.stack([1.0 + 0 * r2, 2.0 + 0 * r2]),
                             iters=60),
        lambda r2: J.broyden(lambda x: jnp.array([x[0]**2 + x[1]**2 - r2,
                                                  x[0] - x[1]]),
                             jnp.array([1.0, 2.0]), iters=60),
        lambda r: (r.uniform(2.0, 6.0, 16),), 1e-10),
    "golden_section": (
        lambda c: T.golden_section(lambda x: (x - c) ** 2, 0 * c, 0 * c + 3),
        lambda c: J.golden_section(lambda x: (x - c) ** 2, 0.0, 3.0),
        lambda r: (r.uniform(0.5, 2.5, 16),), 1e-10),
    "levenberg_marquardt": (
        lambda b: T.levenberg_marquardt(
            lambda p: p[0] * torch.exp(p[1] * torch.as_tensor(T_FIT))
            - torch.exp(b * torch.as_tensor(T_FIT)),
            torch.stack([0.8 + 0 * b, -0.1 + 0 * b]), iters=40).x,
        lambda b: J.levenberg_marquardt(
            lambda p: p[0] * jnp.exp(p[1] * T_FIT) - jnp.exp(b * T_FIT),
            jnp.array([0.8, -0.1]), iters=40).x,
        lambda r: (r.uniform(-2.0, -0.5, 16),), 1e-9),
    "bfgs": (
        lambda x0: T.bfgs(_ros_t, x0, iters=120),
        lambda x0: J.bfgs(_ros_j, x0, iters=120),
        lambda r: (np.array([-1.2, 1.0]) + r.uniform(-0.2, 0.2, (16, 2)),),
        1e-9),
    "augmented_lagrangian": (
        lambda s: T.augmented_lagrangian(
            lambda x: torch.sum(x ** 2), 0 * torch.stack([s, s]),
            ce=lambda x: torch.stack([x[0] + x[1] - s])),
        lambda s: J.augmented_lagrangian(
            lambda x: jnp.sum(x ** 2), jnp.zeros(2),
            ce=lambda x: jnp.array([x[0] + x[1] - s])),
        lambda r: (r.uniform(0.5, 2.0, 16),), 1e-9),
    "solve_lp": (
        lambda A, b, c: tlp.solve_lp(A, b, c, iters=40),
        lambda A, b, c: jlp.solve_lp(A, b, c, iters=40),
        lambda r: tuple(np.stack(x) for x in zip(
            *(_random_standard_lp(r, 4, 9) for _ in range(16)))), 1e-9),
}


@pytest.mark.parametrize("name", list(BATCHED))
def test_batch_of_16_under_vmap(name):
    port, ref, draw, tol = BATCHED[name]
    args = draw(_batch(7))
    got = vmap(port)(*(torch.as_tensor(a) for a in args))
    want = jax.vmap(ref)(*(jnp.asarray(a) for a in args))
    got = got if isinstance(got, tuple) else [got]
    want = want if isinstance(want, tuple) else [want]
    assert _rel(got, want) <= tol


def test_newton_method_batch_of_16_under_vmap():
    """Newton on Rosenbrock from 16 starts around the reference test's:
    the problems that meet the test's bar in the JAX package meet it in the
    port, ≤1e-9 there.  The others (problem 8 of this draw) start where the
    shifted Hessian is nearly singular: each step is ~1/λ_min long, λ_min's
    last bits differ between LAPACK's ``eigvalsh`` and XLA's, and the run
    leaves the valley in both, on different paths."""
    x0 = np.array([-1.2, 1.0]) + _batch(7).uniform(-0.2, 0.2, (16, 2))
    got = vmap(lambda x: T.newton_method(_ros_t, x, iters=60))(
        torch.as_tensor(x0))
    want = jax.vmap(lambda x: J.newton_method(_ros_j, x, iters=60))(
        jnp.asarray(x0))
    ok = np.abs(np.asarray(want.x) - 1.0).max(axis=1) < 2e-3
    assert 0 < ok.sum() < 16
    assert np.array_equal(np.abs(got.x.numpy() - 1.0).max(axis=1) < 2e-3, ok)
    assert _rel([a[ok] for a in got], [np.asarray(a)[ok] for a in want]) \
        <= 1e-9
