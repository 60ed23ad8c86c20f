"""The port's Gaussian beliefs (reak_tpu_torch.ctrl.belief) and invariant
EKF (ctrl.invariant) against the JAX package on the same numpy inputs, f64
on the CPU: the belief functions and the Hamiltonian maps ≤1e-12
relative, and the 12-step IEKF arc of ``tests/test_qp_mpc.py:239-266`` (the
satellite with noisy pose measurements) ≤1e-9, with its posterior bar."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import belief as jbel, invariant as jinv, ss_systems as jss
from reak_tpu_torch.ctrl import belief as bel, invariant as inv, ss_systems as ss

torch.set_num_threads(1)


def _close(got, want, rtol=1e-12):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)),
                                                    1e-300)


def _spd(rng, n, shape=()):
    g = rng.standard_normal(shape + (n, n))
    return g @ np.swapaxes(g, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("shape", [(), (3,)])
def test_belief_functions(shape):
    rng = np.random.default_rng(0)
    n = 5
    m1, m2 = rng.standard_normal(shape + (n,)), rng.standard_normal(shape + (n,))
    P1, P2 = _spd(rng, n, shape), _spd(rng, n, shape)
    x = rng.standard_normal(shape + (n,))
    t = lambda *a: [torch.as_tensor(v) for v in a]
    j = lambda *a: [jnp.asarray(v) for v in a]
    b1, b2 = bel.GaussianBelief(*t(m1, P1)), bel.GaussianBelief(*t(m2, P2))
    c1, c2 = jbel.GaussianBelief(*j(m1, P1)), jbel.GaussianBelief(*j(m2, P2))
    _close(b1.information_matrix, c1.information_matrix)
    _close(b1.sqrt_cov, c1.sqrt_cov, rtol=1e-10)
    _close(b1.logpdf(torch.as_tensor(x)), c1.logpdf(jnp.asarray(x)))
    _close(bel.mahalanobis(b1, torch.as_tensor(x)),
           jbel.mahalanobis(c1, jnp.asarray(x)))
    _close(tuple(bel.symmetrized(b1)), tuple(jbel.symmetrized(c1)))
    _close(bel.kl_divergence(b1, b2), jbel.kl_divergence(c1, c2))
    _close(bel.belief_distance(b1, b2), jbel.belief_distance(c1, c2))


def test_belief_sample_draws_from_its_generator():
    """``sample`` maps the generator's standard-normal draws through the
    Cholesky factor of the covariance (the JAX package draws from a key)."""
    rng = np.random.default_rng(1)
    m, P = rng.standard_normal(4), _spd(rng, 4)
    b = bel.GaussianBelief(torch.as_tensor(m), torch.as_tensor(P))
    got = b.sample(torch.Generator().manual_seed(5), (7,))
    z = torch.randn((7, 4), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    L = np.linalg.cholesky(P)
    _close(got, m + z.numpy() @ L.T)


def test_hamiltonian_maps():
    rng = np.random.default_rng(2)
    n = 4
    A = np.eye(n) + 0.2 * rng.standard_normal((n, n))
    Q, P = _spd(rng, n) * 0.01, _spd(rng, n)
    C, R = rng.standard_normal((2, n)), _spd(rng, 2)
    t = lambda a: torch.as_tensor(a)
    j = lambda a: jnp.asarray(a)
    Tp, Jp = inv.hamiltonian_predict_map(t(A), t(Q)), \
        jinv.hamiltonian_predict_map(j(A), j(Q))
    Tu, Ju = inv.hamiltonian_update_map(t(C), t(R)), \
        jinv.hamiltonian_update_map(j(C), j(R))
    for T_, J_ in ((Tp, Jp), (Tu, Ju)):
        _close(tuple(b for row in T_.blocks for b in row),
               tuple(b for row in J_.blocks for b in row), rtol=1e-11)
        _close(inv.apply_hamiltonian(T_, t(P)),
               jinv.apply_hamiltonian(J_, j(P)), rtol=1e-11)
    Tc, Jc = inv.compose_hamiltonian(Tu, Tp), jinv.compose_hamiltonian(Ju, Jp)
    _close(inv.apply_hamiltonian(Tc, t(P)), jinv.apply_hamiltonian(Jc, j(P)),
           rtol=1e-10)


def test_vector_retraction_and_iekf_without_diff():
    """A linear system on the plain chart: one predict and one update (the
    JAX package's innovation z − h(x))."""
    rng = np.random.default_rng(3)
    n = 4
    A = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    C = rng.standard_normal((2, n))
    ret_t, ret_j = inv.vector_retraction(n), jinv.vector_retraction(n)
    F_t = lambda x, u, t=0.0: torch.as_tensor(A) @ x + u
    F_j = lambda x, u, t=0.0: jnp.asarray(A) @ x + u
    h_t = lambda x, t=0.0: torch.as_tensor(C) @ x
    h_j = lambda x, t=0.0: jnp.asarray(C) @ x
    m, P = rng.standard_normal(n), _spd(rng, n)
    u, z = rng.standard_normal(n), rng.standard_normal(2)
    Q, R = 0.01 * np.eye(n), 0.1 * np.eye(2)
    b = inv.iekf_step(F_t, h_t, ret_t,
                      bel.GaussianBelief(torch.as_tensor(m), torch.as_tensor(P)),
                      torch.as_tensor(u), torch.as_tensor(z),
                      torch.as_tensor(Q), torch.as_tensor(R))
    c = jinv.iekf_step(F_j, h_j, ret_j,
                       jbel.GaussianBelief(jnp.asarray(m), jnp.asarray(P)),
                       jnp.asarray(u), jnp.asarray(z), jnp.asarray(Q),
                       jnp.asarray(R))
    _close(tuple(b), tuple(c), rtol=1e-11)


def test_iekf_arc_of_the_config4_pipeline():
    """tests/test_qp_mpc.py:239-266 on both packages: the satellite (mass
    10, inertia diag(4, 5, 6), dt 0.1) drifts at a small body rate; 12 IEKF
    steps on pose measurements with N(0, 1e-2) position noise (numpy seed
    7) from the belief (rest state, 0.1 I).  Each posterior mean and
    covariance within 1e-9 of the JAX package's, and the final tangent
    error under the test's bar of 0.05."""
    p_t = ss.satellite3D(mass=10.0, inertia=np.diag([4.0, 5.0, 6.0]))
    p_j = jss.satellite3D(mass=10.0,
                          inertia=jnp.diag(jnp.array([4.0, 5.0, 6.0])))
    F_t, F_j = ss.satellite3D_imdt(p_t, 0.1), jss.satellite3D_imdt(p_j, 0.1)
    ret_t, ret_j = ss.sat3D_retraction(), jss.sat3D_retraction()
    Q = 1e-6 * np.eye(12)
    R = np.diag(np.concatenate([np.full(3, 1e-4), np.full(3, 1e-5)]))
    x_true = np.asarray(jss.default_state().at[10:13].set(
        jnp.array([0.02, -0.01, 0.03])))
    step_j = jax.jit(lambda b, z: jinv.iekf_step(
        F_j, jss.h_pose, ret_j, b, jnp.zeros(6), z, jnp.asarray(Q),
        jnp.asarray(R), diff=jss.pose_innovation))
    b_t = bel.GaussianBelief(ss.default_state(device="cpu"),
                             0.1 * torch.eye(12, dtype=torch.float64))
    b_j = jbel.GaussianBelief(jss.default_state(), 0.1 * jnp.eye(12))
    rng = np.random.default_rng(7)
    u0 = torch.zeros(6, dtype=torch.float64)
    for _ in range(12):
        x_true = np.array(F_j(jnp.asarray(x_true), jnp.zeros(6)))
        z = np.asarray(jss.h_pose(jnp.asarray(x_true))).copy()
        z[0:3] += rng.normal(0, 1e-2, 3)
        b_t = inv.iekf_step(F_t, ss.h_pose, ret_t, b_t, u0,
                            torch.as_tensor(z), torch.as_tensor(Q),
                            torch.as_tensor(R), diff=ss.pose_innovation)
        b_j = step_j(b_j, jnp.asarray(z))
        _close(tuple(b_t), tuple(b_j), rtol=1e-9)
    e_post = ret_t.local(torch.as_tensor(x_true), b_t.mean)
    assert float(torch.linalg.vector_norm(e_post[0:6])) < 0.05
