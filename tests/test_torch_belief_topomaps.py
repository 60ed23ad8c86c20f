"""The port's belief space and kinematics topomaps
(``reak_tpu_torch.spaces.belief``, ``topomaps``) against the JAX package,
f64 on the CPU, on the same numpy inputs (seed 15).

- ``GaussianBeliefSpace`` at n = 2 (tests/test_belief_space.py) and n = 12
  (the satellite's tangent): pack, unpack, distance, interpolation and
  clamp ≤1e-12 relative to max(1, |reference|); a covariance that is not
  positive definite packs to NaN in its own row only (F9's ``_cholesky``).
- ``DirectKinTopoMap`` and ``InverseKinTopoMap`` on ``manip_3r3r``: the
  direct map, the 1st-order lift (also against finite differences, as
  tests/test_topomaps_se2plan.py:30-45), the closed-form inverse and the
  CLIK fallback ≤1e-9, and its ``ValueError`` without a seed.
- The planners over the new spaces: the RRT through the gap world of
  tests/test_topomaps_se2plan.py:80-106 on ``FlatSE2Space`` and the RRT
  over beliefs of tests/test_belief_space.py:52-70, each from the JAX
  planner's own draws (``ReplayDraws``): the trees equal, values ≤1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.planning as jpl
import reak_tpu.spaces as jsp
import reak_tpu_torch.planning as tpl
import reak_tpu_torch.spaces as sp
from _planning_jax import assert_result_equal
from reak_tpu.ctrl.belief import GaussianBelief as JBelief
from reak_tpu.kte import ik as jik, models as jmodels
from reak_tpu.planning.queries import PlanningQuery
from reak_tpu.spaces.belief import GaussianBeliefSpace as JBeliefSpace
from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.kte import ik, models
from reak_tpu_torch.planning.draws import ReplayDraws

torch.set_num_threads(1)
TOL, KIN = 1e-12, 1e-9


def _close(got, want, tol=TOL):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(1.0, float(np.max(np.abs(w), initial=0.0)))
    assert float(np.max(np.abs(g - w), initial=0.0)) <= tol * scale


def _beliefs(rng, n, k):
    """Means in and past the box [0, 10]^n and SPD covariances."""
    mean = rng.uniform(-1.0, 11.0, (k, n))
    g = rng.standard_normal((k, n, n)) * 0.3
    return mean, g @ np.swapaxes(g, -1, -2) + 0.05 * np.eye(n)


@pytest.mark.parametrize("n", [2, 12])
def test_belief_space_matches_jax(n):
    rng = np.random.default_rng(15)
    kw = dict(sigma_range=(0.1, 1.0), mean_weight=1.5)
    space = sp.GaussianBeliefSpace(np.zeros(n), np.full(n, 10.0),
                                   device="cpu", **kw)
    jspace = JBeliefSpace(jnp.zeros(n), jnp.full(n, 10.0), **kw)
    ma, Pa = _beliefs(rng, n, 64)
    mb, Pb = _beliefs(rng, n, 64)
    t = rng.uniform(0.0, 1.0, 64)

    def run(s, B, a_m, a_P, b_m, b_P, t):
        xa, xb = s.pack(B(a_m, a_P)), s.pack(B(b_m, b_P))
        out = {"pack_a": xa, "pack_b": xb, "distance": s.distance(xa, xb),
               "difference": s.difference(xa, xb), "clamp": s.clamp(xa),
               "interp": s.interpolate(xa, xb, t),
               "interp_half": s.interpolate(xa, xb, 0.5)}
        ub = s.unpack(out["interp"])
        out.update(unpack_mean=ub.mean, unpack_cov=ub.cov)
        return out

    got = run(space, GaussianBelief, *map(torch.as_tensor,
                                          (ma, Pa, mb, Pb, t)))
    want = jax.jit(lambda *a: run(jspace, JBelief, *a))(
        *map(jnp.asarray, (ma, Pa, mb, Pb, t)))
    for key in got:
        _close(got[key], want[key])
    # the round trip and every interpolated covariance positive definite
    back = space.pack(space.unpack(got["pack_a"]))
    _close(back, got["pack_a"], 1e-10)
    for s in (0.0, 0.25, 0.5, 0.75, 1.0):
        cov = space.unpack(space.interpolate(got["pack_a"], got["pack_b"],
                                             s)).cov
        assert bool((torch.linalg.eigvalsh(cov) > 0).all())


def test_belief_pack_nan_row_only():
    """One covariance with a negative eigenvalue: its row's factor entries
    are NaN, its mean and every other row are as for the batch without it,
    and nothing raises."""
    rng = np.random.default_rng(16)
    n = 12
    space = sp.GaussianBeliefSpace(np.zeros(n), np.full(n, 10.0),
                                   device="cpu")
    m, P = _beliefs(rng, n, 8)
    P[3] -= 2.0 * np.eye(n) * np.linalg.eigvalsh(P[3]).max()
    x = space.pack(GaussianBelief(torch.as_tensor(m), torch.as_tensor(P)))
    assert bool(torch.isnan(x[3, n:]).all())
    assert bool(torch.isfinite(x[3, :n]).all())
    ok = [i for i in range(8) if i != 3]
    assert bool(torch.isfinite(x[ok]).all())
    alone = space.pack(GaussianBelief(torch.as_tensor(m[ok]),
                                      torch.as_tensor(P[ok])))
    assert torch.equal(alone, x[ok])


@pytest.fixture(scope="module")
def arm():
    rng = np.random.default_rng(15)
    return (models.manip_3r3r(), jmodels.manip_3r3r(),
            rng.uniform(-1.0, 1.0, (2, 3, 6)), rng.uniform(-0.5, 0.5,
                                                           (2, 3, 6)))


def test_direct_map_matches_jax(arm):
    spec, jspec, q, _ = arm
    got = sp.DirectKinTopoMap(spec, device="cpu")(q)
    want = jax.jit(lambda q: jsp.DirectKinTopoMap(jspec)(q))(jnp.asarray(q))
    assert got.pos.shape == (2, 3, 3) and got.quat.shape == (2, 3, 4)
    for g, w in zip(got, want):
        _close(g, w, KIN)
    one = sp.DirectKinTopoMap(spec, device="cpu")(q[1, 2])
    _close(one.pos, got.pos[1, 2].numpy(), 0.0)


def test_lift_matches_jax_and_finite_differences(arm):
    spec, jspec, q, qd = arm
    dk = sp.DirectKinTopoMap(spec, device="cpu")
    got = dk.lift(q, qd)
    want = jax.jit(lambda q, qd: jsp.DirectKinTopoMap(jspec).lift(q, qd))(
        jnp.asarray(q), jnp.asarray(qd))
    for g, w in zip(got, want):
        _close(g, w, KIN)
    q0, qd0 = torch.as_tensor(q[0, 0]), torch.as_tensor(qd[0, 0])
    eps = 1e-6
    p0, _ = ik.ee_pose(spec, q0 - 0.5 * eps * qd0)
    p1, _ = ik.ee_pose(spec, q0 + 0.5 * eps * qd0)
    np.testing.assert_allclose(got.vel[0, 0], (p1 - p0) / eps, atol=1e-5)


def test_closed_form_inverse_matches_jax(arm):
    spec, jspec, q, _ = arm
    br = dict(shoulder=1.0, elbow=1.0, wrist=1.0)
    dk = sp.DirectKinTopoMap(spec, device="cpu")
    pose = dk(q)
    got = sp.InverseKinTopoMap(spec, solver=ik.ik_3r3r, device="cpu",
                               **br)(pose)
    jpose = jsp.se3.SE3Point(jnp.asarray(pose.pos.numpy()),
                             jnp.asarray(pose.quat.numpy()))
    want = jax.jit(lambda p: jsp.InverseKinTopoMap(
        jspec, solver=jik.ik_3r3r, **br)(p))(jpose)
    _close(got, want, KIN)
    _close(dk(got).pos, pose.pos.numpy(), 1e-9)


def test_clik_fallback_matches_jax(arm):
    spec, jspec, q, _ = arm
    dk = sp.DirectKinTopoMap(spec, device="cpu")
    ikm = sp.InverseKinTopoMap(spec, device="cpu")
    flat = q.reshape(-1, 6)
    pose = dk(flat)
    jpose = jsp.se3.SE3Point(jnp.asarray(pose.pos.numpy()),
                             jnp.asarray(pose.quat.numpy()))
    seed = flat + 0.05
    got = ikm(pose, q0=seed)
    want = jax.jit(lambda p, s: jsp.InverseKinTopoMap(jspec)(p, q0=s))(
        jpose, jnp.asarray(seed))
    _close(got, want, KIN)
    assert float((dk(got).pos - pose.pos).norm(dim=-1).max()) < 1e-6
    one = ikm(sp.se3.SE3Point(pose.pos[0], pose.quat[0]), q0=seed[0])
    _close(one, got[0].numpy(), KIN)
    with pytest.raises(ValueError, match="needs a seed q0"):
        ikm(pose)


def _wave_samples(jspace, seed, iters, K=64):
    """The samples of the JAX RRT's waves: per wave ``key, sub =
    split(key)``, ``k1, _ = split(sub)``, ``space.sample(k1, (K,))``."""
    draw = jax.jit(lambda k: jspace.sample(jax.random.split(k)[0], (K,)))
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(draw(sub)))
    return out


def _gap_grid():
    grid = np.ones((64, 64), bool)
    grid[30:34, :] = False          # wall across x ≈ 0.5 ...
    grid[30:34, 24:40] = True       # ... with a gap around y ≈ 0.5
    return grid


def test_flat_se2_rrt_through_gap_matches_jax():
    grid = _gap_grid()
    jspace = jsp.FlatSE2Space(jnp.zeros(2), jnp.ones(2), rot_weight=0.1)
    space = sp.FlatSE2Space(np.zeros(2), np.ones(2), rot_weight=0.1,
                            device="cpu")
    jws = jpl.bitmap_workspace(jspace, jnp.asarray(grid), jnp.zeros(2),
                               jnp.ones(2))
    ws = tpl.bitmap_workspace(space, grid, np.zeros(2), np.ones(2))
    q = PlanningQuery(np.array([0.1, 0.5, 3.0]), np.array([0.9, 0.5, -3.0]),
                      goal_tolerance=0.08)
    kw = dict(max_iters=150, step_size=0.12, capacity=1024)
    jr = jpl.rrt_plan(jws, q, seed=0, **kw)
    tr = tpl.rrt_plan(ws, q, seed=ReplayDraws(_wave_samples(jspace, 0, 150)),
                      **kw)
    assert jr.success
    assert_result_equal(tr, jr)
    path = torch.as_tensor(tr.path)
    assert bool(ws.is_free_batch(path).all())
    assert bool((path[:, 2].abs() <= np.pi).all())


def test_belief_rrt_matches_jax():
    jspace = JBeliefSpace(jnp.zeros(2), jnp.full(2, 10.0),
                          sigma_range=(0.1, 1.0))
    space = sp.GaussianBeliefSpace(np.zeros(2), np.full(2, 10.0),
                                   sigma_range=(0.1, 1.0), device="cpu")

    def free(s, trace):
        return lambda x: trace(s.unpack(x).cov) < 1.5

    jtrace = lambda c: jnp.trace(c, axis1=-2, axis2=-1)
    ttrace = lambda c: torch.diagonal(c, dim1=-2, dim2=-1).sum(-1)
    jws = jpl.Workspace(jspace, free(jspace, jtrace), n_checks=8)
    ws = tpl.Workspace(space, free(space, ttrace), n_checks=8)
    start = jspace.pack(JBelief(jnp.array([1.0, 1.0]), 0.04 * jnp.eye(2)))
    goal = jspace.pack(JBelief(jnp.array([9.0, 9.0]), 0.04 * jnp.eye(2)))
    q = PlanningQuery(np.asarray(start), np.asarray(goal),
                      goal_tolerance=2.0)
    kw = dict(max_iters=40, step_size=3.0, capacity=512)
    jr = jpl.rrt_plan(jws, q, seed=0, **kw)
    tr = tpl.rrt_plan(ws, q, seed=ReplayDraws(_wave_samples(jspace, 0, 40)),
                      **kw)
    assert jr.success
    assert_result_equal(tr, jr)
    assert bool(ws.is_free_batch(torch.as_tensor(tr.path)).all())
