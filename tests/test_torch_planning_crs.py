"""The port's workspaces, interception planners and CRS planner example
against the JAX package's, on the CPU at float64, and the goal-bias draws of
the interception planners (F20).

Workspaces are carried across with ``convert.workspace_from``.  The JAX
planners run from their keys; the port gets the same draws through
``planning.draws.ReplayDraws``.  F20: ``reak_tpu/planning/intercept.py:
108-109`` (and ``:246-247``) draw the goal-bias coin (``uniform``) and the
target index (``randint``) from one key.  Measured over 640,000 draws of
the JAX package (threefry, ``jax.random.randint`` splits its key first) the
two are independent: a χ² test of coin × fifth of the table gives p = 0.21.
So F20 is a reused key, not a correlation; the port draws the two
independently all the same, and the parity tests replay JAX's own draws."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.planning as jpl
import reak_tpu_torch.planning as tpl
from _planning_jax import CPU, assert_result_equal, bitmap_worlds
from reak_tpu_torch import convert
from reak_tpu_torch.examples import run_crs_planner as tex
from reak_tpu_torch.planning.draws import Draws, ReplayDraws

torch.set_num_threads(1)

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jex():
    """The JAX package's examples/run_crs_planner.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_crs_planner", os.path.join(ROOT, "examples",
                                            "run_crs_planner.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def crs(jex):
    """(JAX workspace, port workspace, query) of the example's scene."""
    _, jws, q = jex.build_scene()
    return jws, tex.build_scene("cpu")[1], q


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64, device=CPU)


def test_workspaces_carried_across_match_jax(crs):
    """The CRS chain scene (its workspace built by the port's example and
    carried across from JAX's by ``convert.workspace_from``) on 64 edges of
    12 checks, the planar 2-link scene and the bitmap world: clearances
    within 1e-12 of JAX's, validity and edge checks equal."""
    from reak_tpu.geom.proximity2d import ProxyModel2D
    from reak_tpu.geom.shapes2d import CappedRectangle, Circle, ShapeSet2D
    from reak_tpu.kte import models
    from reak_tpu.planning.workspace import PlanarChainWorkspace
    import reak_tpu.spaces.vector as jsp

    jws, tws, _ = crs
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-2.8, 2.8, (2, 64, 6))
    x = np.concatenate([a[:, None] + s * (b - a)[:, None]
                        for s in np.linspace(0, 1, 12)], 1).reshape(-1, 6)
    want = np.asarray(jax.jit(jws.min_distance_batch)(x))
    free = want > jws.margin
    assert 0 < free.mean() < 1
    for ws in (tws, convert.workspace_from(jws, CPU, F64)):
        np.testing.assert_allclose(ws.min_distance_batch(_t(x)).numpy(),
                                   want, rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(ws.is_free_batch(_t(x)).numpy(), free)
        np.testing.assert_array_equal(
            ws.edge_free_batch(_t(a), _t(b)).numpy(),
            free.reshape(64, 12).all(-1))

    robot = ShapeSet2D(crects=CappedRectangle(
        center=jnp.array([[0.2, 0.0], [0.15, 0.0]]), angle=jnp.zeros(2),
        half_len=jnp.array([0.2, 0.15]), radius=jnp.array([0.05, 0.05])),
        crect_body=jnp.array([0, 1]))
    env = ProxyModel2D(circles=Circle(jnp.array([[0.55, 0.0]]),
                                      jnp.array([0.1])))
    jplanar = PlanarChainWorkspace(
        jsp.HyperboxSpace(jnp.full(2, -np.pi), jnp.full(2, np.pi)),
        models.planar_2link(l1=0.4, l2=0.3), robot, env, margin=0.01)
    qs = rng.uniform(-np.pi, np.pi, (256, 2))
    tplanar = convert.workspace_from(jplanar, CPU, F64)
    np.testing.assert_allclose(tplanar.min_distance_batch(_t(qs)).numpy(),
                               np.asarray(jplanar.min_distance_batch(qs)),
                               rtol=1e-12, atol=1e-14)
    jbit, _, _ = bitmap_worlds()
    pts = rng.uniform(-1, 11, (512, 2))
    np.testing.assert_array_equal(
        convert.workspace_from(jbit, CPU, F64).is_free_batch(_t(pts)).numpy(),
        np.asarray(jbit.is_free_batch(jnp.asarray(pts))))


def _crossing_arm():
    """tests/test_temporal_workspace.py's 2-link arm, with the crossing
    sphere's trajectory tabulated (``rigid_traj_tabulated``)."""
    from reak_tpu.geom.proximity import ProxyModel
    from reak_tpu.geom.shapes import Capsule, ShapeSet, Sphere
    from reak_tpu.kte import models
    from reak_tpu.planning.workspace import (TemporalChainWorkspace,
                                             rigid_traj_tabulated)
    import reak_tpu.spaces.vector as jsp

    robot = ShapeSet(capsules=Capsule(
        a=jnp.zeros((2, 3)), b=jnp.array([[0.4, 0.0, 0.0], [0.3, 0.0, 0.0]]),
        radius=jnp.array([0.05, 0.05])), capsule_body=jnp.array([0, 1]))
    sphere = ShapeSet(spheres=Sphere(jnp.zeros((1, 3)), jnp.array([0.08])),
                      sphere_body=jnp.array([0]))
    ts = np.linspace(0.0, 4.0, 9)
    poss = np.stack([np.full(9, 0.55), 1.0 - ts, np.zeros(9)], 1)
    quats = np.tile([1.0, 0.0, 0.0, 0.0], (9, 1))
    env = ProxyModel(spheres=Sphere(jnp.array([[5.0, 5.0, 5.0]]),
                                    jnp.array([0.01])))
    return TemporalChainWorkspace(
        jsp.HyperboxSpace(jnp.full(2, -np.pi), jnp.full(2, np.pi)),
        models.planar_2link(l1=0.4, l2=0.3), robot, env,
        moving=[(sphere, rigid_traj_tabulated(ts, poss, quats))])


def _intercept_draws(space, seed, iters, batch, n_target):
    """The JAX interception wave's draws: ``k1, k2, k3 = split(k, 3)``;
    points from k1, times from k2, the coin and the index both from k3."""
    @jax.jit
    def draw(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (space.sample(k1, (batch,)), jax.random.uniform(k2, (batch,)),
                jax.random.uniform(k3, (batch,)),
                jax.random.randint(k3, (batch,), 0, n_target))

    key, out = jax.random.PRNGKey(seed), []
    for _ in range(iters):
        key, k = jax.random.split(key)
        out.append([np.asarray(x) if not isinstance(x, tuple) else x
                    for x in draw(k)])
    return out


def test_temporal_intercept_matches_jax():
    """``intercept_plan`` on the temporal workspace (moving sphere posed at
    each checked time): clearances at (t, q), then the plan."""
    from reak_tpu.planning.intercept import InterceptQuery

    jws = _crossing_arm()
    tws = convert.workspace_from(jws, CPU, F64)
    rng = np.random.default_rng(1)
    ts, qs = rng.uniform(0, 3, 128), rng.uniform(-np.pi, np.pi, (128, 2))
    np.testing.assert_allclose(
        tws.min_distance_txq_batch(_t(ts), _t(qs)).numpy(),
        np.asarray(jws.min_distance_txq_batch(jnp.asarray(ts),
                                              jnp.asarray(qs))),
        rtol=1e-12, atol=1e-14)
    target = lambda t: np.array([0.25, -0.3])
    kw = dict(max_iters=40, batch=16)
    jq = InterceptQuery(start=jnp.array([np.pi / 2, 0.4]),
                        target_traj=target, t_budget=4.0, v_max=1.5,
                        goal_tol=0.25)
    jr = jpl.intercept_plan(jws, jq, seed=3, **kw)
    draws = sum(_intercept_draws(jws.space, 3, 40, 16, 64), [])
    tq = tpl.InterceptQuery(start=np.array([np.pi / 2, 0.4]),
                            target_traj=target, t_budget=4.0, v_max=1.5,
                            goal_tol=0.25)
    tr = tpl.intercept_plan(tws, tq, seed=ReplayDraws(draws), **kw)
    assert jr.success
    assert_result_equal(tr, jr)


def test_intercept_1st_order_matches_jax():
    """The rendezvous planner of tests/test_tangent_spaces.py:220-248 (SVP
    reach times, timed SVP steering) with a tabulated trajectory target."""
    import reak_tpu.spaces.tangent as jtg
    import reak_tpu.spaces.vector as jsp
    import reak_tpu_torch.spaces.tangent as ttg
    from reak_tpu.interp.trajectory import Trajectory as JTraj
    from reak_tpu_torch.interp.trajectory import Trajectory as TTraj

    jspace1 = jtg.Ndof1stOrderSpace(lower=jnp.full(2, -6.0),
                                    upper=jnp.full(2, 6.0),
                                    speed=jnp.full(2, 1.5))
    tspace1 = ttg.Ndof1stOrderSpace(np.full(2, -6.0), np.full(2, 6.0),
                                    np.full(2, 1.5), device="cpu")
    jws = jpl.NoObstacleWorkspace(jsp.HyperboxSpace(jnp.full(2, -6.0),
                                                    jnp.full(2, 6.0)))
    tws = convert.workspace_from(jws, CPU, F64)
    times = np.linspace(0.0, 10.0, 41)
    pts = np.stack([2.0 - 0.4 * times, 1.0 + 0.3 * times], 1)
    vels = np.tile([-0.4, 0.3], (41, 1))
    kw = dict(max_iters=30, batch=32)
    jq = jpl.RendezvousQuery(jnp.zeros(2), jnp.zeros(2),
                             JTraj(jnp.asarray(times), jnp.asarray(pts),
                                   jnp.asarray(vels)), 10.0, 0.2)
    jr = jpl.intercept_plan_1st_order(jws, jspace1, jq, seed=0, **kw)
    draws = []
    for p, u, c, i in _intercept_draws(jspace1, 0, 30, 32, 41):
        draws += [ttg.NdofPoint1(np.asarray(p.q), np.asarray(p.qd)), u, c, i]
    tq = tpl.RendezvousQuery(np.zeros(2), np.zeros(2),
                             TTraj(_t(times), _t(pts), _t(vels)), 10.0, 0.2)
    tr = tpl.intercept_plan_1st_order(tws, tspace1, tq,
                                      seed=ReplayDraws(draws), **kw)
    assert jr.success
    assert_result_equal(tr, jr)


def test_f20_goal_bias_draws_cover_the_table():
    """The port's goal bias draws coin and index independently: over 2,000
    waves of 32 the biased samples' indices fill every fifth of a 64-row
    table within 15 % of its share (binomial σ ≈ 3 %)."""
    from reak_tpu_torch.planning.intercept import _goal_biased

    draws = Draws(0, "cpu")
    table = torch.arange(64, dtype=F64)
    hits = torch.zeros(64)
    for _ in range(2000):
        (rows,), t = _goal_biased(draws, 32, 0.2, (table, table[:, None]),
                                  (torch.full((32, 1), -1.0, dtype=F64),),
                                  torch.full((32,), -1.0, dtype=F64))
        picked = rows[:, 0][rows[:, 0] >= 0].long()
        assert torch.equal(t[t >= 0], table[picked])
        hits += torch.bincount(picked, minlength=64)
    share = hits.sum() / (2000 * 32)
    assert abs(share - 0.2) < 0.01
    fifths = torch.stack([h.sum() for h in hits.tensor_split(5)])
    expected = hits.sum() * torch.tensor([13, 13, 13, 13, 12]) / 64
    assert torch.all((fifths / expected - 1).abs() < 0.15)


def test_run_crs_planner_matches_jax(jex, crs, capsys):
    """The example's RRT on the CRS scene (replayed draws), its interception
    mode's target (the IK-mapped tool path; the planner itself is held to
    JAX's in ``test_temporal_intercept_matches_jax``), then the CLI on the
    CPU in both modes."""
    from _planning_jax import tree_draws
    from reak_tpu.kte import ik as jik

    jws, _, q = crs
    jr = jex.PLANNERS["rrt"](jws, q, dict(jex.DEFAULTS, max_iters=6))
    _, _, tr = tex.plan(dict(tex.DEFAULTS, max_iters=6, device="cpu",
                             seed=ReplayDraws(tree_draws(jws.space, 0, 6,
                                                         64))))
    assert jr.success
    assert_result_equal(tr, jr)

    spec, _, _ = jex.build_scene()
    ik = jax.jit(lambda t: jik.ik_3r3r(
        spec, jnp.stack([-0.45, -0.3 + 0.06 * t, 0.4]),
        jnp.asarray([1.0, 0, 0, 0]), wrist=-1.0))
    _, iq, tri = tex.intercept(dict(tex.DEFAULTS, max_iters=6, device="cpu"))
    times = np.linspace(0.0, 8.0, 5)
    np.testing.assert_allclose(
        np.stack([iq.target_traj(t) for t in times]),
        np.stack([np.asarray(ik(t)) for t in times]), rtol=1e-12, atol=1e-14)
    assert tri.success

    assert tex.main(["--planner=birrt", "--max_iters=6", "--device=cpu"]) == 0
    assert tex.main(["--dynamic=1", "--max_iters=6", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "planner=birrt  success=True" in out and "intercepted at" in out
