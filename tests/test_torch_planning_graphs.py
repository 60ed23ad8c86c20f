"""The port's roadmap and graph planners (``prm``, ``lazy_prm``, ``rrg``,
``sbastar``, ``fadprm``, ``adstar``, ``graph_search``), its DVP tree and its
reachability sort, against the JAX package's on the CPU at float64.

The JAX planners run from their keys; the port gets the same draws through
``planning.draws.ReplayDraws`` (computed here from the JAX key schedules;
SBA*'s Gaussian draws take the shape of the run's front, so they are
computed when the port asks for them).  Graphs, paths and costs must agree:
indices equal, values within 1e-12 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.planning as jpl
import reak_tpu_torch.planning as tpl
from _planning_jax import (CPU, assert_result_equal, bitmap_grid,
                           bitmap_worlds, _sample)
from reak_tpu.planning.queries import PlanningQuery
from reak_tpu_torch.planning.draws import ReplayDraws

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gap():
    """The gap world; the JAX workspace's batched checks and its space's
    metric under ``jax.jit`` (the host-driven JAX planners call them eagerly
    on a new shape almost every time, and each eager op compiles once per
    shape)."""
    jws, tws, q = bitmap_worlds()
    for obj, name in ((jws, "edge_free_batch"), (jws, "is_free_batch"),
                      (jws.space, "distance")):
        setattr(obj, name, jax.jit(getattr(obj, name)))
    return jws, tws, q


@pytest.fixture(scope="module")
def corner(gap):
    """The gap world with a query whose straight line clips the wall's
    corner: a short detour (fewer vertices, fewer JAX compiles)."""
    return gap[0], gap[1], PlanningQuery(np.array([6.0, 2.0]),
                                         np.array([8.0, 8.0]),
                                         goal_tolerance=0.5)


@pytest.mark.parametrize("planner", ["prm", "lazy_prm"])
def test_roadmaps_match_jax(gap, planner):
    """PRM and Lazy-PRM (with its repair rounds and edge counts) from one
    draw of 2 n_samples points, the JAX key itself."""
    jws, tws, q = gap
    jfn, tfn = getattr(jpl, f"{planner}_plan"), getattr(tpl, f"{planner}_plan")
    jr = jfn(jws, q, n_samples=100, k_neighbors=6, seed=2)
    draws = ReplayDraws([np.asarray(_sample(jws.space, jax.random.PRNGKey(2),
                                            (200,)))])
    tr = tfn(tws, q, n_samples=100, k_neighbors=6, seed=draws)
    assert jr.success
    assert_result_equal(tr, jr)
    assert tr.stats == jr.stats


def test_bnb_prune_matches_jax(gap):
    jws, tws, _ = gap
    rng = np.random.default_rng(0)
    verts = rng.uniform(0, 10, (40, 2))
    costs = rng.uniform(0, 12, 40)
    goal = np.array([5.0, 9.0])
    jk = jpl.bnb_prune(jnp.asarray(verts), jnp.asarray(costs),
                       jnp.asarray(goal), 10.0, jws.space, 30)
    t = lambda x: torch.as_tensor(x, device=CPU)
    tk = tpl.bnb_prune(t(verts), t(costs), goal, 10.0, tws.space, 30)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < 30


def test_rrg_matches_jax(corner):
    jws, tws, q = corner
    kw = dict(max_iters=8, batch=8, step_size=1.0, goal_tol=0.5)
    jr = jpl.rrg_plan(jws, q, seed=2, **kw)

    @jax.jit
    def draw(k):
        k1, k2 = jax.random.split(k)
        return (_sample(jws.space, k1, (8,)),
                jax.random.uniform(k2, (8,)))

    key, draws = jax.random.PRNGKey(2), []
    for _ in range(8):
        key, k = jax.random.split(key)
        draws += [np.asarray(x) for x in draw(k)]
    tr = tpl.rrg_plan(tws, q, seed=ReplayDraws(draws), **kw)
    assert jr.success
    assert_result_equal(tr, jr)


def test_sbastar_matches_jax(corner):
    jws, tws, q = corner
    kw = dict(max_iters=40, step_size=0.8, capacity=512)
    jr = jpl.sbastar_plan(jws, q, seed=2, **kw)
    key, subs = jax.random.PRNGKey(2), []
    for _ in range(40):
        key, sub = jax.random.split(key)
        subs.append(sub)
    normal = jax.jit(jax.random.normal, static_argnums=1)
    draws = [lambda shape, k=k: np.asarray(normal(k, shape)) for k in subs]
    tr = tpl.sbastar_plan(tws, q, seed=ReplayDraws(draws), **kw)
    assert jr.success
    assert_result_equal(tr, jr)


def test_fadprm_and_revalidation_match_jax(corner):
    """Grow in waves, anytime-refine, then close the gap of the wall and
    revalidate every edge: AD*'s repaired answer and the edge costs equal
    JAX's."""
    jws, tws, q = corner
    kw = dict(k_neighbors=6, max_edge_len=2.0)
    jp = jpl.FADPRMPlanner(jws, q, seed=4, **kw)
    key, draws = jax.random.PRNGKey(4), []
    for _ in range(3):
        key, k = jax.random.split(key)
        draws.append(np.asarray(_sample(jws.space, k, (30,))))
    tp = tpl.FADPRMPlanner(tws, q, seed=ReplayDraws(draws), **kw)
    for eps in (2.5, 1.5, 1.0):
        jp.grow(30), tp.grow(30)
        assert_result_equal(tp.solve(eps), jp.solve(eps))
    np.testing.assert_array_equal(tp.edges, jp.edges)
    np.testing.assert_allclose(tp.costs, jp.costs, rtol=1e-12)
    assert jp.solve(1.0).success

    walled = bitmap_grid()
    walled[:56, 24:40] = False
    jws2 = jpl.bitmap_workspace(jws.space, jnp.asarray(walled),
                                jnp.zeros(2), jnp.full(2, 10.0))
    tws2 = tpl.bitmap_workspace(tws.space, walled, np.zeros(2),
                                np.full(2, 10.0))
    jp.revalidate(jws2), tp.revalidate(tws2)
    np.testing.assert_allclose(tp.costs, jp.costs, rtol=1e-12)
    assert (tp.costs == np.inf).any()
    assert_result_equal(tp.solve(1.0), jp.solve(1.0))


def test_graph_search_matches_jax():
    """A*, anytime A* and AD* with an edge cut (host code, copied)."""
    from reak_tpu.planning import graph_search as jgs
    from reak_tpu_torch.planning import graph_search as tgs

    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (60, 2))
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    edges = np.array([(i, j) for i in range(60) for j in range(i + 1, 60)
                      if d[i, j] < 0.25])
    costs = d[edges[:, 0], edges[:, 1]]
    h = lambda v: float(d[v, 59])
    assert tgs.astar(60, edges, costs, 0, 59, h) == \
        jgs.astar(60, edges, costs, 0, 59, h)
    assert tgs.anytime_astar(60, edges, costs, 0, 59, h) == \
        jgs.anytime_astar(60, edges, costs, 0, 59, h)
    jpath, jcost, jhist = jpl.adstar_search(60, edges, costs, 0, 59, h)
    tpath, tcost, thist = tpl.adstar_search(60, edges, costs, 0, 59, h)
    assert (tpath, tcost, thist) == (jpath, jcost, jhist)
    js, ts = (m.ADStar(60, edges, costs, 0, 59, h) for m in (jpl, tpl))
    for s in (js, ts):
        s.compute(1.0)
        s.update_edges(np.arange(0, len(edges), 3), np.inf)
    assert ts.compute(1.5) == js.compute(1.5)


def test_dvp_tree_matches_linear_nn_and_jax():
    """k-NN and range queries of the DVP tree equal the exhaustive search,
    and the port's tree (host rng, device distances) equals JAX's."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (300, 3))
    qs = rng.uniform(-1, 1, (5, 3))
    jt = jpl.DVPTree(pts, leaf_size=8, seed=2)
    tt = tpl.DVPTree(pts, leaf_size=8, seed=2, device="cpu")
    assert [n.keys() for n in tt.nodes] == [n.keys() for n in jt.nodes]
    for q in qs:
        ti, td = tt.find_nearest(q, k=5)
        li, ld = tpl.linear_nn(q, pts, k=5, device="cpu")
        ji, jd = jpl.linear_nn(q, pts, k=5)
        np.testing.assert_array_equal(ti, li)
        np.testing.assert_array_equal(li, ji)
        np.testing.assert_allclose(td, ld, rtol=1e-12)
        np.testing.assert_allclose(ld, jd, rtol=1e-12)
        jki, _ = jt.find_nearest(q, k=5)
        np.testing.assert_array_equal(ti, jki)
        ri, rd = tt.find_in_range(q, 0.4)
        jri, _ = jt.find_in_range(q, 0.4)
        np.testing.assert_array_equal(np.sort(ri), np.sort(jri))
        brute = np.nonzero(np.linalg.norm(pts - q, axis=-1) <= 0.4)[0]
        np.testing.assert_array_equal(np.sort(ri), brute)


def test_reachability_sort_matches_jax():
    """Sort order, the quadrant prune and the nearest reachable point."""
    import reak_tpu.spaces.tangent as jtg
    import reak_tpu.spaces.vector as jsp
    import reak_tpu_torch.spaces.tangent as ttg
    import reak_tpu_torch.spaces.vector as tsp
    from reak_tpu.planning.reach_sort import ReachabilitySortedSet as JR
    from reak_tpu.spaces.temporal import TemporalPoint as JTP
    from reak_tpu_torch.planning.reach_sort import ReachabilitySortedSet as TR
    from reak_tpu_torch.spaces.temporal import TemporalPoint as TTP

    rng = np.random.default_rng(7)
    times = rng.uniform(0, 5, 200)
    pts = rng.uniform(-2, 2, (200, 3))
    jspace = jtg.ReachabilitySpace(
        jsp.HyperboxSpace(jnp.full(3, -2.0), jnp.full(3, 2.0)), 5.0,
        origin=JTP(jnp.asarray(0.0), jnp.zeros(3)))
    tspace = ttg.ReachabilitySpace(
        tsp.HyperboxSpace(np.full(3, -2.0), np.full(3, 2.0), device="cpu"),
        5.0, origin=TTP(torch.tensor(0.0, dtype=torch.float64),
                        torch.zeros(3, dtype=torch.float64)))
    js = JR(jspace, times, pts)
    ts = TR(tspace, times, pts)
    np.testing.assert_array_equal(ts.order.numpy(), np.asarray(js.order))
    np.testing.assert_allclose(ts.b.numpy(), np.asarray(js.b), rtol=1e-12)
    for t, p in zip(rng.uniform(0, 2, 4), rng.uniform(-1, 1, (4, 3))):
        jtp = JTP(jnp.asarray(t), jnp.asarray(p))
        ttp = TTP(torch.tensor(t, dtype=torch.float64),
                  torch.as_tensor(p))
        np.testing.assert_array_equal(ts.candidate_mask_from(ttp).numpy(),
                                      np.asarray(js.candidate_mask_from(jtp)))
        np.testing.assert_array_equal(ts.reachable_from(ttp).numpy(),
                                      np.asarray(js.reachable_from(jtp)))
        ti, tv = ts.nearest_reachable(ttp)
        ji, jv = js.nearest_reachable(jtp)
        assert int(ti) == int(ji)
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-12)
