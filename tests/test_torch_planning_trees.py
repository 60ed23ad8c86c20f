"""The port's tree planners (``reak_tpu_torch.planning.rrt``, ``rrt_star``,
``sbastar_rrtstar``) against the JAX package's, on the CPU at float64
(the single-run RRT and the batched RRT* are held in
tests/test_torch_planning_engines.py, beside the engines that use them).

Each JAX planner runs from its key; the port gets the same draws through
``planning.draws.ReplayDraws``, computed here from the JAX key schedule.
With the same draws the trees must agree: parents, counts, goal vertices
and iteration counts equal, vertices, paths and costs within 1e-12
relative.  Worlds: the 64×64 gap world of bench_planner.py:127-137 and the
empty unit box (for the capacity overflow)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _planning_jax import (assert_result_equal, bitmap_worlds, free_worlds,
                           keeping, same_graphs, same_stats, tree_draws)
import reak_tpu.planning.engines as jeng
import reak_tpu_torch.planning.engines as teng
from reak_tpu.planning import rrt as jrrt, rrt_star as jstar, \
    sbastar_rrtstar as jhyb
from reak_tpu.planning.queries import PlanningQuery
from reak_tpu_torch.planning import rrt as trrt, rrt_star as tstar, \
    sbastar_rrtstar as thyb
from reak_tpu_torch.planning.draws import ReplayDraws

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gap():
    return bitmap_worlds()


def test_rrt_plan_batch_matches_jax(gap):
    """Through ``monte_carlo_engine_batched``: every run keeps expanding
    until the last one connects."""
    jws, tws, q = gap
    kw = dict(n_runs=4, max_iters=30, step_size=0.8, capacity=1024)
    draws = ReplayDraws(tree_draws(jws.space, 5, 30, 64, runs=4))
    jres, tres = [], []
    js = jeng.monte_carlo_engine_batched(keeping(jrrt.rrt_plan_batch, jres),
                                         jws, q, seed=5, **kw)
    ts = teng.monte_carlo_engine_batched(keeping(trrt.rrt_plan_batch, tres),
                                         tws, q, seed=draws, **kw)
    jres, tres = jres[0][0], tres[0][0]
    assert all(r.success for r in jres)
    assert draws.used == jres[0].n_iterations
    same_graphs(tres, jres)
    same_stats(ts, js)


def test_birrt_plan_matches_jax(gap):
    jws, tws, q = gap
    kw = dict(max_iters=40, step_size=0.8, capacity=1024)
    jr = jrrt.birrt_plan(jws, q, seed=2, **kw)
    tr = trrt.birrt_plan(tws, q, seed=ReplayDraws(
        tree_draws(jws.space, 2, 40, 64, split_sub=False)), **kw)
    assert jr.success
    assert_result_equal(tr, jr)


def test_rrt_star_plan_matches_jax(gap):
    """Single run: path, cost and the count after the choose-parent and
    rewire passes."""
    jws, tws, q = gap
    kw = dict(max_iters=15, step_size=0.8, capacity=512)
    jr = jstar.rrt_star_plan(jws, q, seed=1, **kw)
    tr = tstar.rrt_star_plan(tws, q, seed=ReplayDraws(
        tree_draws(jws.space, 1, 15, 32)), **kw)
    assert jr.success
    assert_result_equal(tr, jr)


@pytest.mark.parametrize("planner", ["rrt_batch", "rrt_star"])
def test_capacity_overflow_matches_jax(planner):
    """Trees filled past capacity in an empty box (64- and 32-point waves
    into 100 slots): the points that do not fit are dropped as JAX's
    scatter drops them, and the count stops at cap − 1 (the single-run and
    bidirectional trees insert through the same ``_insert``)."""
    jws, tws = free_worlds()
    q = PlanningQuery(np.zeros(3), np.full(3, 0.9), goal_tolerance=1e-3)
    kw = dict(max_iters=4, step_size=0.05, capacity=100)
    space = jws.space
    if planner == "rrt_batch":
        jres, _ = jrrt.rrt_plan_batch(jws, q, n_runs=2, seed=7, **kw)
        tres, _ = trrt.rrt_plan_batch(tws, q, n_runs=2, seed=ReplayDraws(
            tree_draws(space, 7, 4, 64, runs=2)), **kw)
        same_graphs(tres, jres)
        jr = jres[0]
    else:
        jres, _ = jstar.rrt_star_plan_batch(jws, q, n_runs=2, seed=7, **kw)
        tres, _ = tstar.rrt_star_plan_batch(tws, q, n_runs=2, seed=ReplayDraws(
            tree_draws(space, 7, 4, 32, runs=2)), **kw)
        same_graphs(tres, jres)
        jr = jres[0]
    assert jr.n_vertices == 99


def test_sbastar_rrtstar_matches_jax(gap):
    """The hybrid's mixed wave (randint, normal, then uniform draws through
    the RRT* step's ``sampler`` hook) and its anytime cost history."""
    jws, tws, q = gap
    kw = dict(max_iters=20, step_size=0.8, capacity=1024, K=32,
              return_history=True)
    jr, jh = jhyb.sbastar_rrtstar_plan(jws, q, seed=6, **kw)
    lo, hi = jnp.asarray(jws.space.lower), jnp.asarray(jws.space.upper)

    @jax.jit
    def mixed(sub):
        k1, _ = jax.random.split(sub)
        k1, k2, k3 = jax.random.split(k1, 3)
        return (jax.random.randint(k1, (16,), 0, 8),
                jax.random.normal(k2, (16, 2)),
                lo + jax.random.uniform(k3, (16, 2)) * (hi - lo))

    key, draws = jax.random.PRNGKey(6), []
    for _ in range(20):
        key, sub = jax.random.split(key)
        draws += [np.asarray(x) for x in mixed(sub)]
    tr, th = thyb.sbastar_rrtstar_plan(tws, q, seed=ReplayDraws(draws), **kw)
    assert jr.success
    assert_result_equal(tr, jr)
    np.testing.assert_allclose(th, jh, rtol=1e-12)
