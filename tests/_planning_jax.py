"""Shared pieces of the port's planning tests: the small worlds built in
both packages, and the JAX planners' own draws, computed from their key
schedules so that ``reak_tpu_torch.planning.draws.ReplayDraws`` can hand
them to the port."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

import reak_tpu.planning as jpl
import reak_tpu.spaces.vector as jsp
import reak_tpu_torch.planning as tpl
import reak_tpu_torch.spaces.vector as tsp
from reak_tpu.planning.queries import PlanningQuery

CPU = torch.device("cpu")


def bitmap_grid():
    """The 64×64 gap world of bench_planner.py:127-137 (True = free)."""
    grid = np.ones((64, 64), bool)
    grid[0:44, 24:40] = False
    return grid


def bitmap_worlds(n_checks=16):
    """(JAX workspace, port workspace, query) of the gap world."""
    grid = bitmap_grid()
    js = jsp.NdofSpace(jnp.zeros(2), jnp.full(2, 10.0))
    ts = tsp.NdofSpace(np.zeros(2), np.full(2, 10.0), device="cpu")
    jws = jpl.bitmap_workspace(js, jnp.asarray(grid), jnp.zeros(2),
                               jnp.full(2, 10.0), n_checks=n_checks)
    tws = tpl.bitmap_workspace(ts, grid, np.zeros(2), np.full(2, 10.0),
                               n_checks=n_checks)
    query = PlanningQuery(np.array([5.0, 1.0]), np.array([5.0, 9.0]),
                          goal_tolerance=0.5)
    return jws, tws, query


def free_worlds(dim=3):
    """(JAX workspace, port workspace) of the unit box with no obstacle."""
    js = jsp.NdofSpace(jnp.zeros(dim), jnp.ones(dim))
    ts = tsp.NdofSpace(np.zeros(dim), np.ones(dim), device="cpu")
    return jpl.NoObstacleWorkspace(js), tpl.NoObstacleWorkspace(ts)


@lru_cache(maxsize=None)
def _sampler(space_key, shape):
    lo, hi = (jnp.asarray(x) for x in space_key)
    return jax.jit(lambda k: lo + jax.random.uniform(k, shape + lo.shape)
                   * (hi - lo))


def _sample(space, key, shape):
    return _sampler((tuple(np.asarray(space.lower)),
                     tuple(np.asarray(space.upper))), tuple(shape))(key)


def tree_draws(space, seed, iters, K, runs=None, split_sub=True):
    """The samples of an RRT/RRT* wave loop: per wave ``key, sub =
    split(key)``; a batch of runs splits ``sub`` into one key a run; each
    run's key is split once more (``k1, _ = split(sub)``) unless
    ``split_sub`` is False (birrt samples from ``sub`` itself)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        subs = [sub] if runs is None else list(jax.random.split(sub, runs))
        draws = [_sample(space, jax.random.split(k)[0] if split_sub else k,
                         (K,)) for k in subs]
        out.append(np.asarray(draws[0] if runs is None else jnp.stack(draws)))
    return out


def assert_tree_equal(t_verts, t_parents, j_verts, j_parents, rtol=1e-12):
    np.testing.assert_array_equal(np.asarray(t_parents),
                                  np.asarray(j_parents))
    np.testing.assert_allclose(np.asarray(t_verts), np.asarray(j_verts),
                               rtol=rtol, atol=rtol)


def assert_result_equal(tr, jr, rtol=1e-12):
    """Two PlanResults: success, counts and iterations equal, path and cost
    within ``rtol``."""
    assert (tr.success, tr.n_vertices, tr.n_iterations) == \
        (jr.success, jr.n_vertices, jr.n_iterations)
    if jr.path is None:
        assert tr.path is None
        return
    np.testing.assert_allclose(np.asarray(tr.path), np.asarray(jr.path),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(tr.cost, jr.cost, rtol=rtol)


def same_graphs(t_results, j_results):
    """PlanResults and their motion graphs equal (``assert_result_equal``,
    ``assert_tree_equal``)."""
    for tr, jr in zip(t_results, j_results):
        assert_result_equal(tr, jr)
        assert_tree_equal(tr.stats["verts"], tr.stats["parents"],
                          jr.stats["verts"], jr.stats["parents"])


def same_stats(ts, js):
    """The Monte-Carlo engines' aggregates and rows (all but wall times)."""
    assert ts.keys() == js.keys()
    for k in ("n_runs", "success_rate", "mean_cost", "mean_vertices"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-12)
    for tr, jr in zip(ts["rows"], js["rows"]):
        assert tr.keys() == jr.keys()
        for k in tr.keys() - {"wall_time_s"}:
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-12)


def keeping(planner, out):
    """``planner`` that also appends what it returns to ``out``."""
    def run(*a, **k):
        out.append(planner(*a, **k))
        return out[-1]
    return run
