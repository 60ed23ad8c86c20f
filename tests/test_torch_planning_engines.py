"""The port's planner engines (``reak_tpu_torch.planning.engines``) against
the JAX package's, on the CPU at float64, and fault F1 of the reference.

F1: the JAX ``_graph_cost_to_come`` (``reak_tpu/planning/engines.py:75-93``)
sums edge lengths in one forward pass over the vertex indices, which is
right only where every parent's index is below its child's.  RRT*
rewiring gives vertices parents of higher index, so the JAX package's
vlist dumps of rewired trees carry wrong costs-to-come.  The port sums
parent before child; the tests below hold the port to the edge sums and
record that the JAX package misses them."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import reak_tpu.planning.engines as jeng
import reak_tpu_torch.planning.engines as teng
from _planning_jax import (assert_result_equal, bitmap_worlds, free_worlds,
                           keeping, same_graphs, same_stats, tree_draws)
from reak_tpu.planning import rrt as jrrt, rrt_star as jstar
from reak_tpu_torch.planning import rrt as trrt, rrt_star as tstar
from reak_tpu_torch.planning.draws import ReplayDraws

torch.set_num_threads(1)


def _edge_sums(verts, parents):
    """Cost-to-come by walking each vertex's parent chain to the root."""
    out = np.zeros(len(parents))
    for i in range(len(parents)):
        j = i
        while parents[j] >= 0:
            out[i] += np.linalg.norm(verts[j] - verts[parents[j]])
            j = parents[j]
    return out


def _rewired_tree():
    """Five vertices; vertex 1 hangs off vertex 4 (a rewire's shape)."""
    verts = np.array([[0.0, 0.0], [2.0, 2.0], [1.0, 0.0], [2.0, 0.0],
                      [2.0, 1.0]])
    parents = np.array([-1, 4, 0, 2, 3])
    return verts, parents


def test_f1_rewired_tree_by_hand():
    """F1: the port's costs are the edge sums; the JAX package's are not
    (vertex 1 gets its parent's cost before that cost is summed)."""
    jws, tws = free_worlds(dim=2)
    verts, parents = _rewired_tree()
    want = _edge_sums(verts, parents)
    got = teng._graph_cost_to_come(tws.space, verts, parents)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    jax_costs = jeng._graph_cost_to_come(jws.space, verts, parents)
    assert abs(jax_costs[1] - want[1]) > 1.0  # F1 in the reference


@pytest.fixture(scope="module")
def gap():
    return bitmap_worlds()


@pytest.fixture(scope="module")
def rrt_runs(gap):
    """One RRT run in each package through ``monte_carlo_engine`` (run 0,
    seed 0): (JAX stats, JAX result, port stats, port result)."""
    jws, tws, q = gap
    kw = dict(max_iters=40, step_size=0.8, capacity=1024)
    jres, tres = [], []
    js = jeng.monte_carlo_engine(keeping(jrrt.rrt_plan, jres), jws, q,
                                 n_runs=1, **kw)
    replay = lambda ws, q, seed, **k: trrt.rrt_plan(
        ws, q, seed=ReplayDraws(tree_draws(jws.space, seed, 40, 64)), **k)
    ts = teng.monte_carlo_engine(keeping(replay, tres), tws, q, n_runs=1,
                                 **kw)
    return js, jres[0], ts, tres[0]


@pytest.fixture(scope="module")
def star_runs(gap):
    """``rrt_star_plan_batch`` in each package, 3 runs × 15 waves (the port
    on the JAX draws): (JAX results, port results)."""
    jws, tws, q = gap
    kw = dict(n_runs=3, max_iters=15, step_size=0.8, capacity=512)
    jres, _ = jstar.rrt_star_plan_batch(jws, q, seed=4, **kw)
    tres, _ = tstar.rrt_star_plan_batch(tws, q, seed=ReplayDraws(
        tree_draws(jws.space, 4, 15, 32, runs=3)), **kw)
    return jres, tres


def test_rrt_plan_through_monte_carlo_engine_matches_jax(rrt_runs):
    js, jr, ts, tr = rrt_runs
    assert jr.success
    same_graphs([tr], [jr])
    same_stats(ts, js)


def test_rrt_star_plan_batch_matches_jax(star_runs):
    """Always ``max_iters`` waves; rewired trees equal parent for parent."""
    jres, tres = star_runs
    assert any(r.success for r in jres)
    same_graphs(tres, jres)


def test_f1_rrt_star_tree_from_replayed_draws(gap, star_runs):
    """A rewired RRT* tree (the same in both packages): the port's vlist
    costs equal the edge sums; the JAX package's miss them where a vertex's
    parent has a higher index (F1)."""
    jws, tws, _ = gap
    jres, tres = star_runs
    verts, parents = tres[0].stats["verts"], tres[0].stats["parents"]
    assert (parents > np.arange(len(parents))).any()
    want = _edge_sums(verts, parents)
    np.testing.assert_allclose(
        teng._graph_cost_to_come(tws.space, verts, parents), want,
        rtol=1e-12)
    jax_costs = jeng._graph_cost_to_come(jws.space, jres[0].stats["verts"],
                                         jres[0].stats["parents"])
    assert not np.allclose(jax_costs, want, rtol=1e-6)  # F1


def test_ordered_tree_costs_and_engines_match_jax(gap, rrt_runs, tmp_path):
    """On an RRT tree (parents below children) both packages' costs agree;
    the vlist, differ and diff engines write and read the same numbers (on
    the Monte-Carlo run's result, and on that tree shifted by 0.1)."""
    jws, tws, q = gap
    _, jres, _, tres = rrt_runs
    jr = jeng.vlist_engine(lambda *a, **k: jres, jws, q, str(tmp_path / "j"))
    tr = teng.vlist_engine(lambda *a, **k: tres, tws, q, str(tmp_path / "t"))
    assert_result_equal(tr, jr)
    jv, jp, jc = jeng.load_vlist(str(tmp_path / "j_vlist.csv"))
    tv, tp, tc = teng.load_vlist(str(tmp_path / "t_vlist.csv"))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    np.testing.assert_allclose(tc, jc, rtol=1e-12)
    np.testing.assert_allclose(tc, _edge_sums(tv, tp), rtol=1e-12)
    shifted = lambda r: replace(r, stats=dict(r.stats,
                                              verts=r.stats["verts"] + 0.1))
    for tag, eng, ws, res in (("j", jeng, jws, jr), ("t", teng, tws, tr)):
        eng.differ_report_engine(lambda *a, **k: res, ws, q,
                                 str(tmp_path / f"{tag}d"), segment_steps=5)
        eng.vlist_engine(lambda *a, **k: shifted(res), ws, q,
                         str(tmp_path / f"{tag}2"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "td_traj.csv",
                                          delimiter=","),
                               np.loadtxt(tmp_path / "jd_traj.csv",
                                          delimiter=","), rtol=1e-12)
    jd = jeng.diff_motion_graphs(jws.space, str(tmp_path / "j"),
                                 str(tmp_path / "j2"))
    td = teng.diff_motion_graphs(tws.space, str(tmp_path / "t"),
                                 str(tmp_path / "t2"))
    assert td["n_vertices"] == jd["n_vertices"]
    for k in ("hausdorff_ab", "hausdorff_ba", "mean_nn", "cost_best"):
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-12)
