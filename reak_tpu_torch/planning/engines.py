"""Planner execution engines: Monte-Carlo benchmarking + reporters (port of
``reak_tpu/planning/engines.py``).

(ref: ctrl/path_planning/planner_exec_engines.hpp:86 monte_carlo_mp_engine,
:214 vlist_print_mp_engine, :324 execute_p2p_planner;
basic_sbmp_reporters.hpp:318 timing_sbmp_report, :410 print_sbmp_progress)

One planned difference: ``vlist_engine``'s cost-to-come accumulates in
parent-before-child order (a breadth-first sweep from the root).  The JAX
package makes one forward pass in index order, which assumes that every
parent's index is below its child's; RRT* rewiring gives vertices parents of
higher index, so its dumps of rewired trees carry wrong costs (fault F1 of
the reference).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from reak_tpu_torch.planning.draws import space_like
from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult


def _rows(results, recorder):
    rows = []
    for run, res in results:
        row = {
            "run": run,
            "success": int(res.success),
            "cost": res.cost,
            "vertices": res.n_vertices,
            "iterations": res.n_iterations,
            "wall_time_s": res.wall_time_s,
        }
        rows.append(row)
        if recorder is not None:
            recorder.record(row)
    return rows


def _aggregate(rows, n_runs, mean_time_s, **extra):
    succ = [r for r in rows if r["success"]]
    return {
        "n_runs": n_runs,
        "success_rate": len(succ) / n_runs,
        "mean_time_s": mean_time_s,
        **extra,
        "mean_cost": float(np.mean([r["cost"] for r in succ])) if succ else float("inf"),
        "mean_vertices": float(np.mean([r["vertices"] for r in rows])),
        "rows": rows,
    }


def monte_carlo_engine(planner: Callable, workspace, query: PlanningQuery,
                       n_runs: int = 10, recorder=None, **planner_kw):
    """Repeated randomized runs collecting timing/cost statistics
    (ref: planner_exec_engines.hpp:125-160 — the *_times.txt records).
    Run ``r`` is seeded with ``r``.

    Returns dict of aggregate stats; per-run rows go to ``recorder`` (any
    object with a ``record(dict)`` method, e.g. io.recorder sinks).
    """
    rows = _rows(((run, planner(workspace, query, seed=run, **planner_kw))
                  for run in range(n_runs)), recorder)
    return _aggregate(rows, n_runs,
                      float(np.mean([r["wall_time_s"] for r in rows])))


class timing_reporter:
    """Per-iteration wall-clock reporter (ref: timing_sbmp_report,
    basic_sbmp_reporters.hpp:318)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.times = []

    def __call__(self, iteration, state):
        self.times.append((iteration, time.perf_counter() - self.t0))


class progress_reporter:
    """Prints progress every ``interval`` iterations (ref: print_sbmp_progress,
    basic_sbmp_reporters.hpp:410)."""

    def __init__(self, interval: int = 10):
        self.interval = interval

    def __call__(self, iteration, state):
        if iteration % self.interval == 0:
            count = int(state.count) if hasattr(state, "count") else -1
            print(f"[planner] iter={iteration} vertices={count}")


def _graph_cost_to_come(space, verts, parents):
    """Per-vertex cost-to-come along tree edges (root cost 0): the edge
    lengths summed parent before child, in a breadth-first sweep from the
    roots (vertices with parent −1).  A vertex no root reaches costs +inf."""
    parents = np.asarray(parents, np.int64)
    n = len(parents)
    cost = np.zeros(n)
    if n < 2:
        return cost
    # each vertex's edge from its parent, in one batched distance call
    device, dtype = space_like(space)
    v = torch.as_tensor(np.asarray(verts), dtype=dtype, device=device)
    d = space.distance(v[torch.as_tensor(np.maximum(parents, 0),
                                         device=device)], v).cpu().numpy()
    cost[:] = np.inf
    roots = np.nonzero(parents < 0)[0]
    cost[roots] = 0.0
    # children of each vertex, grouped by a stable sort on the parent index
    order = np.argsort(parents, kind="stable")
    starts = np.searchsorted(parents[order], np.arange(n + 1))
    frontier = roots
    while frontier.size:
        kids = np.concatenate([order[starts[p]:starts[p + 1]]
                               for p in frontier])
        kids = kids[np.isinf(cost[kids])]  # each vertex once
        cost[kids] = cost[parents[kids]] + d[kids]
        frontier = kids
    return cost


def vlist_engine(planner: Callable, workspace, query: PlanningQuery,
                 out_stem: str, seed: int = 0, **planner_kw):
    """Single-run engine that dumps the planner's MOTION GRAPH vertex list
    (index, parent, cost-to-come, coordinates) and the solution records to
    files — the reference's vlist_print_mp_engine
    (ref: planner_exec_engines.hpp:214 + vlist_sbmp_report.hpp,
    basic_sbmp_reporters.hpp least_cost_sbmp_report).

    Writes ``<out_stem>_vlist.csv``, ``<out_stem>_solutions.csv`` (empty if
    unsolved) and ``<out_stem>_times.txt``; returns the PlanResult.  The
    planner must expose its graph via ``PlanResult.stats['verts'/'parents']``
    (numpy on the host; reak_tpu_torch.planning.rrt does).
    """
    import os

    os.makedirs(os.path.dirname(out_stem) or ".", exist_ok=True)
    res: PlanResult = planner(workspace, query, seed=seed, **planner_kw)
    verts = res.stats.get("verts")
    parents = res.stats.get("parents")
    if verts is None:
        raise ValueError("planner result carries no motion graph "
                         "(stats['verts']); vlist engine needs one")
    cost = _graph_cost_to_come(workspace.space, verts, parents)
    with open(out_stem + "_vlist.csv", "w") as f:
        f.write("index,parent,cost_to_come," +
                ",".join(f"x{i}" for i in range(verts.shape[1])) + "\n")
        for i in range(len(verts)):
            coords = ",".join(f"{float(v):.17g}" for v in verts[i])
            f.write(f"{i},{int(parents[i])},{cost[i]:.17g},{coords}\n")
    with open(out_stem + "_solutions.csv", "w") as f:
        if res.success and res.path is not None:
            for row in np.asarray(res.path):
                f.write(",".join(f"{float(v):.17g}" for v in row) + "\n")
    with open(out_stem + "_times.txt", "w") as f:
        f.write(f"{res.wall_time_s:.6f} {res.n_vertices} {res.cost}\n")
    return res


def differ_report_engine(planner: Callable, workspace, query: PlanningQuery,
                         out_stem: str, segment_steps: int = 10,
                         seed: int = 0, **planner_kw):
    """Single-run engine dumping the solution trajectory DENSIFIED to
    ``segment_steps`` interpolation points per edge — the reference's
    differ_report_mp_engine / differ_sbmp_report_to_space
    (ref: planner_exec_engines.hpp:275).  Writes
    ``<out_stem>_traj.csv``; returns the PlanResult."""
    import os

    os.makedirs(os.path.dirname(out_stem) or ".", exist_ok=True)
    res: PlanResult = planner(workspace, query, seed=seed, **planner_kw)
    with open(out_stem + "_traj.csv", "w") as f:
        if res.success and res.path is not None:
            path = np.asarray(res.path)
            for a, b in zip(path[:-1], path[1:]):
                for s in np.linspace(0.0, 1.0, segment_steps, endpoint=False):
                    p = a + s * (b - a)
                    f.write(",".join(f"{float(v):.17g}" for v in p) + "\n")
            f.write(",".join(f"{float(v):.17g}" for v in path[-1]) + "\n")
    return res


def load_vlist(path: str):
    """Read a ``vlist_engine`` dump back: (verts, parents, cost_to_come)."""
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    parents = data[:, 1].astype(int)
    cost = data[:, 2]
    verts = data[:, 3:]
    return verts, parents, cost


def diff_motion_graphs(space, stem_a: str, stem_b: str):
    """Run-to-run structural diff of two vlist dumps — the report the
    reference's differ engines exist to enable (compare planner runs across
    algorithms/settings).  Returns coverage/cost deltas:

    - ``n_vertices``: per-run vertex counts;
    - ``hausdorff_ab``/``hausdorff_ba``: directed Hausdorff distances
      between the vertex sets under the space metric (coverage difference);
    - ``mean_nn``: symmetric mean nearest-neighbor distance;
    - ``cost_best``: per-run best cost-to-come at the last vertex layer.
    """
    device, dtype = space_like(space)
    va, pa, ca = load_vlist(stem_a + "_vlist.csv")
    vb, pb, cb = load_vlist(stem_b + "_vlist.csv")
    A = torch.as_tensor(va, dtype=dtype, device=device)
    B = torch.as_tensor(vb, dtype=dtype, device=device)

    def directed(X, Y):
        return torch.amin(space.distance(X[:, None, :], Y[None, :, :]),
                          dim=-1).cpu().numpy()

    d_ab = directed(A, B)
    d_ba = directed(B, A)
    return {
        "n_vertices": (len(va), len(vb)),
        "hausdorff_ab": float(np.max(d_ab)),
        "hausdorff_ba": float(np.max(d_ba)),
        "mean_nn": float(0.5 * (np.mean(d_ab) + np.mean(d_ba))),
        "cost_best": (float(np.max(ca)), float(np.max(cb))),
    }


def monte_carlo_engine_batched(planner_batch: Callable, workspace,
                               query: PlanningQuery, n_runs: int = 10,
                               recorder=None, **planner_kw):
    """Monte-Carlo statistics via a BATCHED planner (rrt.rrt_plan_batch /
    rrt_star.rrt_star_plan_batch): all runs advance as one batch on the
    device, so per-run wall-clock amortizes to total/n_runs (vs the
    reference's serial loop, planner_exec_engines.hpp:125-160).  Same
    aggregate dict as monte_carlo_engine, plus ``wall_total_s``."""
    results, wall_total = planner_batch(workspace, query, n_runs=n_runs,
                                        **planner_kw)
    rows = _rows(enumerate(results), recorder)
    return _aggregate(rows, n_runs, wall_total / n_runs,
                      wall_total_s=wall_total)
