"""Moving-target interception planning over a temporal space (port of
``reak_tpu/planning/intercept.py``).

(ref: ctrl/path_planning/intercept_query.hpp:75 motion_plan_intercept_query,
driven by examples/robot_airship/CRS_planner_dynexec.cpp:75 — plan in
time × joint space toward any point of a predicted target trajectory that is
reachable within a time budget.)

Time-augmented RRT: vertices are (t, q); edges only move forward in time with
rate-limited |Δq| ≤ v_max·Δt; goal test is proximity to ``target_traj(t)``
within the horizon.  The target trajectory is either an interp.Trajectory
(used at its NATIVE resolution, tables on the device) or any host callable
t → q (e.g. the maximum-likelihood trajectory mapped through IK, the
reference's transformed_trajectory composition, CRS_planner_dynexec.cpp:180),
sampled once at ``target_samples`` points.

One planned difference: the goal bias draws its coin and the target index
independently.  The JAX package draws both from one key (``k3`` for the
``uniform`` and the ``randint``); under threefry the two come out
uncorrelated all the same, because ``randint`` splits its key first.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from reak_tpu_torch.planning.draws import as_draws, space_like
from reak_tpu_torch.planning.queries import PlanResult
from reak_tpu_torch.planning.rrt import _compact_slots, _first, _insert
from reak_tpu_torch.planning.workspace import fractions


class InterceptQuery(NamedTuple):
    start: object               # (n,) joint start
    target_traj: object         # interp.Trajectory OR callable t → (n,) point
    t_budget: float             # time horizon
    v_max: float                # max joint-space speed
    goal_tol: float = 0.2
    target_samples: int = 64    # host-sampling count for callable targets


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tabulate_target(traj, t_budget, n_samples, with_vel=False,
                     device="cuda", dtype=torch.float64):
    """Target trajectory → device tables (ts, qs[, qds]).

    An interp.Trajectory is consumed directly (native resolution, clipped to
    the budget, never fewer than two rows).  A plain callable is sampled on
    the host at ``n_samples`` times."""
    from reak_tpu_torch.interp.trajectory import Trajectory

    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                  device=device)
    if isinstance(traj, Trajectory):
        ts = _host(traj.times).astype(np.float64)
        # keep samples within the budget, but never fewer than two — a
        # trajectory starting at/after the budget would otherwise produce
        # empty tables (randint(0, 0) in the goal bias) or a 1-row
        # np.gradient crash
        n_keep = max(int(np.sum(ts <= float(t_budget) + 1e-9)),
                     min(2, ts.shape[0]))
        pts = _host(traj.points)[:n_keep]
        if not with_vel:
            return t(ts[:n_keep]), t(pts)
        if traj.vels is not None:
            qds = _host(traj.vels)[:n_keep]
        elif n_keep >= 2:
            qds = np.gradient(pts, ts[:n_keep], axis=0)
        else:
            qds = np.zeros_like(pts)
        return t(ts[:n_keep]), t(pts), t(qds)
    ts = np.linspace(0.0, float(t_budget), n_samples)
    if not with_vel:
        return t(ts), t(np.stack([_host(traj(float(x))) for x in ts]))
    qs, qds = zip(*(traj(float(x)) for x in ts))
    return (t(ts), t(np.stack([_host(x) for x in qs])),
            t(np.stack([_host(x) for x in qds])))


def _goal_biased(draws, batch, frac, tables, samples, t_samp):
    """Replace a ``frac`` share of the (samples, times) by target rows: one
    uniform coin per sample, then one target index per sample, drawn
    independently."""
    tgrid = tables[0]
    bias = draws.uniform((batch,), t_samp) < frac
    ti = draws.randint(0, tgrid.shape[0], (batch,), tgrid.device)
    out = [torch.where(bias[:, None], tab[ti], s)
           for tab, s in zip(tables[1:], samples)]
    return out, torch.where(bias, tgrid[ti], t_samp)


def _path_rows(parent, goal_idx, *columns):
    """Rows [columns...] of the vertices root → goal_idx."""
    idxs = [goal_idx]
    while idxs[-1] != 0:
        idxs.append(int(parent[idxs[-1]]))
    idxs.reverse()
    return np.hstack([c[idxs].reshape(len(idxs), -1) for c in columns])


def intercept_plan(workspace, query: InterceptQuery, max_iters: int = 200,
                   batch: int = 16, dt_max: float = 0.5,
                   seed=0) -> PlanResult:
    """Returns a PlanResult whose path rows are [t, q...] (time-stamped
    waypoints); cost is the interception time.

    If ``workspace`` is temporal (has ``edge_free_txq_batch``, e.g.
    TemporalChainWorkspace), edges are collision-checked against the moving
    obstacles POSED AT EACH CHECKED TIME — the reference's dynamic planning
    environment (manip_free_dynamic_workspace.hpp:60,111); otherwise the
    static check is used.
    """
    space = workspace.space
    device, dtype = space_like(space)
    temporal = hasattr(workspace, "edge_free_txq_batch")
    start = torch.as_tensor(np.asarray(_host(query.start), np.float64),
                            dtype=dtype, device=device)
    n = start.shape[-1]
    t0 = time.perf_counter()
    draws = as_draws(seed, device)

    cap = max_iters * batch + 1

    target_t, target_pts = _tabulate_target(
        query.target_traj, query.t_budget,
        getattr(query, "target_samples", 64), device=device, dtype=dtype)

    def expand(Vv, Tv, c):
        q_samp = draws.sample(space, (batch,))
        t_samp = draws.uniform((batch,), Tv) * query.t_budget
        # 20% goal bias: sample a target-trajectory point and its time
        (q_samp,), t_samp = _goal_biased(draws, batch, 0.2,
                                         (target_t, target_pts), (q_samp,),
                                         t_samp)
        # nearest by temporal metric among vertices with T < t_samp
        mask = torch.arange(cap, device=device) < c
        dq = space.distance(q_samp[:, None, :], Vv[None, :, :])  # (batch, cap)
        dtm = t_samp[:, None] - Tv[None, :]
        feas = mask & (dtm > 1e-6) & (dq <= query.v_max * dtm)
        # among feasible predecessors prefer min arrival slack; else min dq
        score = torch.where(feas, dq + dtm, torch.inf)
        fallback = torch.where(mask & (dtm > 1e-6), dq, torch.inf)
        ni = torch.where(feas.any(-1), torch.argmin(score, dim=-1),
                         torch.argmin(fallback, dim=-1))
        src_q, src_t = Vv[ni], Tv[ni]
        dt = torch.clamp_min(torch.clamp_max(t_samp - src_t, dt_max), 1e-3)
        # steer: bounded joint motion toward the sample
        dq = q_samp - src_q
        dqn = torch.linalg.vector_norm(dq, dim=-1, keepdim=True)
        reach = query.v_max * dt[:, None]
        new_q = space.clamp(src_q + dq * torch.clamp_max(reach / (dqn + 1e-12),
                                                         1.0))
        new_t = src_t + dt
        if temporal:
            free = workspace.edge_free_txq_batch(src_t, src_q, new_t, new_q)
        else:
            free = workspace.edge_free_batch(src_q, new_q)
        ok = free & (new_t <= query.t_budget)
        # goal: close to the target at arrival time (nearest tabulated point)
        tgt = target_pts[torch.clamp(torch.searchsorted(target_t, new_t),
                                     0, target_t.shape[0] - 1)]
        hit = space.distance(new_q, tgt) < query.goal_tol
        return new_q, new_t, ni, ok, hit

    # device-resident tree with compacted batch insertion (rrt.py pattern)
    def wave(Vv, Tv, par, c, gi):
        new_q, new_t, ni, ok, hit = expand(Vv, Tv, c)
        slots, write = _compact_slots(ok, c, cap)
        Vv = _insert(Vv, slots, write, new_q)
        Tv = _insert(Tv, slots, write, new_t)
        par = _insert(par, slots, write, ni)
        c = torch.clamp_max(c + write.sum(), cap - 1)
        gi = torch.where(gi >= 0, gi, _first(write & hit, slots))
        return Vv, Tv, par, c, gi

    Vv = start.new_zeros((cap, n))
    Vv[0] = start
    Tv = start.new_zeros(cap)
    par = torch.full((cap,), -1, dtype=torch.int64, device=device)
    c = torch.ones((), dtype=torch.int64, device=device)
    gi = torch.full((), -1, dtype=torch.int64, device=device)
    it = 0
    for it in range(max_iters):
        Vv, Tv, par, c, gi = wave(Vv, Tv, par, c, gi)
        if int(gi) >= 0:
            break

    goal_idx = int(gi)
    cnt = int(c)
    if goal_idx < 0:
        return PlanResult(success=False, path=None, cost=float("inf"),
                          n_vertices=cnt, n_iterations=max_iters,
                          wall_time_s=time.perf_counter() - t0)
    T, V, parent = (x.cpu().numpy() for x in (Tv, Vv, par))
    path = _path_rows(parent, goal_idx, T, V)
    return PlanResult(success=True, path=path, cost=float(T[goal_idx]),
                      n_vertices=cnt, n_iterations=it + 1,
                      wall_time_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 1st-order (kinodynamic rendezvous) interception
# ---------------------------------------------------------------------------


class RendezvousQuery(NamedTuple):
    """Intercept query in time × 1st-order joint space: the goal is to MATCH
    the target's position AND velocity (a grapple/rendezvous, the capability
    the reference's dynamic workspaces + reachability spaces compose for,
    manip_free_dynamic_workspace.hpp:60 + reachability_space.hpp:180)."""

    start_q: object             # (n,)
    start_qd: object            # (n,)
    target_traj: Callable       # t → (q (n,), qd (n,)) target state
    t_budget: float
    goal_tol: float = 0.15      # SVP reach-time ball around the target state


def intercept_plan_1st_order(workspace, space1, query: RendezvousQuery,
                             max_iters: int = 200, batch: int = 16,
                             dt_max: float = 1.0, n_checks: int = 8,
                             seed=0) -> PlanResult:
    """Time-augmented RRT over the 1st-order tangent bundle ``space1``
    (spaces.Ndof1stOrderSpace): vertices are (t, q, q̇); edges ride min-time
    SVP profiles (velocity-continuous, |q̇| ≤ speed by construction); the
    predecessor-feasibility gate and the goal test both use the SVP
    REACH-TIME metric — i.e. the planner plans in time × 1st-order joint
    space with reachability pruning (the VERDICT/ref composition:
    intercept_query.hpp:75 over a 1st-order rate-limited topology).

    Path rows are [t, q..., qd...]; cost is the rendezvous time.
    """
    from reak_tpu_torch.interp import pulses as pl_

    device, dtype = space_like(space1)
    as_t = lambda x: torch.as_tensor(np.asarray(_host(x), np.float64),
                                     dtype=dtype, device=device)
    start_q, start_qd = as_t(query.start_q), as_t(query.start_qd)
    n = start_q.shape[-1]
    temporal = hasattr(workspace, "is_free_txq_batch")
    speed = space1.speed
    a_ramp = space1.a_ramp
    t0 = time.perf_counter()
    draws = as_draws(seed, device)

    cap = max_iters * batch + 1

    tgrid, tq, tqd = _tabulate_target(
        query.target_traj, query.t_budget,
        getattr(query, "target_samples", 64), with_vel=True, device=device,
        dtype=dtype)

    def reach(q1, qd1, q2, qd2):
        Tj, _ = pl_.svp_min_time(q1, q2, qd1, qd2, speed, a_ramp)
        return torch.amax(Tj, dim=-1)

    def expand(Qv, QDv, Tv, c):
        samp = draws.sample(space1, (batch,))
        t_samp = draws.uniform((batch,), Tv) * query.t_budget
        # 25% goal bias toward tabulated target states
        (q_s, qd_s), t_s = _goal_biased(draws, batch, 0.25, (tgrid, tq, tqd),
                                        (samp.q, samp.qd), t_samp)

        mask = torch.arange(cap, device=device) < c
        rt = reach(Qv[None], QDv[None], q_s[:, None], qd_s[:, None])
        dtm = t_s[:, None] - Tv[None, :]
        feas = mask & (dtm > 1e-6) & (rt <= dtm)
        score = torch.where(feas, rt + 0.1 * dtm, torch.inf)
        fallback = torch.where(mask & (dtm > 1e-6), rt, torch.inf)
        ni = torch.where(feas.any(-1), torch.argmin(score, dim=-1),
                         torch.argmin(fallback, dim=-1))
        src_q, src_qd, src_t = Qv[ni], QDv[ni], Tv[ni]
        rt = reach(src_q, src_qd, q_s, qd_s)
        # steer along the SVP profile that ARRIVES AT THE SAMPLE'S TIME:
        # stretch the profile to Δt when Δt ≥ min time, else ride the
        # min-time profile as far as the edge cap allows
        dt_s = torch.clamp_min(t_s - src_t, 1e-3)
        Tprof = torch.maximum(dt_s, rt)[:, None]
        tau = torch.clamp_min(torch.clamp_max(dt_s, dt_max), 1e-3)
        vp = pl_.svp_peak_velocity(src_q, q_s, src_qd, qd_s, speed, Tprof,
                                   a_ramp)
        new_q, new_qd, _ = pl_.svp_eval(src_q, q_s, src_qd, qd_s, vp, speed,
                                        Tprof, tau[:, None], a_ramp)
        new_t = src_t + tau
        # collision: sample the swept position profile; with a temporal
        # workspace each sample is checked against obstacles posed at its
        # absolute time (ref: manip_dynamic_env, proxy_traj_applicator)
        ts_chk = fractions(n_checks, tau)[:, None] * tau[None, :]
        pos_chk, _, _ = pl_.svp_eval(
            src_q[None], q_s[None], src_qd[None], qd_s[None],
            vp[None], speed, Tprof[None], ts_chk[..., None], a_ramp)
        if temporal:
            abs_t = src_t[None, :] + ts_chk  # (n_checks, batch)
            free = workspace.is_free_txq_batch(
                abs_t.reshape(-1), pos_chk.reshape(-1, n))
        else:
            free = workspace.is_free_batch(pos_chk.reshape(-1, n))
        ok = torch.all(free.reshape(n_checks, batch), dim=0)
        ok = ok & (new_t <= query.t_budget)
        # goal: within a reach-time ball of the target state at arrival time
        gidx = torch.clamp(torch.searchsorted(tgrid, new_t), 0,
                           tgrid.shape[0] - 1)
        rt_goal = reach(new_q, new_qd, tq[gidx], tqd[gidx])
        hit = ok & (rt_goal < query.goal_tol)
        return new_q, new_qd, new_t, ni, ok, hit

    # device-resident tree, compacted batch insertion (rrt.py pattern)
    def wave(Qv, QDv, Tv, par, c, gi):
        new_q, new_qd, new_t, ni, ok, hit = expand(Qv, QDv, Tv, c)
        slots, write = _compact_slots(ok, c, cap)
        Qv = _insert(Qv, slots, write, new_q)
        QDv = _insert(QDv, slots, write, new_qd)
        Tv = _insert(Tv, slots, write, new_t)
        par = _insert(par, slots, write, ni)
        c = torch.clamp_max(c + write.sum(), cap - 1)
        gi = torch.where(gi >= 0, gi, _first(write & hit, slots))
        return Qv, QDv, Tv, par, c, gi

    Qv = start_q.new_zeros((cap, n))
    Qv[0] = start_q
    QDv = start_q.new_zeros((cap, n))
    QDv[0] = start_qd
    Tv = start_q.new_zeros(cap)
    par = torch.full((cap,), -1, dtype=torch.int64, device=device)
    c = torch.ones((), dtype=torch.int64, device=device)
    gi = torch.full((), -1, dtype=torch.int64, device=device)
    it = 0
    for it in range(max_iters):
        Qv, QDv, Tv, par, c, gi = wave(Qv, QDv, Tv, par, c, gi)
        if int(gi) >= 0:
            break

    wall = time.perf_counter() - t0
    goal_idx, cnt = int(gi), int(c)
    if goal_idx < 0:
        return PlanResult(False, None, float("inf"), cnt, max_iters, wall)
    T, Q, QD, parent = (x.cpu().numpy() for x in (Tv, Qv, QDv, par))
    path = _path_rows(parent, goal_idx, T, Q, QD)
    return PlanResult(True, path, float(T[goal_idx]), cnt, it + 1, wall)
