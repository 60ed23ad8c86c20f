#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``reak_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``reak_tpu_torch/csrc`` (one ``nvcc``
per library, as many at once as the host has cores but one; beside the
build runs the card's work of what launches no kernel: the phases
``optimizers_geometry``, ``interp_spaces_io``, ``planning`` and
``spaces_meaqr_examples``, the stiff suite and the filters), holds each
kernel against its plain torch version on the card, and drives the port's
main paths through the kernels:

- the flagship batched KTE-MPC solve ``ctrl.mpc.make_kte_mpc`` (6-DoF
  CRS-A465 arm, n=12, m=6, H=50, 8 Mehrotra iterations, f32, B=8192), one
  SQP pass and two passes with the line search;
- the free-base satellite scenario MPC
  ``ctrl.manifold_lanes.make_sat_scenario_mpc_lanes`` (H=20, B=8192), from
  initial states that ``ctrl.mpc_manifold.sample_belief_states`` draws from
  the belief N(rest state, 0.05 I₁₂) in its tangent space (a
  ``torch.Generator`` seeded 0 on the card), on K2 and on the per-pass
  kernels;
- the same satellite on the generic route (phase ``belief_scenario``):
  ``ctrl.mpc_manifold.make_scenario_mpc`` on ``ss_systems.satellite3D_imdt``
  (jacfwd linearization, the batch-first Riccati PDIP on K3a/K3b) beside
  the lanes route, both timed at B=8192 in f32; the two routes at f64 on
  256 scenarios, the generic one against the CPU child's plain f64 solve;
  and the config-4 composition: 12 IEKF steps (``ctrl.invariant``) on the
  card, then ``belief_scenario_mpc`` on that posterior at B=8192;
- the generic dense MPC and the closed loop (phase
  ``dense_and_closed_loop``, f64): ``ctrl.mpc.solve`` with
  ``method="riccati"`` (K3a/K3b at B=1) and ``"condensed"`` against the C++
  oracle, ``receding_horizon`` on a double integrator, the 2-link
  closed loop of ``make_kte_mpc`` (K1 + K2) against the
  ``ctrl.systems.kte_discrete`` plant, and ``ctrl.mpc_manifold.
  make_kte_scenario_mpc`` on its fixed branch (the flagship arm, K1 + K2)
  and its free one (the floating arm, K2 + K3), each bit for bit the call
  it routes to;
- estimation and LQG (phase ``estimation``): the Monte-Carlo filters of
  ``examples/estimate_satellite3d.py`` (``--mc-runs``, one ``torch.func.
  vmap`` of ``run_filter``) for iekf, ekf and ukf at f64 on 256 runs and
  iekf at f32 on 8192, the first runs held to the CPU child's; the
  prediction example at 8192 scenarios; the satellite MPC example (15
  IEKF steps, ``sample_belief_states``, the lanes route on K2) at 8192
  scenarios; ``math.are.dlqr`` on the (A_d, B_d) that K1 returns at phase
  ``k1_vs_plain``'s inputs, and every solver of ``math.are`` and
  ``ctrl.lqg`` on 8192 seeded systems of 12 states and 6 inputs, each
  within its test's residual bar;
- the arms, IK and integrators (phase ``arms_ik_integrators``): the 7-DoF
  SSRMS arm through ``make_kte_mpc`` (n=14, m=7, H=50, f32, B=8192; K1 at
  (7, 7) and K2), the new chain builders on K1/K5 against their plain
  versions, the closed-form IK and CLIK at 8192 poses, the arm as an RK4
  plant, the stiff test suite through the adaptive, multistep and
  Rosenbrock integrators at their tests' bars, the bitonic sorts, HOSVD and
  CP-ALS, and the task-space forces, each against its CPU result;
- the optimizers, the geometry and the profiler (phase
  ``optimizers_geometry``, f64 unless said): every optimizer family of
  ``reak_tpu_torch.opt`` (root finders, line searches, least squares with
  inverse kinematics of the 6-DoF arm by Levenberg–Marquardt, BFGS, SR1,
  nonlinear CG, Newton, Nelder–Mead, the constrained solvers, the LP,
  finite differences) on 8192 seeded problems under one
  ``torch.func.vmap`` each, at its reference test's bar and against the
  CPU child; Newton once more with one non-finite problem; the planner's
  collision scenes (``kte.fk`` → ``geom.pose_shapes`` →
  ``geom.proxy_query``: the arm's capsules against a sphere and the floor,
  then also a box and a flat-capped cylinder, and a planar 2-link arm)
  at 8192 configurations in f64 and f32; an ``io.profiling``
  section timer around each part; and (phase ``flagship_trace``) a
  ``torch.profiler`` trace of one warm flagship solve, whose kernel events
  must name K1 50 times and K2 once, with the device-busy share of its
  window;
- the interpolators, the joint-space bundles, the archives and the native
  recorder (phase ``interp_spaces_io``, f64 unless said), on the 6-DoF CRS
  arm's joint space (±2.8 rad, 1.5 rad/s, 3 rad/s²): the SVP and SAP
  bundles of ``spaces/tangent`` (reach times and interpolation at 64
  fractions of 8192 state pairs; reach times also in f32), the
  rate-limited space, the JAX tests' bars per pair on dense sweeps, a
  quintic ``interp`` trajectory through 1,024 waypoints at 8192 × 64 times
  and through ``kte.fk`` of the arm, ``planning/queries.path_cost``, the
  UAV corridor scenario's clearance at 8192 times, one bundle through the
  three archive formats of ``io/serialization`` (bit for bit back),
  ``examples/estimate_satellite3d.run_from_options`` and ``--options``
  against the in-code run (bit for bit), and ``io/native_recorder``
  against the Python recorder on 524,288 rows;
- the planners (phase ``planning``, f64) on the CRS scene of
  ``examples/run_crs_planner.py`` (the arm's capsules against the sphere
  and the floor, margin 0.01, 12 checks an edge): ``rrt_plan_batch`` (256
  runs, capacity 4096, waves of 64) and ``rrt_star_plan_batch`` (8 runs,
  capacity 2048, 60 waves) through ``monte_carlo_engine_batched``, each
  after an untimed wave; the ported example's eight planners at its CLI
  defaults, every one but SBA* finding a path, every path found held to
  its query's ends, to a 4× denser edge check and to ``path_cost``; both
  batched planners and the example's eight on the card against the CPU
  child from the same host draws (trees index for index; success, counts
  and iterations equal, costs and paths ≤1e-12); and the
  ``vlist_engine`` dump of the example's rewired RRT* tree, whose costs
  must be the edge sums (F1 fixed in the port);
- the last spaces, the MEAQR planners and the last two examples (phase
  ``spaces_meaqr_examples``, f64): the SE(2) and SE(3) spaces of every
  order and ``FlatSE2Space`` on 8192 pairs (distance, difference, clamp,
  interpolation at 64 fractions; F21's headings ±π and ±3π wrap to +π),
  the Gaussian belief space at n = 12 on 8192 beliefs (round trip,
  interpolated covariances positive definite, a covariance that is not NaN
  in its own row), the kinematics topomaps of the CRS arm at 8192
  configurations (direct map, lift, the closed-form inverse's round trip,
  the CLIK fallback), an RRT on ``FlatSE2Space`` through a wall's gap and
  one over beliefs, ``examples/x8_planner.py``'s main with RRT* and SBA*
  at its defaults on the MEAQR topology of the quadrotor's hover LTI (and
  each planner again from host draws, held to a third CPU child,
  ``--spaces-reference``, with the first 256 rows of every batch), and
  ``examples/crs_dynexec.py``'s main at its defaults (40 rows over a
  loopback TCP stream, the IEKF, the prediction, the IK table, the
  interception among the moving target body, the plan recorded);
- the flagship one-pass solve through ``parallel.mesh`` (phase
  ``mesh_flagship``): a one-process NCCL group, ``sharded_map`` with
  ``pmean_scalar`` of mean(us²), bit for bit the unsharded solve, exactly
  50 K1 and 1 K2 launches (one rank shows the code path and the
  collective, not scaling);
- the floating-arm scenario MPC (free base + 6-DoF arm, tangent n=24,
  m=12, H=16, B=2048) through ``kte.lanes.make_kte_manifold_lanes``;
- the flagship chain at a long horizon (H=256, B=8192, f32) on the rollout
  core kernel and the per-pass PDIP kernels:
  ``kte.lanes.make_rollout_ltv_fused`` then
  ``ctrl.riccati_soa.solve_box_mpc_riccati_soa_fused(use_kernels="passes")``,
  and the satellite solve on the per-pass kernels.

It also holds the tile kernels (the whole-solve PDIP and the three per-pass
kernels) to their plain versions at f64 on batches that are no multiple of
the tile (B=1001, 1000, 100, 77, 1) and at widths off the exact instances
((6, 3) and (13, 7), which run the padded ones), and the rollout step and
its core (K1, K5; one library per chain width and type) at f64 on the
flagship arm at B=1, 77, 1001, on ``planar_2link`` and on a mixed chain of
8 links (FIXED and PRISMATIC joints, offset quaternions, springs, dampers,
full inertia tensors; phase ``kte_chains``).  Phase ``wide_widths`` takes
the widest instances at f64: K1/K5 on a 16-segment flexible beam (16
joints), K2 and K4a-c at (32, 16) and at a padded width under it (and
at (32, 16) in f32 against twice the plain f32 error), K3a/K3b
at n = 17 and 32 (and timed at 32, 48 and 64), and one ``make_kte_mpc``
solve of the beam against the plain f64 solve of the CPU child.  Phase
``past_the_caps`` takes the runtime-width instances: K1/K5 on 17- and
24-segment beams, K2 and K4a-c at (33, 17), (48, 24) and on the tile's
device-memory branch ((62, 31) in f64, the mirror's first width in f32;
every case but the f64 device branch also in f32), each timed beside its bound, and one ``make_kte_mpc`` solve of the
24-segment beam against the plain f64 solve on the card.  Phase
``batch_first`` drives the second branch of ``make_kte_mpc``
(``qp_layout="vmap"``, with ``rollout="lanes"``, and ``rollout="register"``;
the batch-first PDIP's Schur solves on K3a/K3b, exact launch counts) at
B=8192 against the K1 + K2 route, and the batch-first route against the C++
oracle.  Phase
``k3_vs_plain`` holds K3a/K3b at the main paths' shapes and at n = 17, 32,
33, 48, 64, 70, 241 and 341 in both types (the main paths' shapes include
the dense MPC's n = 1 and 2 at B = 1; bit for bit their plain version;
past n = 240 in f64 and 340 in f32 on the device-memory work area).  The RK4 step of the line search and the
floating arm's step and LTV are replayed from CUDA graphs
(``ops/graphs.py``); phase ``graphs_vs_eager`` holds a replayed
line-search rollout and a free-base stage to the eager functions at f64,
and the two-pass flagship and the floating arm are timed on their first
call (which captures) and on a warm one.  The build line reports ptxas'
registers and stack frame of every kernel instance and the blocks an SM
holds of each K1/K5 instance.

It checks the port at f64 against the independent C++ oracle
``native/mpc_oracle.cpp`` (the flagship chain and an LTV instance) and
against its own plain f64 solves, and times
the solves and the kernels with CUDA events.  The plain f64 CPU references
run in a child process (``--cpu-reference``) beside the card's phases;
the child also solves the satellite's generic route on states it draws
itself, and the card solves the same states, and runs the Monte-Carlo
filters' first runs and ``dlqr`` on the plain step's linearization.  A
second child (``--op-counts``) counts the plain versions' operations that
the bounds of the wide and long calls need (``op_counts``), and a third
(``--spaces-reference``) makes phase ``spaces_meaqr_examples``'
references.
Line ``k2_phases`` times the whole-solve PDIP (its TMA pipeline) at the
flagship's shape at 0, 1, 2 and 8 iterations: the fit's slope is one
iteration, its intercept the two rollouts (``python3 -m
reak_tpu_torch.ops.k2_phases`` splits an iteration by phase).  Line
``k1_split`` times K1 and K5 at (6, 6) and (7, 7) f32, B = 8192 and one
block an SM, a wrapper's call by CUDA events and the kernel alone by the
profiler, beside ptxas' registers, stack and spills (``python3 -m
reak_tpu_torch.ops.k1_phases`` splits a launch by phase); the kernels
line's K1 and K5 ``ms`` is the wrapper's call by CUDA events, as for
every kernel, and their ``device_ms`` the kernel alone by the profiler,
as for K3.
Each phase prints one JSON line; the card's name and power limit follow as
``nvidia-smi`` prints them, then one JSON line of the eight kernels (each
with its launches on the main paths, its time per launch beside its plain
version's, the least time the card could take for the same work, and the
time of one PyTorch call computing the same function where there is one),
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no last line; with no CUDA device it exits 1 at
once.  Imports no JAX.
"""
import functools
import json
import os
import re
import struct
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 0.01
B, H, N, M, ITERS = 8192, 50, 12, 6, 8
FLAGSHIP_W = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
# the free-base cells of bench.py:223-313
SAT_B, SAT_H, SAT_DT = 8192, 20, 0.1
FA_B, FA_H, FA_DT = 2048, 16, 0.02
N_REF = 256  # scenarios of the plain f64 CPU references
H_LONG = 256  # the long-horizon path: past the TPU kernel's VMEM bound
# the build: one nvcc a core but one, each this far below the smoke's
# priority, so that the card work run beside it keeps a core; the libraries
# that take longest to compile first, the 16-joint K1/K5 the longest (the
# build line's library_seconds has when each one ended)
NVCC_NICENESS = 19
BUILD_LONGEST_FIRST = (
    "kte_step@16x16_f64", "pdip_whole@32x16_f32", "pdip_whole@32x16_f64",
    "riccati_bwd@32x16_f32", "riccati_bwd@32x16_f64", "pdip_whole@24x12_f64",
    "pdip_whole@24x12_f32", "kte_step@8x6_f64", "pdip_whole@16x8_f64",
    "kte_step@7x7_f32", "pdip_whole@16x8_f32", "kte_step@7x7_f64",
    "riccati_bwd@24x12_f32", "riccati_bwd@24x12_f64", "kte_step@6x6_f32",
    "kte_step@6x6_f64")
# K2's iterations in phase past_the_caps' f32 device-memory case
PTC_F32_DEVICE_ITERS = 2
# the iteration counts of the k2_phases line: K2 at the flagship's shape
# at each, the fit's slope one iteration and its intercept the rollouts
K2_PHASE_ITERS = (0, 1, 2, 8)
# the 16-segment flexible beam (kte/models.flexible_beam): n=32, m=16; its
# fastest mode is overdamped at |λ| ≈ 5.1e5 /s, and the order-4 series is
# stable for |λ| dt ≤ 2.78
BEAM_SEGMENTS, BEAM_B, BEAM_H, BEAM_DT = 16, 64, 8, 2e-6
# scenarios of the second branch's f64 checks (phase batch_first)
BF_B64 = 8192
# phase belief_scenario: the f64 scenarios of the two routes' comparison
# (the settings of tests/test_manifold_lanes.py:101-129), and those of the
# CPU child's plain f64 solve of the generic route
SAT_F64_B, GEN_REF_B = 256, 64
# phase estimation: the Monte-Carlo filters of README.md:104 at the
# example's defaults (150 steps), EST_RUNS runs at f64 and EST_RUNS_F32 at
# f32, the first EST_REF_RUNS runs held over their first EST_REF_STEPS steps
# to the CPU child's; prediction and planning from the estimate at 8192
# scenarios; the batched ARE and LQG solvers on ARE_B systems of
# ARE_N states and ARE_M inputs, and dlqr on K1's linearization, DLQR_REF
# gains held to the CPU child's
EST_RUNS, EST_RUNS_F32, EST_REF_RUNS, EST_REF_STEPS = 256, 8192, 16, 30
EST_SCENARIOS, ARE_B, ARE_N, ARE_M, DLQR_REF = 8192, 8192, 12, 6, 64
# The continuous Riccati equations of the regulator (Q = 2I, R = 0.5I on
# unstable A) have solutions up to |X| ≈ 290 at (12, 6), and the round-off
# of their quadratic term grows as |X|²: their absolute residuals reach
# 5.3e-8 on an H100, above the tests' 1e-8 set at (4, 2), while the
# residual over the size of its terms stays at 2.8e-11 (f64, seed 13).
# These rows are held to ARE_REL_BAR on the relative residual, every
# other row to its test's absolute bar (their worst readings: 4.1e-13 of
# 1e-8, 3.1e-12 of 1e-10).
ARE_REL_ROWS = ("solve_care", "clqr", "clqg", "solve_ihct_lqg")
# the filters' final position, attitude (rad) and rate errors, each run's
# (tests/test_ss_systems.py:95-96); the f32 IEKF's final state against its
# f64 run's, a hundredth of the f64 runs' errors against the truth (≤1.6e-3
# on every block over 256 runs on an H100, where the f32 runs' final states
# are off by ≤1.6e-7)
EST_BAR, EST_F32_BAR = 0.05, 1e-5
ARE_REL_BAR = 1e-10
# NVIDIA's published peaks of one H100 SXM at 700 W: HBM3 bytes/s, and
# float32 and float64 operations/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S, PEAK_F64_S = 3.35e12, 67e12, 34e12


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase also says how far into the run it ended."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, ref):
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def abs_err(got, ref):
    return float((got.double() - ref.double()).abs().max())


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of fn() over `reps` calls, CUDA events after a
    warm-up (for the plain versions this includes the host's launch gaps,
    which is their real cost)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, name, tries=3):
    """Device time per launch of the kernels whose name holds ``name``, from
    torch.profiler's CUDA activity over ``reps`` calls of fn() after a
    warm-up; a profile that records none of them is taken again, up to
    ``tries`` profiles; None where none does."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in events)
        total_us = sum(getattr(e, "device_time_total", None)
                       or getattr(e, "cuda_time_total", 0.0)
                       for e in events)
        if count and total_us:
            return total_us / count / 1e3
    return None


def wall_ms(fn, reps):
    """Host time per call of fn() over ``reps`` back-to-back calls ended by
    one synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def timed(fn):
    """fn() once, with its time in ms by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


class _OpCount(TorchDispatchMode):
    """Counts the arithmetic of the aten calls beneath it: one operation per
    output element of an elementwise call, one per input element of a
    reduction, 2·m·n·k for a matrix product; views, copies and fills count
    nothing."""
    ELEMENTWISE = {"add", "sub", "rsub", "mul", "div", "neg", "rsqrt", "sqrt",
                   "sin", "cos", "exp", "pow", "reciprocal", "maximum",
                   "minimum", "clamp", "clamp_min", "clamp_max", "where",
                   "lt", "le", "gt", "ge", "eq", "ne", "addcmul"}
    REDUCTIONS = {"sum", "amin", "amax", "min", "max", "mean"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in self.ELEMENTWISE:
            self.ops += out.numel()
        elif name in self.REDUCTIONS:
            self.ops += args[0].numel()
        elif name in ("mm", "bmm"):
            self.ops += 2 * args[0].numel() * args[1].shape[-1]
        return out


class _CholeskyCalls:
    """Within it, the input shape of every ``torch.linalg.cholesky_ex``
    call (the port's factorizations all go through it)."""

    def __enter__(self):
        self.shapes, self._real = [], torch.linalg.cholesky_ex

        def counting(A, *args, **kwargs):
            self.shapes.append(tuple(A.shape))
            return self._real(A, *args, **kwargs)

        torch.linalg.cholesky_ex = counting
        return self

    def __exit__(self, *exc):
        torch.linalg.cholesky_ex = self._real


def ops_per_scenario(fn, make_args):
    """Arithmetic operations per scenario of ``fn`` (a plain version), from
    its aten calls on CPU tensors at 2 and 4 scenarios:
    (ops(4) − ops(2)) / 2, so work that does not scale with the batch drops
    out.  ``make_args(batch)`` gives the arguments."""
    counts = []
    for batch in (2, 4):
        args = make_args(batch)
        with _OpCount() as c:
            fn(*args)
        counts.append(c.ops)
    return (counts[1] - counts[0]) / 2


def k2_ops_per_scenario(make_args, iters=ITERS):
    """``ops_per_scenario`` of the plain whole solve (K2's plain version,
    ``ctrl/riccati_soa._fused_scan``) at ``iters`` iterations.  Every
    iteration makes the same aten calls on the same shapes, so the count
    follows from a count of one iteration and of two."""
    from reak_tpu_torch.ctrl import riccati_soa

    o1, o2 = (ops_per_scenario(
        lambda *a, it=it: riccati_soa._fused_scan(*a, iters=it), make_args)
        for it in (1, 2))
    return o1 + (iters - 1) * (o2 - o1)


def cpu_args(args, batch, nb):
    """``args`` for a count on the CPU: the first nb scenarios of each
    scenario-last tensor (last axis ``batch``), the others whole; f64."""
    return tuple((t[..., :nb] if t.dim() > 1 and t.shape[-1] == batch
                  else t).double().cpu() for t in args)


# the plain versions' operation counts that the bounds of the wide and
# long calls need, counted by a CPU process of their own (``--op-counts``)
# beside the card's phases: a count depends on the shapes only, so it runs
# on inputs of the calls' shapes, four scenarios each
OP_COUNT_TILES = ((33, 17), (48, 24), (62, 31))
OP_COUNT_BEAMS = (17, 24)


def count_problem(n, m, horizon, nb=4, seed=0):
    """CPU f64 inputs of K2's and K4a-c's shapes at (n, m) and ``horizon``
    with ``nb`` scenarios (the layout of ``smoke``'s ``synthetic``)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    return {"A": t(0.1 * rng.standard_normal((horizon, n, n, nb))
                   + np.eye(n)[None, :, :, None]),
            "Bm": t(0.2 * rng.standard_normal((horizon, n, m, nb))),
            "c": t(0.05 * rng.standard_normal((horizon, n, nb))),
            "Q": t(np.eye(n) + 0.01), "QN": t(5.0 * np.eye(n)),
            "R": t(0.1 * np.eye(m) + 0.01),
            "x0": t(rng.standard_normal((n, nb))),
            "lb": t(np.full(m, -1.5)), "ub": t(np.full(m, 1.5)),
            "q": t(rng.standard_normal((horizon, n, nb))),
            "u_eff": t(rng.standard_normal((horizon, m, nb))),
            "D": t(rng.uniform(0.5, 2.0, (horizon, m, nb))),
            "rhs": t(rng.standard_normal((horizon, m, nb))),
            "k": t(rng.standard_normal((horizon, m, nb))),
            "dx0": t(rng.standard_normal((n, nb)))}


def op_counts(seed=0):
    """{key: operations per scenario} of the plain versions: K2 (the plain
    whole solve at ITERS iterations) as ``k2@<n>x<m>,H<h>`` and K4a-c as
    ``<entry>@<n>x<m>,H<h>``, at each width of OP_COUNT_TILES (H = 4),
    K2 at (32, 16), H = 12 and at the flagship's (12, 6), H = H and
    H_LONG; and K1 and K5 (their plain step and core) on the beams of
    OP_COUNT_BEAMS segments as ``k1@beam<segments>`` and
    ``k5@beam<segments>``."""
    from reak_tpu_torch.ctrl import riccati_soa
    from reak_tpu_torch.kte import models
    from reak_tpu_torch.ops import kte_core, kte_step

    plain_pass = {"fused_backward": riccati_soa.fused_backward_plain,
                  "vector_backward": riccati_soa.vector_backward_plain,
                  "forward": riccati_soa.forward_plain}
    k2_keys = ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb", "ub")
    out = {}
    for (n, m), h, passes in ([(w, 4, True) for w in OP_COUNT_TILES]
                              + [((32, 16), 12, False), ((N, M), H, False),
                                 ((N, M), H_LONG, False)]):
        p = count_problem(n, m, h, seed=seed)
        first = lambda args: (lambda nb: cpu_args(args, 4, nb))
        out[f"k2@{n}x{m},H{h}"] = k2_ops_per_scenario(
            first([p[k] for k in k2_keys]))
        if passes:
            pa = [p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN",
                                 "R")]
            K_, G_ = riccati_soa.fused_backward_plain(*pa)[1:3]
            for e, a in (("fused_backward", pa),
                         ("vector_backward", [p["A"], p["Bm"], p["rhs"], K_,
                                              G_]),
                         ("forward", [p["A"], p["Bm"], K_, p["k"],
                                      p["dx0"]])):
                out[f"{e}@{n}x{m},H{h}"] = ops_per_scenario(plain_pass[e],
                                                            first(a))
    rng = np.random.default_rng(seed)
    for segs in OP_COUNT_BEAMS:
        chain = models.flexible_beam(segs)
        xu = (torch.as_tensor(rng.uniform(-0.5, 0.5, (2 * chain.nv, 4))),
              torch.as_tensor(rng.uniform(-5.0, 5.0, (chain.nv, 4))))
        for key, plain in (("k1", kte_step.make_step_plain(chain, BEAM_DT)),
                           ("k5", kte_core.make_core_plain(chain))):
            out[f"{key}@beam{segs}"] = ops_per_scenario(plain, first(xu))
    return out


def op_count_process(path):
    """``--op-counts``: ``op_counts()`` saved to ``path``, one thread."""
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    counts_ = op_counts()
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, seconds=time.perf_counter() - t0,
             **{k: np.float64(v) for k, v in counts_.items()})
    os.replace(tmp, path)
    return 0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved, ops, peak_ops_s=PEAK_F32_S):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over their peak rate (float32
    unless another is given), and which of the two it is."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def chol_rows_plain(G, rhs):
    """``riccati_soa._chol_solve_lanes`` with each step of the factor and of
    the forward substitution taken over all the rows it updates at once:
    every entry gets the same operations in the same order (k ascending,
    the product rounded, then the difference), so the result is the plain
    version's bit for bit (phase ``k3_vs_plain`` checks it at n = 70), at
    O(n²) tensor ops instead of O(n³).  The backward substitution sums in
    the plain version's order, which a sweep over rows would reverse, so it
    stays one op per term.  G (n, n, B), rhs (n, k, B) → (n, k, B)."""
    n = G.shape[0]
    L = torch.zeros_like(G)
    inv_d = []
    for j in range(n):
        t = G[j:, j]
        for k in range(j):
            t = t - L[j:, k] * L[j, k]
        d = torch.rsqrt(t[0])
        inv_d.append(d)
        L[j + 1:, j] = t[1:] * d
    t = rhs
    ys = []
    for i in range(n):
        ys.append(t[0] * inv_d[i][None])
        t = t[1:] - L[i + 1:, i][:, None] * ys[i]
    xs = [None] * n
    for i in reversed(range(n)):
        t = ys[i]
        for k in range(i + 1, n):
            t = t - L[k, i][None] * xs[k]
        xs[i] = t * inv_d[i][None]
    return torch.stack(xs, dim=0)


def k2_design_bytes(horizon, n, m, batch, iters, itemsize):
    """The device-memory traffic of the whole-solve kernel as designed (the
    TMA pipeline of csrc/pdip_whole.cu), which keeps its working set in a
    scratch buffer: per iteration, scenario and stage it streams A and B
    four times (fused reverse, affine forward, corrector reverse, corrector
    forward), writes K once and streams it three times, writes the packed
    factor's lower triangle and streams its m × m box once; of the (H, m)
    iterate arrays the reverse pass streams seven (u, the slacks and duals,
    the step before) and writes seven (the updated five, the gradient,
    k_aff), the affine forward pass streams five and writes one, the μ_aff
    sweep reads five, the corrector reverse pass streams six and writes
    one, and the corrector forward pass streams six and writes one (39 in
    all, 48 before the sweeps were folded into the passes); of the (H, n)
    trajectory arrays the reverse pass streams xs and dx and writes xs and
    the corrector forward pass writes dx (4, 6 before).  The two rollouts
    are not counted.  The bound of the kernels line counts inputs and
    outputs only; this is the floor of the design."""
    values = (4 * (n * n + n * m) + 4 * m * n + m * (m + 1) // 2 + m * m
              + 4 * n + 39 * m)
    return iters * horizon * batch * values * itemsize


def estimation_draws(runs, steps=150):
    """The standard-normal draws (runs, steps, 9) of the Monte-Carlo
    filters' measurement noise (numpy, seed 11); the first runs are the
    same whatever ``runs`` is."""
    return np.random.default_rng(11).standard_normal((runs, steps, 9))


def k1_inputs():
    """The states (2nv, B) and inputs (nv, B) of phase k1_vs_plain."""
    rng = np.random.default_rng(0)
    x_np = bench_states(rng, B).T.copy()
    return x_np, rng.uniform(-5.0, 5.0, (6, B))


def spectral_positive(F, G, H, E, margin, points, discrete):
    """Whether each system's spectral density Φ = E + T + Tᴴ,
    T = H(zI − F)⁻¹G, exceeds ``margin``·I (a Cholesky factor of
    Φ − margin·I exists) at every point of a frequency grid on the unit
    circle (discrete) or the imaginary axis; a positive-real system, whose
    spectral factorization exists, has Φ ≻ 0.  Batched in chunks on the
    systems' device, complex128."""
    n = F.shape[-1]
    if discrete:
        w = torch.linspace(0.0, np.pi, points, dtype=torch.float64)
        z = torch.polar(torch.ones_like(w), w)
    else:
        w = torch.cat([torch.zeros(1, dtype=torch.float64),
                       torch.logspace(-3, 4, points - 1, dtype=torch.float64)])
        z = torch.complex(torch.zeros_like(w), w)
    z = z.to(F.device)[:, None, None]
    eye = torch.eye(n, dtype=torch.complex128, device=F.device)
    shift = (E - margin[:, None, None] * torch.eye(
        E.shape[-1], dtype=E.dtype, device=E.device))
    out = []
    for i in range(0, F.shape[0], 512):
        Fc, Gc, Hc = (a[i:i + 512, None].to(torch.complex128)
                      for a in (F, G, H))
        T = Hc @ torch.linalg.solve(z * eye - Fc, Gc)
        _, info = torch.linalg.cholesky_ex(shift[i:i + 512, None] + T + T.mH)
        out.append((info == 0).all(dim=1))
    return torch.cat(out)


def spectral_systems(rng, batch, n, m, device):
    """The systems of tests/test_are_spectral.py:10-19 (continuous, KYP
    construction) and :49-58 (discrete) at width (n, m), as f64 tensors
    on ``device``.  At n = 12 the constructions do not ensure a positive-
    real system (none of 512 discrete draws is), so each system's D (J)
    is doubled until its spectral density's least eigenvalue on the grid
    exceeds a tenth of E's.  Returns the continuous (A, B, C, D), the
    discrete (F, G, H, J) and the doublings' counts of each."""
    sw = lambda a: np.swapaxes(a, -1, -2)
    Mc = rng.standard_normal((batch, n, n))
    A = -(Mc @ sw(Mc)) - 0.7 * np.eye(n) + 0.3 * rng.standard_normal(
        (batch, n, n))
    Bc = rng.standard_normal((batch, n, m))
    C = sw(Bc) @ (np.eye(n) * 2.0)
    D = np.eye(m) * 1.5 + 0.2 * rng.standard_normal((batch, m, m))
    F = 0.5 * rng.standard_normal((batch, n, n))
    F = F / np.maximum(1.0, 1.3 * np.abs(np.linalg.eigvals(F)).max(-1))[
        :, None, None]
    G = 0.5 * rng.standard_normal((batch, n, m))
    H = sw(G) @ (np.eye(n) * 0.6)
    J = np.broadcast_to(np.eye(m) * 2.0, (batch, m, m)).copy()
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    A, Bc, C, D, F, G, H, J = map(t, (A, Bc, C, D, F, G, H, J))
    doubled = {}
    for name, (S1, S2, S3, S4, disc) in {
            "ctsf": (A, Bc, C, D, False), "dtsf": (F, G, H, J, True)}.items():
        count = torch.zeros(batch, dtype=torch.int64, device=device)
        while True:
            E = S4 + S4.mT
            bad = ~spectral_positive(S1, S2, S3, E,
                                     0.1 * torch.linalg.eigvalsh(E)[:, 0],
                                     181, disc)
            if not bool(bad.any()):
                break
            S4[bad] *= 2.0
            count += bad
        doubled[name] = torch.bincount(count).tolist()
    return (A, Bc, C, D), (F, G, H, J), doubled


def lqg_systems(rng, batch, n, m, device):
    """The systems and weights of tests/test_are_spectral.py:69-77
    (continuous) and :86-97 (discrete) at width (n, m), p = m outputs, as
    f64 tensors on ``device``: (A, B, C, V, W, Q, R) and (F, G, H, V, W,
    Q, R)."""
    p = m
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    eye = lambda k, c: t(np.broadcast_to(np.eye(k) * c, (batch, k, k))
                         .copy())
    cont = (t(rng.standard_normal((batch, n, n))),
            t(rng.standard_normal((batch, n, m))),
            t(rng.standard_normal((batch, p, n))),
            eye(n, 0.3), eye(p, 0.2), eye(n, 2.0), eye(m, 0.5))
    disc = (t(0.9 * rng.standard_normal((batch, n, n)) / np.sqrt(n)),
            t(rng.standard_normal((batch, n, m))),
            t(rng.standard_normal((batch, p, n))),
            eye(n, 0.3), eye(p, 0.2), eye(n, 1.0), eye(m, 0.4))
    return cont, disc


def care_terms(A, B, Q, R, X):
    """The terms of AᵀX + XA − XBR⁻¹BᵀX + Q, each system's."""
    return [A.mT @ X, X @ A, -(X @ B @ torch.linalg.solve(R, B.mT) @ X), Q]


def dare_terms(A, B, Q, R, X):
    """The terms of AᵀXA − X − AᵀXB(R + BᵀXB)⁻¹BᵀXA + Q, each system's."""
    return [A.mT @ X @ A, -X, -(A.mT @ X @ B @ torch.linalg.solve(
        R + B.mT @ X @ B, B.mT @ X @ A)), Q]


def residual(terms):
    """Each system's residual of an equation Σ terms = 0: the entrywise max
    |Σ terms| (as tests/test_are_spectral.py measures it), and the same
    over Σ max |term|, the size of the round-off that a solution at
    working precision leaves."""
    res = sum(terms[1:], terms[0]).abs().amax(dim=(-2, -1))
    return res, res / sum(t.abs().amax(dim=(-2, -1)) for t in terms)


def bench_states(rng, batch):
    """x0 as bench.py draws it: q ~ U(±0.5), q̇ ~ U(±0.2)."""
    return np.concatenate([rng.uniform(-0.5, 0.5, (batch, 6)),
                           rng.uniform(-0.2, 0.2, (batch, 6))], axis=1)


def flagship_problem(mpc, device, dtype, horizon=H, bound=40.0):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return mpc.MPCProblem(Q=t(np.diag(FLAGSHIP_W)), R=t(np.eye(M) * 0.05),
                          QN=t(np.diag(5.0 * FLAGSHIP_W)),
                          u_min=t(np.full(M, -bound)),
                          u_max=t(np.full(M, bound)), horizon=horizon)


def export_kte(path, spec, horizon, x0, Q, QN, R, lb, ub):
    """The --kte input of native/mpc_oracle: chain parameters, x0 and
    weights only; the oracle builds its own dynamics and linearization."""
    with open(path, "wb") as f:
        f.write(struct.pack("<qq", horizon, spec.n_joints))
        f.write(np.float64(DT).tobytes())
        for i in range(spec.n_joints):
            f.write(struct.pack("<q", int(spec.joint_types[i] == 1)))
            for arr in (spec.axes[i], spec.offsets_pos[i],
                        spec.offsets_quat[i], spec.com_pos[i],
                        (spec.masses[i],), spec.inertias[i],
                        (spec.stiffness[i],), (spec.rest_q[i],),
                        (spec.damping[i],)):
                f.write(np.asarray(arr, np.float64).tobytes())
        for arr in (spec.gravity, x0, Q, QN, R, lb, ub):
            f.write(np.ascontiguousarray(arr, np.float64).tobytes())


def sat_config(mpc, ss_systems, device, dtype):
    """bench.py:232-250: mass 10, inertia diag(4, 5, 6), Q = diag(10×6,
    1×6), R = 0.05 I, QN = 10 Q, ±20, H=20; the target at p = (1, .5, -.3)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    w = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
    prob = mpc.MPCProblem(Q=t(np.diag(w)), R=t(np.eye(6) * 0.05),
                          QN=t(np.diag(10.0 * w)), u_min=t(np.full(6, -20.0)),
                          u_max=t(np.full(6, 20.0)), horizon=SAT_H)
    params = ss_systems.satellite3D(mass=10.0, inertia=np.diag([4.0, 5.0,
                                                                 6.0]))
    x_ref = ss_systems.default_state(dtype=dtype, device=device)
    x_ref[0:3] = t([1.0, 0.5, -0.3])
    return params, prob, x_ref


def sat_states(belief, mpc_manifold, ss_systems, batch, device,
               dtype=torch.float64):
    """x0 as bench.py:243-246 draws it: the belief GaussianBelief(rest
    state, 0.05 I₁₂) sampled in its tangent space and retracted
    (ctrl/mpc_manifold.sample_belief_states, ss_systems.sat3D_retraction),
    from a torch.Generator seeded 0 on ``device``; (batch, 13)."""
    b = belief.GaussianBelief(
        ss_systems.default_state(dtype=dtype, device=device),
        0.05 * torch.eye(12, dtype=dtype, device=device))
    gen = torch.Generator(device=device).manual_seed(0)
    return mpc_manifold.sample_belief_states(
        gen, b, batch, ret=ss_systems.sat3D_retraction())


def manifold_cost(prob, ret, us, xs, x_ref):
    """Each scenario's manifold tracking cost (tests/test_manifold_lanes.py
    _traj_cost): ½ Σ eᵀQe (QN at the last step) + ½ Σ uᵀRu, e the tangent
    from each state to the target; (B,)."""
    e = ret.local(x_ref.expand(xs.shape), xs)
    return 0.5 * (torch.einsum("bti,ij,btj->b", e[:, :-1], prob.Q, e[:, :-1])
                  + torch.einsum("bi,ij,bj->b", e[:, -1], prob.QN, e[:, -1])
                  + torch.einsum("bti,ij,btj->b", us, prob.R, us))


def export_ltv(path, A, Bm, c, x0, Q, QN, R, lb, ub):
    """The LTV input of native/mpc_oracle (tests/test_mpc_parity.py
    _export): H, n, m, then the arrays in float64."""
    H, n, m = Bm.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<qqq", H, n, m))
        for arr in (A, Bm, c, x0, Q, QN, R, lb, ub):
            f.write(np.ascontiguousarray(arr, np.float64).tobytes())


def floating_arm_config(mpc, spec, device, dtype):
    """bench.py:274-295: Q = diag(5×nv, 0.5×nv), R = 0.05 I, QN = 10 Q, ±30,
    H=16; the target at rest with identity attitude."""
    nq, nv = spec.nq, spec.nv
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    w = np.concatenate([np.full(nv, 5.0), np.full(nv, 0.5)])
    prob = mpc.MPCProblem(Q=t(np.diag(w)), R=t(np.eye(nv) * 0.05),
                          QN=t(np.diag(10.0 * w)),
                          u_min=t(np.full(nv, -30.0)),
                          u_max=t(np.full(nv, 30.0)), horizon=FA_H)
    x_ref = torch.zeros(nq + nv, dtype=dtype, device=device)
    x_ref[3] = 1.0
    return prob, x_ref


def floating_arm_states(spec, batch):
    """x0 as bench.py:287-293 draws it (numpy seed 0): random attitude,
    p ~ 0.2 N, arm angles ~ 0.3 N, rates ~ 0.1 N; (batch, nq + nv)."""
    nq, nv = spec.nq, spec.nv
    rng = np.random.default_rng(0)
    qr = rng.standard_normal((batch, 4))
    qr /= np.linalg.norm(qr, axis=1, keepdims=True)
    x0 = np.zeros((batch, nq + nv))
    x0[:, 0:3] = 0.2 * rng.standard_normal((batch, 3))
    x0[:, 3:7] = qr
    x0[:, 7:nq] = 0.3 * rng.standard_normal((batch, nq - 7))
    x0[:, nq:] = 0.1 * rng.standard_normal((batch, nv))
    return x0


def floating_arm_solver(lanes, manifold_lanes, spec, prob, sqp_iters=1):
    step, ltv = lanes.make_kte_manifold_lanes(spec, FA_DT)
    return manifold_lanes.make_scenario_mpc_lanes(
        step, ltv, prob, tangent_dim=2 * spec.nv, quat_index=3,
        qp_iters=ITERS, sqp_iters=sqp_iters)


def beam_config(mpc, spec, device, dtype):
    """The beam's MPC: Q = diag(10×nv, 1×nv), R = 0.05 I, QN = 5 Q, ±30,
    H = BEAM_H."""
    nv = spec.nv
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    w = np.concatenate([np.full(nv, 10.0), np.full(nv, 1.0)])
    return mpc.MPCProblem(Q=t(np.diag(w)), R=t(np.eye(nv) * 0.05),
                          QN=t(np.diag(5.0 * w)), u_min=t(np.full(nv, -30.0)),
                          u_max=t(np.full(nv, 30.0)), horizon=BEAM_H)


def beam_states(spec):
    """x0 (BEAM_B, 2nv), numpy seed 0: q ~ U(±0.05), q̇ ~ U(±0.5)."""
    rng = np.random.default_rng(0)
    nv = spec.nv
    return np.concatenate([rng.uniform(-0.05, 0.05, (BEAM_B, nv)),
                           rng.uniform(-0.5, 0.5, (BEAM_B, nv))], axis=1)


def cpu_reference(path):
    """The plain f64 solves on CPU tensors that the card's solves are held
    to: for the first N_REF scenarios the flagship with two SQP passes and
    the line search and the floating arm, the 16-segment beam's solve, the
    satellite's generic scenario MPC (ctrl/mpc_manifold) on GEN_REF_B
    states this process draws itself, the three Monte-Carlo filters' first
    EST_REF_RUNS runs over EST_REF_STEPS steps, DLQR_REF gains of dlqr
    on the plain step's linearization, phase arms_ik_integrators'
    7-DoF arm solve and CLIK (``arm_references``), and phases
    optimizers_geometry's, interp_spaces_io's and planning's references.
    Saved to
    ``path``."""
    sys.path.insert(0, ROOT)
    from reak_tpu_torch.ctrl import (belief, manifold_lanes, mpc, mpc_manifold,
                                     ss_systems)
    from reak_tpu_torch.kte import lanes, models

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    f64 = torch.float64
    spec = models.manip_3r3r()
    x0 = torch.as_tensor(bench_states(np.random.default_rng(0), B)[:N_REF])
    us_flag, _ = mpc.make_kte_mpc(
        spec, flagship_problem(mpc, "cpu", f64), DT, qp_iters=ITERS,
        sqp_iters=2)(x0, torch.zeros(N_REF, H, M, dtype=f64))
    fa = models.floating_arm()
    prob, x_ref = floating_arm_config(mpc, fa, "cpu", f64)
    us_fa, xs_fa = floating_arm_solver(lanes, manifold_lanes, fa, prob)(
        torch.as_tensor(floating_arm_states(fa, FA_B)[:N_REF]), x_ref,
        torch.zeros(N_REF, FA_H, fa.nv, dtype=f64))
    beam = models.flexible_beam(BEAM_SEGMENTS)
    us_bm, xs_bm = mpc.make_kte_mpc(
        beam, beam_config(mpc, beam, "cpu", f64), BEAM_DT, qp_iters=ITERS)(
        torch.as_tensor(beam_states(beam)),
        torch.zeros(BEAM_B, BEAM_H, beam.nv, dtype=f64))
    params, prob_sat, xr_sat = sat_config(mpc, ss_systems, "cpu", f64)
    x0_gen = sat_states(belief, mpc_manifold, ss_systems, GEN_REF_B, "cpu")
    us_gen, _ = mpc_manifold.make_scenario_mpc(
        ss_systems.satellite3D_imdt(params, SAT_DT),
        ss_systems.sat3D_retraction(), prob_sat, qp_iters=ITERS,
        sqp_iters=2)(x0_gen, xr_sat,
                     torch.zeros(GEN_REF_B, SAT_H, 6, dtype=f64))
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, flagship_sqp_us=us_flag.numpy(), floating_arm_us=us_fa.numpy(),
             floating_arm_xs=xs_fa.numpy(), beam_us=us_bm.numpy(),
             beam_xs=xs_bm.numpy(), generic_x0=x0_gen.numpy(),
             generic_us=us_gen.numpy(), **estimation_references(),
             **arm_references(), **optimizers_geometry_references(),
             **interp_spaces_references(), **planning_references(),
             seconds=time.perf_counter() - t0)
    os.replace(tmp, path)
    return 0


def estimation_references():
    """Phase estimation's plain f64 references on CPU tensors: the three
    Monte-Carlo filters on the first EST_REF_RUNS runs' draws over their
    first EST_REF_STEPS steps (``est_<filter>``), and DLQR_REF gains of dlqr
    on the plain step's linearization at the first states and inputs of
    phase k1_vs_plain (``dlqr_K``)."""
    from reak_tpu_torch.examples import estimate_satellite3d as est
    from reak_tpu_torch.kte import models
    from reak_tpu_torch.math import are
    from reak_tpu_torch.ops import kte_step

    cfg = dict(est.DEFAULTS, device="cpu")
    _, F_est = est.make_system(cfg)
    zs = est._measurements_from_draws(
        est.truth_rollout(F_est, EST_REF_STEPS, "cpu"), cfg["meas_noise"],
        torch.as_tensor(estimation_draws(EST_REF_RUNS)[:, :EST_REF_STEPS]))
    out = {f"est_{kind}": est.monte_carlo(dict(cfg, filter=kind), F_est,
                                          zs).numpy()
           for kind in ("iekf", "ekf", "ukf")}
    x_k1, u_k1 = k1_inputs()
    A_k1, B_k1, _, _ = kte_step.make_step_plain(models.manip_3r3r(), DT)(
        torch.as_tensor(x_k1[:, :DLQR_REF].copy()),
        torch.as_tensor(u_k1[:, :DLQR_REF].copy()))
    K_k1, _ = are.dlqr(A_k1.permute(2, 0, 1), B_k1.permute(2, 0, 1),
                       torch.eye(N, dtype=torch.float64),
                       torch.eye(M, dtype=torch.float64))
    out["dlqr_K"] = K_k1.numpy()
    return out


def are_solvers(rng, batch, n, m, device):
    """Every solver of math/are and ctrl/lqg on ``batch`` seeded f64
    systems at (n, m) on ``device`` (spectral_systems, lqg_systems), each
    timed, with the worst entry's residual of its defining equation,
    absolute and relative (``residual``), and the bar it is held to:
    its test's absolute bar, or ARE_REL_BAR on the relative residual for
    the continuous Riccati equations of the regulator (ARE_REL_ROWS), whose
    solutions reach |X| ≈ 300 at this width.  Returns the rows and the
    spectral systems' D (J) doublings."""
    from reak_tpu_torch.ctrl import lqg
    from reak_tpu_torch.math import are

    (Ac, Bc, Cc, Dc), (Fd, Gd, Hd, Jd), doubled = spectral_systems(
        rng, batch, n, m, device)
    (A_c, B_c, C_c, V_c, W_c, Q_c, R_c), (A_d, B_d, C_d, V_d, W_d, Q_d,
                                          R_d) = lqg_systems(
        rng, batch, n, m, device)
    care = lambda X: care_terms(A_c, B_c, Q_c, R_c, X)
    dare = lambda X: dare_terms(A_d, B_d, Q_d, R_d, X)
    care_f = lambda S: care_terms(A_c.mT, C_c.mT, V_c, W_c, S)
    dare_f = lambda S: dare_terms(A_d.mT, C_d.mT, V_d, W_d, S)

    def ctsf(X):
        E = Dc + Dc.mT
        Abar = Ac - Bc @ torch.linalg.solve(E, Cc)
        return [Bc @ torch.linalg.solve(E, Bc.mT), X @ Abar.mT, Abar @ X,
                X @ Cc.mT @ torch.linalg.solve(E, Cc) @ X]

    def dtsf(X):
        E = Jd + Jd.mT
        return [-X, Fd @ X @ Fd.mT, (Gd - Fd @ X @ Hd.mT) @ torch.linalg.solve(
            E - Hd @ X @ Hd.mT, Gd.mT - Hd @ X @ Fd.mT)]

    # name: (call, [(terms, its solution) of each equation], test's bar)
    cases = {
        "solve_care": (lambda: are.solve_care(A_c, B_c, Q_c, R_c),
                       lambda X: [(care, X)], 1e-8),
        "clqr": (lambda: are.clqr(A_c, B_c, Q_c, R_c),
                 lambda KX: [(care, KX[1])], 1e-8),
        "solve_dare": (lambda: are.solve_dare(A_d, B_d, Q_d, R_d),
                       lambda X: [(dare, X)], 1e-8),
        "dlqr": (lambda: are.dlqr(A_d, B_d, Q_d, R_d),
                 lambda KX: [(dare, KX[1])], 1e-8),
        # the LQG gains: process noise V, measurement noise W
        "dlqg": (lambda: lqg.dlqg(A_d, B_d, C_d, Q_d, R_d, V_d, W_d),
                 lambda g: [(dare, g.P), (dare_f, g.S)], 1e-8),
        "clqg": (lambda: lqg.clqg(A_c, B_c, C_c, Q_c, R_c, V_c, W_c),
                 lambda g: [(care, g.P), (care_f, g.S)], 1e-8),
        "solve_ihct_lqg": (lambda: are.solve_ihct_lqg(
            A_c, B_c, C_c, V_c, W_c, Q_c, R_c),
            lambda r: [(care, r[1]), (care_f, r[3])], 1e-8),
        "solve_ihdt_lqg": (lambda: are.solve_ihdt_lqg(
            A_d, B_d, C_d, V_d, W_d, Q_d, R_d),
            lambda r: [(dare, r[1]), (dare_f, r[3])], 1e-8),
        "solve_ctsf": (lambda: are.solve_ctsf(Ac, Bc, Cc, Dc),
                       lambda X: [(ctsf, X)], 1e-10),
        "solve_dtsf": (lambda: are.solve_dtsf(Fd, Gd, Hd, Jd),
                       lambda X: [(dtsf, X)], 1e-10),
    }
    rows = {}
    for name, (call, equations, bar) in cases.items():
        out, ms = timed(call)
        res = [residual(f(X)) for f, X in equations(out)]
        rel = name in ARE_REL_ROWS
        rows[name] = {
            "ms": ms, "bar_on": "relative" if rel else "absolute",
            "bar": ARE_REL_BAR if rel else bar,
            "max_abs_residual": max(float(r.max()) for r, _ in res),
            "max_rel_residual": max(float(r.max()) for _, r in res),
            "max_abs_X": max(float(X.abs().max()) for _, X in
                             equations(out))}
    return {"spectral_D_doublings": doubled, **rows}


def estimation_filters(card, dev):
    """Phase estimation's parts (a) and (b) (see ``estimation``), which
    launch no kernel: the card's work, run beside the build.  Returns the
    phase's line so far, with the first runs of each f64 filter for the
    comparison with the CPU child, as ``(es, ref_runs)``."""
    f64 = torch.float64
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    from reak_tpu_torch.examples import estimate_satellite3d as est, \
        predict_satellite3d as pred_ex
    from reak_tpu_torch.io.config import config_from_args

    t_est = time.perf_counter()
    es = {"phase": "estimation", "card": card, "filters": {}}
    cfg = dict(est.DEFAULTS)
    _, F_est = est.make_system(cfg)
    xs_est = est.truth_rollout(F_est, cfg["steps"], dev)
    eps_est = on(estimation_draws(EST_RUNS_F32, cfg["steps"]), f64)
    m64, ref_runs = {}, {}

    def monte_carlo(kind, xs_, eps_):
        zs_ = est._measurements_from_draws(xs_, cfg["meas_noise"], eps_)
        return timed(lambda: est.monte_carlo(dict(cfg, filter=kind), F_est,
                                             zs_))

    def errors(means):
        """Each final error's mean and max over the runs."""
        return {f"final_{k}_err_{f.__name__}": float(f(e)) for k, e in zip(
            ("pos", "att", "rate"), est.final_errors(means.double(),
                                                     xs_est[-1]))
                for f in (torch.mean, torch.amax)}

    for kind in ("iekf", "ekf", "ukf"):
        m64[kind], ms = monte_carlo(kind, xs_est, eps_est[:EST_RUNS])
        es["filters"][kind] = {
            "runs": EST_RUNS, "dtype": "float64", "steps": cfg["steps"],
            "ms": ms, "finite": bool(torch.isfinite(m64[kind]).all()),
            **errors(m64[kind])}
        ref_runs[kind] = m64[kind][:EST_REF_RUNS, :EST_REF_STEPS].cpu()
    m32, ms = monte_carlo("iekf", xs_est.float(), eps_est.float())
    d32 = (m32[:EST_RUNS, -1].double() - m64["iekf"][:, -1]).abs()
    es["filters"]["iekf_f32"] = {
        "runs": EST_RUNS_F32, "dtype": "float32", "steps": cfg["steps"],
        "ms": ms, "finite": bool(torch.isfinite(m32).all()), **errors(m32),
        "max_abs_final_vs_f64": {k: float(d32[:, sl].max()) for k, sl in (
            ("pos", slice(0, 3)), ("quat", slice(3, 7)),
            ("vel", slice(7, 10)), ("rate", slice(10, 13)))}}
    del eps_est, m32, m64, d32
    # (b) prediction
    with _CholeskyCalls() as chol:
        pr, ms = timed(lambda: pred_ex.predict(config_from_args(
            [f"--n-scenarios={EST_SCENARIOS}", f"--device={dev}"],
            pred_ex.DEFAULTS)))
    batched = [sh for sh in chol.shapes if len(sh) > 2]
    es["predict"] = {
        "scenarios": list(pr.scenarios.shape), "ms": ms,
        "final_err": pr.final_err, "trace_growth": pr.trace_growth,
        "quat_unit_err": float((torch.linalg.vector_norm(
            pr.scenarios[..., 3:7], dim=-1) - 1.0).abs().max()),
        "finite": bool(torch.isfinite(pr.scenarios).all()),
        "cholesky_calls": len(chol.shapes), "batched_cholesky": batched,
        "matrices_factored": sum(int(np.prod(sh[:-2])) for sh in
                                 chol.shapes)}
    del pr
    es["seconds"] = time.perf_counter() - t_est
    return es, ref_runs


def estimation(card, dev, cpu_refs, step_k, k64, x_np, u_np, reset_counts,
               counts, main_runs, filters):
    """Phase estimation, on the card: the Monte-Carlo filters, prediction
    and planning from the estimate, and the batched ARE and LQG solvers.
    ``cpu_refs()`` returns the CPU child's results, ``estimation_
    references()`` among them, waiting for the child: it is called after
    the card's work, which runs while the child may still be running.
    ``step_k``, ``k64``, ``x_np`` and ``u_np`` are phase k1_vs_plain's K1,
    its f64 outputs and its inputs; the K1 and K2 launches go into
    ``main_runs``; ``filters`` is what ``estimation_filters`` returned
    (parts (a) and (b), run beside the build)."""
    f64 = torch.float64
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    # (README.md:104, examples/*.py, tests/test_are_spectral.py)
    # (a) the Monte-Carlo filters of examples/estimate_satellite3d.py at its
    # defaults (150 steps, dt 0.05, pose and gyro, noise 1e-3), each one
    # vmap of run_filter: iekf, ekf and ukf at f64 on EST_RUNS runs (every
    # run's final position and rate errors < EST_BAR, as
    # tests/test_ss_systems.py:95-96 holds them, and its attitude error
    # < EST_BAR rad; the first EST_REF_RUNS runs over EST_REF_STEPS steps
    # ≤1e-9 relative to the CPU child's), then iekf at f32 on EST_RUNS_F32
    # runs of the same truth (each within the same bars, each of the first
    # EST_RUNS within EST_F32_BAR of its f64 final state);
    # (b) predict_satellite3d at its defaults (150 IEKF steps, H = 50) with
    # EST_SCENARIOS scenarios: unit quaternions, a growing covariance
    # trace, the H+1 covariances factored in one call; (c) satellite_mpc at
    # its defaults (15 IEKF steps, sample_belief_states, the lanes route on
    # K2, H = 20, dt 0.1, ±20, 8 iterations, 2 passes, f64) on
    # EST_SCENARIOS scenarios, every one within 0.1 of the target; (d) dlqr
    # (Q = I, R = I) on the (A_d, B_d) of K1 at phase k1_vs_plain's inputs,
    # DARE residual ≤1e-8 of ‖P‖, DLQR_REF gains ≤1e-9 relative to the CPU
    # child's; and every solver of math/are and ctrl/lqg on ARE_B seeded
    # systems at (ARE_N, ARE_M), each within its bar (are_solvers).
    from reak_tpu_torch.examples import satellite_mpc as smpc
    from reak_tpu_torch.io.config import config_from_args
    from reak_tpu_torch.math import are

    t_est = time.perf_counter()
    es, ref_runs = filters
    # (c) planning from the estimate, on K2
    reset_counts()
    plan, ms = timed(lambda: smpc.plan(config_from_args(
        [f"--scenarios={EST_SCENARIOS}", f"--device={dev}"],
        smpc.DEFAULTS)))
    main_runs["estimation.satellite_mpc"] = counts()
    u0_plan = torch.zeros_like(plan.us)
    solve_ms = cuda_ms(lambda: plan.solver(plan.x0s, plan.x_ref, u0_plan),
                       reps=2)
    es["satellite_mpc"] = {
        "scenarios": EST_SCENARIOS, "dtype": "float64", "plan_ms": ms,
        "solve_ms": solve_ms, "solves_per_s": EST_SCENARIOS / solve_ms * 1e3,
        "launches": main_runs["estimation.satellite_mpc"],
        "posterior_err": plan.posterior_err,
        "terminal_pos_err_max": float(plan.terminal_pos_err.max()),
        "terminal_rot_err_max": float(plan.terminal_rot_err.max()),
        "finite": bool(torch.isfinite(plan.us).all())}
    del plan, u0_plan
    # (d) dlqr on K1's linearization, then the batched ARE and LQG solvers
    check(all(np.array_equal(a, b) for a, b in zip(k1_inputs(),
                                                   (x_np, u_np))),
          "k1_inputs() differs from phase k1_vs_plain's inputs")
    reset_counts()
    Ad_e, Bd_e, _, _ = step_k(on(x_np, f64), on(u_np, f64))
    main_runs["estimation.dlqr"] = counts()
    A_e, B_e = Ad_e.permute(2, 0, 1), Bd_e.permute(2, 0, 1)
    eye_n = torch.eye(N, dtype=f64, device=dev)
    eye_m = torch.eye(M, dtype=f64, device=dev)
    (K_e, P_e), ms = timed(lambda: are.dlqr(A_e, B_e, eye_n, eye_m))
    es["dlqr"] = {
        "B": B, "ms": ms, "launches": main_runs["estimation.dlqr"],
        "k1_bitwise_phase_3": bool(torch.equal(Ad_e, k64[0])
                                   and torch.equal(Bd_e, k64[1])),
        "max_residual_rel_P": float((residual(dare_terms(
            A_e, B_e, eye_n, eye_m, P_e))[0] / P_e.abs().amax(
                dim=(-2, -1))).max())}
    ref_runs["dlqr_K"] = K_e[:DLQR_REF].cpu()
    del Ad_e, Bd_e, A_e, B_e, K_e, P_e
    es["are"] = {"B": ARE_B, "n": ARE_N, "m": ARE_M, "dtype": "float64",
                 **are_solvers(np.random.default_rng(13), ARE_B, ARE_N,
                               ARE_M, dev)}
    es["seconds"] += time.perf_counter() - t_est
    refs = cpu_refs()
    for kind in ("iekf", "ekf", "ukf"):
        es["filters"][kind]["rel_vs_cpu"] = rel_err(
            ref_runs[kind], torch.as_tensor(refs[f"est_{kind}"]))
    es["dlqr"]["gain_rel_vs_cpu"] = rel_err(
        ref_runs["dlqr_K"], torch.as_tensor(refs["dlqr_K"]))
    emit(es)
    for kind in ("iekf", "ekf", "ukf", "iekf_f32"):
        r = es["filters"][kind]
        check(r["finite"], f"a {kind} Monte-Carlo run is not finite")
        for q in ("pos", "att", "rate"):
            check(r[f"final_{q}_err_amax"] < EST_BAR,
                  f"{kind}: a run's final {q} error "
                  f"{r[f'final_{q}_err_amax']} ≥ {EST_BAR}")
        if kind != "iekf_f32":
            check(r["rel_vs_cpu"] <= 1e-9,
                  f"{kind}: the card's runs {r['rel_vs_cpu']:.2e} from the "
                  "CPU child's")
    for q, d in es["filters"]["iekf_f32"]["max_abs_final_vs_f64"].items():
        check(d <= EST_F32_BAR, f"the f32 IEKF runs' final {q} {d:.2e} from "
              f"their f64 runs, above {EST_F32_BAR:.0e}")
    p_ = es["predict"]
    check(p_["scenarios"] == [EST_SCENARIOS, 51, 13] and p_["finite"],
          f"predicted scenarios of shape {p_['scenarios']} or not finite")
    check(p_["quat_unit_err"] <= 1e-12, "a predicted quaternion is not unit")
    check(p_["trace_growth"] > 1.0, "the covariance trace does not grow")
    check(p_["batched_cholesky"] == [(51, 12, 12)],
          f"the scenarios' covariances factored as {p_['batched_cholesky']}")
    check(p_["matrices_factored"] == 150 + 51,
          f"{p_['matrices_factored']} matrices factored, expected 201")
    sm = es["satellite_mpc"]
    want = {k: (2 if k == "pdip_whole" else 0) for k in sm["launches"]}
    check(sm["launches"] == want, f"satellite_mpc launched {sm['launches']}")
    check(sm["finite"] and sm["terminal_pos_err_max"] < 0.1,
          "a satellite_mpc scenario ends 0.1 or more from the target")
    dl = es["dlqr"]
    check(dl["launches"]["kte_step"] == 1 and dl["k1_bitwise_phase_3"],
          "K1 did not give phase k1_vs_plain's (A_d, B_d) again")
    check(dl["max_residual_rel_P"] <= 1e-8, "a DARE residual > 1e-8 ‖P‖")
    check(dl["gain_rel_vs_cpu"] <= 1e-9, "dlqr gains against the CPU child")
    for k, r in es["are"].items():
        if isinstance(r, dict) and "bar_on" in r:
            worst = r["max_rel_residual" if r["bar_on"] == "relative"
                      else "max_abs_residual"]
            check(worst <= r["bar"], f"{k}: {r['bar_on']} residual "
                  f"{worst:.2e} above {r['bar']:.0e}")


# ---- phase arms_ik_integrators: the arm builders, IK, forces, sorting,
# tensors and the integrators ----------------------------------------------
# the full-width 7-DoF arm (kte/models.manip_ssrms, n = 14, m = 7) through
# make_kte_mpc at the flagship's settings (bench.py:104-132) with its weight
# pattern widened to seven joints; IK, plant and force checks on ARM_B
# scenarios, ARM_REF of them held to the CPU
ARM_B, ARM_REF = 8192, 64
ARM_W = np.concatenate([np.full(7, 10.0), np.full(7, 1.0)])
# the new builders on K1/K5 (the batches of phase kte_chains)
ARM_CHAINS = ("pendulum", "double_pendulum", "manip_3r_planar", "manip_p3r3r",
              "manip_scara", "manip_era", "manip_ssrms")
ARM_BATCHES = (1, 77, 1001)
# the stiff suite's runs at tests/test_stiff_ivp.py's settings and bars:
# (problem, dt0, rtol, atol, max_steps, endpoint bar), MEDAKZO's bars in
# the phase; the adaptive loops read their condition every IVP_CHECK
# attempts and replay each group of attempts, and the multistep loops each
# IVP_GRAPH steps, from a CUDA graph.  The multistep methods take
# HIRES_STEPS fixed steps where the JAX test takes 400,000: both are
# unstable at 40,000 and within 3e-12 of the published endpoint from
# 100,000 (JAX on the CPU; 2.6e-12 and 6.2e-13 on an H100), and 400,000
# steps took 47.8 and 93.5 s on the card (a graph replays ~2 µs a launch)
ROSENBROCK_RUNS = (("HIRES", 1e-6, 1e-7, 1e-12, 100_000, 1e-5),
                   ("ROBER", 1e-6, 1e-7, 1e-14, 200_000, 2e-3),
                   ("OREGO", 1e-6, 1e-7, 1e-12, 200_000, 5e-4),
                   ("VDP", 1e-8, 1e-7, 1e-12, 200_000, 5e-5))
HIRES_STEPS, IVP_CHECK, IVP_GRAPH = 100_000, 64, 1000
SORT_B, SORT_N = 8192, 1000


def arm_states(batch):
    """x0 (batch, 14) of the 7-DoF arm as bench.py draws the flagship's
    (seed 0): q ~ U(±0.5), q̇ ~ U(±0.2)."""
    rng = np.random.default_rng(0)
    return np.concatenate([rng.uniform(-0.5, 0.5, (batch, 7)),
                           rng.uniform(-0.2, 0.2, (batch, 7))], axis=1)


def arm_problem(mpc, device, dtype):
    """The flagship's weights widened to seven joints (bench.py:112-119):
    Q = diag(10 ×7, 1 ×7), R = 0.05 I₇, QN = 5 Q, ±40, H = 50."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return mpc.MPCProblem(Q=t(np.diag(ARM_W)), R=t(np.eye(7) * 0.05),
                          QN=t(np.diag(5.0 * ARM_W)),
                          u_min=t(np.full(7, -40.0)),
                          u_max=t(np.full(7, 40.0)), horizon=H)


def ik_draws(batch):
    """Configurations of the 7-DoF arms ~ U(±1.2) and the N(0, 1) draws
    that perturb CLIK's starts, numpy seed 21."""
    rng = np.random.default_rng(21)
    return rng.uniform(-1.2, 1.2, (batch, 7)), rng.standard_normal((batch, 7))


def phi_of(spec, q):
    """The redundancy angle of a 7-DoF configuration: its middle pitch axis
    on the closed form's self-motion circle (tests/test_ik.py:138-156)."""
    from reak_tpu_torch.kte import dynamics, ik
    from reak_tpu_torch.math import rotations as rot

    w = dynamics.fk(spec, q).joint_axis[3]
    p, quat = ik.ee_pose(spec, q)
    offs = np.asarray(spec.offsets_pos)
    vec = lambda *a: torch.tensor(a, dtype=q.dtype, device=q.device)
    v = p - float(offs[6][2]) * rot.q_to_matrix(quat)[:, 2] \
        - vec(0.0, 0.0, float(offs[1][2]))
    vu = v / torch.linalg.vector_norm(v)
    ref = torch.where(torch.abs(vu[2]) < 0.9, vec(0.0, 0.0, 1.0),
                      vec(1.0, 0.0, 0.0))
    e1 = rot.cross(vu, ref)
    e1 = e1 / torch.linalg.vector_norm(e1)
    return torch.atan2(torch.dot(w, rot.cross(vu, e1)), torch.dot(w, e1))


def ssrms_clik_inputs(q_np, noise_np, device):
    """Targets (FK of q), and CLIK's starts: the closed form's answers at
    each configuration's own phi and elbow, plus 0.1 × the draws."""
    from torch.func import vmap

    from reak_tpu_torch.kte import ik, models

    spec = models.manip_ssrms()
    q = torch.as_tensor(q_np, device=device)
    p, quat = vmap(lambda x: ik.ee_pose(spec, x))(q)
    phi = vmap(lambda x: phi_of(spec, x))(q)
    elbow = torch.where(q[:, 3] >= 0, 1.0, -1.0).to(q.dtype)
    q_ik = vmap(lambda a, b, c, d: ik.ik_ssrms(spec, a, b, phi=c, elbow=d))(
        p, quat, phi, elbow)
    return p, quat, q_ik, q_ik + 0.1 * torch.as_tensor(noise_np,
                                                       device=device)


def arm_plant(x0, tau, graph_steps=0):
    """The 7-DoF arm as a plant: integrators.rollout (RK4, H steps of DT)
    of kte.state_rate under the held inputs ``tau`` (B, 7), one
    ``torch.func.vmap`` over the scenarios; (H, B, 14)."""
    from torch.func import vmap

    from reak_tpu_torch import integrators, kte
    from reak_tpu_torch.kte import models

    spec = models.manip_ssrms()
    rate = lambda t, X: vmap(lambda x, u: kte.state_rate(spec, x, u))(X, tau)
    return integrators.rollout(rate, x0, 0.0, DT, H, method="rk4",
                               graph_steps=graph_steps)


def arm_references():
    """Phase arms_ik_integrators' plain f64 references on CPU tensors: the
    7-DoF arm's plain solve of the first N_REF states (``arm_us``), the
    plant from the first ARM_REF of them under that solve's first controls
    (``arm_plant``), and CLIK on the first ARM_REF of the arm's IK draws
    (``arm_clik_q``, ``arm_clik_err``)."""
    from reak_tpu_torch.ctrl import mpc
    from reak_tpu_torch.kte import ik, models

    f64 = torch.float64
    spec = models.manip_ssrms()
    us, _ = mpc.make_kte_mpc(spec, arm_problem(mpc, "cpu", f64), DT,
                             qp_iters=ITERS)(
        torch.as_tensor(arm_states(B)[:N_REF]),
        torch.zeros(N_REF, H, 7, dtype=f64))
    q_np, noise_np = ik_draws(ARM_B)
    p, quat, _, q0 = ssrms_clik_inputs(q_np[:ARM_REF], noise_np[:ARM_REF],
                                       "cpu")
    res = ik.clik_batched(spec, p, quat, q0)
    xs = arm_plant(torch.as_tensor(arm_states(B)[:ARM_REF]),
                   us[:ARM_REF, 0])
    return {"arm_us": us.numpy(), "arm_plant": xs.numpy(),
            "arm_clik_q": res.q.numpy(), "arm_clik_err": res.err.numpy()}


def endpoint_rel_err(y, ref):
    """tests/test_stiff_ivp.py's endpoint error: max relative over the
    published components (NaN entries unchecked)."""
    y, m = y.double().cpu().numpy(), ~np.isnan(ref)
    return float(np.max(np.abs(y[m] - ref[m]) / (np.abs(ref[m]) + 1e-30)))


def stiff_suite(dev):
    """Phase arms_ik_integrators' stiff suite (its part (d) after the
    plant), which launches no kernel: run beside the build.  Returns its
    entries of the phase's ``integrators``."""
    from reak_tpu_torch.integrators import (adaptive, implicit, ivp_suite,
                                            multistep)

    f64 = torch.float64
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    ivp = {}
    hires = ivp_suite.HIRES
    y_h = on(hires.y0, f64)

    def adaptive_run(key, run, ref, bar):
        reads = adaptive.host_reads
        res, ms = timed(run)
        ivp[key] = {"attempts": int(res.n_steps), "ok": bool(res.ok),
                    "host_reads": adaptive.host_reads - reads, "ms": ms,
                    "endpoint_rel_err": endpoint_rel_err(res.y, ref),
                    "bar": bar}
        return res

    adaptive_run("dopri45_HIRES", lambda: adaptive.integrate_adaptive(
        hires.f, y_h, hires.t0, hires.tf, dt0=1e-4, tol=1e-10, dt_min=1e-12,
        max_steps=2_000_000, method="dopri45", check_every=IVP_CHECK,
        graphed=True), hires.y_ref, 1e-4)
    dt_h = (hires.tf - hires.t0) / HIRES_STEPS
    for key, fn in (("adams_bm5_HIRES", multistep.adams_bm5),
                    ("hamming_iter_mod_HIRES", multistep.hamming_iter_mod)):
        y, ms = timed(lambda: fn(hires.f, y_h, hires.t0, dt_h, HIRES_STEPS,
                                 graph_steps=IVP_GRAPH))
        ivp[key] = {"steps": HIRES_STEPS, "ms": ms,
                    "endpoint_rel_err": endpoint_rel_err(y, hires.y_ref),
                    "bar": 1e-5}
    for name, dt0, rtol, atol, max_steps, bar in ROSENBROCK_RUNS:
        prob = getattr(ivp_suite, name)
        res = adaptive_run(f"rosenbrock_{name}",
                           lambda: implicit.integrate_rosenbrock(
                               prob.f, on(prob.y0, f64), prob.t0, prob.tf,
                               dt0=dt0, rtol=rtol, atol=atol,
                               max_steps=max_steps, check_every=IVP_CHECK,
                               graphed=True), prob.y_ref, bar)
        if name == "ROBER":
            ivp["rosenbrock_ROBER"]["mass_err"] = abs(float(res.y.sum())
                                                      - 1.0)
    med = ivp_suite.MEDAKZO
    res = adaptive_run("rosenbrock_MEDAKZO",
                       lambda: implicit.integrate_rosenbrock(
                           med.f, on(med.y0, f64), med.t0, med.tf, dt0=1e-8,
                           rtol=1e-6, atol=1e-12, max_steps=200_000,
                           check_every=IVP_CHECK, graphed=True),
                       med.y_ref, 2e-3)
    y_m = res.y.cpu().numpy()
    ivp["rosenbrock_MEDAKZO"].update(
        states=int(y_m.shape[0]),
        lead_rel_err=float(np.max(np.abs(y_m[0:30:2] - med.y_ref[0:30:2])
                                  / np.abs(med.y_ref[0:30:2]))),
        far_v_err=float(np.max(np.abs(y_m[391:400:2] - 1.0))),
        far_u_max=float(np.max(np.abs(y_m[390:400:2]))))
    return ivp


def arms_ik_integrators(card, dev, cpu_refs, reset_counts, counts, main_runs,
                        stiff):
    """Phase arms_ik_integrators, on the card, f64 unless said:
    (a) the seven new fixed-base builders on K1/K5 at B = 1, 77, 1001
    against their plain versions (≤1e-9 relative), and uav_kinematics'
    step and LTV on the generic free-base assembly (no K1/K5 launch;
    ≤1e-12 of the CPU on 16 states); (b) make_kte_mpc on the 7-DoF SSRMS
    (f32, B = 8192, H = 50, 8 iterations, 1 pass, ±40): exactly 50 K1
    launches at (7, 7) and 1 K2, controls within 1e-3 of the CPU child's
    plain f64 solve of N_REF states, timed with its rollout/PDIP split;
    (c) IK at B = 8192: the closed forms under vmap round-trip FK(IK(pose))
    ≤1e-9 in position and angle (3R3R and P3R3R on their best of eight
    branches, SCARA in position); CLIK on the 3R3R (60 iterations from q +
    0.1 N(0, 1)) and on the SSRMS from its closed form's answers + 0.1 N(0,
    1): ≥ 99 % below 1e-6 (and the 3R3R's first 16, the JAX test's batch,
    all), the SSRMS's first ARM_REF ≤1e-8 from the CPU child's; (d) the
    plant (``arm_plant``: integrators.rollout, RK4, of the arm's
    kte.state_rate, 50 steps of DT, each replayed from a CUDA graph) under
    the solve's first controls, and from the child's first ARM_REF states
    under its f64 solve's first controls ≤1e-9 relative of the child's;
    integrate_adaptive (dopri45), adams_bm5 and
    hamming_iter_mod on HIRES and integrate_rosenbrock on HIRES, ROBER,
    OREGO, VDP and MEDAKZO at tests/test_stiff_ivp.py's settings and bars
    (the multistep methods at HIRES_STEPS; ``stiff`` is what
    ``stiff_suite`` returned, run beside the build);
    (e) the bitonic networks on (SORT_B, SORT_N) f32 bit for bit
    torch.sort(stable=True), lexsort_2key, median_partition and top_k
    equal to the CPU's, hosvd and cp_als reconstructions of a seeded
    (32, 24, 16) tensor ≤1e-10 and ≤1e-8 relative of the CPU's, and
    world_force_to_tau on the arm at B = 8192 ≤1e-12 of the CPU's.  The
    K1 and K2 launches of (b) go into ``main_runs``; ``cpu_refs()`` gives
    the child's ``arm_references()``, called after the card's work.
    Returns the 3R3R CLIK's share below 1e-6."""
    from torch.func import vmap

    from reak_tpu_torch.ctrl import mpc, riccati_soa
    from reak_tpu_torch.kte import forces, ik, lanes, models
    from reak_tpu_torch.math import rotations as rot, sorting, tensors
    from reak_tpu_torch.ops import kte_core, kte_step

    f32, f64 = torch.float32, torch.float64
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    t_phase = time.perf_counter()
    ph = {"phase": "arms_ik_integrators", "card": card}

    # (a) the new builders on K1/K5, and the free-base UAV on no kernel
    crng = np.random.default_rng(11)
    chains = {}
    for name in ARM_CHAINS:
        chain = getattr(models, name)()
        for batch in ARM_BATCHES:
            nv = chain.nv
            xc = on(np.concatenate([crng.uniform(-0.5, 0.5, (nv, batch)),
                                    crng.uniform(-0.3, 0.3, (nv, batch))]),
                    f64)
            uc = on(crng.uniform(-5.0, 5.0, (nv, batch)), f64)
            before = (kte_step.launches, kte_core.launches)
            got1 = kte_step.make_step_lanes(chain, DT)(xc, uc)
            got5 = kte_core.make_core_lanes(chain)(xc, uc)
            launched = (kte_step.launches - before[0],
                        kte_core.launches - before[1])
            want1 = kte_step.make_step_plain(chain, DT)(xc, uc)
            want5 = kte_core.make_core_plain(chain)(xc, uc)
            chains[f"{name},B={batch}"] = {
                "widths": list(kte_step.instance_for(chain)),
                "launches": list(launched),
                "finite": all(bool(torch.isfinite(a).all())
                              for a in (*got1, *got5)),
                "k1_f64_rel": max(rel_err(a, r) for a, r in zip(got1,
                                                                  want1)),
                "k5_f64_rel": max(rel_err(a, r) for a, r in zip(got5,
                                                                  want5))}
    uav = models.uav_kinematics()
    step_u, ltv_u = lanes.make_kte_manifold_lanes(uav, DT)
    q_u = np.tile(uav.neutral_q()[:, None], (1, 1001))
    q_u[0:3] += crng.uniform(-1.0, 1.0, (3, 1001))
    quat_u = crng.standard_normal((4, 1001))
    q_u[3:7] = quat_u / np.linalg.norm(quat_u, axis=0)
    x_u = np.concatenate([q_u, crng.uniform(-0.5, 0.5, (uav.nv, 1001))])
    u_u = crng.uniform(-2.0, 2.0, (uav.nv, 1001))
    reset_counts()
    xn_u = step_u.eager(on(x_u, f64), on(u_u, f64))
    Ad_u, Bd_u, cd_u = ltv_u.eager(on(x_u, f64), on(u_u, f64))
    uav_counts = counts()
    cpu_x = lambda a: torch.as_tensor(a[:, :16].copy())
    xn_c = step_u.eager(cpu_x(x_u), cpu_x(u_u))
    Ad_c, Bd_c, cd_c = ltv_u.eager(cpu_x(x_u), cpu_x(u_u))
    ph["uav_kinematics"] = {
        "B": 1001, "launches": uav_counts,
        "finite": all(bool(torch.isfinite(a).all()) for a in
                      (xn_u, Ad_u, Bd_u, cd_u)),
        "rel_vs_cpu": max(rel_err(a[..., :16].cpu(), b) for a, b in zip(
            (xn_u, Ad_u, Bd_u, cd_u), (xn_c, Ad_c, Bd_c, cd_c)))}
    ph["kte_chains"] = chains
    del xn_u, Ad_u, Bd_u, cd_u

    # (b) the 7-DoF arm's solve through K1 (7, 7) f32 and K2
    ssrms = models.manip_ssrms()
    x0_np = arm_states(ARM_B)
    prob32 = arm_problem(mpc, dev, f32)
    solve = mpc.make_kte_mpc(ssrms, prob32, DT, qp_iters=ITERS, sqp_iters=1)
    x0_32 = on(x0_np, f32)
    u0_32 = torch.zeros(ARM_B, H, 7, dtype=f32, device=dev)
    reset_counts()
    (us, xs), t_first = timed(lambda: solve(x0_32, u0_32))
    main_runs["arm_ssrms"] = counts()
    t_solve = cuda_ms(lambda: solve(x0_32, u0_32), reps=3)
    roll_k = lanes.make_rollout_ltv_fullfused(ssrms, DT, H)
    t_roll = cuda_ms(lambda: roll_k(x0_32, u0_32), reps=3)
    A32, B32, c32, _ = roll_k(x0_32, u0_32)
    x0T = x0_32.T.contiguous()
    t_pdip = cuda_ms(lambda: riccati_soa.solve_box_mpc_riccati_soa_fused(
        A32, B32, c32, prob32.Q, prob32.QN, prob32.R, x0T, prob32.u_min,
        prob32.u_max, iters=ITERS, use_kernels="whole"), reps=3)
    del A32, B32, c32, x0T
    # one K1 launch at (7, 7) in f32, beside the least time the card could
    # take for it (bytes or operations, as the kernels line counts them)
    step7 = kte_step.make_step_lanes(ssrms, DT)
    xk7 = x0_32.T.contiguous()
    uk7 = torch.zeros(7, ARM_B, dtype=f32, device=dev)
    t_k1 = cuda_ms(lambda: step7(xk7, uk7), reps=20)
    k1_bound = bound(nbytes(xk7, uk7, *step7(xk7, uk7)),
                     ARM_B * ops_per_scenario(
                         kte_step.make_step_plain(ssrms, DT),
                         lambda nb: cpu_args((xk7, uk7), ARM_B, nb)))
    ph["ssrms_solve"] = {
        "chain": ssrms.name, "B": ARM_B, "H": H, "n": 14, "m": 7,
        "iters": ITERS, "dtype": "float32",
        "launches": main_runs["arm_ssrms"], "first_ms": t_first,
        "solve_ms": t_solve, "solves_per_s": ARM_B / t_solve * 1e3,
        "rollout_ms": t_roll, "pdip_ms": t_pdip,
        "k1_7x7_f32_launch_ms": t_k1, "k1_7x7_f32_bound_ms": k1_bound[0],
        "k1_7x7_f32_bound_by": k1_bound[1],
        "finite": bool(torch.isfinite(us).all()
                       and torch.isfinite(xs).all()),
        "max_abs_u": float(us.abs().max()),
        "active_bounds": int((us.abs() > 40.0 - 1e-4).sum())}

    # (c) IK at ARM_B targets
    irng = np.random.default_rng(31)
    t_ik = {}

    def fk_err(spec_, q_ik, p, quat):
        p2, quat2 = vmap(lambda x: ik.ee_pose(spec_, x))(q_ik)
        ang = torch.linalg.vector_norm(rot.q_log(rot.qmul(rot.qconj(quat),
                                                          quat2)), dim=-1)
        return torch.linalg.vector_norm(p2 - p, dim=-1), ang

    branches = on([[s, e, w] for s in (1.0, -1.0) for e in (1.0, -1.0)
                   for w in (1.0, -1.0)], f64)
    rt = {}
    for name, width in (("manip_3r3r", 6), ("manip_p3r3r", 7)):
        chain = getattr(models, name)()
        q = on(irng.uniform(-1.2, 1.2, (ARM_B, width)), f64)
        p, quat = vmap(lambda x: ik.ee_pose(chain, x))(q)
        if name == "manip_3r3r":
            solve_ik = lambda a, b, tp, c: ik.ik_3r3r(chain, a, b, c[0],
                                                      c[1], c[2])
        else:
            solve_ik = lambda a, b, tp, c: ik.ik_p3r3r(
                chain, a, b, tp, shoulder=c[0], elbow=c[1], wrist=c[2])
        q_ik, t_ik[name] = timed(lambda: vmap(
            lambda a, b, tp: vmap(lambda c: solve_ik(a, b, tp, c))(
                branches))(p, quat, q[:, 0]))
        pe, ae = fk_err(chain, q_ik.reshape(-1, width),
                        p.repeat_interleave(8, 0),
                        quat.repeat_interleave(8, 0))
        best = (pe + ae).reshape(ARM_B, 8).argmin(1, keepdim=True)
        rt[name] = {"pos": float(pe.reshape(ARM_B, 8).gather(1, best).max()),
                    "angle": float(ae.reshape(ARM_B, 8).gather(1,
                                                               best).max())}
    q7, noise7 = ik_draws(ARM_B)
    for name, solver in (("manip_ssrms", ik.ik_ssrms),
                         ("manip_era", ik.ik_era)):
        chain = getattr(models, name)()
        q = on(q7, f64)
        p, quat = vmap(lambda x: ik.ee_pose(chain, x))(q)
        phi = vmap(lambda x: phi_of(chain, x))(q)
        elbow = torch.where(q[:, 3] >= 0, 1.0, -1.0).to(f64)
        q_ik, t_ik[name] = timed(lambda: vmap(
            lambda a, b, c, d: solver(chain, a, b, phi=c, elbow=d))(
                p, quat, phi, elbow))
        pe, ae = fk_err(chain, q_ik, p, quat)
        rt[name] = {"pos": float(pe.max()), "angle": float(ae.max())}
    scara = models.manip_scara()
    q = on(np.stack([irng.uniform(-np.pi, np.pi, ARM_B),
                     irng.uniform(-2.5, 2.5, ARM_B),
                     irng.uniform(-0.2, 0.2, ARM_B)], 1), f64)
    p, _ = vmap(lambda x: ik.ee_pose(scara, x))(q)
    q_ik, t_ik["manip_scara"] = timed(lambda: vmap(
        lambda a, e: ik.ik_scara(scara, a, elbow=e))(
            p, torch.where(q[:, 1] >= 0, 1.0, -1.0).to(f64)))
    rt["manip_scara"] = {"pos": float(fk_err(scara, q_ik, p, torch.zeros(
        ARM_B, 4, dtype=f64, device=dev) + on([1, 0, 0, 0], f64))[0].max())}
    arm6 = models.manip_3r3r()
    q = on(irng.uniform(-0.8, 0.8, (ARM_B, 6)), f64)
    p, quat = vmap(lambda x: ik.ee_pose(arm6, x))(q)
    q0 = q + 0.1 * on(irng.standard_normal((ARM_B, 6)), f64)
    res6, t_clik6 = timed(lambda: ik.clik_batched(arm6, p, quat, q0,
                                                  iters=60))
    p, quat, _, q0 = ssrms_clik_inputs(q7, noise7, dev)
    res7, t_clik7 = timed(lambda: ik.clik_batched(ssrms, p, quat, q0))
    ph["ik"] = {
        "B": ARM_B, "round_trip_max": rt, "ms": t_ik,
        "clik_3r3r": {"iters": 60, "ms": t_clik6,
                      "max_err": float(res6.err.max()),
                      "max_err_first_16": float(res6.err[:16].max()),
                      "share_below_1e-6": float((res6.err < 1e-6).double()
                                                .mean())},
        "clik_ssrms": {"iters": 50, "ms": t_clik7,
                       "max_err": float(res7.err.max()),
                       "share_below_1e-6": float((res7.err < 1e-6).double()
                                                 .mean())}}
    clik7_ref = (res7.q[:ARM_REF].cpu(), res7.err[:ARM_REF].cpu())
    del res6, res7

    # (d) the plant under the solve's first controls, and the stiff suite
    xs_plant, t_plant = timed(lambda: arm_plant(
        on(x0_np, f64), us[:, 0].to(f64), graph_steps=1))
    ivp = {"plant_rk4": {"B": ARM_B, "steps": H, "ms": t_plant,
                         "graph_steps": 1,
                         "finite": bool(torch.isfinite(xs_plant).all())}}
    del xs_plant
    ivp.update(stiff)
    ph["integrators"] = ivp

    # (e) sorting, tensors and forces
    srng = np.random.default_rng(41)
    xs_np = srng.standard_normal((SORT_B, SORT_N)).astype(np.float32)
    xs_np[:, ::7] = xs_np[:, ::7].round(1)  # ties
    x_s = on(xs_np, f32)
    ref_sort = torch.sort(x_s, dim=-1, stable=True)
    sort_ms = {}
    got_s, sort_ms["bitonic_sort"] = timed(lambda: sorting.bitonic_sort(x_s))
    got_a, sort_ms["bitonic_argsort"] = timed(
        lambda: sorting.bitonic_argsort(x_s))
    (got_k, got_v), sort_ms["bitonic_sort_kv"] = timed(
        lambda: sorting.bitonic_sort_kv(x_s, 3.0 * x_s))
    sort_ms["torch_sort_stable"] = cuda_ms(
        lambda: torch.sort(x_s, dim=-1, stable=True), reps=5)
    prim = on(srng.integers(0, 5, (SORT_B, SORT_N)), f32)
    x_c, prim_c = x_s.cpu(), prim.cpu()
    surface = {
        "lexsort_2key": (sorting.lexsort_2key(prim, x_s),
                         sorting.lexsort_2key(prim_c, x_c)),
        "median_partition": (sorting.median_partition(x_s),
                             sorting.median_partition(x_c)),
        "median_partition_even": (sorting.median_partition(x_s[:, :-1]),
                                  sorting.median_partition(x_c[:, :-1])),
        "top_k": (sorting.top_k(x_s, 16), sorting.top_k(x_c, 16)),
        "smallest_k": (sorting.smallest_k(x_s, 16),
                       sorting.smallest_k(x_c, 16))}
    equal = lambda a, b: all(torch.equal(u.cpu(), v) for u, v in zip(
        a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple)
        else (b,)))
    T_np = np.random.default_rng(43).standard_normal((32, 24, 16))
    T_d, T_c = on(T_np, f64), torch.as_tensor(T_np)
    (core, Us), t_hosvd = timed(lambda: tensors.hosvd(T_d))
    rec_d = tensors.tucker_reconstruct(core, Us)
    rec_c = tensors.tucker_reconstruct(*tensors.hosvd(T_c))
    (w_cp, F_cp), t_cp = timed(lambda: tensors.cp_als(T_d, rank=8,
                                                     n_iters=50))
    cp_d = tensors.cp_reconstruct(w_cp, F_cp)
    cp_c = tensors.cp_reconstruct(*tensors.cp_als(T_c, rank=8, n_iters=50))
    q_f = on(np.random.default_rng(47).uniform(-1.2, 1.2, (ARM_B, 7)), f64)
    f_f = on(np.random.default_rng(48).standard_normal((ARM_B, 3)), f64)
    pt = [0.0, 0.0, 0.15]
    tau_f, t_tau = timed(lambda: vmap(lambda q_, f_: forces.world_force_to_tau(
        ssrms, q_, 6, pt, f_))(q_f, f_f))
    tau_fc = vmap(lambda q_, f_: forces.world_force_to_tau(
        ssrms, q_, 6, pt, f_))(q_f.cpu(), f_f.cpu())
    ph["sorting_tensors_forces"] = {
        "sort_shape": [SORT_B, SORT_N], "sort_dtype": "float32",
        "ms": {**sort_ms, "hosvd": t_hosvd, "cp_als": t_cp,
               "world_force_to_tau": t_tau},
        "bitonic_sort_bitwise": torch.equal(got_s, ref_sort.values),
        "bitonic_argsort_bitwise": torch.equal(got_a, ref_sort.indices),
        "bitonic_sort_kv_bitwise": torch.equal(got_k, ref_sort.values)
        and torch.equal(got_v, torch.take_along_dim(3.0 * x_s,
                                                    ref_sort.indices, -1)),
        "equal_to_cpu": {k: equal(*v) for k, v in surface.items()},
        "hosvd_rec_abs_vs_cpu": abs_err(rec_d.cpu(), rec_c),
        "hosvd_rec_abs_vs_tensor": abs_err(rec_d, T_d),
        "cp_als_rank": 8, "cp_als_sweeps": 50,
        "cp_als_rec_rel_vs_cpu": rel_err(cp_d.cpu(), cp_c),
        "cp_als_fit": float(torch.linalg.vector_norm(cp_d - T_d)
                            / torch.linalg.vector_norm(T_d)),
        "world_force_to_tau_abs_vs_cpu": abs_err(tau_f.cpu(), tau_fc)}
    del x_s, got_s, got_a, got_k, got_v, ref_sort, prim, surface

    # the CPU child's references, then the checks
    ph["card_seconds"] = time.perf_counter() - t_phase
    refs = cpu_refs()
    ph["ssrms_solve"]["max_abs_u_vs_cpu_f64"] = abs_err(
        us[:N_REF].cpu(), torch.as_tensor(refs["arm_us"]))
    ph["ssrms_solve"]["reference_scenarios"] = N_REF
    ph["ik"]["clik_ssrms"]["q_abs_vs_cpu"] = abs_err(
        clik7_ref[0], torch.as_tensor(refs["arm_clik_q"]))
    ph["ik"]["clik_ssrms"]["err_abs_vs_cpu"] = abs_err(
        clik7_ref[1], torch.as_tensor(refs["arm_clik_err"]))
    # the plant on the child's first states under its f64 solve's controls
    ivp["plant_rk4"]["rel_vs_cpu"] = rel_err(arm_plant(
        on(x0_np[:ARM_REF], f64), on(refs["arm_us"][:ARM_REF, 0], f64),
        graph_steps=1).cpu(), torch.as_tensor(refs["arm_plant"]))
    emit(ph)
    for key, c in chains.items():
        check(c["launches"] == [1, 1], f"{key} did not launch K1 and K5 once")
        check(c["finite"], f"{key}: K1 or K5 outputs are not finite")
        for k in ("k1_f64_rel", "k5_f64_rel"):
            check(c[k] <= 1e-9, f"{key} {k} {c[k]:.2e} above 1e-9")
    uv = ph["uav_kinematics"]
    check(uv["launches"]["kte_step"] == 0 and uv["launches"]["kte_core"] == 0,
          f"uav_kinematics launched K1 or K5: {uv['launches']}")
    check(uv["finite"] and uv["rel_vs_cpu"] <= 1e-12,
          f"uav_kinematics' step and LTV: {uv}")
    so = ph["ssrms_solve"]
    want = {k: {"kte_step": H, "pdip_whole": 1}.get(k, 0)
            for k in so["launches"]}
    check(so["launches"] == want, f"the arm's solve launched {so['launches']}")
    check(so["finite"], "the arm's solve is not finite")
    check(so["max_abs_u_vs_cpu_f64"] <= 1e-3,
          f"the arm's f32 controls {so['max_abs_u_vs_cpu_f64']:.2e} from "
          "the plain f64 solve")
    for name, r in ph["ik"]["round_trip_max"].items():
        for k, e in r.items():
            check(e <= 1e-9, f"{name}: FK(IK(pose)) {k} error {e:.2e}")
    c6, c7 = ph["ik"]["clik_3r3r"], ph["ik"]["clik_ssrms"]
    check(c6["max_err_first_16"] < 1e-6 and c6["share_below_1e-6"] >= 0.99,
          f"3R3R CLIK: {c6}")
    check(c7["share_below_1e-6"] >= 0.99, f"SSRMS CLIK: {c7}")
    check(c7["q_abs_vs_cpu"] <= 1e-8, "SSRMS CLIK against the CPU child")
    check(ivp["plant_rk4"]["finite"] and ivp["plant_rk4"]["rel_vs_cpu"]
          <= 1e-9, f"the arm's plant: {ivp['plant_rk4']}")
    for key, r in ivp.items():
        if "bar" in r:
            check(r.get("ok", True) and r["endpoint_rel_err"] < r["bar"],
                  f"{key}: {r}")
    check(ivp["rosenbrock_ROBER"]["mass_err"] < 1e-7, "ROBER's mass")
    mz = ivp["rosenbrock_MEDAKZO"]
    check(mz["lead_rel_err"] < 2e-3 and mz["far_v_err"] <= 1e-8
          and mz["far_u_max"] < 1e-8, f"MEDAKZO: {mz}")
    st = ph["sorting_tensors_forces"]
    for k in ("bitonic_sort_bitwise", "bitonic_argsort_bitwise",
              "bitonic_sort_kv_bitwise"):
        check(st[k], f"{k} is false")
    for k, v in st["equal_to_cpu"].items():
        check(v, f"{k} differs from the CPU's")
    check(st["hosvd_rec_abs_vs_cpu"] <= 1e-10, "hosvd against the CPU")
    check(st["cp_als_rec_rel_vs_cpu"] <= 1e-8, "cp_als against the CPU")
    check(st["world_force_to_tau_abs_vs_cpu"] <= 1e-12,
          "world_force_to_tau against the CPU")
    return c6["share_below_1e-6"]


# ---- phase optimizers_geometry: the optimization toolbox (opt/*), the
# geometry (geom/*) and the profiler (io/profiling) ------------------------
# OG_B problems of each optimizer family and OG_B configurations of each
# scene; the first OG_REF of each held to the CPU child's plain f64 run, the
# first OG_LP_REF LPs to scipy's linprog (HiGHS) in the child; problem
# OG_NAN of the F14 run made non-finite
OG_B, OG_REF, OG_LP_REF, OG_NAN = 8192, 256, 64, 17
# the fit of tests/test_opt.py:99-110 (y = exp(b t), 20 times on [0, 1])
OG_FIT_T = np.linspace(0.0, 1.0, 20)
# the optimizers that leave some of these draws outside their reference
# test's bar (nonlinear CG stops mid-valley, Newton runs off from starts
# where the shifted Hessian is nearly singular, as the JAX package does):
# their share is printed, and Newton's runs off on paths that the last bits
# of eigvalsh decide, so it is held to the CPU on the problems that meet
# the bar on both
OG_UNCONVERGED = ("nonlinear_cg_fr", "nonlinear_cg_pr", "newton_method")
# the card against the CPU for fd_gradient, fd_jacobian and fd_hessian:
# a central difference divides a last-bit difference of f (CUDA's sin and
# the CPU's differ by an ulp, ~9e-16 at |f| ≤ 3.75) by 2 eps = 2e-4, and
# the Hessian's difference of differences by eps² = 1e-8 once more (≈ 9e-8;
# 7.5e-9 on an H100)
OG_FD_BARS = (1e-9, 1e-9, 1e-7)


def random_standard_lp(rng, m, n):
    """tests/test_lp.py:21-32's draw: a feasible, bounded standard-form LP
    (x* > 0, reduced costs ≥ 0 with m of them zero)."""
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.5, 2.0, n)
    y = rng.standard_normal(m)
    s = rng.uniform(0.1, 1.0, n)
    s[rng.choice(n, size=m, replace=False)] = 0.0
    return A, b, A.T @ y + s


def og_draws(batch=None):
    """The optimizer problems' parameters and the scenes' configurations,
    numpy seed 0, drawn in this order; the LPs last, one after another as
    tests/test_lp.py draws them."""
    batch = batch or OG_B
    rng = np.random.default_rng(0)
    d = {"bisection_a": rng.uniform(0.8, 1.25, batch),     # cos x − a x
         "cubic_c": rng.uniform(4.0, 6.0, batch),          # x³ − 2x − c
         "exp_c": rng.uniform(1.5, 3.0, batch),            # eˣ − c
         "square_c": rng.uniform(1.0, 3.0, batch),         # x² − c
         "broyden_r2": rng.uniform(2.0, 6.0, batch),       # |x|² = r², x₀ = x₁
         "golden_m": rng.uniform(0.5, 2.5, batch),         # (x − m)² on [0, 3]
         "dichotomous_m": rng.uniform(-0.5, 0.5, batch),   # |x − m| on [−1, 1]
         "wolfe_m": rng.uniform(1.0, 3.0, (batch, 2)),     # |x − m|² from 0
         "fit_b": rng.uniform(-2.0, -0.5, batch),          # y = exp(b t)
         "rosenbrock_x0": np.array([-1.2, 1.0])
         + rng.uniform(-0.2, 0.2, (batch, 2)),
         "nelder_mead_c": np.array([0.3, -0.7, 1.1])
         + rng.uniform(-0.3, 0.3, (batch, 3)),
         "al_eq_s": rng.uniform(0.5, 2.0, batch),          # x₀ + x₁ = s
         "al_ineq_m": rng.uniform(1.5, 3.0, batch),        # (x − m)², x ≤ 1
         "sqp_rho": rng.uniform(1.5, 3.0, batch),          # x₀² + x₁² = ρ
         "barrier_m": rng.uniform(0.5, 2.0, batch),        # (x + m)², x ≥ 0
         "fd_x": rng.uniform(-1.5, 1.5, (batch, 3)),
         "scene_q": rng.uniform(-2.8, 2.8, (batch, 6)),
         "planar_q": rng.uniform(-np.pi, np.pi, (batch, 2))}
    lps = [random_standard_lp(rng, 4, 9) for _ in range(batch)]
    d["lp_A"], d["lp_b"], d["lp_c"] = (np.stack(x) for x in zip(*lps))
    return d


def clik3_draws(batch=None):
    """The 3R3R CLIK's configurations and starts of phase
    arms_ik_integrators (numpy seed 31, after that phase's round-trip and
    SCARA draws)."""
    batch = batch or ARM_B
    irng = np.random.default_rng(31)
    irng.uniform(-1.2, 1.2, (batch, 6))
    irng.uniform(-1.2, 1.2, (batch, 7))
    for lim in (np.pi, 2.5, 0.2):
        irng.uniform(-lim, lim, batch)
    q = irng.uniform(-0.8, 0.8, (batch, 6))
    return q, q + 0.1 * irng.standard_normal((batch, 6))


def optimizer_families(d, device, n=None):
    """{family: run} of the optimizer families on the first ``n`` draws of
    ``d`` (f64 on ``device``): ``run()`` solves the family's batch under
    one torch.func.vmap and returns its outputs as a tuple."""
    from torch.func import vmap

    from reak_tpu_torch import opt
    from reak_tpu_torch.kte import ik, models
    from reak_tpu_torch.math import rotations as rot
    from reak_tpu_torch.opt import lp

    t = lambda k: torch.as_tensor(d[k][:n], dtype=torch.float64,
                                  device=device).contiguous()
    fit_t = torch.as_tensor(OG_FIT_T, device=device)
    z = lambda c: 0.0 * c  # a batched zero (starts that are constants)

    def fit(b):
        return lambda p: p[0] * torch.exp(p[1] * fit_t) - torch.exp(b * fit_t)

    def fit_start(b):
        return torch.stack([z(b) + 0.8, z(b) - 0.1])

    def result(r):
        return tuple(r) if isinstance(r, tuple) else (r,)

    arm = models.manip_3r3r()
    nb = len(d["bisection_a"][:n])
    q_t, q_0 = (torch.as_tensor(a[:nb], device=device)
                for a in clik3_draws())

    def ik_residual(p_t, quat_t):
        def r(theta):
            p, quat = ik.ee_pose(arm, theta)
            return torch.cat([p - p_t, rot.qmul(rot.qconj(quat_t),
                                                quat)[1:]])
        return r

    fams = {
        "bisection": lambda: vmap(lambda a: opt.bisection(
            lambda x: torch.cos(x) - a * x, z(a), z(a) + 1.5))(
                t("bisection_a")),
        "secant": lambda: vmap(lambda c: opt.secant(
            lambda x: x ** 3 - 2 * x - c, z(c) + 2.0, z(c) + 3.0))(
                t("cubic_c")),
        "illinois": lambda: vmap(lambda c: opt.illinois(
            lambda x: x ** 3 - 2 * x - c, z(c) + 1.0, z(c) + 3.0))(
                t("cubic_c")),
        "ridders": lambda: vmap(lambda c: opt.ridders(
            lambda x: torch.exp(x) - c, z(c), z(c) + 2.0))(t("exp_c")),
        "brent": lambda: vmap(lambda c: opt.brent(
            lambda x: torch.exp(x) - c, z(c), z(c) + 2.0))(t("exp_c")),
        "newton_raphson": lambda: vmap(lambda c: opt.newton_raphson(
            lambda x: x * x - c, z(c) + 1.0))(t("square_c")),
        "broyden": lambda: vmap(lambda r2: opt.broyden(
            lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - r2, x[0] - x[1]]),
            torch.stack([z(r2) + 1.0, z(r2) + 2.0]), iters=60))(
                t("broyden_r2")),
        "golden_section": lambda: vmap(lambda m: opt.golden_section(
            lambda x: (x - m) ** 2, z(m), z(m) + 3.0))(t("golden_m")),
        "dichotomous_search": lambda: vmap(lambda m: opt.dichotomous_search(
            lambda x: torch.abs(x - m), z(m) - 1.0, z(m) + 1.0))(
                t("dichotomous_m")),
        "wolfe_zoom": lambda: vmap(lambda m: opt.wolfe_zoom(
            lambda x: (torch.sum((x - m) ** 2), 2.0 * (x - m)), z(m),
            2.0 * m, torch.sum(m * m), -2.0 * m))(t("wolfe_m")),
        "backtracking_armijo": lambda: vmap(
            lambda m: opt.backtracking_armijo(
                lambda x: torch.sum((x - m) ** 2), z(m), 2.0 * m,
                torch.sum(m * m), -2.0 * m))(t("wolfe_m")),
        "gauss_newton": lambda: vmap(lambda b: opt.gauss_newton(
            fit(b), fit_start(b), iters=25))(t("fit_b")),
        "levenberg_marquardt": lambda: vmap(lambda b: opt.levenberg_marquardt(
            fit(b), fit_start(b), iters=40))(t("fit_b")),
        "jacobian_transpose": lambda: vmap(lambda b: opt.jacobian_transpose(
            fit(b), fit_start(b), iters=300))(t("fit_b")),
        "lm_ik_3r3r": lambda: vmap(
            lambda qt, q0: opt.levenberg_marquardt(
                ik_residual(*ik.ee_pose(arm, qt)), q0, iters=40))(q_t, q_0),
        "bfgs": lambda: vmap(lambda x0: opt.bfgs(_rosenbrock, x0, iters=120))(
            t("rosenbrock_x0")),
        "nonlinear_cg_fr": lambda: vmap(lambda x0: opt.nonlinear_cg(
            _rosenbrock, x0, iters=400, variant="fr"))(t("rosenbrock_x0")),
        "nonlinear_cg_pr": lambda: vmap(lambda x0: opt.nonlinear_cg(
            _rosenbrock, x0, iters=1600, variant="pr"))(t("rosenbrock_x0")),
        "newton_method": lambda: vmap(lambda x0: opt.newton_method(
            _rosenbrock, x0, iters=60))(t("rosenbrock_x0")),
        "sr1_trust_region": lambda: vmap(lambda x0: opt.sr1_trust_region(
            _rosenbrock, x0, iters=200))(t("rosenbrock_x0")),
        "nelder_mead": lambda: vmap(lambda c: opt.nelder_mead(
            lambda x: torch.sum((x - c) ** 2), z(c), iters=300))(
                t("nelder_mead_c")),
        "augmented_lagrangian_eq": lambda: vmap(
            lambda s: opt.augmented_lagrangian(
                lambda x: torch.sum(x ** 2), torch.stack([z(s), z(s)]),
                ce=lambda x: torch.stack([x[0] + x[1] - s])))(t("al_eq_s")),
        "augmented_lagrangian_ineq": lambda: vmap(
            lambda m: opt.augmented_lagrangian(
                lambda x: torch.sum((x - m) ** 2), z(m)[None],
                ci=lambda x: torch.stack([1.0 - x[0]])))(t("al_ineq_m")),
        "sqp_equality": lambda: vmap(lambda rho: opt.sqp_equality(
            lambda x: x[0] + x[1],
            lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - rho]),
            torch.stack([z(rho) + 1.5, z(rho) + 0.1]), iters=40))(
                t("sqp_rho")),
        "log_barrier": lambda: vmap(lambda m: opt.log_barrier(
            lambda x: torch.sum((x + m) ** 2), lambda x: x,
            (z(m) + 0.5)[None]))(t("barrier_m")),
        "solve_lp": lambda: vmap(lambda A, b, c: lp.solve_lp(
            A, b, c, iters=40))(t("lp_A"), t("lp_b"), t("lp_c")),
        "fd": lambda: vmap(lambda x: (
            opt.fd_gradient(_fd_f, x, eps=1e-4, order=4),
            opt.fd_jacobian(_fd_v, x, eps=1e-4),
            opt.fd_hessian(_fd_f, x)))(t("fd_x")),
    }
    return {k: (lambda run=run: result(run())) for k, run in fams.items()}


def _rosenbrock(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _fd_f(x):
    return torch.sin(x[0]) * x[1] ** 2 + x[2]


def _fd_v(x):
    return torch.stack([x[0] * x[1], torch.cos(x[2])])


def nan_newton(d, device, n=None):
    """newton_method at 60 iterations on the Rosenbrock starts with start
    OG_NAN made NaN (F14 on the card)."""
    from torch.func import vmap

    from reak_tpu_torch import opt

    x0 = torch.as_tensor(d["rosenbrock_x0"][:n], device=device).clone()
    x0[OG_NAN, 0] = float("nan")
    return vmap(lambda x: opt.newton_method(_rosenbrock, x, iters=60))(x0)


def scene_models(scene, device, dtype):
    """(chain, robot shapes, environment) of a scene, as tensors of
    ``dtype`` on ``device``.  "A": examples/run_crs_planner.py:47-75 —
    manip_3r3r's chain capsules (r = 0.05; from each body's origin to the
    next joint, a 0.06 tool stub on the last), the sphere obstacle and the
    floor plane.  "B": A plus a box (half extents 0.12, 0.08, 0.10 at
    (−0.35, 0.25, 0.45), turned 0.5 rad about (1, 1, 0)/√2) and a
    flat-capped cylinder (r = 0.08 from (0.1, −0.45, 0.2) to (0.1, −0.45,
    0.7)).  "planar": planar_2link (0.4, 0.3) with capped-rectangle links
    (tests/test_geom2d.py:172-197) against that test's circle and a
    rectangle (half 0.12 × 0.06 at (−0.3, 0.45), 0.4 rad)."""
    from reak_tpu_torch.geom import proximity as prox, proximity2d as p2
    from reak_tpu_torch.geom import shapes as sh, shapes2d as s2
    from reak_tpu_torch.kte import models

    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    if scene == "planar":
        robot = s2.ShapeSet2D(
            crects=s2.CappedRectangle(t([[0.2, 0.0], [0.15, 0.0]]),
                                      t([0.0, 0.0]), t([0.2, 0.15]),
                                      t([0.05, 0.05])),
            crect_body=torch.tensor([0, 1], device=device))
        env = p2.ProxyModel2D(
            circles=s2.Circle(t([[0.55, 0.0]]), t([0.1])),
            rects=s2.Rectangle(t([[-0.3, 0.45]]), t([0.4]),
                               t([[0.12, 0.06]])))
        return models.planar_2link(l1=0.4, l2=0.3), robot, env
    spec = models.manip_3r3r()
    nb = spec.n_joints
    offs = np.asarray(spec.offsets_pos, float)
    robot = sh.ShapeSet(
        capsules=sh.Capsule(t(np.zeros((nb, 3))),
                            t(np.vstack([offs[1:], [[0.0, 0.0, 0.06]]])),
                            t(np.full(nb, 0.05))),
        capsule_body=torch.arange(nb, device=device))
    env = dict(spheres=sh.Sphere(t([[0.35, 0.0, 0.55]]), t([0.18])),
               planes=sh.Plane(t([[0.0, 0.0, 1.0]]), t([-0.12])))
    if scene == "B":
        h = 0.25
        axis = np.array([1.0, 1.0, 0.0]) / np.sqrt(2.0)
        env["boxes"] = sh.Box(
            t([[-0.35, 0.25, 0.45]]),
            t([[np.cos(h), *(np.sin(h) * axis)]]), t([[0.12, 0.08, 0.10]]))
        env["cylinders"] = sh.Cylinder(t([[0.1, -0.45, 0.2]]),
                                       t([[0.1, -0.45, 0.7]]), t([0.08]))
    return spec, robot, prox.ProxyModel(**env)


def scene_clearance(scene, q):
    """Signed clearance of each configuration q (B, nq) of a scene, composed
    as planning/workspace.py:113-121 (3-D) and :227-241 (planar) compose it:
    kte.fk → pose_shapes → proxy_query under one torch.func.vmap over q,
    closing over the shapes."""
    from torch.func import vmap

    from reak_tpu_torch import kte
    from reak_tpu_torch.geom import proximity as prox, proximity2d as p2
    from reak_tpu_torch.geom import shapes as sh, shapes2d as s2

    spec, robot, env = scene_models(scene, q.device, q.dtype)

    def one(x):
        res = kte.fk(spec, x)
        if scene == "planar":
            ang = 2.0 * torch.atan2(res.body_quat[:, 3], res.body_quat[:, 0])
            posed = s2.pose_shapes_2d(robot, res.body_pos[:, :2], ang)
            return p2.proxy_query_2d(p2.ProxyModel2D.from_shapes(posed), env)
        posed = sh.pose_shapes(robot, res.body_pos, res.body_quat)
        return prox.proxy_query(prox.ProxyModel(
            spheres=posed.spheres, capsules=posed.capsules,
            boxes=posed.boxes, cylinders=posed.cylinders), env)

    return vmap(one)(q)


def optimizers_geometry_references():
    """Phase optimizers_geometry's plain f64 references on CPU tensors: every
    optimizer family on the first OG_REF problems (``og_<family>_<i>``),
    the scenes' clearances at the first OG_REF
    configurations (``og_scene_<scene>``) and scipy's linprog (HiGHS) on the
    first OG_LP_REF LPs (``og_linprog``)."""
    from scipy.optimize import linprog

    d = og_draws()
    out = {}
    for name, run in optimizer_families(d, "cpu", OG_REF).items():
        for i, a in enumerate(run()):
            out[f"og_{name}_{i}"] = a.numpy()
    for scene, qk in (("A", "scene_q"), ("B", "scene_q"),
                      ("planar", "planar_q")):
        out[f"og_scene_{scene}"] = scene_clearance(
            scene, torch.as_tensor(d[qk][:OG_REF])).numpy()
    out["og_linprog"] = np.array([
        linprog(d["lp_c"][i], A_eq=d["lp_A"][i], b_eq=d["lp_b"][i],
                bounds=(0, None), method="highs").fun
        for i in range(OG_LP_REF)])
    return out


def _newton_roots(f, df, x0, iters=60):
    """numpy Newton iterations: the exact roots the root finders' bars are
    measured from."""
    x = np.array(x0, np.float64)
    for _ in range(iters):
        x = x - f(x) / df(x)
    return x


def optimizer_bars(name, out, d, dev):
    """(per-problem mask of the family's reference-test bar, worst error)
    for the outputs ``out`` of one family on all of ``d``'s problems."""
    from torch.func import grad, hessian, jacfwd, vmap

    o = [a.double().cpu().numpy() for a in out]
    a_b = d["bisection_a"]
    cubic = _newton_roots(lambda x: x ** 3 - 2 * x - d["cubic_c"],
                          lambda x: 3 * x ** 2 - 2, np.full(OG_B, 2.0))
    fit_x = np.stack([np.ones(OG_B), d["fit_b"]], 1)
    exact = {
        "bisection": (_newton_roots(lambda x: np.cos(x) - a_b * x,
                                    lambda x: -np.sin(x) - a_b,
                                    np.full(OG_B, 0.7)), 1e-9),
        "secant": (cubic, 1e-8), "illinois": (cubic, 1e-8),
        "ridders": (np.log(d["exp_c"]), 1e-8),
        "brent": (np.log(d["exp_c"]), 1e-6),
        "golden_section": (d["golden_m"], 1e-7),
        "dichotomous_search": (d["dichotomous_m"], 1e-5),
        "gauss_newton": (fit_x, 1e-5), "levenberg_marquardt": (fit_x, 1e-5),
        "jacobian_transpose": (fit_x, 1e-5),
        "bfgs": (np.ones((OG_B, 2)), 2e-3),
        "nonlinear_cg_fr": (np.ones((OG_B, 2)), 2e-3),
        "nonlinear_cg_pr": (np.ones((OG_B, 2)), 2e-3),
        "newton_method": (np.ones((OG_B, 2)), 2e-3),
        "sr1_trust_region": (np.ones((OG_B, 2)), 2e-3),
        "nelder_mead": (d["nelder_mead_c"], 1e-4),
        "augmented_lagrangian_eq": (
            np.repeat(d["al_eq_s"][:, None] / 2, 2, 1), 1e-5),
        "augmented_lagrangian_ineq": (np.ones((OG_B, 1)), 1e-4),
        "sqp_equality": (np.repeat(-np.sqrt(d["sqp_rho"][:, None] / 2), 2,
                                   1), 1e-5),
        "log_barrier": (np.zeros((OG_B, 1)), 1e-3)}
    if name in exact:
        want, bar = exact[name]
        err = np.abs(o[0] - want).reshape(OG_B, -1).max(1)
        ok = err <= bar
        if name == "augmented_lagrangian_eq":
            ok &= o[2] < 1e-6
        return ok, float(err.max())
    if name == "broyden":
        # two roots, ±√(r²/2)(1, 1): the distance to the nearer one
        root = np.sqrt(d["broyden_r2"] / 2)[:, None]
        err = np.minimum(np.abs(o[0] - root), np.abs(o[0] + root)).max(1)
        return err <= 1e-7, float(err.max())
    if name == "newton_raphson":
        err = np.abs(o[0] - np.sqrt(d["square_c"])) / np.sqrt(d["square_c"])
        return err <= 1e-12, float(err.max())
    if name in ("wolfe_zoom", "backtracking_armijo"):
        f0 = np.sum(d["wolfe_m"] ** 2, 1)
        return o[1] < f0, float(np.max(o[1] - f0))
    if name == "lm_ik_3r3r":
        return o[1] < 1e-6, float(o[1].max())
    if name == "solve_lp":
        res = np.maximum(o[5], o[6])
        return res < 1e-7, float(res.max())
    if name == "fd":
        x = torch.as_tensor(d["fd_x"], device=dev)
        refs = (vmap(grad(_fd_f))(x), vmap(jacfwd(_fd_v))(x),
                vmap(hessian(_fd_f))(x))
        err = np.max([np.abs(a - r.cpu().numpy()).reshape(OG_B, -1).max(1)
                      for a, r in zip(o, refs)], axis=0)
        return err <= 1e-5, float(err.max())
    raise KeyError(name)


def scaled_err(got, ref):
    """max |got − ref| over max(max |ref|, 1): relative to the size of the
    reference, absolute for outputs that converge to 0 (residual and
    gradient norms, duality gaps), whose relative error means nothing."""
    ref = ref.double()
    return float((got.double() - ref).abs().max()
                 / max(float(ref.abs().max()), 1.0))


def optimizers_geometry(card, dev):
    """Phase optimizers_geometry, on the card: (a) every optimizer family
    of ``optimizer_families`` at OG_B problems, f64, each under one
    torch.func.vmap, timed; each problem against its reference test's bar
    (all problems, but for OG_UNCONVERGED, whose share is printed, and the
    LM IK, held to CLIK's ≥ 99 % below 1e-6); the first OG_REF problems
    ≤1e-9 of the CPU child's plain f64 run (``scaled_err``; Newton on the
    problems that meet the bar on both; the finite differences at
    OG_FD_BARS), the first OG_LP_REF LP objectives
    ≤1e-5 relative of scipy's linprog; newton_method once more with
    problem OG_NAN non-finite: that problem NaN, the others bit for bit the
    clean run (F14 on the card); (b) the scenes' clearances
    (``scene_models``) at OG_B configurations in f64 and f32: f64 ≤1e-9
    absolute of the CPU child's on the first OG_REF; f32 ≤1e-3 of f64 with
    the same sign where |d| > 1e-3, except where the f64 clearance is an
    overlap (< −1e-6) in scene B: there the depth is signed_pair's
    subgradient estimate, whose path the rounding decides (its JAX
    counterpart differs between jax.jit and op by op;
    tests/test_torch_geom.py), held to the sign and 1e-2; the colliding
    share printed; (c) an ExecTimeProfiler section around each part, its
    report on a line of its own.  Runs the card's work and returns
    ``finish(refs, clik_share)``, which holds it to the child's
    ``optimizers_geometry_references()`` in ``refs``, prints the phase and
    checks it (so that the card's work runs before the wait for the
    child)."""
    from reak_tpu_torch.io import profiling

    t_phase = time.perf_counter()
    prof = profiling.ExecTimeProfiler()
    d = og_draws()
    ph = {"phase": "optimizers_geometry", "card": card, "B": OG_B,
          "dtype": "float64", "optimizers": {}, "scenes": {}}
    outs = {}
    for name, run in optimizer_families(d, dev).items():
        with prof.section(name):
            outs[name], ms = timed(run)
        ok, worst = optimizer_bars(name, outs[name], d, dev)
        ph["optimizers"][name] = {"ms": ms, "share_meeting_bar":
                                  float(ok.mean()), "worst": worst}
    with prof.section("newton_method_nan"):
        nan_res, ms = timed(lambda: nan_newton(d, dev))
    clean = outs["newton_method"]
    others = [i for i in range(OG_B) if i != OG_NAN]
    ph["newton_method_nan"] = {
        "ms": ms, "problem": OG_NAN,
        "nan_problem_all_nan": all(bool(torch.isnan(a[OG_NAN]).all())
                                   for a in nan_res),
        "others_bitwise_clean": all(torch.equal(a[others], b[others])
                                    for a, b in zip(nan_res, clean))}
    q = {k: torch.as_tensor(d[k], device=dev) for k in ("scene_q",
                                                        "planar_q")}
    clear = {}
    for scene, qk in (("A", "scene_q"), ("B", "scene_q"),
                      ("planar", "planar_q")):
        row = {}
        for dt, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            with prof.section(f"scene_{scene}_{tag}"):
                clear[scene, tag], row[f"{tag}_ms"] = timed(
                    lambda: scene_clearance(scene, q[qk].to(dt)))
        d64, d32 = clear[scene, "f64"], clear[scene, "f32"].double()
        depth = (d64 < -1e-6) if scene == "B" else torch.zeros_like(
            d64, dtype=torch.bool)
        big = d64.abs() > 1e-3
        row.update(
            colliding_share=float((d64 < 0).double().mean()),
            finite=bool(torch.isfinite(d64).all()
                        and torch.isfinite(d32).all()),
            f32_max_abs_vs_f64=abs_err(d32[~depth], d64[~depth]),
            f32_sign_flips=int(((d32 < 0) != (d64 < 0))[big].sum()))
        if scene == "B":
            row["overlap_share"] = float(depth.double().mean())
            row["f32_max_abs_vs_f64_overlaps"] = abs_err(d32[depth],
                                                         d64[depth])
        ph["scenes"][scene] = row
    ph["card_seconds"] = time.perf_counter() - t_phase
    emit({"phase": "optimizers_geometry.profile", "card": card,
          "report": prof.report().splitlines()})
    return lambda refs, clik_share: _og_finish(ph, outs, clear, refs,
                                               clik_share)


def _og_finish(ph, outs, clear, refs, clik_share):
    """optimizers_geometry's comparisons with the CPU child, its line (the
    LM IK's share below 1e-6 beside ``clik_share``, phase
    arms_ik_integrators' 3R3R CLIK on the same targets) and its checks."""
    for name, out in outs.items():
        row = ph["optimizers"][name]
        ref = [torch.as_tensor(refs[f"og_{name}_{i}"])
               for i in range(len(out))]
        got = [a[:OG_REF].cpu() for a in out]
        if name == "newton_method":
            # the problems at the test's bar on both the card and the CPU
            at_bar = lambda x: (x - 1.0).abs().amax(1) < 2e-3
            both = at_bar(got[0]) & at_bar(ref[0])
            row["problems_at_bar_card_cpu_both"] = [
                int(at_bar(got[0]).sum()), int(at_bar(ref[0]).sum()),
                int(both.sum())]
            got, ref = [a[both] for a in got], [a[both] for a in ref]
        row["rel_vs_cpu"] = [scaled_err(a, b) for a, b in zip(got, ref)]
    row = ph["optimizers"]["lm_ik_3r3r"]
    row["share_below_1e-6"] = row["share_meeting_bar"]
    row["clik_3r3r_share_below_1e-6"] = clik_share
    lp_obj = outs["solve_lp"][3][:OG_LP_REF].cpu().numpy()
    ph["optimizers"]["solve_lp"]["obj_rel_vs_linprog"] = float(np.max(
        np.abs(lp_obj - refs["og_linprog"]) / np.abs(refs["og_linprog"])))
    for scene in ("A", "B", "planar"):
        ph["scenes"][scene]["f64_abs_vs_cpu"] = abs_err(
            clear[scene, "f64"][:OG_REF].cpu(),
            torch.as_tensor(refs[f"og_scene_{scene}"]))
    emit(ph)
    for name, row in ph["optimizers"].items():
        bars = OG_FD_BARS if name == "fd" else (1e-9,) * len(
            row["rel_vs_cpu"])
        check(all(e <= b for e, b in zip(row["rel_vs_cpu"], bars)),
              f"{name} against the CPU: {row}")
        if name == "lm_ik_3r3r":
            check(row["share_below_1e-6"] >= 0.99, f"the LM IK: {row}")
        elif name not in OG_UNCONVERGED:
            check(row["share_meeting_bar"] == 1.0,
                  f"{name}: a problem misses its test's bar: {row}")
    check(ph["optimizers"]["solve_lp"]["obj_rel_vs_linprog"] <= 1e-5,
          "the LP objectives against scipy's linprog")
    nm = ph["newton_method_nan"]
    check(nm["nan_problem_all_nan"] and nm["others_bitwise_clean"],
          f"newton_method with one non-finite problem: {nm}")
    for scene, row in ph["scenes"].items():
        check(row["finite"], f"scene {scene}: clearances not finite")
        check(row["f64_abs_vs_cpu"] <= 1e-9,
              f"scene {scene}: f64 against the CPU: {row}")
        check(row["f32_max_abs_vs_f64"] <= 1e-3
              and row["f32_sign_flips"] == 0
              and row.get("f32_max_abs_vs_f64_overlaps", 0.0) <= 1e-2,
              f"scene {scene}: f32 against f64: {row}")


# phase interp_spaces_io: the 6-DoF CRS-A465 arm manip_3r3r in joint space
# (bounds ±2.8 rad, examples/run_crs_planner.py:66-67; speed 1.5 rad/s, the
# interception query's v_max, :155; accel twice the speed, the ratio of
# tests/test_tangent_spaces.py:61-62; jerk = accel, spaces/tangent.py's
# default); ISI_B state pairs (numpy seed 0) at f64 and f32, interpolated at
# ISI_FRACS fractions, the first ISI_REF held to the CPU child; the JAX
# tests' bars checked on dense sweeps of tests/test_pulses.py's grids
# (ISI_DENSE samples: 257 for SVP, 513 for SAP); a quintic trajectory of
# ISI_WAYPOINTS waypoints evaluated at ISI_B × ISI_TIMES times; the
# estimation options run ISI_OPT_STEPS steps (tests/test_estimator_options.
# py:104-114), and --options ISI_CLI_STEPS
ISI_B, ISI_FRACS, ISI_REF, ISI_WAYPOINTS, ISI_TIMES = 8192, 64, 256, 1024, 64
ISI_LIMIT, ISI_SPEED, ISI_ACCEL = 2.8, 1.5, 3.0
ISI_DENSE = {"svp": 257, "sap": 513}
ISI_OPT_STEPS, ISI_CLI_STEPS = 150, 20
# tests/test_tangent_spaces.py:45-48 (SVP) and :68-71 (SAP): the endpoints'
# bars (q at t=0, q̇ at t=0, q at t=1, q̇ at t=1); tests/test_pulses.py's
# continuity bars (Δq/Δt against the mean q̇: 2e-2; Δq̇/Δt against the mean
# q̈: 5e-2) and the limits' slack (1e-6)
ISI_END_BARS = {"svp": (1e-8, 1e-8, 1e-6, 1e-7),
                "sap": (1e-8, 1e-8, 5e-3, 1e-6)}
ISI_CONT_BARS, ISI_LIMIT_SLACK = (2e-2, 5e-2), 1e-6
# F18: the share of the ISI_B pairs where a joint has no feasible profile at
# the synchronized duration, as measured on an H100 (151 SVP pairs and 50
# SAP pairs of 8192), and the bar held on each share: which boundary pairs
# are infeasible is decided by the rounding of the reach time
# (tests/test_torch_spaces.py::test_f18_crs_pairs_miss_the_bars_as_in_jax),
# so a few may move, and no more
ISI_INFEASIBLE = {"svp": 151 / ISI_B, "sap": 50 / ISI_B}
ISI_INFEASIBLE_BAR = 8 / ISI_B


def isi_draws():
    """Phase interp_spaces_io's numpy draws (seed 0): the state pairs, the
    quintic trajectory's waypoints and its query times (fractions of its
    span)."""
    rng = np.random.default_rng(0)
    u = lambda scale, *shape: scale * rng.uniform(-1.0, 1.0, shape)
    b, n, w = ISI_B, 6, ISI_WAYPOINTS
    return {"qa": u(ISI_LIMIT, b, n), "qb": u(ISI_LIMIT, b, n),
            "qda": u(ISI_SPEED, b, n), "qdb": u(ISI_SPEED, b, n),
            "qdda": u(ISI_ACCEL, b, n), "qddb": u(ISI_ACCEL, b, n),
            "knots": np.cumsum(rng.uniform(0.05, 0.15, w)),
            "wp": u(ISI_LIMIT, w, n), "wv": u(ISI_SPEED, w, n),
            "wa": u(ISI_ACCEL, w, n),
            "tq": rng.uniform(0.0, 1.0, (b, ISI_TIMES))}


def isi_spaces(device, dtype):
    """(SVP bundle, SAP bundle, rate-limited joint space) of the CRS arm."""
    from reak_tpu_torch import spaces as sp
    from reak_tpu_torch.kte import models

    full = lambda x: torch.full((6,), x, dtype=dtype, device=device)
    lo, hi, v, a = full(-ISI_LIMIT), full(ISI_LIMIT), full(ISI_SPEED), full(
        ISI_ACCEL)
    return (sp.Ndof1stOrderSpace(lo, hi, v), sp.Ndof2ndOrderSpace(lo, hi, v, a),
            sp.RateLimitedNdofSpace.for_chain(models.manip_3r3r(), lo, hi, v))


def isi_points(d, device, dtype, n=None):
    """{"svp": (a, b), "sap": (a, b)} of the first ``n`` state pairs."""
    from reak_tpu_torch import spaces as sp

    t = lambda k: torch.as_tensor(d[k][:n], dtype=dtype, device=device)
    return {"svp": (sp.NdofPoint1(t("qa"), t("qda")),
                    sp.NdofPoint1(t("qb"), t("qdb"))),
            "sap": (sp.NdofPoint2(t("qa"), t("qda"), t("qdda")),
                    sp.NdofPoint2(t("qb"), t("qdb"), t("qddb")))}


def isi_bundles(d, device, dtype, n=None):
    """Part (a): each bundle's distance (reach time) and interpolation at
    ISI_FRACS fractions of the first ``n`` pairs, and the rate-limited
    space's distance and mapping round trip, as {name: tensor}."""
    s1, s2, rl = isi_spaces(device, dtype)
    pts = isi_points(d, device, dtype, n)
    fr = torch.linspace(0.0, 1.0, ISI_FRACS, dtype=dtype, device=device)[:, None]
    out = {}
    for name, space in (("svp", s1), ("sap", s2)):
        a, b = pts[name]
        out[f"{name}_T"] = space.distance(a, b)
        for f, x in zip(a._fields, space.interpolate(a, b, fr)):
            out[f"{name}_{f}"] = x
    qa, qb = pts["svp"][0].q, pts["svp"][1].q
    out["rl_distance"] = rl.distance(rl.from_natural(qa), rl.from_natural(qb))
    out["rl_round_trip"] = rl.to_natural(rl.from_natural(qa))
    return out


def isi_bar_masks(d, device, dtype, n=None):
    """``isi_bars`` and ``isi_feasible`` of both bundles on the first ``n``
    pairs: {name: bool tensor (n,)}."""
    s1, s2, _ = isi_spaces(device, dtype)
    pts = isi_points(d, device, dtype, n)
    out = {}
    for name, space in (("svp", s1), ("sap", s2)):
        a, b = pts[name]
        fr = torch.linspace(0.0, 1.0, ISI_DENSE[name], dtype=dtype,
                            device=device)[:, None]
        T = space.distance(a, b)
        out.update(isi_bars(name, a, b, space.interpolate(a, b, fr), T))
        out[f"{name}_feasible"] = isi_feasible(name, space, a, b, T[:, None])
    return out


def isi_bars(name, a, b, p, T):
    """Per pair, whether the pair meets the JAX tests' bars, given bundle
    ``name``'s interpolation ``p`` at ISI_DENSE[name] fractions (the dense
    grid of tests/test_pulses.py) and its reach times ``T``: the endpoints
    at fractions 0 and 1, |q̇| ≤ speed (and |q̈| ≤ accel on the SAP
    bundle) and the continuity of q (and of q̇).  {bar: bool tensor}."""
    dt = (T / (ISI_DENSE[name] - 1))[None, :, None]
    worst = lambda x: x.abs().amax(dim=-1)
    e = ISI_END_BARS[name]
    out = {f"{name}_endpoints": ((worst(p.q[0] - a.q) <= e[0])
                                 & (worst(p.qd[0] - a.qd) <= e[1])
                                 & (worst(p.q[-1] - b.q) <= e[2])
                                 & (worst(p.qd[-1] - b.qd) <= e[3])),
           f"{name}_speed": (p.qd.abs() - ISI_SPEED).amax(dim=(0, 2))
           <= ISI_LIMIT_SLACK,
           f"{name}_continuity": ((p.q[1:] - p.q[:-1]) / dt - 0.5 * (
               p.qd[1:] + p.qd[:-1])).abs().amax(dim=(0, 2))
           <= ISI_CONT_BARS[0]}
    if name == "sap":
        out["sap_accel"] = (p.qdd.abs() - ISI_ACCEL).amax(dim=(0, 2)) \
            <= ISI_LIMIT_SLACK
        out["sap_accel_continuity"] = ((p.qd[1:] - p.qd[:-1]) / dt - 0.5 * (
            p.qdd[1:] + p.qdd[:-1])).abs().amax(dim=(0, 2)) \
            <= ISI_CONT_BARS[1]
    return out


def isi_feasible(name, space, a, b, T, vp=None):
    """Per pair, whether every joint's profile of bundle ``name`` at the
    synchronized duration ``T`` (pairs, 1) with peak velocity ``vp``
    (the bundle's own where not given) is feasible: its two ramps fit the
    duration (slack ≥ −1e-9) and, with the cruise between them, cover the
    move (to 1e-6).  Where one is not (fault F18 of the reference), the
    pulse evaluated anyway jumps."""
    from reak_tpu_torch.interp import pulses as pl

    if name == "svp":
        if vp is None:
            vp = pl.svp_peak_velocity(a.q, b.q, a.qd, b.qd, space.speed, T,
                                      space.a_ramp)
        d1, t1 = pl._svp_ramp(a.qd, vp, space.a_ramp)
        d2, t2 = pl._svp_ramp(vp, b.qd, space.a_ramp)
    else:
        if vp is None:
            vp = pl.sap_peak_velocity(a.q, b.q, a.qd, b.qd, space.speed,
                                      space.accel, T, space.jerk)
        d1, t1 = pl._sap_ramp(a.qd, vp, space.accel, space.jerk)
        d2, t2 = pl._sap_ramp(vp, b.qd, space.accel, space.jerk)
    slack = T - t1 - t2
    cover = (b.q - a.q) - (d1 + d2 + vp * slack.clamp_min(0.0))
    return ((slack >= -1e-9) & (cover.abs() <= 1e-6)).all(dim=-1)


def isi_trajectory(d, device, dtype):
    """The quintic trajectory through the ISI_WAYPOINTS waypoints, and the
    query times (ISI_B, ISI_TIMES) across its span."""
    from reak_tpu_torch import interp as ip

    t = lambda k: torch.as_tensor(d[k], dtype=dtype, device=device)
    tr = ip.waypoint_trajectory(t("knots"), t("wp"), t("wv"), t("wa"))
    return tr, tr.t0 + t("tq") * (tr.t1 - tr.t0)


def isi_trajectories(d, device, dtype, n=None):
    """Part (b): the quintic trajectory at the first ``n`` rows of query
    times (pos, vel, acc), the tool positions of manip_3r3r through
    ``transformed_trajectory`` (kte.fk under torch.func.vmap) at the first
    time of each of the ISI_B rows, and planning/queries.path_cost of the
    waypoint path on NdofSpace and on the SVP bundle."""
    from torch.func import vmap

    from reak_tpu_torch import interp as ip, kte, spaces as sp
    from reak_tpu_torch.kte import models
    from reak_tpu_torch.planning import queries

    tr, tq = isi_trajectory(d, device, dtype)
    pos, vel, acc = tr.eval_with_derivatives(tq[:n])
    spec = models.manip_3r3r()
    tool = ip.transformed_trajectory(
        tr, vmap(lambda q: kte.fk(spec, q).body_pos[-1]))
    s1, _, _ = isi_spaces(device, dtype)
    costs = torch.tensor([
        queries.path_cost(sp.NdofSpace(s1.lower, s1.upper), tr.points),
        queries.path_cost(s1, sp.NdofPoint1(tr.points, tr.vels))],
        dtype=torch.float64)
    return {"traj_pos": pos, "traj_vel": vel, "traj_acc": acc,
            "tool_pos": tool.eval(tq[:, 0]), "path_costs": costs}


def isi_uav_clearance(device, dtype):
    """Part (c): kte/scenarios.uav_corridor_scenario on ``device``, its
    start → goal trajectory over [0, 10] s at ISI_B times, and the robot's
    signed clearance from the environment at each, composed as
    planning/workspace.py:113-121 composes it: kte.fk → pose_shapes →
    proxy_query under one torch.func.vmap, closing over the shapes."""
    from torch.func import vmap

    from reak_tpu_torch import interp as ip, kte
    from reak_tpu_torch.geom import proximity as prox, shapes as sh
    from reak_tpu_torch.kte import scenarios

    sc = scenarios.uav_corridor_scenario(device=device, dtype=dtype)
    traj = ip.point_to_point_trajectory(sc.start, sc.goal, 0.0, 10.0)
    q = traj.eval(torch.linspace(0.0, 10.0, ISI_B, dtype=dtype, device=device))

    def one(x):
        res = kte.fk(sc.robot, x)
        posed = sh.pose_shapes(sc.robot_shapes, res.body_pos, res.body_quat)
        return prox.proxy_query(prox.ProxyModel(
            spheres=posed.spheres, capsules=posed.capsules,
            boxes=posed.boxes, cylinders=posed.cylinders), sc.env)

    return sc, vmap(one)(q)


def interp_spaces_references():
    """Phase interp_spaces_io's plain f64 references on CPU tensors
    (``isi_<name>``): part (a) on the first ISI_REF pairs, part (b) on the
    first ISI_REF rows of query times (the tool positions and path costs
    whole), part (c)'s clearances."""
    f64 = torch.float64
    d = isi_draws()
    out = {**isi_bundles(d, "cpu", f64, ISI_REF),
           **isi_trajectories(d, "cpu", f64, ISI_REF),
           "uav_clearance": isi_uav_clearance("cpu", f64)[1]}
    return {f"isi_{k}": v.numpy() for k, v in out.items()}


def isi_archives(dev, sc, tr):
    """Part (d): one bundle (the UAV scenario, the waypoint trajectory, the
    flagship MPCProblem and scene A's shapes and environment of phase
    optimizers_geometry) saved as .json, .json.gz and .rkb in a temporary
    directory and loaded back; {format: row}, and the schema kinds of
    reak.NavigationScenario."""
    import tempfile

    from reak_tpu_torch.ctrl import mpc
    from reak_tpu_torch.io import serialization as ser

    _, robot, env = scene_models("A", dev, torch.float64)
    bundle = {"scenario": sc, "trajectory": tr,
              "flagship": flagship_problem(mpc, dev, torch.float64),
              "scene_a_robot": robot, "scene_a_env": env}
    # the canonical document of each: every array's values (float64 and
    # float32 exact in JSON's shortest repr, -0.0 kept), dtype and shape
    doc = lambda x: json.dumps(ser.to_document(x))
    want = doc(bundle)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fmt in (".json", ".json.gz", ".rkb"):
            path = os.path.join(tmp, f"bundle{fmt}")
            t0 = time.perf_counter()
            ser.save_scene(path, bundle)
            t1 = time.perf_counter()
            back = ser.load_scene(path)
            t2 = time.perf_counter()
            rows[fmt] = {"bytes": os.path.getsize(path),
                         "save_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3,
                         "bitwise": doc(back) == want}
    kinds = {f["name"]: f["kind"] for f in ser.build_schemes()["schemes"][
        "reak.NavigationScenario"]["fields"]}
    return rows, kinds


def isi_options(dev):
    """Part (e): the TSOS airship options of tests/test_estimator_options.
    py:104-114 saved as .rkx and run on the card by run_from_options(path),
    beside _run_from_options on the same options built in code; the same
    at ISI_CLI_STEPS steps through the example's --options.  Returns the
    row, with both comparisons and the test's bars (:119-126)."""
    import dataclasses
    import tempfile

    from reak_tpu_torch.ctrl.options import EstimatorOptions
    from reak_tpu_torch.examples import estimate_satellite3d as est
    from reak_tpu_torch.io import serialization as ser

    opts = EstimatorOptions(
        system_kind="airship_aug", mass=2.0, inertia_diag=(0.8, 1.0, 1.2),
        time_step=0.05, measurements="pose_sonars", tsos=True,
        room_lower=(-8.0, -8.0, -8.0), room_upper=(8.0, 8.0, 8.0),
        measurement_noise=(1e-6,) * 3 + (1e-6,) * 3 + (1e-5,) * 6,
        initial_cov_diag=(1e-2,) * 12 + (0.05,) * 5,
        initial_state=tuple(np.concatenate(
            [np.zeros(3), [1, 0, 0, 0], np.zeros(6),
             [0.15, 0.02, -0.01, 0.0, 0.3]])), steps=ISI_OPT_STEPS)
    same = lambda r, s: bool(torch.equal(r[1].mean, s[1].mean)
                             and torch.equal(r[1].cov, s[1].cov)
                             and torch.equal(r[2], s[2]))
    row = {"steps": ISI_OPT_STEPS, "cli_steps": ISI_CLI_STEPS}
    real = est._run_from_options
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tsos_airship.rkx")
        ser.save_scene(path, opts)
        got, row["run_from_options_ms"] = timed(
            lambda: est.run_from_options(path, seed=0, device=dev))
        want, row["in_code_ms"] = timed(
            lambda: real(opts, seed=0, device=dev))
        cli = dataclasses.replace(opts, steps=ISI_CLI_STEPS)
        cli_path = os.path.join(tmp, "tsos_airship_cli.rkx")
        ser.save_scene(cli_path, cli)
        runs = []
        est._run_from_options = lambda *a, **k: runs.append(real(*a, **k)) \
            or runs[-1]
        try:
            t0 = time.perf_counter()
            rc = est.main([f"--options={cli_path}", f"--device={dev}"])
            row["cli_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            est._run_from_options = real
        cli_want = real(cli, seed=0, device=dev)
    belief, x_true = got[1], got[2]
    row.update(
        bitwise_run_from_options=same(got, want),
        bitwise_cli=rc == 0 and len(runs) == 1 and same(runs[0], cli_want),
        options_round_trip=dataclasses.asdict(got[0]) == dataclasses.asdict(
            opts),
        position_error=float(torch.linalg.vector_norm(belief.mean[0:3]
                                                      - x_true[0:3])),
        aug_error=float((belief.mean[13:18].cpu() - torch.tensor(
            [0.15, 0.02, -0.01, 0.0, 0.3], dtype=torch.float64)).abs().max()),
        device=str(belief.mean.device))
    return row


def isi_recorder(tq, pos):
    """Part (f): the native recorder built from native/recorder.cpp (timed),
    the ISI_B × ISI_TIMES rows (t, q) of part (b) written by the native
    recorder and by the Python BinaryRecorder, each file read back by
    NativeExtractor and by open_extractor."""
    import tempfile

    from reak_tpu_torch.io import native_recorder as nr
    from reak_tpu_torch.io.recorder import BinaryRecorder, open_extractor

    t0 = time.perf_counter()
    nr.build_library()
    row = {"build_s": time.perf_counter() - t0}
    nr.load_library()
    rows = torch.cat([tq.reshape(-1, 1), pos.reshape(-1, 6)], 1).cpu().numpy()
    cols = ["t"] + [f"q{i}" for i in range(6)]
    row["rows"] = rows.shape[0]
    reads = []
    with tempfile.TemporaryDirectory() as tmp:
        native, python = (os.path.join(tmp, f"{w}.bin")
                          for w in ("native", "python"))
        t0 = time.perf_counter()
        with nr.NativeRecorder(native, cols) as rec:
            rec.record_rows(rows)
            rec.flush()
        t1 = time.perf_counter()
        rec = BinaryRecorder(python, cols)
        for r in rows:
            rec.record(r)
        rec.close()
        t2 = time.perf_counter()
        row["native_rows_per_s"] = rows.shape[0] / (t1 - t0)
        row["python_rows_per_s"] = rows.shape[0] / (t2 - t1)
        for path in (native, python):
            with nr.NativeExtractor(path) as ext:
                reads.append((ext.columns, ext.read_all()))
            reads.append(open_extractor(path))
    row["all_reads_bitwise"] = all(
        list(c) == cols and r.dtype == rows.dtype and np.array_equal(r, rows)
        for c, r in reads)
    return row


def interp_spaces_io(card, dev):
    """Phase interp_spaces_io, on the card (slice 13): (a) the SVP and SAP
    bundles' reach times and interpolations at ISI_FRACS fractions on ISI_B
    pairs of the CRS arm in f64 (and the reach times in f32), the
    rate-limited space's mapping round trip, and the JAX tests' bars per
    pair on dense sweeps; (b) the quintic trajectory at ISI_B × ISI_TIMES
    times, the arm's tool through transformed_trajectory, path costs; (c)
    the UAV corridor's clearance at ISI_B times; (d) the archives; (e)
    run_from_options and --options; (f) the native recorder.  Returns
    ``finish(refs)``, which holds the card's f64 results to the CPU
    child's ``interp_spaces_references()``, prints the phase and checks it
    (so that the card's work runs before the wait for the child)."""
    f64, f32 = torch.float64, torch.float32
    t_phase = time.perf_counter()
    d = isi_draws()
    ph = {"phase": "interp_spaces_io", "card": card, "B": ISI_B,
          "fracs": ISI_FRACS, "waypoints": ISI_WAYPOINTS,
          "times": [ISI_B, ISI_TIMES]}
    out, ph["bundles_ms"] = timed(lambda: isi_bundles(d, dev, f64))
    out32, ph["bundles_f32_ms"] = timed(lambda: isi_bundles(d, dev, f32))
    for name in ("svp", "sap"):
        t32, t64 = out32[f"{name}_T"], out[f"{name}_T"]
        rel = (t32.double() - t64).abs() / t64.abs().clamp_min(1e-300)
        ph[f"{name}_f32_T"] = {"max_rel": float(rel.max()),
                               "worst_pair": int(rel.argmax()),
                               "share_beyond_1e-4": float((rel > 1e-4).double()
                                                          .mean())}
    ph["rl_round_trip_max_abs"] = abs_err(out["rl_round_trip"],
                                          torch.as_tensor(d["qa"], device=dev))
    masks, ph["bars_ms"] = timed(lambda: isi_bar_masks(d, dev, f64))
    ph["bars_share_met"] = {k: float(m.double().mean())
                            for k, m in masks.items()}
    traj, ph["trajectories_ms"] = timed(lambda: isi_trajectories(d, dev, f64))
    tr, tq = isi_trajectory(d, dev, f64)
    ph["trajectory_eval_ms"] = timed(lambda: tr.eval_with_derivatives(tq))[1]
    ph["path_costs"] = traj["path_costs"].tolist()
    (sc, clear), ph["uav_ms"] = timed(lambda: isi_uav_clearance(dev, f64))
    ph["uav_min_clearance"] = float(clear.min())
    ph["uav_colliding_share"] = float((clear < 0).double().mean())
    ph["card_seconds"] = time.perf_counter() - t_phase
    ph["archives"], ph["scheme_kinds"] = isi_archives(dev, sc, tr)
    ph["options"] = isi_options(dev)
    ph["recorder"] = isi_recorder(tq, traj["traj_pos"])
    ph["seconds"] = time.perf_counter() - t_phase
    card_out = {k: v[:, :ISI_REF] if v.ndim == 3 else v[:ISI_REF]
                for k, v in out.items()}
    card_out.update({k: traj[k][:ISI_REF]
                     for k in ("traj_pos", "traj_vel", "traj_acc")},
                    tool_pos=traj["tool_pos"], path_costs=traj["path_costs"],
                    uav_clearance=clear)
    return lambda refs: _isi_finish(ph, card_out, masks, refs)


def _isi_finish(ph, card_out, masks, refs):
    """interp_spaces_io's comparisons with the CPU child, its line and its
    checks."""
    rel = {}
    for k, v in card_out.items():
        rel[k] = rel_err(v.cpu(), torch.as_tensor(refs[f"isi_{k}"]))
    ph["rel_vs_cpu"] = rel
    # F18: the pairs that miss a bar, and of them those with a feasible
    # profile at the synchronized duration (none may)
    ph["bars_missed_feasible"] = {
        k: int((~m & masks[k[:3] + "_feasible"]).sum())
        for k, m in masks.items() if not k.endswith("_feasible")}
    emit(ph)
    for k, e in rel.items():
        bar = 1e-12 if k.startswith(("traj_", "tool_", "path_")) else 1e-9
        check(e <= bar, f"interp_spaces_io {k} against the CPU: {e}")
    check(not any(ph["bars_missed_feasible"].values()),
          f"interp_spaces_io: a pair with a feasible profile misses a bar: "
          f"{ph['bars_missed_feasible']}")
    for name, share in ISI_INFEASIBLE.items():
        got = 1.0 - ph["bars_share_met"][f"{name}_feasible"]
        check(abs(got - share) <= ISI_INFEASIBLE_BAR,
              f"interp_spaces_io: {name}'s infeasible share {got} is not "
              f"within {ISI_INFEASIBLE_BAR} of {share} (F18)")
    for k in ("svp_endpoints", "svp_speed", "sap_speed", "sap_accel"):
        check(ph["bars_share_met"][k] == 1.0,
              f"interp_spaces_io: a pair misses {k}: {ph['bars_share_met']}")
    for name in ("svp", "sap"):
        check(ph[f"{name}_f32_T"]["max_rel"] <= 1e-3,
              f"{name} f32 reach times: {ph[f'{name}_f32_T']}")
    check(ph["rl_round_trip_max_abs"] <= 1e-14, "the rate-limited round trip")
    check(all(r["bitwise"] for r in ph["archives"].values()),
          f"an archive did not load back bit for bit: {ph['archives']}")
    want = {"name": "str", "robot": "object:reak.ChainSpec",
            "robot_shapes": "object:reak.ShapeSet",
            "env": "object:reak.ProxyModel"}
    check(all(ph["scheme_kinds"][k] == v for k, v in want.items()),
          f"NavigationScenario's scheme (F17): {ph['scheme_kinds']}")
    op = ph["options"]
    check(op["bitwise_run_from_options"] and op["bitwise_cli"]
          and op["options_round_trip"] and op["device"].startswith("cuda"),
          f"run_from_options against _run_from_options: {op}")
    check(op["position_error"] < 0.05 and op["aug_error"] < 0.15,
          f"the TSOS airship run misses its test's bars: {op}")
    check(ph["recorder"]["all_reads_bitwise"],
          f"the recorders' files: {ph['recorder']}")
    check(np.isfinite(ph["uav_min_clearance"]), "the UAV clearance")


# phase planning: the planners of reak_tpu_torch.planning on the CRS scene of
# examples/run_crs_planner.py:47-80 (manip_3r3r, its six chain capsules r =
# 0.05, the sphere and the floor plane, margin 0.01, 12 checks an edge;
# joint bounds ±2.8 rad), f64.  (a) the batched Monte-Carlo planners:
# rrt_plan_batch at PL_RRT = (runs, capacity, wave, max waves) and
# rrt_star_plan_batch at PL_STAR = (runs, capacity, waves), both through
# monte_carlo_engine_batched, draws from a CUDA generator (seed PL_SEED);
# (b) the example's eight planners at its CLI defaults; (c) the card against
# the CPU child with the same host draws (planning/draws.HostDraws, numpy
# seed PL_SEED): rrt_plan_batch PL_CMP_RRT = (runs, waves) and
# rrt_star_plan_batch PL_CMP_STAR, capacity PL_CMP_CAP, and the example's
# eight planners at its CLI defaults; (d) F1: the vlist_engine dump of (b)'s
# rewired RRT* tree.  Paths are checked with PL_DENSE× the edge checks.
# Every example planner but PL_NO_PATH finds a path (SBA* finds none on this
# scene in the JAX package's example too).
PL_SEED = 0
PL_RRT = (256, 4096, 64, 200)
PL_STAR = (8, 2048, 60)
PL_CMP_RRT, PL_CMP_STAR, PL_CMP_CAP = (4, 20), (2, 20), 2048
PL_DENSE = 4
PL_PLANNERS = ("rrt", "birrt", "rrt_star", "prm", "sbastar", "fadprm", "rrg")
PL_NO_PATH = {"sbastar"}


def pl_compare_runs(device):
    """(c)'s runs on ``device`` from the host draws: per batched planner
    the runs' vertex tensors, parents and counts (and RRT*'s stored costs),
    as numpy arrays of the first ``count`` slots; per example planner its
    (success, vertices, iterations, cost) and its path."""
    from reak_tpu_torch.examples import run_crs_planner as ex
    from reak_tpu_torch.planning import draws, rrt, rrt_star

    _, ws, q = ex.build_scene(device)
    out = {}
    for name in PL_PLANNERS + ("intercept",):
        cfg = dict(ex.DEFAULTS, planner=name, device=str(device),
                   seed=draws.HostDraws(PL_SEED))
        r = (ex.intercept(cfg) if name == "intercept" else ex.plan(cfg))[2]
        out[f"pl_ex_{name}_stats"] = np.array(
            [r.success, r.n_vertices, r.n_iterations, r.cost], np.float64)
        out[f"pl_ex_{name}_path"] = np.zeros((0, 0)) if r.path is None \
            else np.asarray(r.path, np.float64)
    for name, fn, (runs, waves) in (
            ("rrt", rrt.rrt_plan_batch, PL_CMP_RRT),
            ("star", rrt_star.rrt_star_plan_batch, PL_CMP_STAR)):
        res, _ = fn(ws, q, n_runs=runs, max_iters=waves,
                    capacity=PL_CMP_CAP, seed=draws.HostDraws(PL_SEED))
        out[f"pl_{name}_counts"] = np.array([r.n_vertices for r in res])
        out[f"pl_{name}_waves"] = np.array([r.n_iterations for r in res])
        for key in ("verts", "parents", "costs"):
            if key in res[0].stats:
                out[f"pl_{name}_{key}"] = np.concatenate(
                    [r.stats[key] for r in res])
    return out


def planning_references():
    """Phase planning's references on CPU tensors: (c)'s runs."""
    return pl_compare_runs("cpu")


def pl_path_check(ws_dense, space, res, start, goal=None, goal_tol=None):
    """(endpoints right, collision-free under the dense edge check, |cost −
    path_cost| / cost) of a successful joint-space path: the first point is
    the start; the last is the goal where the planner appends it, else
    within ``goal_tol`` of ``goal``."""
    from reak_tpu_torch.planning.queries import path_cost

    dev = space.lower.device
    path = torch.as_tensor(np.asarray(res.path), dtype=torch.float64,
                           device=dev)
    first = bool(torch.equal(path[0].cpu(), torch.as_tensor(start)))
    if goal_tol is None:
        last = bool(torch.equal(path[-1].cpu(), torch.as_tensor(goal)))
    else:
        last = float(space.distance(path[-1].cpu(), torch.as_tensor(goal))) \
            <= goal_tol
    free = bool(ws_dense.edge_free_batch(path[:-1], path[1:]).all())
    cost = path_cost(space, path)
    return first and last, free, abs(res.cost - cost) / max(cost, 1e-300)


def planning(card, dev, counts):
    """Phase planning, on the card (slice 14): (a)–(d) above.  Returns
    ``finish(refs)``, which holds (c) to the CPU child's
    ``planning_references()``, prints the phase and checks it."""
    from reak_tpu_torch.examples import run_crs_planner as ex
    from reak_tpu_torch.ops import _build
    from reak_tpu_torch.planning import (ChainWorkspace, engines, rrt,
                                         rrt_star)

    t_phase = time.perf_counter()
    launches_before = counts()
    spec, ws, q = ex.build_scene(dev)
    dense = ChainWorkspace(ws.space, spec, ws.robot_shapes, ws.env,
                           margin=ws.margin, n_checks=PL_DENSE * ws.n_checks)
    ph = {"phase": "planning", "card": card, "scene": "run_crs_planner",
          "dtype": "float64", "n_checks": ws.n_checks}
    start, goal = q.start, q.goal

    # (a) the batched Monte-Carlo planners
    runs, cap, wave, waves = PL_RRT
    kept = {}

    def keep(fn, name):
        def run(*a, **k):
            kept[name] = fn(*a, **k)
            return kept[name]
        return run

    runs_s, cap_s, waves_s = PL_STAR
    # one untimed wave of each at the timed shapes first, so that the
    # timings do not depend on what earlier phases warmed
    warm = torch.Generator(dev).manual_seed(PL_SEED + 1)
    rrt.rrt_plan_batch(ws, q, n_runs=runs, max_iters=1, capacity=cap,
                       wave=wave, seed=warm)
    rrt_star.rrt_star_plan_batch(ws, q, n_runs=runs_s, max_iters=1,
                                 capacity=cap_s, seed=warm)
    gen = torch.Generator(dev).manual_seed(PL_SEED)
    torch.cuda.synchronize()
    st = engines.monte_carlo_engine_batched(
        keep(rrt.rrt_plan_batch, "rrt"), ws, q, n_runs=runs,
        max_iters=waves, capacity=cap, wave=wave, seed=gen)
    res = kept["rrt"][0]
    n_waves = res[0].n_iterations
    ph["rrt_batch"] = {
        "runs": runs, "capacity": cap, "wave": wave, "waves": n_waves,
        "success_rate": st["success_rate"], "mean_cost": st["mean_cost"],
        "mean_vertices": st["mean_vertices"],
        "wall_s": st["wall_total_s"],
        "ms_per_wave": st["wall_total_s"] * 1e3 / n_waves,
        "ms_per_run": st["mean_time_s"] * 1e3}
    checks = [pl_path_check(dense, ws.space, r, start, goal)
              for r in res if r.success]
    ph["rrt_batch"]["paths_ok"] = [sum(c[0] for c in checks),
                                   sum(c[1] for c in checks), len(checks)]
    ph["rrt_batch"]["max_cost_rel_err"] = max(c[2] for c in checks)
    st = engines.monte_carlo_engine_batched(
        keep(rrt_star.rrt_star_plan_batch, "star"), ws, q, n_runs=runs_s,
        max_iters=waves_s, capacity=cap_s, seed=gen)
    checks = [pl_path_check(dense, ws.space, r, start, goal)
              for r in kept["star"][0] if r.success]
    ph["rrt_star_batch"] = {
        "runs": runs_s, "capacity": cap_s, "waves": waves_s,
        "success_rate": st["success_rate"], "mean_cost": st["mean_cost"],
        "mean_vertices": st["mean_vertices"], "wall_s": st["wall_total_s"],
        "ms_per_wave": st["wall_total_s"] * 1e3 / waves_s,
        "ms_per_run": st["mean_time_s"] * 1e3,
        "paths_ok": [sum(c[0] for c in checks), sum(c[1] for c in checks),
                     len(checks)],
        "max_cost_rel_err": max((c[2] for c in checks), default=0.0)}
    ph["batched_seconds"] = time.perf_counter() - t_phase

    # (b) the example's planners at its CLI defaults, once each; RRT*'s
    # through vlist_engine, whose dump (d) reads
    stem = str(_build.BUILD_DIR / "planning" / "rrt_star")
    ph["example"] = {}
    for name in PL_PLANNERS + ("intercept",):
        cfg = dict(ex.DEFAULTS, planner=name, device=str(dev))
        t0 = time.perf_counter()
        if name == "intercept":
            _, iq, r = ex.intercept(cfg)
        elif name == "rrt_star":
            r = engines.vlist_engine(lambda *a, **k: ex.plan(cfg)[2], ws, q,
                                     stem)
        else:
            _, _, r = ex.plan(cfg)
        row = {"success": r.success, "cost": r.cost,
               "vertices": r.n_vertices, "iterations": r.n_iterations,
               "wall_s": time.perf_counter() - t0}
        if r.success and name == "intercept":
            # the last waypoint within goal_tol of the target's tabulated
            # row at its time (the planner's goal test)
            path = np.asarray(r.path)
            grid = np.linspace(0.0, iq.t_budget, iq.target_samples)
            i = min(int(np.searchsorted(grid, path[-1, 0])), len(grid) - 1)
            tgt = np.asarray(iq.target_traj(float(grid[i])))
            jp = np.ascontiguousarray(path[:, 1:])
            row["ends_ok"] = bool(path[0, 0] == 0.0
                                  and np.array_equal(jp[0], iq.start)
                                  and np.linalg.norm(jp[-1] - tgt)
                                  < iq.goal_tol)
            row["dense_free"] = bool(dense.edge_free_batch(
                torch.as_tensor(jp[:-1], device=dev),
                torch.as_tensor(jp[1:], device=dev)).all())
            row["cost_rel_err"] = abs(r.cost - path[-1, 0]) / path[-1, 0]
        elif r.success:
            ends, free, err = pl_path_check(
                dense, ws.space, r, start, goal,
                goal_tol=0.3 if name == "rrg" else None)
            row.update(ends_ok=ends, dense_free=free, cost_rel_err=err)
        ph["example"][name] = row
    ph["example_seconds"] = sum(r["wall_s"] for r in ph["example"].values())

    # (c) the card's runs from the host draws
    card_cmp = pl_compare_runs(dev)

    # (d) F1: the dump of (b)'s RRT* tree from the card; each vertex's
    # cost-to-come against its edge lengths summed root first
    verts, parents, cost = engines.load_vlist(stem + "_vlist.csv")
    edge = ws.space.distance(torch.as_tensor(verts[np.maximum(parents, 0)]),
                             torch.as_tensor(verts)).numpy()
    sums = np.zeros(len(parents))
    for i in range(len(parents)):
        chain = [i]
        while parents[chain[-1]] >= 0:
            chain.append(parents[chain[-1]])
        for j in chain[-2::-1]:
            sums[i] += edge[j]
    ph["f1"] = {"vertices": len(parents),
                "rewired_to_higher_index": int(
                    (parents > np.arange(len(parents))).sum()),
                "max_abs_cost_err": float(np.abs(cost - sums).max())}
    ph["card_seconds"] = time.perf_counter() - t_phase
    ph["launches"] = {k: v - launches_before[k] for k, v in counts().items()}
    return lambda refs: _pl_finish(ph, card_cmp, refs)


def _pl_finish(ph, card_cmp, refs):
    """planning's comparison with the CPU child, its line and its checks."""
    cmp = {}
    for name in ("rrt", "star"):
        same = all(np.array_equal(card_cmp[f"pl_{name}_{k}"],
                                  refs[f"pl_{name}_{k}"])
                   for k in ("counts", "waves", "parents"))
        rel = {k: rel_err(torch.as_tensor(card_cmp[f"pl_{name}_{k}"]),
                          torch.as_tensor(refs[f"pl_{name}_{k}"]))
               for k in ("verts", "costs") if f"pl_{name}_{k}" in refs}
        cmp[name] = {"indices_equal": same, "rel": rel,
                     "vertices": card_cmp[f"pl_{name}_counts"].tolist(),
                     "waves": card_cmp[f"pl_{name}_waves"].tolist()}
    ex_cmp = {}
    for name in PL_PLANNERS + ("intercept",):
        got, want = (d[f"pl_ex_{name}_stats"] for d in (card_cmp, refs))
        p_got, p_want = (d[f"pl_ex_{name}_path"] for d in (card_cmp, refs))
        same_path = p_got.shape == p_want.shape
        ex_cmp[name] = {
            "success": bool(got[0]), "vertices": int(got[1]),
            "iterations": int(got[2]), "cost": float(got[3]),
            "counts_equal": bool(np.array_equal(got[:3], want[:3])
                                 and same_path),
            "cost_rel": float(abs(got[3] - want[3])
                              / max(abs(want[3]), 1e-300))
            if np.isfinite(want[3]) else float(got[3] != want[3]),
            "path_rel": float(rel_err(torch.as_tensor(p_got),
                                      torch.as_tensor(p_want)))
            if same_path and p_want.size else 0.0}
    cmp["example"] = ex_cmp
    ph["card_vs_cpu"] = cmp
    emit(ph)
    check(not any(ph["launches"].values()),
          f"phase planning launched a kernel: {ph['launches']}")
    for name, c in ex_cmp.items():
        check(c["counts_equal"] and c["cost_rel"] <= 1e-12
              and c["path_rel"] <= 1e-12,
              f"planning: the example's {name} from the host draws differs "
              f"from the CPU's: {c}")
    for name in ("rrt", "star"):
        c = cmp[name]
        check(c["indices_equal"],
              f"planning ({name}): the card's tree differs from the CPU's")
        check(all(e <= 1e-12 for e in c["rel"].values()),
              f"planning ({name}): vertices or costs off the CPU's: {c}")
    for key in ("rrt_batch", "rrt_star_batch"):
        b = ph[key]
        check(b["success_rate"] > 0.5, f"planning {key}: {b}")
        check(b["paths_ok"][0] == b["paths_ok"][1] == b["paths_ok"][2],
              f"planning {key}: a path's ends or dense check: {b}")
        check(b["max_cost_rel_err"] <= 1e-12, f"planning {key}'s costs")
    for name, r in ph["example"].items():
        check(not r["success"] or (r["ends_ok"] and r["dense_free"]
                                   and r["cost_rel_err"] <= 1e-12),
              f"planning: the example's {name} path: {r}")
    for runs in (ph["example"], ex_cmp):
        check({n for n, r in runs.items() if not r["success"]} == PL_NO_PATH,
              f"planning: the example's planners: {runs}")
    check(ph["f1"]["rewired_to_higher_index"] > 0,
          f"planning: no rewired vertex in the F1 tree: {ph['f1']}")
    check(ph["f1"]["max_abs_cost_err"] <= 1e-12,
          f"planning: F1 cost-to-come off the edge sums: {ph['f1']}")


# phase spaces_meaqr_examples (slice 15), f64 unless said: (a) the SE(2)
# spaces (orders 0-2 of tests/test_tangent_spaces.py:164-215 and the gap
# world's FlatSE2Space, tests/test_topomaps_se2plan.py:84) and the SE(3)
# orders (tests/test_tangent_spaces.py:121-160) on SME_B pairs drawn with
# numpy seed SME_SEED: distance, difference, clamp, and interpolation at
# SME_FRACS fractions, F21's headings ±π and ±3π in the first pairs and
# points; (b) the Gaussian belief space at n = SME_BELIEF_N on SME_B
# beliefs: the pack/unpack round trip, every covariance interpolated at
# SME_BELIEF_T positive definite, one covariance that is not (row
# SME_NONPD_ROW) NaN in its own row only (F9); (c) the topomaps on
# manip_3r3r at SME_B configurations q ~ U(±2.8)⁶: the direct map, the
# lift, the closed-form inverse's round trip (≤ SME_ROUND_TRIP_BAR), the
# CLIK fallback from q + U(±0.05) (≥ 99 % below SME_CLIK_BAR, PR 11's
# bar); (d) the planners over the new spaces: the RRT through the gap world
# of tests/test_topomaps_se2plan.py:80-106 and the belief RRT of
# tests/test_belief_space.py:52-70; (e) examples/x8_planner.py's main at
# its CLI defaults with both planners, and each planner again from
# HostDraws(SME_SEED); (f) examples/crs_dynexec.py's main at its defaults.
# The first SME_REF of each batch and (e)'s host-drawn runs are held to the
# CPU child (--spaces-reference): values ≤ SME_REL_BAR relative (the CLIK
# fallback's joints ≤ SME_CLIK_REL_BAR: 50 Gauss-Newton steps), the
# planners' success, vertices and iterations equal, costs ≤ SME_REL_BAR.
SME_B, SME_REF, SME_FRACS, SME_SEED = 8192, 256, 64, 0
SME_SE2 = {
    "se2_0": dict(pos_lower=[-1.0, -1.0], pos_upper=[1.0, 1.0]),
    "se2_1": dict(pos_lower=[-5.0, -5.0], pos_upper=[5.0, 5.0], order=1,
                  max_speed=2.0, max_ang_speed=1.0, max_acc=4.0,
                  max_ang_acc=2.0),
    "se2_2": dict(pos_lower=[0.0, 0.0], pos_upper=[1.0, 1.0], order=2,
                  max_speed=1.0, max_ang_speed=1.0, max_acc=3.0,
                  max_ang_acc=2.0),
    "flat_se2": dict(pos_lower=[0.0, 0.0], pos_upper=[1.0, 1.0],
                     rot_weight=0.1),
}
SME_SE3 = {
    "se3_0": dict(pos_lower=[-1.0] * 3, pos_upper=[1.0] * 3),
    "se3_1": dict(pos_lower=[-1.0] * 3, pos_upper=[1.0] * 3, order=1,
                  max_speed=2.0, max_ang_speed=1.0),
    "se3_2": dict(pos_lower=[0.0] * 3, pos_upper=[1.0] * 3, order=2,
                  max_speed=1.0, max_ang_speed=1.0, max_acc=3.0,
                  max_ang_acc=2.0),
}
SME_F21 = np.pi * np.array([1.0, -1.0, 3.0, -3.0])
SME_BELIEF_N, SME_BELIEF_T, SME_NONPD_ROW = 12, (0.0, 0.25, 0.5, 0.75,
                                                 1.0), 5
SME_ROUND_TRIP_BAR, SME_CLIK_BAR, SME_CLIK_SHARE = 1e-9, 1e-6, 0.99
# unpack adds 1e-9 to the square-root factor's diagonal (and pack 1e-12 to
# the covariance's), so the belief round trip moves the diagonal by ~1e-9
SME_BELIEF_ROUND_TRIP_BAR = 2e-9
SME_REL_BAR, SME_CLIK_REL_BAR = 1e-12, 1e-9
SME_X8 = ("rrt_star", "sbastar")
# residuals at rounding level, checked against their bars, not the CPU's
SME_RESIDUALS = ("topo_round_trip0", "topo_clik_err0")


def sme_ref_path():
    """Where the --spaces-reference child saves its references."""
    from reak_tpu_torch.ops import _build

    return _build.BUILD_DIR / "spaces_reference.npz"


def sme_draws(batch=SME_B):
    """Phase spaces_meaqr_examples' inputs, numpy seed SME_SEED: per space
    the fields of the pairs' ends a, b and of the points p that clamp
    takes (positions in and around the bounds, headings in (−3π, 3π),
    rates up to 1.5 times their limits; F21's headings in the first four
    a's, b = 0 there, and the first four p's); the beliefs (means in and
    past [0, 10]¹², SPD covariances) and the arm's configurations, rates
    and CLIK starts."""
    rng = np.random.default_rng(SME_SEED)
    d = {}
    for name, cfg in {**SME_SE2, **SME_SE3}.items():
        lo, hi = np.asarray(cfg["pos_lower"]), np.asarray(cfg["pos_upper"])
        order = cfg.get("order", 0)
        for end in ("a", "b", "p"):
            pos = lo + rng.uniform(-0.2, 1.2, (batch, lo.size)) * (hi - lo)
            fields = [pos]
            if name.startswith(("se2", "flat")):
                theta = np.pi * rng.uniform(-3.0, 3.0, batch)
                theta[:4] = 0.0 if end == "b" else SME_F21
                fields.append(theta)
                lim = (("max_speed", 2), ("max_ang_speed", ()),
                       ("max_acc", 2), ("max_ang_acc", ()))
            else:
                fields.append(rng.standard_normal((batch, 4)))
                lim = (("max_speed", 3), ("max_ang_speed", 3),
                       ("max_acc", 3), ("max_ang_acc", 3))
            for key, shape in lim[:2 * order]:
                shape = (batch,) + ((shape,) if shape else ())
                fields.append(1.5 * cfg[key] * rng.uniform(-1.0, 1.0, shape))
            if name.startswith("se3") and end != "p":
                fields[1] /= np.linalg.norm(fields[1], axis=1, keepdims=True)
            for i, f in enumerate(fields):
                d[f"{name}_{end}{i}"] = f
    n = SME_BELIEF_N
    for end in ("a", "b"):
        d[f"belief_mean_{end}"] = rng.uniform(-1.0, 11.0, (batch, n))
        g = 0.3 * rng.standard_normal((batch, n, n))
        d[f"belief_cov_{end}"] = g @ np.swapaxes(g, -1, -2) + 0.05 * np.eye(n)
    d["topo_q"] = rng.uniform(-2.8, 2.8, (batch, 6))
    d["topo_qd"] = rng.uniform(-1.0, 1.0, (batch, 6))
    d["topo_seed"] = d["topo_q"] + 0.05 * rng.uniform(-1.0, 1.0, (batch, 6))
    return d


def sme_space(name, device):
    from reak_tpu_torch import spaces

    kw = dict({**SME_SE2, **SME_SE3}[name], device=device)
    lo, hi = kw.pop("pos_lower"), kw.pop("pos_upper")
    if name == "flat_se2":
        return spaces.FlatSE2Space(lo, hi, **kw)
    make = spaces.make_se2_space if name.startswith("se2") \
        else spaces.make_se3_space
    return make(lo, hi, **kw)


def sme_point(name, d, end, device, n):
    """The point record (or FlatSE2 tensor) of ``end`` from the draws, its
    first ``n`` rows, as float64 on ``device``."""
    from reak_tpu_torch.spaces import se2, se3

    fields = []
    while f"{name}_{end}{len(fields)}" in d:
        fields.append(torch.as_tensor(d[f"{name}_{end}{len(fields)}"][:n],
                                      dtype=torch.float64, device=device))
    if name == "flat_se2":
        return torch.cat([fields[0], fields[1][:, None]], dim=1)
    order = {**SME_SE2, **SME_SE3}[name].get("order", 0)
    kind = (se2, "SE2Point") if name.startswith("se2") else (se3, "SE3Point")
    return getattr(kind[0], kind[1] + ("", "1", "2")[order])(*fields)


def sme_outputs(d, device, n=None):
    """(a)-(c) on the first ``n`` draws (all by default): {key: tensor}
    and, for the card, each part's ms."""
    from reak_tpu_torch import spaces
    from reak_tpu_torch.ctrl.belief import GaussianBelief
    from reak_tpu_torch.kte import ik, models

    n = n or SME_B
    on = lambda a: torch.as_tensor(a[:n], dtype=torch.float64,
                                   device=device)
    fracs = torch.as_tensor(np.linspace(0.0, 1.0, SME_FRACS),
                            dtype=torch.float64, device=device)[:, None]
    out, ms = {}, {}

    def put(key, value):
        for i, v in enumerate(value if isinstance(value, tuple)
                              else (value,)):
            out[f"{key}{i}"] = v

    for name in {**SME_SE2, **SME_SE3}:
        sp = sme_space(name, device)
        a, b, p = (sme_point(name, d, e, device, n) for e in ("a", "b", "p"))
        t0 = time.perf_counter()
        put(f"{name}_distance", sp.distance(a, b))
        put(f"{name}_difference", sp.difference(a, b))
        put(f"{name}_clamp", sp.clamp(p))
        put(f"{name}_interp", sp.interpolate(a, b, fracs))
        if device != "cpu":
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    bel = spaces.GaussianBeliefSpace(np.zeros(SME_BELIEF_N),
                                     np.full(SME_BELIEF_N, 10.0),
                                     sigma_range=(0.1, 1.0), device=device)
    t0 = time.perf_counter()
    xa, xb = (bel.pack(GaussianBelief(on(d[f"belief_mean_{e}"]),
                                      on(d[f"belief_cov_{e}"])))
              for e in ("a", "b"))
    ua = bel.unpack(xa)
    put("belief_pack", (xa, xb))
    put("belief_unpack", (ua.mean, ua.cov))
    put("belief_distance", bel.distance(xa, xb))
    put("belief_clamp", bel.clamp(xa))
    for i, t in enumerate(SME_BELIEF_T):
        put(f"belief_interp_pd_{i}", torch.linalg.cholesky_ex(
            bel.unpack(bel.interpolate(xa, xb, t)).cov)[1] == 0)
    put("belief_round_trip", bel.pack(ua))
    cov = on(d["belief_cov_a"]).clone()
    cov[SME_NONPD_ROW] -= 2.0 * torch.eye(SME_BELIEF_N, dtype=cov.dtype,
                                          device=device)
    put("belief_nonpd", bel.pack(GaussianBelief(on(d["belief_mean_a"]), cov)))
    if device != "cpu":
        torch.cuda.synchronize()
    ms["belief"] = (time.perf_counter() - t0) * 1e3
    spec = models.manip_3r3r()
    dk = spaces.DirectKinTopoMap(spec, device=device)
    t0 = time.perf_counter()
    pose = dk(on(d["topo_q"]))
    put("topo_direct", tuple(pose))
    put("topo_lift", tuple(dk.lift(on(d["topo_q"]), on(d["topo_qd"]))))
    q_cf = spaces.InverseKinTopoMap(spec, solver=ik.ik_3r3r, device=device,
                                    shoulder=1.0, elbow=1.0, wrist=1.0)(pose)
    put("topo_inverse", q_cf)
    back = dk(q_cf)
    quat_err = torch.minimum((back.quat - pose.quat).norm(dim=-1),
                             (back.quat + pose.quat).norm(dim=-1))
    put("topo_round_trip", torch.maximum(
        (back.pos - pose.pos).norm(dim=-1), quat_err))
    q_clik = spaces.InverseKinTopoMap(spec, device=device)(
        pose, q0=on(d["topo_seed"]))
    put("topo_clik", q_clik)
    put("topo_clik_err", torch.func.vmap(
        lambda q, p, qt: ik.pose_error(spec, q, p, qt))(
            q_clik, pose.pos, pose.quat).norm(dim=-1))
    if device != "cpu":
        torch.cuda.synchronize()
    ms["topomaps"] = (time.perf_counter() - t0) * 1e3
    return out, ms


def sme_x8_runs(device):
    """(e)'s planners from HostDraws(SME_SEED) at the example's defaults:
    per planner [success, vertices, iterations, cost] and its path."""
    from reak_tpu_torch.examples import x8_planner as x8
    from reak_tpu_torch.planning import draws

    out = {}
    for planner in SME_X8:
        cfg = dict(x8.DEFAULTS, planner=planner, device=str(device),
                   seed=draws.HostDraws(SME_SEED))
        r = x8.plan(cfg)[2]
        out[f"x8_{planner}_stats"] = np.array(
            [r.success, r.n_vertices, r.n_iterations, r.cost], np.float64)
        out[f"x8_{planner}_path"] = np.zeros((0, 0)) if r.path is None \
            else np.asarray(r.path, np.float64)
    return out


def spaces_meaqr_references(path):
    """``--spaces-reference``: phase spaces_meaqr_examples' references on
    CPU tensors, one thread, beside the other children: (a)-(c) on the
    first SME_REF draws and (e)'s host-drawn planners.  Saved to
    ``path``."""
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out, _ = sme_outputs(sme_draws(), "cpu", SME_REF)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **{f"sme_{k}": v.numpy() for k, v in out.items()},
             **sme_x8_runs("cpu"), seconds=time.perf_counter() - t0)
    os.replace(tmp, path)
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sme_planners(dev):
    """(d): the RRT through the gap world on FlatSE2Space and the belief
    RRT, each from a CUDA generator seeded SME_SEED, at the JAX tests'
    settings; per run its success, vertices, checks and ms."""
    from reak_tpu_torch import planning, spaces
    from reak_tpu_torch.ctrl.belief import GaussianBelief
    from reak_tpu_torch.planning.queries import PlanningQuery

    grid = np.ones((64, 64), bool)
    grid[30:34, :] = False          # wall across x ≈ 0.5 ...
    grid[30:34, 24:40] = True       # ... with a gap around y ≈ 0.5
    flat = spaces.FlatSE2Space(np.zeros(2), np.ones(2), rot_weight=0.1,
                               device=dev)
    ws = planning.bitmap_workspace(flat, grid, np.zeros(2), np.ones(2))
    q = PlanningQuery(np.array([0.1, 0.5, 3.0]), np.array([0.9, 0.5, -3.0]),
                      goal_tolerance=0.08)
    gen = torch.Generator(dev).manual_seed(SME_SEED)
    r, t_ms = timed(lambda: planning.rrt_plan(ws, q, max_iters=150,
                                              step_size=0.12, seed=gen))
    out = {"flat_se2_rrt": {"success": r.success, "vertices": r.n_vertices,
                            "waves": r.n_iterations, "ms": t_ms}}
    if r.success:
        path = np.asarray(r.path)
        dth = np.abs(((path[1:, 2] - path[:-1, 2]) + np.pi) % (2 * np.pi)
                     - np.pi)
        out["flat_se2_rrt"].update(
            path_free=bool(ws.is_free_batch(torch.as_tensor(
                path, device=dev)).all()),
            headings_wrapped=bool(np.all(np.abs(path[:, 2]) <= np.pi)),
            heading_travel=float(dth.sum()))
    bel = spaces.GaussianBeliefSpace(np.zeros(2), np.full(2, 10.0),
                                     sigma_range=(0.1, 1.0), device=dev)
    free = lambda x: torch.diagonal(bel.unpack(x).cov, dim1=-2,
                                    dim2=-1).sum(-1) < 1.5
    ws_b = planning.Workspace(bel, free, n_checks=8)
    eye = torch.eye(2, dtype=torch.float64, device=dev)
    start, goal = (bel.pack(GaussianBelief(torch.tensor(
        m, dtype=torch.float64, device=dev), 0.04 * eye)).cpu().numpy()
        for m in ([1.0, 1.0], [9.0, 9.0]))
    gen = torch.Generator(dev).manual_seed(SME_SEED)
    r, t_ms = timed(lambda: planning.rrt_plan(
        ws_b, PlanningQuery(start, goal, goal_tolerance=2.0), max_iters=40,
        step_size=3.0, seed=gen))
    out["belief_rrt"] = {"success": r.success, "vertices": r.n_vertices,
                         "waves": r.n_iterations, "ms": t_ms}
    if r.success:
        out["belief_rrt"]["path_free"] = bool(free(torch.as_tensor(
            np.asarray(r.path), device=dev)).all())
    return out


def sme_examples(dev):
    """(e) and (f) on the card: x8_planner.main at its CLI defaults per
    planner (its printed JSON), crs_dynexec.main at its defaults on a free
    port, its output written under the build directory (its printed
    lines and the recorded rows)."""
    import contextlib
    import io

    from reak_tpu_torch.examples import crs_dynexec, x8_planner
    from reak_tpu_torch.ops import _build

    out = {}
    for planner in SME_X8:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = x8_planner.main([f"--planner={planner}"])
        out[f"x8_{planner}"] = {"rc": rc, **json.loads(
            buf.getvalue().strip().splitlines()[-1]),
            "seconds": time.perf_counter() - t0}
    plan_csv = _build.BUILD_DIR / "crs_dynexec_plan.csv"
    if plan_csv.exists():
        plan_csv.unlink()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = crs_dynexec.main([f"--port={_free_port()}",
                               f"--output={plan_csv}"])
    text = buf.getvalue()
    rows = plan_csv.read_text().strip().splitlines() if plan_csv.exists() \
        else []
    out["crs_dynexec"] = {
        "rc": rc, "seconds": time.perf_counter() - t0,
        "lines": text.strip().splitlines(),
        "rows_streamed": "40 rows streamed" in text,
        "intercept_planned": "intercept planned" in text,
        "all_clear": "all clear of the moving target body: True" in text,
        "recorded_rows": max(len(rows) - 1, 0)}
    return out


def spaces_meaqr_examples(card, dev):
    """Phase spaces_meaqr_examples, on the card (slice 15): (a)-(f) above.
    It launches no kernel, so it runs beside the build.  Returns
    ``finish(refs)``, which holds the first SME_REF rows and (e)'s
    host-drawn planners to the CPU child's ``spaces_meaqr_references``,
    prints the phase and checks it."""
    t_phase = time.perf_counter()
    ph = {"phase": "spaces_meaqr_examples", "card": card, "B": SME_B,
          "fracs": SME_FRACS, "dtype": "float64"}
    d = sme_draws()
    out, ph["ms"] = sme_outputs(d, dev)
    # F21: ±π and ±3π (the first four a's and p's, b's heading 0) wrap to
    # π in the clamp and the difference
    f21 = {}
    for name in SME_SE2:
        heading = out["flat_se2_clamp0"][:4, 2] if name == "flat_se2" \
            else out[f"{name}_clamp1"][:4]
        diff = out[f"{name}_difference0"][:4, 2]
        f21[name] = [float(heading.min()), float(diff.min()),
                     float(heading.max()), float(diff.max())]
    ph["f21_min_max"] = f21
    ph["belief"] = {
        "round_trip_max_abs": abs_err(out["belief_round_trip0"],
                                      out["belief_pack0"]),
        "interpolations_pd": [bool(out[f"belief_interp_pd_{i}0"].all())
                              for i in range(len(SME_BELIEF_T))],
        "nonpd_row_nan": bool(torch.isnan(
            out["belief_nonpd0"][SME_NONPD_ROW, SME_BELIEF_N:]).all()),
        "other_rows_equal": bool(torch.equal(
            torch.cat([out["belief_nonpd0"][:SME_NONPD_ROW],
                       out["belief_nonpd0"][SME_NONPD_ROW + 1:]]),
            torch.cat([out["belief_pack0"][:SME_NONPD_ROW],
                       out["belief_pack0"][SME_NONPD_ROW + 1:]])))}
    err = out["topo_clik_err0"]
    ph["topomaps"] = {
        "round_trip_max": float(out["topo_round_trip0"].max()),
        "clik_share_below": float((err < SME_CLIK_BAR).double().mean()),
        "clik_max_err": float(err.max()),
        "finite": all(bool(torch.isfinite(out[k]).all()) for k in out
                      if k.startswith("topo_"))}
    ph["planners"] = sme_planners(dev)
    card_x8 = sme_x8_runs(dev)
    ph["examples"] = sme_examples(dev)
    ph["seconds"] = time.perf_counter() - t_phase
    card_out = {k: (v[:, :SME_REF] if k.endswith(tuple(
        f"_interp{i}" for i in range(6))) else v[:SME_REF]).cpu()
        for k, v in out.items() if not k.startswith(("belief_interp_pd",
                                                    "belief_nonpd"))}
    return lambda refs: _sme_finish(ph, card_out, card_x8, refs)


def _sme_finish(ph, card_out, card_x8, refs):
    """spaces_meaqr_examples' comparisons with the CPU child, its line and
    its checks."""
    rel = {}
    for k, v in card_out.items():
        if k in SME_RESIDUALS:
            continue
        ref = torch.as_tensor(refs[f"sme_{k}"])
        if v.dtype == torch.bool:
            rel[k] = float(not torch.equal(v, ref))
        elif float(ref.abs().max()) == 0.0:
            rel[k] = float(v.abs().max())
        else:
            rel[k] = rel_err(v, ref)
    ph["worst_rel_vs_cpu"] = dict(sorted(
        ((k, v) for k, v in rel.items() if k != "topo_clik0"),
        key=lambda kv: -kv[1])[:4])
    ph["clik_rel_vs_cpu"] = rel["topo_clik0"]
    x8_cmp = {}
    for planner in SME_X8:
        got, want = (r[f"x8_{planner}_stats"] for r in (card_x8, refs))
        p_got, p_want = (r[f"x8_{planner}_path"] for r in (card_x8, refs))
        x8_cmp[planner] = {
            "success": bool(got[0]), "vertices": int(got[1]),
            "iterations": int(got[2]), "cost": float(got[3]),
            "counts_equal": bool(np.array_equal(got[:3], want[:3])
                                 and p_got.shape == p_want.shape),
            "cost_rel": float(abs(got[3] - want[3]) / abs(want[3]))
            if np.isfinite(want[3]) else float(got[3] != want[3]),
            "path_rel": float(np.abs(p_got - p_want).max()
                              / np.abs(p_want).max())
            if p_got.shape == p_want.shape and p_want.size else 0.0}
    ph["x8_host_draws_vs_cpu"] = x8_cmp
    ph["cpu_reference_seconds"] = float(refs["seconds"])
    emit(ph)
    for k, e in rel.items():
        bar = SME_CLIK_REL_BAR if k == "topo_clik0" else SME_REL_BAR
        check(e <= bar, f"spaces_meaqr_examples {k} against the CPU: {e}")
    for name, (h_lo, d_lo, h_hi, d_hi) in ph["f21_min_max"].items():
        check(min(h_lo, d_lo) > 0.0 and abs(h_lo - np.pi) <= 1e-12
              and abs(d_lo - np.pi) <= 1e-12,
              f"F21: {name}'s headings at ±π, ±3π: {ph['f21_min_max']}")
    b = ph["belief"]
    check(b["round_trip_max_abs"] <= SME_BELIEF_ROUND_TRIP_BAR
          and all(b["interpolations_pd"])
          and b["nonpd_row_nan"] and b["other_rows_equal"],
          f"spaces_meaqr_examples belief space: {b}")
    t = ph["topomaps"]
    check(t["finite"] and t["round_trip_max"] <= SME_ROUND_TRIP_BAR
          and t["clik_share_below"] >= SME_CLIK_SHARE,
          f"spaces_meaqr_examples topomaps: {t}")
    fr, br = ph["planners"]["flat_se2_rrt"], ph["planners"]["belief_rrt"]
    check(fr["success"] and fr["path_free"] and fr["headings_wrapped"]
          and fr["heading_travel"] < 2.0, f"the FlatSE2 RRT: {fr}")
    check(br["success"] and br["path_free"], f"the belief RRT: {br}")
    for planner, c in x8_cmp.items():
        check(c["counts_equal"] and c["cost_rel"] <= SME_REL_BAR
              and c["path_rel"] <= SME_REL_BAR,
              f"x8 {planner} from host draws differs from the CPU's: {c}")
    ex = ph["examples"]
    for planner in SME_X8:
        check(ex[f"x8_{planner}"]["rc"] == 0
              and ex[f"x8_{planner}"]["success"],
              f"x8_planner --planner={planner}: {ex[f'x8_{planner}']}")
    dx = ex["crs_dynexec"]
    check(dx["rc"] == 0 and dx["rows_streamed"] and dx["intercept_planned"]
          and dx["all_clear"] and dx["recorded_rows"] >= 2,
          f"crs_dynexec: {dx}")


def mesh_flagship(card, dev, solve, x0, u0, main_runs):
    """Phase mesh_flagship (slice 15): phase times' flagship solve through
    ``parallel.mesh`` on a one-process NCCL group — ``sharded_map`` of the
    solve with ``pmean_scalar`` of mean(us²) (the JAX package's
    ``local_step``, tests/test_mesh_equivalence.py:36-56) — against the
    unsharded solve of the same x0: controls bit for bit, the scalar
    equal, exactly H K1 and one K2 launches; each timed.  One rank shows
    the code path and the collective, not scaling."""
    import torch.distributed as dist

    from reak_tpu_torch import parallel

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    check(parallel.distribute_init(f"127.0.0.1:{_free_port()}", 1, 0),
          "distribute_init returned False with a coordinator")
    try:
        mesh = parallel.make_mesh()

        def local_step(x0s, u0s):
            us, _ = solve(x0s, u0s)
            return us, torch.mean(us ** 2)

        step = parallel.pmean_scalar(local_step, mesh)
        xd, ud = parallel.shard_batch((x0, u0), mesh)
        step(xd, ud)  # the group's first collective sets up its communicator
        setup_s = time.perf_counter() - t0
        reset_counts()
        (us_d, mean_d), t_sharded = timed(lambda: step(xd, ud))
        launches = counts()
        main_runs["mesh_flagship"] = launches
        (us, _), t_local = timed(lambda: solve(x0, u0))
        mean_local = torch.mean(us ** 2)
        row = {"phase": "mesh_flagship", "card": card, "B": B, "H": H,
               "iters": ITERS, "dtype": "float32", "ranks": mesh.size(),
               "backend": dist.get_backend(),
               "note": "one rank: the code path and the collective, not "
                       "scaling",
               "launches": launches, "setup_s": setup_s,
               "sharded_ms": t_sharded, "unsharded_ms": t_local,
               "sharded_warm_ms": cuda_ms(lambda: step(xd, ud), reps=3),
               "unsharded_warm_ms": cuda_ms(lambda: solve(x0, u0), reps=3),
               "local_shape": list(us_d.to_local().shape),
               "controls_bitwise": torch.equal(us_d.to_local(), us),
               "mean_us2": float(mean_d.to_local()),
               "mean_us2_bitwise": torch.equal(mean_d.to_local(),
                                               mean_local)}
    finally:
        dist.destroy_process_group()
    emit(row)
    check(launches["kte_step"] == H and launches["pdip_whole"] == 1
          and sum(launches.values()) == H + 1,
          f"the sharded flagship's launches: {launches}")
    check(row["controls_bitwise"] and row["mean_us2_bitwise"],
          f"the sharded flagship differs from the unsharded solve: {row}")


def trace_flagship(card, solve, x0, u0):
    """Part (c) of phase optimizers_geometry: io/profiling.device_trace
    around one warm flagship one-pass solve (phase times' configuration);
    the Chrome trace's CUDA kernel events must name K1's kernel H times and
    K2's once.  Prints the five longest device operations and the share of
    the traced window (its first event's start to its last event's end,
    host and device) in which the device ran an operation."""
    from reak_tpu_torch.io import profiling
    from reak_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "flagship_trace"
    solve(x0, u0)
    torch.cuda.synchronize()
    with profiling.device_trace(str(out_dir)):
        solve(x0, u0)
        torch.cuda.synchronize()
    trace = json.loads((out_dir / "trace.json").read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    on_device = [e for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in on_device if e["cat"] == "kernel"]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e.get("dur", 0) for e in events)
    busy, reach = 0.0, start
    for e in sorted(on_device, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], reach), e["ts"] + e.get("dur", 0)
        if hi > lo:
            busy += hi - lo
            reach = hi
    longest = sorted(on_device, key=lambda e: -e.get("dur", 0))[:5]
    row = {"phase": "flagship_trace", "card": card, "B": B, "H": H,
           "iters": ITERS, "dtype": "float32",
           "trace": os.path.relpath(out_dir / "trace.json", ROOT),
           "trace_bytes": (out_dir / "trace.json").stat().st_size,
           "device_events": len(on_device), "kernel_events": len(kernels),
           "k1_kernel_events": sum("kte_step_kernel" in e["name"]
                                   for e in kernels),
           "k2_kernel_events": sum("pdip_pipe_kernel" in e["name"]
                                   for e in kernels),
           "window_ms": (end - start) / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / (end - start),
           "longest_device_ops": [{"name": e["name"][:90],
                                   "ms": e.get("dur", 0) / 1e3}
                                  for e in longest]}
    emit(row)
    check(row["k1_kernel_events"] == H and row["k2_kernel_events"] == 1,
          f"the traced flagship solve's kernels: {row['k1_kernel_events']} "
          f"K1, {row['k2_kernel_events']} K2")


def k1_split(card, dev, step_k, core_k, x_np, u_np):
    """K1 and K5 of the shipped (6, 6) and (7, 7) f32 libraries at B = 64,
    at one block an SM (B = SMs × TS) and at B = 8192, each in the mode
    the wrapper takes there (a wrapper's call by CUDA events and the
    kernel's device time by the profiler; the flagship's states, and the
    SSRMS's as ``arm_states`` draws them), beside ptxas' registers, stack
    and spills of each kernel; no patched build (``ops/k1_phases.py``
    splits the phases)."""
    from reak_tpu_torch.kte import models
    from reak_tpu_torch.ops import _build, kte_core, kte_step

    f32 = torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f32,
                                   device=dev)
    ssrms = models.manip_ssrms()
    x7 = arm_states(B).T
    u7 = np.random.default_rng(7).uniform(-5.0, 5.0, (7, B))
    row = {"phase": "k1_split", "card": card, "sms": sms, "dtype": "float32",
           "chains": {}}
    for label, spec, k1, k5, xs, us in (
            ("6x6", models.manip_3r3r(), step_k, core_k, x_np, u_np),
            ("7x7", ssrms, kte_step.make_step_lanes(ssrms, DT),
             kte_core.make_core_lanes(ssrms), x7, u7)):
        widths = kte_step.instance_for(spec)
        shape = kte_step.launch_shape(*widths, f32)
        res = {"tile_scenarios": shape.scenarios, "threads": shape.threads,
               "primal_slot": shape.primal_slot,
               "blocks_per_sm": shape.blocks_per_sm,
               "registers_cap": shape.registers,
               "outer_shared": shape.outer_shared,
               "shared_bytes": shape.shared_bytes, "ptxas": {}}
        lines = _build.ptxas_report(kte_step.library(widths, f32)).splitlines()
        for mode in ("step", "split"):
            for core in (0, 1):
                frag = (f"kte_{mode}_kernelIfLi{widths[0]}ELi{widths[1]}"
                        f"ELb{core}E")
                for i, line in enumerate(lines):
                    if "Compiling entry" in line and frag in line:
                        text = " ".join(lines[i + 1:i + 4])
                        num = {k: re.search(p, text) for k, p in (
                            ("registers", r"Used (\d+) registers"),
                            ("stack_bytes", r"(\d+) bytes stack frame"),
                            ("spill_stores", r"(\d+) bytes spill stores"),
                            ("spill_loads", r"(\d+) bytes spill loads"))}
                        res["ptxas"][("k5" if core else "k1") + (
                            "_split" if mode == "split" else "")] = {
                            k: int(m.group(1)) if m else None
                            for k, m in num.items()}
        for batch in (64, sms * shape.scenarios, B):
            x, u = on(xs[:, :batch]), on(us[:, :batch])
            split = kte_step.split_mode(*widths, f32, batch, x.device)
            name = (f"kte_{'split' if split else 'step'}_kernel<float, "
                    f"{widths[0]}, {widths[1]}")
            res[f"split_mode_B{batch}"] = split
            # a wrapper's call by CUDA events (host-bound where the host's
            # time a call passes the kernel's), the kernel alone by the
            # profiler (null where three profiles saw none of it)
            res[f"k1_ms_B{batch}"] = cuda_ms(lambda: k1(x, u), reps=20)
            res[f"k5_ms_B{batch}"] = cuda_ms(lambda: k5(x, u), reps=20)
            res[f"k1_device_ms_B{batch}"] = device_ms(
                lambda: k1(x, u), 20, f"{name}, false>")
            res[f"k5_device_ms_B{batch}"] = device_ms(
                lambda: k5(x, u), 20, f"{name}, true>")
        row["chains"][label] = res
    emit(row)
    for label, res in row["chains"].items():
        check(len(res["ptxas"]) == 4, f"ptxas lines of K1/K5 {label} f32")
        check(res["split_mode_B64"] and not res[f"split_mode_B{B}"],
              f"the split mode at B = 64 and not at {B}, {label}")


def kte_instances():
    """(chain, widths, type) of every K1/K5 library the run drives: the
    flagship arm in f32 and f64, planar_2link, the mixed chain and the
    16-segment beam in f64; the pendulum (1, 1), the planar 3R arm (3, 3;
    SCARA's widths too) in f64, and the 7-DoF SSRMS (7, 7; ERA's and
    P3R3R's) in f32 and f64 (phase arms_ik_integrators)."""
    from reak_tpu_torch.kte import models
    from reak_tpu_torch.ops import kte_step

    out = []
    for spec, dtypes in ((models.manip_3r3r(), (torch.float32,
                                                torch.float64)),
                         (models.planar_2link(), (torch.float64,)),
                         (models.mixed_chain(), (torch.float64,)),
                         (models.flexible_beam(BEAM_SEGMENTS),
                          (torch.float64,)),
                         (models.pendulum(), (torch.float64,)),
                         (models.manip_3r_planar(), (torch.float64,)),
                         (models.manip_ssrms(), (torch.float32,
                                                 torch.float64))):
        out += [(spec.name, kte_step.instance_for(spec), dt) for dt in dtypes]
    return out


def kernel_libraries():
    """{library: {function: argtypes}} of every kernel of the port.  K1 and
    K5 are two instances of one kernel in csrc/kte_step.cu, built once per
    chain width and type, and once per type at run-time widths; K2 and
    K4a-c are built once per (bound, type) and once per type at run-time
    widths, each into a library of its own."""
    from reak_tpu_torch.ops import (chol_lanes, kte_core, kte_step,
                                    pdip_whole, riccati_bwd)

    kte = {kte_step.library(w, dt): kte_step.signatures(w, dt)
           for _, w, dt in kte_instances()}
    # the runtime-width instance of each type (chains past 16 joints)
    kte.update({kte_step.library(None, dt): kte_step.signatures(None, dt)
                for dt in (torch.float32, torch.float64)})
    return {**kte, "chol_lanes": chol_lanes.SIGNATURES,
            **pdip_whole.LIBRARIES, **riccati_bwd.LIBRARIES}


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from reak_tpu_torch.ops import (chol_lanes, kte_core, kte_step,
                                    pdip_whole, riccati_bwd)

    kte_step.launches = 0
    kte_core.launches = 0
    pdip_whole.launches = 0
    for per_entry in (chol_lanes.launches, riccati_bwd.launches):
        for key in per_entry:
            per_entry[key] = 0


def counts():
    """{kernel entry: launches since the last ``reset_counts``}."""
    from reak_tpu_torch.ops import (chol_lanes, kte_core, kte_step,
                                    pdip_whole, riccati_bwd)

    return {"kte_step": kte_step.launches,
            "kte_core": kte_core.launches,
            "pdip_whole": pdip_whole.launches,
            **{f"chol_lanes.{k}": v for k, v in chol_lanes.launches.items()},
            **{f"riccati_bwd.{k}": v for k, v in riccati_bwd.launches.items()}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import reak_tpu_torch
    from reak_tpu_torch.ops import _build

    # ---- phase 1: device -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    dev = torch.device("cuda", 0)
    reak_tpu_torch.enable_full_precision()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # the build, and beside it (nvcc below this process's priority) the
    # card's work of what launches no kernel: three phases, the stiff suite
    # of arms_ik_integrators and the filters and prediction of estimation;
    # the CPU reference starts after the build
    rank = {name: i for i, name in enumerate(BUILD_LONGEST_FIRST)}
    libraries = sorted(kernel_libraries(),
                       key=lambda n: rank.get(n, len(rank)))
    building = _build.start(libraries, jobs=max(os.cpu_count() - 1, 1),
                            niceness=NVCC_NICENESS)
    try:
        reset_counts()
        t_early = time.perf_counter()
        early = {"optimizers_geometry": optimizers_geometry(card, dev),
                 "interp_spaces_io": interp_spaces_io(card, dev),
                 "planning": planning(card, dev, counts),
                 "spaces_meaqr_examples": spaces_meaqr_examples(card, dev),
                 "stiff_suite": stiff_suite(dev),
                 "estimation_filters": estimation_filters(card, dev)}
        early_seconds = time.perf_counter() - t_early
        check(not any(counts().values()), "a phase run beside the build "
              f"launched a kernel: {counts()}")
        _build.finish(building)
    finally:
        _build.stop(building)
    build = {"seconds": max(building["seconds"].values(), default=0.0),
             "jobs": max(os.cpu_count() - 1, 1),
             "library_seconds": building["seconds"],
             "beside_it": list(early), "beside_it_seconds": early_seconds}
    ref_path = _build.BUILD_DIR / "cpu_reference.npz"
    if ref_path.exists():
        ref_path.unlink()
    ops_path = _build.BUILD_DIR / "op_counts.npz"
    children = {}
    for key, path in (("cpu_reference", ref_path), ("op_counts", ops_path),
                      ("spaces_reference", sme_ref_path())):
        if path.exists():
            path.unlink()
        with open(_build.BUILD_DIR / f"{key}.log", "w") as log:
            children[key] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 f"--{key.replace('_', '-')}", str(path)], cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT)
    try:
        return smoke(children, ref_path, ops_path, card, dev, build, early)
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()


def smoke(children, ref_path, ops_path, card, dev, build, early):
    from reak_tpu_torch.ctrl import (belief, invariant, manifold_lanes, mpc,
                                     mpc_manifold, riccati_soa, ss_systems,
                                     systems)
    from reak_tpu_torch.kte import lanes, models, soa
    from reak_tpu_torch.ops import (_build, _tile, chol_lanes, kte_core,
                                    kte_step, pdip_whole, riccati_bwd)

    def child_result(key, path):
        """The results of the child ``key``, and how long this process
        waited for it."""
        t_wait = time.perf_counter()
        rc = children[key].wait(timeout=900)
        log = (_build.BUILD_DIR / f"{key}.log").read_text()
        check(rc == 0, f"the {key} process failed:\n{log[-4000:]}")
        return np.load(path), time.perf_counter() - t_wait

    def cpu_references():
        return child_result("cpu_reference", ref_path)

    op_count = {}

    def plain_ops(key):
        """Operations per scenario of a plain version, from ``op_counts``
        (the CPU process ``--op-counts``)."""
        if not op_count:
            op_count["npz"], op_count["waited_s"] = child_result(
                "op_counts", ops_path)
        return float(op_count["npz"][key])

    # ---- phase 2: build (done before the CPU reference started) ----------
    f64, f32 = torch.float64, torch.float32
    for name, signatures in kernel_libraries().items():
        _build.load(name, signatures)
    # registers and stack frame of each kernel instance the paths launch
    # (ptxas -v), as {key: (library, mangled-name fragment)}; the whole
    # report lands beside each library.  The tile kernels (K2, K4a-c) have
    # an instance of the exact widths and a padded one per bound and type.
    wanted = {}
    for bd in _tile.INSTANCES:
        for t, suffix in (("f", "f32"), ("d", "f64")):
            k2_lib = _build.instance_library("pdip_whole", bd, suffix)
            k4_lib = _build.instance_library("riccati_bwd", bd, suffix)
            for (nb, mb), exact in ((_tile.EXACT[bd], 1), (bd, 0)):
                w = f"I{t}Li{nb}ELi{mb}ELb{exact}E"
                wanted[f"pdip_whole<{w}>"] = (k2_lib, f"pdip_pipe_kernel{w}")
                for e in riccati_bwd.launches:
                    wanted[f"riccati_bwd.{e}<{w}>"] = (k4_lib,
                                                       f"{e}_kernel{w}")
    # K3a/K3b: the unrolled instances of the hot widths (n = 1 and 2: the
    # dense MPC's Schur solves), and the instance of any other width (0)
    wanted.update({f"chol_lanes<{w}>": ("chol_lanes", f"chol_lanes_kernel{w}")
                   for w in ("IfLi1E", "IdLi1E", "IfLi2E", "IdLi2E",
                             "IfLi6E", "IdLi6E", "IfLi12E", "IdLi12E",
                             "IfLi0E", "IdLi0E")})
    # the runtime-width tile of each type
    for t, suffix in (("f", "f32"), ("d", "f64")):
        wanted[f"pdip_whole<any,{suffix}>"] = (
            _build.instance_library("pdip_whole", None, suffix),
            f"pdip_whole_any_kernelI{t}E")
        for e in riccati_bwd.launches:
            wanted[f"riccati_bwd.{e}<any,{suffix}>"] = (
                _build.instance_library("riccati_bwd", None, suffix),
                f"{e}_any_kernelI{t}E")
    # K1 and K5 per chain width (joints x dofs) and type, with the blocks
    # of each that an SM holds; the runtime-width instance of each type,
    # its blocks an SM at a 17-joint chain's launch shape
    occupancy = {}
    for _, w, dt in kte_instances():
        t = "f" if dt == f32 else "d"
        for i, key in enumerate(("kte_step", "kte_core")):
            k = f"{key}<{t}{w[0]}x{w[1]}>"
            for mode in ("step", "split"):
                wanted[k + ("" if mode == "step" else ",split")] = (
                    kte_step.library(w, dt),
                    f"kte_{mode}_kernelI{t}Li{w[0]}ELi{w[1]}ELb{i}E")
            occupancy[k] = kte_step.occupancy(w, dt, core=bool(i))
            # the wrapper's mirror of the launch shape, in both modes, is
            # the library's own
            for split in (False, True):
                mirror = kte_step.launch_shape(*w, dt, core=bool(i),
                                               split=split)
                built = kte_step.built_shape(w, dt, core=bool(i),
                                             split=split)
                check(all(getattr(mirror, f) == v
                          for f, v in built.items()),
                      f"launch_shape of {k} {vars(mirror)} against {built}")
    for dt in (f32, f64):
        t = "f" if dt == f32 else "d"
        for i, key in enumerate(("kte_step", "kte_core")):
            k = f"{key}<{t},any>"
            wanted[k] = (kte_step.library(None, dt),
                         f"kte_step_rt_kernelI{t}Lb{i}E")
            occupancy[k + "@17x17"] = kte_step.occupancy(
                None, dt, core=bool(i),
                threads=kte_step.launch_shape(17, 17, dt).threads)
    ptxas = {}
    for key, (name, fragment) in wanted.items():
        lines = _build.ptxas_report(name).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and fragment in line:
                ptxas[key] = " | ".join(
                    s.replace("ptxas info    :", "").strip()
                    for s in lines[i + 2:i + 4])
    check(len(ptxas) == len(wanted), "a kernel instance missing from ptxas")
    emit({"phase": "build", **build,
          "dir": os.path.relpath(_build.BUILD_DIR, ROOT), "ptxas": ptxas,
          "kte_blocks_per_sm": occupancy})

    spec = models.manip_3r3r()
    rng = np.random.default_rng(0)
    x0_np = bench_states(rng, B)

    # ---- phase 3: K1 against its plain version, B=8192, one step ---------
    step_k = kte_step.make_step_lanes(spec, DT)
    step_p = kte_step.make_step_plain(spec, DT)
    x_np = x0_np.T.copy()
    u_np = rng.uniform(-5.0, 5.0, (6, B))
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    ref64 = step_p(on(x_np, f64), on(u_np, f64))
    k64 = step_k(on(x_np, f64), on(u_np, f64))
    k32 = step_k(on(x_np, f32), on(u_np, f32))
    p32 = step_p(on(x_np, f32), on(u_np, f32))
    torch.cuda.synchronize()
    names = ("Ad", "Bd", "cd", "x_new")
    k1 = {"phase": "k1_vs_plain", "B": B, "f64_rel": {}, "f32_abs": {},
          "plain_f32_abs": {}}
    for nm, a64, a32, b32, r in zip(names, k64, k32, p32, ref64):
        k1["f64_rel"][nm] = rel_err(a64, r)
        k1["f32_abs"][nm] = abs_err(a32, r)
        k1["plain_f32_abs"][nm] = abs_err(b32, r)
    k1_max_abs = max(abs_err(a, r) for a, r in zip(k64, ref64))
    emit(k1)
    for nm in names:
        check(k1["f64_rel"][nm] <= 1e-9, f"K1 f64 {nm} relative error")
        check(k1["f32_abs"][nm] <= 2.0 * k1["plain_f32_abs"][nm],
              f"K1 f32 {nm} error above twice the plain f32 error")

    # ---- K5 against its plain version, B=8192, one launch -----------------
    core_k = kte_core.make_core_lanes(spec)
    core_p = kte_core.make_core_plain(spec)
    c_ref64 = core_p(on(x_np, f64), on(u_np, f64))
    c_k64 = core_k(on(x_np, f64), on(u_np, f64))
    c_k32 = core_k(on(x_np, f32), on(u_np, f32))
    c_p32 = core_p(on(x_np, f32), on(u_np, f32))
    torch.cuda.synchronize()
    k5 = {"phase": "k5_vs_plain", "B": B, "f64_rel": {}, "f32_abs": {},
          "plain_f32_abs": {}}
    for nm, a64, a32, b32, r in zip(("qdd", "dqdd", "minv"), c_k64, c_k32,
                                    c_p32, c_ref64):
        k5["f64_rel"][nm] = rel_err(a64, r)
        k5["f32_abs"][nm] = abs_err(a32, r)
        k5["plain_f32_abs"][nm] = abs_err(b32, r)
        check(k5["f64_rel"][nm] <= 1e-9, f"K5 f64 {nm} relative error")
        check(k5["f32_abs"][nm] <= 2.0 * k5["plain_f32_abs"][nm],
              f"K5 f32 {nm} error above twice the plain f32 error")
    k5_max_abs = max(abs_err(a, r) for a, r in zip(c_k64, c_ref64))

    # ---- K1 and K5 on other chains and on ragged batches, f64 -------------
    # the flagship arm at batches that are no multiple of the tile (B = 1,
    # 77, 1001), planar_2link and the mixed chain (FIXED and PRISMATIC
    # joints, offset quaternions, springs, dampers, full inertia tensors) at
    # B = 1001; states and inputs from numpy seed 5, against the plain
    # versions
    crng = np.random.default_rng(5)
    chains = {"phase": "kte_chains", "dtype": "float64", "cases": {}}
    for chain, batch in ((spec, 1), (spec, 77), (spec, 1001),
                         (models.planar_2link(), 1001),
                         (models.mixed_chain(), 1001)):
        nv_c = chain.nv
        xc = on(np.concatenate([crng.uniform(-0.5, 0.5, (nv_c, batch)),
                                crng.uniform(-0.3, 0.3, (nv_c, batch))]), f64)
        uc = on(crng.uniform(-5.0, 5.0, (nv_c, batch)), f64)
        before = (kte_step.launches, kte_core.launches)
        got1 = kte_step.make_step_lanes(chain, DT)(xc, uc)
        got5 = kte_core.make_core_lanes(chain)(xc, uc)
        want1 = kte_step.make_step_plain(chain, DT)(xc, uc)
        want5 = kte_core.make_core_plain(chain)(xc, uc)
        torch.cuda.synchronize()
        shape = kte_step.launch_shape(*kte_step.instance_for(chain), f64)
        case = {"widths": list(shape.widths),
                "tile_scenarios": shape.scenarios,
                "k1_f64_rel": {nm: rel_err(a, r)
                               for nm, a, r in zip(names, got1, want1)},
                "k5_f64_rel": {nm: rel_err(a, r) for nm, a, r in
                               zip(("qdd", "dqdd", "minv"), got5, want5)}}
        chains["cases"][f"{chain.name},B={batch}"] = case
        check((kte_step.launches, kte_core.launches)
              == (before[0] + 1, before[1] + 1),
              f"{chain.name} B={batch} did not launch K1 and K5")
        check(all(bool(torch.isfinite(a).all()) for a in (*got1, *got5)),
              f"{chain.name} B={batch}: K1 or K5 outputs are not finite")
        for key in ("k1_f64_rel", "k5_f64_rel"):
            for nm, e in case[key].items():
                check(e <= 1e-9, f"{key[:2].upper()} {chain.name} B={batch} "
                      f"{nm} f64 relative error")
        k1_max_abs = max([k1_max_abs] + [abs_err(a, r)
                                         for a, r in zip(got1, want1)])
        k5_max_abs = max([k5_max_abs] + [abs_err(a, r)
                                         for a, r in zip(got5, want5)])
    emit(chains)
    del xc, uc, got1, got5, want1, want5

    # ---- phase 4: K2 against its plain version at the flagship shape -----
    roll_k = lanes.make_rollout_ltv_fullfused(spec, DT, H)
    u0_64 = torch.zeros(B, H, M, dtype=f64, device=dev)
    A64, B64, c64, xs64 = roll_k(on(x0_np, f64), u0_64)
    # the K5 rollout computes the same function as the K1 rollout
    r5 = lanes.make_rollout_ltv_fused(spec, DT, H)(on(x0_np, f64), u0_64)
    k5["rollout_H"] = H
    k5["rollout_vs_k1_rollout_f64_rel"] = {
        nm: rel_err(a, r) for nm, a, r in zip(("A", "B", "c", "xs"), r5,
                                              (A64, B64, c64, xs64))}
    emit(k5)
    for nm, e in k5["rollout_vs_k1_rollout_f64_rel"].items():
        check(e <= 1e-9, f"K5 rollout {nm} against the K1 rollout")
    del r5, xs64
    x0T64 = on(x0_np.T, f64)
    refs_np = {"x_ref": 0.05 * rng.standard_normal((H, N, B)),
               "u_ref": 0.5 * rng.standard_normal((H, M, B))}
    k2 = {"phase": "k2_vs_plain", "H": H, "n": N, "m": M, "iters": ITERS,
          "B": B, "modes": {}}
    k4 = {"phase": "k4_vs_plain", "H": H, "n": N, "m": M, "iters": ITERS,
          "B": B, "modes": {}}
    k2_max_abs = k4_max_abs = 0.0

    def k4_case(u_k, x_k, u_k32, x_k32, u_p, x_p, u_p32, x_p32):
        """The per-pass solve against the plain scan, as K2 is held."""
        return {"f64_rel": {"u": rel_err(u_k, u_p), "xs": rel_err(x_k, x_p)},
                "f32_abs": {"u": abs_err(u_k32, u_p), "xs": abs_err(x_k32,
                                                                    x_p)},
                "plain_f32_abs": {"u": abs_err(u_p32, u_p),
                                  "xs": abs_err(x_p32, x_p)}}

    for mode, keys in (("regulator", ()), ("x_ref", ("x_ref",)),
                       ("x_ref+u_ref", ("x_ref", "u_ref"))):
        out = {}
        for dt in (f64, f32):
            prob = flagship_problem(mpc, dev, dt)
            args = (A64.to(dt), B64.to(dt), c64.to(dt), prob.Q, prob.QN,
                    prob.R, x0T64.to(dt), prob.u_min, prob.u_max)
            kw = {k: on(refs_np[k], dt) for k in keys}
            out[dt] = [riccati_soa.solve_box_mpc_riccati_soa_fused(
                *args, iters=ITERS, use_kernels=uk, **kw)
                for uk in ("whole", "never", "passes")]
        torch.cuda.synchronize()
        (uk64, xk64), (up64, xp64), (uq64, xq64) = out[f64]
        (uk32, xk32), (up32, xp32), (uq32, xq32) = out[f32]
        k4["modes"][mode] = k4_case(uq64, xq64, uq32, xq32, up64, xp64, up32,
                                    xp32)
        k4_max_abs = max(k4_max_abs, abs_err(uq64, up64), abs_err(xq64, xp64))
        res = {"f64_rel": {"u": rel_err(uk64, up64), "xs": rel_err(xk64, xp64)},
               "f32_abs": {"u": abs_err(uk32, up64), "xs": abs_err(xk32, xp64)},
               "plain_f32_abs": {"u": abs_err(up32, up64),
                                 "xs": abs_err(xp32, xp64)}}
        k2["modes"][mode] = res
        k2_max_abs = max(k2_max_abs, abs_err(uk64, up64), abs_err(xk64, xp64))
        for o in ("u", "xs"):
            check(res["f64_rel"][o] <= 1e-9, f"K2 {mode} f64 {o} relative")
            check(res["f32_abs"][o] <= 2.0 * res["plain_f32_abs"][o],
                  f"K2 {mode} f32 {o} error above twice the plain f32 error")
    emit(k2)

    # ---- K4a/K4b/K4c alone against their plain passes, flagship shape -----
    # phase 4's f64 LTV with stage costs q, inputs u_eff, a positive barrier
    # diagonal D, right-hand sides and gains k drawn from the seed; K and G
    # of the passes after the first come from the plain f64 fused pass
    pass_np = {"q": rng.standard_normal((H, N, B)),
               "u_eff": rng.standard_normal((H, M, B)),
               "D": rng.uniform(0.5, 2.0, (H, M, B)),
               "rhs": rng.standard_normal((H, M, B)),
               "k": rng.standard_normal((H, M, B)),
               "dx0": rng.standard_normal((N, B))}

    def pass_args(dt, A_, B_, arrays, KG=None):
        """The arguments of each pass in type dt; the vector and forward
        passes take KG = (K, G)."""
        prob = flagship_problem(mpc, dev, dt)
        t = {k: on(v, dt) for k, v in arrays.items()}
        A_, B_ = A_.to(dt), B_.to(dt)
        args = {"fused_backward": (A_, B_, t["q"], t["u_eff"], t["D"],
                                   prob.Q, prob.QN, prob.R)}
        if KG is not None:
            K_, G_ = (a.to(dt) for a in KG)
            args["vector_backward"] = (A_, B_, t["rhs"], K_, G_)
            args["forward"] = (A_, B_, K_, t["k"], t["dx0"])
        return args

    plain_pass = {"fused_backward": riccati_soa.fused_backward_plain,
                  "vector_backward": riccati_soa.vector_backward_plain,
                  "forward": riccati_soa.forward_plain}
    KG64 = riccati_soa.fused_backward_plain(
        *pass_args(f64, A64, B64, pass_np)["fused_backward"])[1:3]
    k4["passes_alone"] = {}
    for entry, plain in plain_pass.items():
        res, unchanged = {}, True
        for dt in (f64, f32):
            a = pass_args(dt, A64, B64, pass_np, KG64)[entry]
            before = [t.clone() for t in a]
            k_out = getattr(riccati_bwd, entry)(*a)
            torch.cuda.synchronize()
            # the kernel leaves its inputs (k, rhs, K, G, dx0) as they were
            unchanged &= all(torch.equal(t, b) for t, b in zip(a, before))
            p_out = plain(*a)
            res[dt] = ((k_out,) if torch.is_tensor(k_out) else k_out,
                       (p_out,) if torch.is_tensor(p_out) else p_out)
            del before
        torch.cuda.synchronize()
        (k64s, p64s), (k32s, p32s) = res[f64], res[f32]
        case = {"f64_rel": [rel_err(a, r) for a, r in zip(k64s, p64s)],
                "f32_abs": [abs_err(a, r) for a, r in zip(k32s, p64s)],
                "plain_f32_abs": [abs_err(a, r) for a, r in zip(p32s, p64s)],
                "inputs_unchanged": unchanged}
        k4["passes_alone"][entry] = case
        k4_max_abs = max([k4_max_abs] + [abs_err(a, r)
                                         for a, r in zip(k64s, p64s)])
        check(unchanged, f"K4 {entry} wrote one of its inputs")
        for i, e in enumerate(case["f64_rel"]):
            check(e <= 1e-9, f"K4 {entry} output {i} f64 relative")
            check(case["f32_abs"][i] <= 2.0 * case["plain_f32_abs"][i],
                  f"K4 {entry} output {i} f32 error above twice the plain "
                  "f32 error")
    # per launch at the flagship shape, f32
    a32 = pass_args(f32, A64, B64, pass_np, KG64)
    k4["flagship_shape_ms"] = {
        e: cuda_ms(lambda: getattr(riccati_bwd, e)(*a32[e]), reps=10)
        for e in plain_pass}
    k4["flagship_shape_plain_ms"] = {
        e: cuda_ms(lambda: plain_pass[e](*a32[e]), reps=1)
        for e in plain_pass}
    del A64, B64, c64, out, KG64, a32

    # ---- K3a/K3b against their plain version -----------------------------
    # G SPD as bench.py:193-195 makes it (G Gᵀ + 3I); shapes of the main
    # paths: the line-search rollout (n=6, one right-hand side, B=8192), the
    # floating-arm LTV (n=12, k=36, B=2048), bench.py's (6, 18, 1024), and
    # K3a through the standard-layout chol_lanes.solve at (12, 2048); then
    # the widths past the unrolled instances, n = 17, 32, 33, 48, 64, 70
    # (one and 5 right-hand sides, B = 1001: a ragged tile; 70 is past the
    # substitutions' local-memory vector), and two right-hand sides at
    # n = 241 (B = 77; in f64 a scenario's triangle no longer fits a block's
    # shared memory) and n = 341 (B = 33; nor in f32), whose work area is
    # the device-memory workspace.  Past n = 70 the plain version is taken
    # in its row-vectorized form (chol_rows_plain), held bitwise to the
    # plain version at n = 70
    def spd(n, batch):
        g = rng.standard_normal((n, n, batch))
        return np.einsum("ikz,jkz->ijz", g, g) + 3.0 * np.eye(n)[:, :, None]

    def k3_bytes(g, r):
        """What K3 must move: G's lower triangle (n(n+1)/2 rows of B
        scenarios) read once, the right-hand sides read and x written."""
        n, batch = g.shape[0], g.shape[-1]
        return n * (n + 1) // 2 * batch * g.element_size() + 2 * nbytes(r)

    k3_cases, k3_profiled = {}, {}
    k3_wide = [(e, n, k, 1001) for n in (17, 32, 33, 48, 64, 70)
               for e, k in (("solve_lanes", 1), ("solve_lanes_multi", 5))]
    k3_workspace = [("solve_lanes_multi", 241, 2, 77),
                    ("solve_lanes_multi", 341, 2, 33)]
    for entry, n, k, batch in [("solve_lanes", 6, 1, B),
                               ("solve_lanes_multi", 6, 1, B),
                               ("solve_lanes_multi", 12, 36, FA_B),
                               ("solve_lanes_multi", 6, 18, 1024),
                               # lqr_backward's G⁻¹F on the batch-first
                               # routes (phase batch_first)
                               ("solve_lanes_multi", 6, 12, B),
                               # the dense MPC's Schur solves (phase
                               # dense_and_closed_loop: m = 2, n = 4, and
                               # the double integrator's m = 1, n = 2)
                               ("solve_lanes", 2, 1, 1),
                               ("solve_lanes_multi", 2, 4, 1),
                               ("solve_lanes", 1, 1, 1),
                               ("solve_lanes_multi", 1, 2, 1),
                               ("solve", 12, 1, FA_B)] + k3_wide \
            + k3_workspace:
        G_np, r_np = spd(n, batch), rng.standard_normal((n, k, batch))
        if entry == "solve_lanes_multi":
            kern = lambda g, r: chol_lanes.solve_lanes_multi(g, r)
        elif entry == "solve_lanes":
            kern = lambda g, r: chol_lanes.solve_lanes(g, r[:, 0])[:, None]
        else:  # (B, n, n), (B, n) standard layout
            kern = lambda g, r: chol_lanes.solve(
                g.permute(2, 0, 1).contiguous(),
                r[:, 0].T.contiguous()).T[:, None]
        res, rows_bitwise = {}, {}
        for dt in (f64, f32):
            g, r = on(G_np, dt), on(r_np, dt)
            plain_ = (riccati_soa._chol_solve_lanes(g, r) if n <= 70
                      else chol_rows_plain(g, r))
            if n == 70:
                rows_bitwise[str(dt)] = torch.equal(
                    chol_rows_plain(g, r), plain_)
            res[dt] = (kern(g, r), plain_)
        torch.cuda.synchronize()
        (k64_, p64_), (k32_, p32_) = res[f64], res[f32]
        key = f"{entry}(n={n},k={k},B={batch})"
        k3_cases[key] = {"f64_rel": rel_err(k64_, p64_),
                         "f64_abs": abs_err(k64_, p64_),
                         "f32_abs": abs_err(k32_, p64_),
                         "plain_f32_abs": abs_err(p32_, p64_),
                         "bitwise": {"f64": torch.equal(k64_, p64_),
                                     "f32": torch.equal(k32_, p32_)}}
        if n > 70:  # which types ran with the device-memory work area
            ws = {"f64": chol_lanes.workspace_values(n, batch, 8) > 0,
                  "f32": chol_lanes.workspace_values(n, batch, 4) > 0}
            k3_cases[key]["workspace"] = ws
            check(ws["f64"] and ws["f32"] == (n == 341),
                  f"K3 {key} did not run the workspace cases: {ws}")
        if rows_bitwise:
            k3_cases[key]["rows_plain_bitwise"] = rows_bitwise
            check(all(rows_bitwise.values()),
                  f"K3 {key}: chol_rows_plain is not the plain version")
        check(k3_cases[key]["f64_rel"] <= 1e-9, f"K3 {key} f64 relative")
        check(k3_cases[key]["f32_abs"] <= 2.0 * k3_cases[key]["plain_f32_abs"],
              f"K3 {key} f32 error above twice the plain f32 error")
        # each product rounded alone (csrc/chol_lanes.cu mul_rn): the
        # kernel is its plain version bit for bit
        check(all(k3_cases[key]["bitwise"].values()),
              f"K3 {key} is not its plain version bit for bit")
        if entry != "solve" and (n, k, batch) in ((6, 1, B), (12, 36, FA_B)):
            # times at the line-search and the floating-arm LTV shapes, on
            # contiguous inputs made beforehand: per call by CUDA events
            # over 50 back-to-back calls (as in earlier runs), the device
            # alone by the profiler, and the host's wall time per call
            g, r = on(G_np, f32), on(r_np, f32)
            r1 = r[:, 0].contiguous()
            call = (functools.partial(chol_lanes.solve_lanes, g, r1)
                    if entry == "solve_lanes"
                    else functools.partial(chol_lanes.solve_lanes_multi, g,
                                           r))
            k3_cases[key]["ms"] = cuda_ms(call, reps=50)
            k3_cases[key]["wall_ms"] = wall_ms(call, 50)
            # the profiler runs last in the script (phase times)
            k3_profiled[key] = call
            k3_cases[key]["plain_ms"] = cuda_ms(
                lambda: riccati_soa._chol_solve_lanes(g, r), reps=5)
            # one PyTorch call computing the same solves (standard layout)
            g_std = g.permute(2, 0, 1).contiguous()
            r_std = r.permute(2, 0, 1).contiguous()
            k3_cases[key]["library_ms"] = cuda_ms(
                lambda: torch.linalg.solve(g_std, r_std), reps=20)
            k3_cases[key]["bytes"] = k3_bytes(g, r)
            k3_cases[key]["ops"] = batch * ops_per_scenario(
                riccati_soa._chol_solve_lanes,
                lambda nb: (torch.eye(n, dtype=f64)[:, :, None].repeat(
                    1, 1, nb), torch.ones(n, k, nb, dtype=f64)))
    emit({"phase": "k3_vs_plain", "cases": k3_cases})
    k3_err = {e: max(v["f64_abs"] for c, v in k3_cases.items()
                     if c.startswith(e + "(") or (e == "solve_lanes"
                                                  and c.startswith("solve(")))
              for e in ("solve_lanes", "solve_lanes_multi")}
    k3a_case = k3_cases[f"solve_lanes(n=6,k=1,B={B})"]
    k3b_case = k3_cases[f"solve_lanes_multi(n=12,k=36,B={FA_B})"]

    # ---- K2 at the floating arm's width (24, 12) against its plain version
    # A, B, c: the port's f64 floating-arm LTV along x0 with u = 0, x_ref the
    # tangent errors to the target, as the scenario MPC hands them to K2
    fa = models.floating_arm()
    nv_fa = fa.nv
    x0_fa_np = floating_arm_states(fa, FA_B)
    prob_fa64, xr_fa64 = floating_arm_config(mpc, fa, dev, f64)
    step_fa, ltv_fa = lanes.make_kte_manifold_lanes(fa, FA_DT)
    x = on(x0_fa_np.T, f64)
    u_zero = torch.zeros(nv_fa, FA_B, dtype=f64, device=dev)
    lin, xs_fa = [], []
    for _ in range(FA_H):
        lin.append(ltv_fa(x, u_zero))
        x = step_fa(x, u_zero)
        xs_fa.append(x)
    Aw, Bw, cw = (torch.stack(s, dim=0) for s in zip(*lin))
    xs_fa = torch.stack(xs_fa, dim=0)
    ew = manifold_lanes.quat_local_lanes(
        xr_fa64[None, :, None].expand(xs_fa.shape), xs_fa).contiguous()
    e0 = torch.zeros(2 * nv_fa, FA_B, dtype=f64, device=dev)
    del lin, xs_fa
    out = {}
    for dt in (f64, f32):
        p = prob_fa64
        args = [a.to(dt) for a in (Aw, Bw, cw, p.Q, p.QN, p.R, e0, p.u_min,
                                   p.u_max)]
        out[dt] = [riccati_soa.solve_box_mpc_riccati_soa_fused(
            *args, x_ref=ew.to(dt), iters=ITERS, use_kernels=uk)
            for uk in ("whole", "never", "passes")]
    torch.cuda.synchronize()
    (uk64, xk64), (up64, xp64), (uq64, xq64) = out[f64]
    (uk32, xk32), (up32, xp32), (uq32, xq32) = out[f32]
    k4["wide"] = {"H": FA_H, "n": 2 * nv_fa, "m": nv_fa, "B": FA_B,
                  "mode": "x_ref", **k4_case(uq64, xq64, uq32, xq32, up64,
                                             xp64, up32, xp32)}
    k4_max_abs = max(k4_max_abs, abs_err(uq64, up64), abs_err(xq64, xp64))
    for case in [k4["wide"]] + list(k4["modes"].values()):
        for o in ("u", "xs"):
            check(case["f64_rel"][o] <= 1e-9, f"K4 solve f64 {o} relative")
            check(case["f32_abs"][o] <= 2.0 * case["plain_f32_abs"][o],
                  f"K4 solve f32 {o} error above twice the plain f32 error")
    emit(k4)
    k2w = {"phase": "k2_wide_vs_plain", "H": FA_H, "n": 2 * nv_fa,
           "m": nv_fa, "iters": ITERS, "B": FA_B, "mode": "x_ref",
           "f64_rel": {"u": rel_err(uk64, up64), "xs": rel_err(xk64, xp64)},
           "f32_abs": {"u": abs_err(uk32, up64), "xs": abs_err(xk32, xp64)},
           "plain_f32_abs": {"u": abs_err(up32, up64),
                             "xs": abs_err(xp32, xp64)},
           "active_bounds": int((up64.abs() > 30.0 - 1e-6).sum())}
    for o in ("u", "xs"):
        check(k2w["f64_rel"][o] <= 1e-9, f"K2 (24, 12) f64 {o} relative")
        check(k2w["f32_abs"][o] <= 2.0 * k2w["plain_f32_abs"][o],
              f"K2 (24, 12) f32 {o} error above twice the plain f32 error")
    k2_max_abs = max(k2_max_abs, abs_err(uk64, up64), abs_err(xk64, xp64))
    args32 = [a.to(f32) for a in (Aw, Bw, cw, prob_fa64.Q, prob_fa64.QN,
                                  prob_fa64.R, e0, prob_fa64.u_min,
                                  prob_fa64.u_max)]
    ew32 = ew.to(f32)
    wide = lambda uk: riccati_soa.solve_box_mpc_riccati_soa_fused(
        *args32, x_ref=ew32, iters=ITERS, use_kernels=uk)
    k2w["ms"] = cuda_ms(lambda: wide("whole"), reps=5)
    k2w["plain_ms"] = cuda_ms(lambda: wide("never"), reps=1)
    emit(k2w)
    del Aw, Bw, cw, out, args32

    # ---- the CUDA graphs against the eager functions, f64 ----------------
    # the free-base stage (step + LTV) at the last state of the loop above
    # and inputs ±2 from the seed, replayed from the graphs that loop captured, against the uncaptured
    # functions; one line-search rollout of the flagship (B=8192, H=50,
    # inputs ±5 from the seed): its first call captures the RK4 step and
    # replays it for the later steps, its second call replays every step,
    # both against the rollout with every step eager
    gr = {"phase": "graphs_vs_eager", "dtype": "float64", "stage": {}}
    u_gr = on(rng.uniform(-2.0, 2.0, (nv_fa, FA_B)), f64)
    stage_g = (step_fa(x, u_gr), *ltv_fa(x, u_gr))
    stage_e = (step_fa.eager(x, u_gr), *ltv_fa.eager(x, u_gr))
    torch.cuda.synchronize()
    for nm, a, e in zip(("step", "A_d", "B_d", "c_d"), stage_g, stage_e):
        gr["stage"][nm] = {"rel": rel_err(a, e), "bitwise": torch.equal(a, e)}
    gr["stage_seconds"] = {nm: next(iter(f.captured.values())).seconds
                           for nm, f in (("step", step_fa), ("ltv", ltv_fa))}
    del stage_g, stage_e
    roll_ls = lanes.make_rollout_lanes(spec, DT)
    x0_ls = on(x0_np, f64)
    u_ls = on(rng.uniform(-5.0, 5.0, (H, M, B)), f64)
    k3a_at = [chol_lanes.launches["solve_lanes"]]
    xs_first, t_first = timed(lambda: roll_ls(x0_ls, u_ls))
    k3a_at.append(chol_lanes.launches["solve_lanes"])
    xs_replay, t_replay = timed(lambda: roll_ls(x0_ls, u_ls))
    k3a_at.append(chol_lanes.launches["solve_lanes"])
    xs_eager, t_eager = timed(lambda: roll_ls.eager(x0_ls, u_ls))
    cap = next(iter(roll_ls.step.captured.values()))
    gr["rollout"] = {
        "H": H, "B": B, "replay_rel": rel_err(xs_replay, xs_eager),
        "replay_bitwise": torch.equal(xs_replay, xs_eager),
        "first_rel": rel_err(xs_first, xs_eager),
        "first_bitwise": torch.equal(xs_first, xs_eager),
        "first_ms": t_first, "replay_ms": t_replay, "eager_ms": t_eager,
        "step_seconds": cap.seconds,
        "k3a_launches": [k3a_at[1] - k3a_at[0], k3a_at[2] - k3a_at[1]]}
    emit(gr)
    for nm, e in gr["stage"].items():
        check(e["rel"] <= 1e-12, f"free-base {nm} replayed from its graph "
              "against the eager function")
    for key in ("replay_rel", "first_rel"):
        check(gr["rollout"][key] <= 1e-12, f"line-search rollout {key}")
    check(gr["rollout"]["k3a_launches"] == [4 * H, 4 * H],
          f"the line-search rollout did not count 4 K3a launches a step: "
          f"{gr['rollout']['k3a_launches']}")
    check(bool(torch.isfinite(xs_replay).all()),
          "the replayed rollout is not finite")
    del roll_ls, xs_first, xs_replay, xs_eager, x0_ls, u_ls

    # ---- K2 and K4a-c on ragged batches and padded widths, f64 ------------
    # batches that are no multiple of the tile (its last block runs lanes
    # past B) and widths off the exact instances (the padded ones), on a
    # random LTV near the identity with a ±1.5 box, against the plain
    # versions
    def synthetic(n, m, batch, horizon=12):
        t = lambda a: on(a, f64)
        return {"A": t(0.1 * rng.standard_normal((horizon, n, n, batch))
                       + np.eye(n)[None, :, :, None]),
                "Bm": t(0.2 * rng.standard_normal((horizon, n, m, batch))),
                "c": t(0.05 * rng.standard_normal((horizon, n, batch))),
                "Q": t(np.eye(n) + 0.01), "QN": t(5.0 * np.eye(n)),
                "R": t(0.1 * np.eye(m) + 0.01),
                "x0": t(rng.standard_normal((n, batch))),
                "lb": t(np.full(m, -1.5)), "ub": t(np.full(m, 1.5)),
                "x_ref": t(0.1 * rng.standard_normal((horizon, n, batch))),
                "u_ref": t(0.1 * rng.standard_normal((horizon, m, batch))),
                "q": t(rng.standard_normal((horizon, n, batch))),
                "u_eff": t(rng.standard_normal((horizon, m, batch))),
                "D": t(rng.uniform(0.5, 2.0, (horizon, m, batch))),
                "rhs": t(rng.standard_normal((horizon, m, batch))),
                "k": t(rng.standard_normal((horizon, m, batch))),
                "dx0": t(rng.standard_normal((n, batch)))}

    def edge_passes(p):
        """K4a-c against their plain passes at f64 on ``synthetic``'s
        problem (K4b and K4c on the plain pass's K and G, K4c from a
        nonzero dx0): each launched once, each within 1e-9 relative, and
        their inputs left as they were."""
        nonlocal k4_max_abs
        pa = [p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN", "R")]
        K_, G_ = riccati_soa.fused_backward_plain(*pa)[1:3]
        args = {"fused_backward": pa,
                "vector_backward": [p["A"], p["Bm"], p["rhs"], K_, G_],
                "forward": [p["A"], p["Bm"], K_, p["k"], p["dx0"]]}
        out = {}
        for entry, a in args.items():
            before, count = [t.clone() for t in a], riccati_bwd.launches[entry]
            got = getattr(riccati_bwd, entry)(*a)
            want = plain_pass[entry](*a)
            got, want = ((got,), (want,)) if torch.is_tensor(got) else (got,
                                                                        want)
            torch.cuda.synchronize()
            out[f"{entry}_f64_rel"] = [rel_err(g, w) for g, w in zip(got,
                                                                     want)]
            check(riccati_bwd.launches[entry] == count + 1,
                  f"a ragged or padded case did not launch {entry}")
            check(all(torch.equal(t, b) for t, b in zip(a, before)),
                  f"K4 {entry} wrote one of its inputs")
            for i, e in enumerate(out[f"{entry}_f64_rel"]):
                check(e <= 1e-9, f"K4 {entry} ragged/padded output {i}")
            k4_max_abs = max([k4_max_abs] + [abs_err(g, w)
                                             for g, w in zip(got, want)])
        return out

    def f32_passes(p, label, iters=ITERS, k2_ref=None):
        """K2 (u and xs, at ``iters`` iterations) and K4a-c on the float32
        copy of ``synthetic``'s f64 problem ``p``, each output against the
        plain f64 result and held to twice the plain float32 path's error
        against it (K4b and K4c on the plain f64 pass's K and G,
        rounded).  ``k2_ref``: the plain f64 K2's (u, xs) on ``p``, where
        the caller has it."""
        q = {k: v.float() for k, v in p.items()}
        K_, G_ = riccati_soa.fused_backward_plain(*[
            p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN",
                           "R")])[1:3]

        def args(d, K, G):
            return {"k2": [d[k] for k in ("A", "Bm", "c", "Q", "QN", "R",
                                          "x0", "lb", "ub")],
                    "fused_backward": [d[k] for k in ("A", "Bm", "q",
                                                      "u_eff", "D", "Q",
                                                      "QN", "R")],
                    "vector_backward": [d["A"], d["Bm"], d["rhs"], K, G],
                    "forward": [d["A"], d["Bm"], K, d["k"], d["dx0"]]}

        a64, a32 = args(p, K_, G_), args(q, K_.float(), G_.float())
        kern = {"k2": lambda *a: riccati_soa.solve_box_mpc_riccati_soa_fused(
                    *a, iters=iters, use_kernels="whole"),
                **{e: getattr(riccati_bwd, e) for e in plain_pass}}
        plain = {"k2": lambda *a: riccati_soa._fused_scan(*a, iters=iters),
                 **plain_pass}
        out = {}
        for key in kern:
            ref = (k2_ref if key == "k2" and k2_ref is not None
                   else plain[key](*a64[key]))
            got, pl = kern[key](*a32[key]), plain[key](*a32[key])
            ref, got, pl = (((ref,), (got,), (pl,)) if torch.is_tensor(ref)
                            else (ref, got, pl))
            out[f"{key}_f32_abs"] = [abs_err(a, r) for a, r in zip(got, ref)]
            out[f"{key}_plain_f32_abs"] = [abs_err(a, r)
                                           for a, r in zip(pl, ref)]
            for i, (e, ep) in enumerate(zip(out[f"{key}_f32_abs"],
                                            out[f"{key}_plain_f32_abs"])):
                check(e <= 2.0 * ep, f"{key} {label} f32 output {i} above "
                      "twice the plain f32 error")
        return out

    edge = {"phase": "ragged_and_padded", "dtype": "float64", "H": 12,
            "cases": {}}
    def tile_case(n_, m_, batch, keys):
        """K2 and K4a-c at widths (n_, m_) on ``batch`` scenarios, f64,
        against their plain versions; K2 in the modes ``keys``."""
        nonlocal k2_max_abs
        p = synthetic(n_, m_, batch)
        tile = _tile.tile_config(n_, m_, f64)
        args = [p[k] for k in ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb",
                               "ub")]
        kw = {k: p[k] for k in keys}
        before = pdip_whole.launches
        (u_k, x_k), (u_p, x_p) = (
            riccati_soa.solve_box_mpc_riccati_soa_fused(
                *args, iters=ITERS, use_kernels=uk, **kw)
            for uk in ("whole", "never"))
        torch.cuda.synchronize()
        k2_tile = _tile.k2_config(n_, m_, f64)
        case = {"exact_instance": tile.exact, "tile_scenarios": tile.scenarios,
                "k2_tile_scenarios": k2_tile.scenarios,
                "k2_batch": -(-batch // k2_tile.batch_quantum)
                * k2_tile.batch_quantum,
                "modes": list(keys) or ["regulator"],
                "k2_f64_rel": {"u": rel_err(u_k, u_p), "xs": rel_err(x_k,
                                                                     x_p)},
                **edge_passes(p),
                "active_bounds": int((u_p.abs() > 1.5 - 1e-9).sum())}
        check(pdip_whole.launches == before + 1,
              f"{n_, m_, batch} did not launch K2")
        check(batch % tile.scenarios != 0, "the batch is a multiple of the "
              "tile: not a ragged case")
        for o, e in case["k2_f64_rel"].items():
            check(e <= 1e-9, f"K2 {n_, m_, batch} f64 {o}")
        k2_max_abs = max(k2_max_abs, abs_err(u_k, u_p), abs_err(x_k, x_p))
        return case

    for n_, m_, batch, keys in ((12, 6, 1000, ()), (12, 6, 1, ("x_ref",
                                                               "u_ref")),
                                (24, 12, 100, ("x_ref",)),
                                (6, 3, 1001, ("x_ref",)),
                                (13, 7, 77, ("x_ref", "u_ref"))):
        edge["cases"][f"n={n_},m={m_},B={batch}"] = tile_case(n_, m_, batch,
                                                              keys)
    check(any(not c["exact_instance"] for c in edge["cases"].values())
          and any(c["active_bounds"] > 0 for c in edge["cases"].values()),
          "no padded instance or no active bound among the edge cases")
    emit(edge)

    # ---- phase 5: the flagship solve through the kernels -----------------
    prob32 = flagship_problem(mpc, dev, f32)
    solve = mpc.make_kte_mpc(spec, prob32, DT, qp_iters=ITERS, sqp_iters=1)
    x0_32 = on(x0_np, f32)
    u0_32 = torch.zeros(B, H, M, dtype=f32, device=dev)
    reset_counts()
    us, xs = solve(x0_32, u0_32)
    torch.cuda.synchronize()
    launches = counts()
    main_runs = {"flagship": launches}
    check(launches["kte_step"] > 0 and launches["pdip_whole"] > 0,
          f"the flagship solve did not launch both kernels: {launches}")
    check(tuple(us.shape) == (B, H, M) and tuple(xs.shape) == (B, H, N),
          "flagship output shapes")
    check(bool(torch.isfinite(us).all()) and bool(torch.isfinite(xs).all()),
          "flagship outputs are not finite")

    roll_p = lanes.make_rollout_ltv_lanes(spec, DT, H)

    def plain_solve(prob, x0s, u0s):
        """The plain solve's controls, and its rollout's time in ms."""
        (A, Bm, c, _), t_roll = timed(lambda: roll_p(x0s, u0s))
        ul, _ = riccati_soa.solve_box_mpc_riccati_soa_fused(
            A, Bm, c, prob.Q, prob.QN, prob.R, x0s.T.contiguous(),
            prob.u_min, prob.u_max, iters=ITERS, use_kernels="never")
        return ul.permute(2, 0, 1), t_roll

    us_p32, t_roll_p = plain_solve(prob32, x0_32, u0_32)
    us_p64, _ = plain_solve(flagship_problem(mpc, dev, f64), on(x0_np, f64),
                            u0_64)
    torch.cuda.synchronize()
    flag = {"phase": "flagship", "B": B, "H": H, "iters": ITERS,
            "dtype": "float32", "launches": launches,
            "max_abs_u_vs_plain_f32": abs_err(us, us_p32),
            "max_abs_u_vs_plain_f64": abs_err(us, us_p64),
            "plain_f32_max_abs_u_vs_plain_f64": abs_err(us_p32, us_p64),
            "max_abs_u": float(us.abs().max()),
            "active_bounds": int((us.abs() > 40.0 - 1e-4).sum())}
    emit(flag)
    # the repo's own bar for f32 bench controls against a tighter solve
    # (tests/test_bench_accuracy.py: ≤1e-3)
    check(flag["max_abs_u_vs_plain_f64"] <= 1e-3,
          "flagship f32 controls more than 1e-3 from the plain f64 solve")

    # ---- phase 6: the independent C++ oracle, reduced H=8 instance -------
    oracle = _build.BUILD_DIR / "mpc_oracle"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", "-O2", "-std=c++17",
                    os.path.join(ROOT, "native", "mpc_oracle.cpp"), "-o",
                    str(oracle)], check=True, capture_output=True)
    Ho = 8
    x0o = bench_states(np.random.default_rng(0), 1)[0]
    lb, ub = np.full(M, -1.0), np.full(M, 1.0)
    fin, fout = _build.BUILD_DIR / "oracle_in.bin", _build.BUILD_DIR / "u.bin"
    export_kte(fin, spec, Ho, x0o, np.diag(FLAGSHIP_W),
               np.diag(5.0 * FLAGSHIP_W), np.eye(M) * 0.05, lb, ub)
    subprocess.run([str(oracle), "--kte", str(fin), str(fout)], check=True,
                   timeout=300)
    u_cpp = np.fromfile(fout, np.float64).reshape(Ho, M)
    probo = flagship_problem(mpc, dev, f64, horizon=Ho, bound=1.0)
    before = (kte_step.launches, pdip_whole.launches)
    u_port, _ = mpc.make_kte_mpc(spec, probo, DT, qp_iters=30)(
        on(x0o[None], f64), torch.zeros(1, Ho, M, dtype=f64, device=dev))
    err = float(np.abs(u_port[0].cpu().numpy() - u_cpp).max())
    active = int(np.sum((np.abs(u_cpp - lb) < 1e-6)
                        | (np.abs(u_cpp - ub) < 1e-6)))
    emit({"phase": "oracle", "H": Ho, "iters": 30, "dtype": "float64",
          "max_abs_u_vs_oracle": err, "active_bounds": active,
          "through_kernels": [kte_step.launches > before[0],
                              pdip_whole.launches > before[1]]})
    check(err <= 1e-4, f"port vs C++ oracle {err:.2e} > 1e-4")
    check(active > 0, "no active box constraint on the oracle instance")
    check(kte_step.launches > before[0] and pdip_whole.launches > before[1],
          "the oracle solve did not go through both kernels")

    # ---- the second branch of make_kte_mpc: batch first and register -----
    # The JAX package's cross-check routes, each at the flagship width
    # (f32, B = 8192 timed by phase; f64 at B = BF_B64 held to the K1 + K2
    # route at the JAX package's layout bars, atol 1e-8, rtol 1e-6); the
    # rollouts' steps are replayed from CUDA graphs (kte/soa.py,
    # kte/lanes.make_rollout_ltv_batchfirst; one eager step is timed beside
    # them), so each solver's first call, which captures, is timed apart
    # from its warm one:
    #   vmap        qp_layout="vmap": the register rollout, then the
    #               batch-first PDIP (ctrl/riccati.py);
    #   vmap_lanes  qp_layout="vmap", rollout="lanes": the batch-first
    #               lanes rollout, then the batch-first PDIP;
    #   register    rollout="register": the register rollout, then the
    #               unfused lanes PDIP (ctrl/riccati_soa.py).
    # Launches a solve, from the code: the batch-first PDIP makes one
    # chol_solve_auto a stage in lqr_backward (K3b, n right-hand sides) and
    # one in each of the two lqr_solve_rhs (K3a) per iteration, so K3b =
    # ITERS·H and K3a = 2·ITERS·H; the unfused lanes PDIP makes one
    # solve_lanes_multi a stage in lqr_backward_soa and in each of the two
    # vector passes (riccati_soa.py:331-386), so K3b = 3·ITERS·H, K3a = 0.
    # No route launches K1, K5, K2 or K4.
    from reak_tpu_torch.ctrl import riccati
    from reak_tpu_torch.kte import soa

    bf = {"phase": "batch_first", "B": B, "H": H, "iters": ITERS,
          "f64_B": BF_B64, "routes": {}}
    routes = {"vmap": dict(qp_layout="vmap"),
              "vmap_lanes": dict(qp_layout="vmap", rollout="lanes"),
              "register": dict(rollout="register")}
    want_k3 = {"vmap": (2 * ITERS * H, ITERS * H),
               "vmap_lanes": (2 * ITERS * H, ITERS * H),
               "register": (0, 3 * ITERS * H)}
    prob64 = flagship_problem(mpc, dev, f64)
    x0_bf = on(x0_np[:BF_B64], f64)
    u0_bf = torch.zeros(BF_B64, H, M, dtype=f64, device=dev)
    us_ref, xs_ref = mpc.make_kte_mpc(spec, prob64, DT, qp_iters=ITERS)(
        x0_bf, u0_bf)
    # the K1 rollout's LTV, batch first, that the other rollouts are held to
    ltv_k1 = [torch.movedim(a, -1, 0) for a in
              lanes.make_rollout_ltv_fullfused(spec, DT, H)(x0_bf, u0_bf)]
    ltv_of = {"register": soa.make_rollout_ltv_soa(spec, DT, H),
              "batchfirst": lanes.make_rollout_ltv_batchfirst(spec, DT, H)}
    bf["ltv_f64_rel_vs_k1"] = {}
    for key, roll in ltv_of.items():
        got = roll(x0_bf, u0_bf)
        bf["ltv_f64_rel_vs_k1"][key] = [rel_err(a, r)
                                        for a, r in zip(got, ltv_k1)]
        for i, e in enumerate(bf["ltv_f64_rel_vs_k1"][key]):
            check(e <= 1e-7, f"the {key} LTV output {i} against K1's")
    del ltv_k1, got

    def close(a, b):
        """max of |a − b| − (atol + rtol |b|): ≤ 0 passes the JAX package's
        layout bars."""
        return float(((a - b).abs() - (1e-8 + 1e-6 * b.abs())).max())

    # x0_32, u0_32 and prob32: the flagship's f32 inputs of phase 5
    eager_step_ms = {}
    for name, kw in routes.items():
        res = {}
        solve64 = mpc.make_kte_mpc(spec, prob64, DT, qp_iters=ITERS, **kw)
        reset_counts()
        us64, xs64 = solve64(x0_bf, u0_bf)
        torch.cuda.synchronize()
        res["launches_f64"] = counts()
        res["u_f64_vs_k1_k2"] = close(us64, us_ref)
        res["xs_f64_vs_k1_k2"] = close(xs64, xs_ref)
        check(res["u_f64_vs_k1_k2"] <= 0 and res["xs_f64_vs_k1_k2"] <= 0,
              f"route {name}: f64 controls or states beyond atol 1e-8, "
              "rtol 1e-6 of the K1 + K2 route")
        # the first f32 call captures the rollout's step (a CUDA graph per
        # solver, shape and type); the warm one is the route's run
        solve32 = mpc.make_kte_mpc(spec, prob32, DT, qp_iters=ITERS, **kw)
        _, res["first_call_ms"] = timed(lambda: solve32(x0_32, u0_32))
        reset_counts()
        (us32, xs32), res["solve_ms"] = timed(lambda: solve32(x0_32, u0_32))
        main_runs[f"batch_first.{name}"] = res["launches"] = counts()
        res["u_f32_max_abs_vs_f64"] = abs_err(us32[:BF_B64], us64)
        check(res["u_f32_max_abs_vs_f64"] <= 1e-3,
              f"route {name}: f32 controls more than 1e-3 from its f64 solve")
        check(bool(torch.isfinite(us32).all())
              and bool(torch.isfinite(xs32).all()),
              f"route {name}: f32 outputs are not finite")
        for runs in (res["launches"], res["launches_f64"]):
            got_k3 = (runs["chol_lanes.solve_lanes"],
                      runs["chol_lanes.solve_lanes_multi"])
            check(got_k3 == want_k3[name], f"route {name}: K3a/K3b launches "
                  f"{got_k3}, expected {want_k3[name]}")
            check(all(v == 0 for k, v in runs.items()
                      if not k.startswith("chol_lanes")),
                  f"route {name} launched K1, K5, K2 or K4: {runs}")
        # the two phases apart, composed from the same public functions
        # (the rollout warm: its f32 step captured at its first call)
        roll = (ltv_of["batchfirst"] if kw.get("rollout") == "lanes"
                else ltv_of["register"])
        roll(x0_32, u0_32)
        (A_, B_, c_, _), res["rollout_ms"] = timed(lambda: roll(x0_32,
                                                                u0_32))
        if kw.get("qp_layout") == "vmap":
            pdip_bf = lambda: riccati.solve_box_mpc_riccati(
                A_, B_, c_, prob32.Q, prob32.QN, prob32.R, x0_32,
                prob32.u_min, prob32.u_max, iters=ITERS)
        else:
            pdip_bf = lambda: riccati_soa.solve_box_mpc_riccati_soa(
                torch.movedim(A_, 0, -1), torch.movedim(B_, 0, -1),
                torch.movedim(c_, 0, -1), prob32.Q, prob32.QN, prob32.R,
                x0_32.T, prob32.u_min, prob32.u_max, iters=ITERS)
        _, res["pdip_ms"] = timed(pdip_bf)
        # one step of the rollout run eagerly (the function its CUDA graph
        # replays), after a first call; once a rollout
        if roll not in eager_step_ms:
            xs_, us_ = x0_32.T.contiguous(), u0_32[:, 0].T.contiguous()
            roll.step.eager(xs_, us_)
            _, eager_step_ms[roll] = timed(lambda: roll.step.eager(xs_, us_))
        res["eager_step_ms"] = eager_step_ms[roll]
        bf["routes"][name] = res
        del us64, xs64, us32, xs32, A_, B_, c_
    # the batch-first route against the independent C++ oracle on phase 6's
    # instance (H = 8, ±1, 30 iterations), f64
    A_o, B_o, c_o, _ = lanes.make_rollout_ltv_batchfirst(spec, DT, Ho)(
        on(x0o[None], f64), torch.zeros(1, Ho, M, dtype=f64, device=dev))
    u_bfo, _ = riccati.solve_box_mpc_riccati(
        A_o, B_o, c_o, probo.Q, probo.QN, probo.R, on(x0o[None], f64),
        probo.u_min, probo.u_max, iters=30)
    bf["oracle_max_abs_u"] = float(np.abs(u_bfo[0].cpu().numpy()
                                          - u_cpp).max())
    emit(bf)
    check(bf["oracle_max_abs_u"] <= 1e-4,
          f"batch-first route vs the C++ oracle {bf['oracle_max_abs_u']:.2e}")
    del us_ref, xs_ref, x0_bf, u0_bf

    # ---- the satellite scenario MPC (bench.py:223-263) -------------------
    params, prob_sat32, xr_sat32 = sat_config(mpc, ss_systems, dev, f32)
    _, prob_sat64, xr_sat64 = sat_config(mpc, ss_systems, dev, f64)
    x0_sat = sat_states(belief, mpc_manifold, ss_systems, SAT_B, dev)
    u0_sat = torch.zeros(SAT_B, SAT_H, 6, dtype=f64, device=dev)
    sat32 = manifold_lanes.make_sat_scenario_mpc_lanes(
        params, prob_sat32, SAT_DT, qp_iters=ITERS, sqp_iters=2)
    reset_counts()
    (us_sat, xs_sat), t_sat = timed(lambda: sat32(
        x0_sat.to(f32), xr_sat32, u0_sat.to(f32)))
    main_runs["free_base_sat"] = counts()
    us_sat_p, _ = manifold_lanes.make_sat_scenario_mpc_lanes(
        params, prob_sat64, SAT_DT, qp_iters=ITERS, sqp_iters=2,
        use_kernels="never")(x0_sat, xr_sat64, u0_sat)
    torch.cuda.synchronize()
    sat = {"phase": "free_base_sat", "B": SAT_B, "H": SAT_H, "dt": SAT_DT,
           "sqp_iters": 2, "iters": ITERS, "dtype": "float32",
           "launches": main_runs["free_base_sat"],
           "max_abs_u_vs_plain_f64": abs_err(us_sat, us_sat_p),
           "max_abs_u": float(us_sat.abs().max()),
           "active_bounds": int((us_sat.abs() > 20.0 - 1e-4).sum())}
    emit(sat)
    check(sat["launches"]["pdip_whole"] > 0,
          "the satellite solve did not launch the whole-solve kernel")
    check(tuple(us_sat.shape) == (SAT_B, SAT_H, 6)
          and tuple(xs_sat.shape) == (SAT_B, SAT_H, 13),
          "satellite output shapes")
    check(bool(torch.isfinite(us_sat).all())
          and bool(torch.isfinite(xs_sat).all()),
          "satellite outputs are not finite")
    check(sat["max_abs_u_vs_plain_f64"] <= 1e-3,
          "satellite f32 controls more than 1e-3 from the plain f64 solve")

    # ---- the satellite solve on the per-pass kernels ----------------------
    sat32p = manifold_lanes.make_sat_scenario_mpc_lanes(
        params, prob_sat32, SAT_DT, qp_iters=ITERS, sqp_iters=2,
        use_kernels="passes")
    reset_counts()
    (us_satp, xs_satp), t_satp = timed(lambda: sat32p(
        x0_sat.to(f32), xr_sat32, u0_sat.to(f32)))
    main_runs["free_base_sat_passes"] = counts()
    satp = {"phase": "free_base_sat_passes", "B": SAT_B, "H": SAT_H,
            "sqp_iters": 2, "iters": ITERS, "dtype": "float32",
            "launches": main_runs["free_base_sat_passes"], "ms": t_satp,
            "solves_per_s": SAT_B / t_satp * 1e3,
            "max_abs_u_vs_plain_f64": abs_err(us_satp, us_sat_p),
            "max_abs_u_vs_whole_f32": abs_err(us_satp, us_sat),
            "active_bounds": int((us_satp.abs() > 20.0 - 1e-4).sum())}
    emit(satp)
    for name in riccati_bwd.launches:
        check(satp["launches"][f"riccati_bwd.{name}"] > 0,
              f"the satellite solve on the passes did not launch {name}")
    check(tuple(us_satp.shape) == (SAT_B, SAT_H, 6)
          and tuple(xs_satp.shape) == (SAT_B, SAT_H, 13)
          and bool(torch.isfinite(us_satp).all())
          and bool(torch.isfinite(xs_satp).all()),
          "satellite outputs on the passes are not finite or of the wrong "
          "shape")
    check(satp["max_abs_u_vs_plain_f64"] <= 1e-3,
          "satellite f32 controls on the passes more than 1e-3 from the "
          "plain f64 solve")
    del us_sat_p, xs_sat, xs_satp

    # ---- the flagship with two SQP passes and the line search -----------
    # the first call captures the line search's RK4 step; the warm call
    # replays it
    solve2 = mpc.make_kte_mpc(spec, prob32, DT, qp_iters=ITERS, sqp_iters=2)
    reset_counts()
    (us2, xs2), t_sqp2 = timed(lambda: solve2(x0_32, u0_32))
    main_runs["flagship_sqp"] = counts()
    reset_counts()
    (us2w, _), t_sqp2_warm = timed(lambda: solve2(x0_32, u0_32))
    sqp2_warm_launches = counts()
    traj_cost, _ = mpc.make_traj_cost(spec, prob32, DT)
    J_init = traj_cost(x0_32, u0_32.permute(1, 2, 0))
    J_sqp = traj_cost(x0_32, us2.permute(1, 2, 0).contiguous())

    # ---- the floating arm (bench.py:265-313) -----------------------------
    prob_fa32, xr_fa32 = floating_arm_config(mpc, fa, dev, f32)
    solve_fa = floating_arm_solver(lanes, manifold_lanes, fa, prob_fa32)
    x0_fa32 = on(x0_fa_np, f32)
    u0_fa32 = torch.zeros(FA_B, FA_H, nv_fa, dtype=f32, device=dev)
    reset_counts()
    (us_fa, xs_fa), t_fa = timed(lambda: solve_fa(x0_fa32, xr_fa32, u0_fa32))
    main_runs["floating_arm"] = counts()
    reset_counts()
    (us_faw, _), t_fa_warm = timed(lambda: solve_fa(x0_fa32, xr_fa32,
                                                    u0_fa32))
    fa_warm_launches = counts()

    # ---- the generic dense MPC and the closed loop, f64 -------------------
    # ctrl/mpc.solve on the LTV data of tests/test_mpc_parity.py:75-140
    # (planar_2link, dt 0.02, x0 (0.4, -0.2, 0.1, 0.05), Q = I, QN = 5 I,
    # R = 0.1 I, ±3, 30 iterations; the LTV from kte/soa's rollout, passed
    # in through linearizer=): method "riccati" (H = 12; K3a 2·30·H and K3b
    # 30·H at B = 1) and "condensed" (H = 8; the dense Cholesky in torch),
    # each against native/mpc_oracle (≤1e-4, with active bounds);
    # receding_horizon on the double integrator of tests/test_qp_mpc.py:
    # 143-156 (‖x₈₀‖ < 1e-2); the closed loop of tests/test_tracking_mpc.py:
    # 123-156 (planar_2link, make_kte_mpc re-solved each step against the
    # kte_discrete plant, 60 steps: position error < 0.05, rates < 0.1; on
    # the card its rollout is K1, the CPU test takes the plain lanes one); make_kte_scenario_mpc on both branches, each equal bit
    # for bit to the call it routes to: the flagship arm (B, one pass, K1 +
    # K2) and the floating arm (N_REF scenarios, its lanes SQP on K2 and
    # K3).  It needs none of the CPU child's references, so it runs while
    # the child may still be running, before the wait for it.
    p2 = models.planar_2link()
    dc = {"phase": "dense_and_closed_loop", "dtype": "float64", "dense": {}}
    x0_d = np.array([0.4, -0.2, 0.1, 0.05])
    Q_d, QN_d, R_d = np.eye(4), 5.0 * np.eye(4), 0.1 * np.eye(2)
    lb_d, ub_d = np.full(2, -3.0), np.full(2, 3.0)
    plant = systems.kte_discrete(p2, 0.02)
    for method, H_d in (("riccati", 12), ("condensed", 8)):
        A_d, B_d, c_d, _ = (a[0] for a in soa.make_rollout_ltv_soa(
            p2, 0.02, H_d)(on(x0_d[None], f64),
                           torch.zeros(1, H_d, 2, dtype=f64, device=dev)))
        fin_d = _build.BUILD_DIR / f"oracle_ltv_{method}.bin"
        fout_d = _build.BUILD_DIR / f"u_ltv_{method}.bin"
        export_ltv(fin_d, *(a.cpu().numpy() for a in (A_d, B_d, c_d)), x0_d,
                   Q_d, QN_d, R_d, lb_d, ub_d)
        subprocess.run([str(oracle), str(fin_d), str(fout_d)], check=True,
                       timeout=120)
        u_ltv = np.fromfile(fout_d, np.float64).reshape(H_d, 2)
        prob_d = mpc.MPCProblem(Q=on(Q_d, f64), R=on(R_d, f64),
                                QN=on(QN_d, f64), u_min=on(lb_d, f64),
                                u_max=on(ub_d, f64), horizon=H_d)
        reset_counts()
        sol_d, ms_d = timed(lambda: mpc.solve(
            plant, prob_d, on(x0_d, f64), qp_iters=30, method=method,
            linearizer=lambda xs_, us_: (A_d, B_d, c_d)))
        runs = counts()
        if method == "riccati":
            main_runs["dense_solve"] = runs
        want = ({"chol_lanes.solve_lanes": 2 * 30 * H_d,
                 "chol_lanes.solve_lanes_multi": 30 * H_d}
                if method == "riccati" else {})
        want = {k: want.get(k, 0) for k in runs}
        err_d = float(np.abs(sol_d.u.cpu().numpy() - u_ltv).max())
        active_d = int(np.sum((np.abs(u_ltv - lb_d) < 1e-6)
                              | (np.abs(u_ltv - ub_d) < 1e-6)))
        dc["dense"][method] = {"H": H_d, "iters": 30, "ms": ms_d,
                               "launches": runs, "max_abs_u_vs_oracle": err_d,
                               "active_bounds": active_d}
        check(runs == want, f"mpc.solve({method}) launched {runs}, expected "
              f"{want}")
        check(err_d <= 1e-4, f"mpc.solve({method}) vs the C++ oracle "
              f"{err_d:.2e} > 1e-4")
        check(active_d > 0, f"no active bound on the {method} instance")
    # receding horizon on the double integrator
    A_di = on([[1.0, 0.1], [0.0, 1.0]], f64)
    B_di = on([[0.005], [0.1]], f64)
    prob_di = mpc.MPCProblem(Q=torch.eye(2, dtype=f64, device=dev),
                             R=0.1 * torch.eye(1, dtype=f64, device=dev),
                             QN=10.0 * torch.eye(2, dtype=f64, device=dev),
                             u_min=on([-2.0], f64), u_max=on([2.0], f64),
                             horizon=15)
    (xs_rh, us_rh), ms_rh = timed(lambda: mpc.receding_horizon(
        systems.lti_discrete(A_di, B_di), prob_di, on([1.5, 0.0], f64), 80,
        qp_iters=12))
    dc["receding_horizon"] = {"steps": 80, "H": 15, "ms": ms_rh,
                              "final_norm": float(torch.linalg.vector_norm(
                                  xs_rh[-1]))}
    check(dc["receding_horizon"]["final_norm"] < 1e-2,
          "receding_horizon did not stabilize the double integrator")
    # the closed loop of tests/test_tracking_mpc.py:123-156
    H_cl, m_cl, dt_cl = 20, 2, 0.05
    prob_cl = mpc.MPCProblem(
        Q=torch.diag(on([10.0, 10.0, 1.0, 1.0], f64)),
        R=1e-3 * torch.eye(m_cl, dtype=f64, device=dev),
        QN=torch.diag(on([50.0, 50.0, 5.0, 5.0], f64)),
        u_min=on(np.full(m_cl, -30.0), f64),
        u_max=on(np.full(m_cl, 30.0), f64), horizon=H_cl)
    x_ref_cl = on([0.4, -0.3, 0.0, 0.0], f64)
    solver_cl = mpc.make_kte_mpc(p2, prob_cl, dt_cl, qp_iters=8, sqp_iters=1)
    plant_cl = systems.kte_discrete(p2, dt_cl)
    u0_cl = torch.zeros(1, H_cl, m_cl, dtype=f64, device=dev)

    def closed_loop():
        x = torch.zeros(4, dtype=f64, device=dev)
        for _ in range(60):
            us_cl, _ = solver_cl(x[None], u0_cl, x_ref=x_ref_cl)
            x = plant_cl(x, us_cl[0, 0])
        return x

    reset_counts()
    x_cl, ms_cl = timed(closed_loop)
    main_runs["closed_loop"] = counts()
    dc["closed_loop"] = {
        "steps": 60, "ms": ms_cl, "launches": main_runs["closed_loop"],
        "max_pos_err": float((x_cl[0:2] - x_ref_cl[0:2]).abs().max()),
        "max_rate": float(x_cl[2:4].abs().max())}
    check(main_runs["closed_loop"]["kte_step"] == 60 * H_cl
          and main_runs["closed_loop"]["pdip_whole"] == 60,
          f"the closed loop did not solve each step on K1 and K2: "
          f"{main_runs['closed_loop']}")
    check(dc["closed_loop"]["max_pos_err"] < 0.05
          and dc["closed_loop"]["max_rate"] < 0.1,
          f"the closed loop missed its target: {dc['closed_loop']}")
    # make_kte_scenario_mpc, both branches, bit for bit the direct calls
    prob_fx = flagship_problem(mpc, dev, f64)
    x0_fx = on(x0_np, f64)
    xr_fx = torch.zeros(N, dtype=f64, device=dev)
    xr_fx[0:3] = on([0.3, -0.2, 0.1], f64)
    u0_fx = torch.zeros(B, H, M, dtype=f64, device=dev)
    reset_counts()
    got_fx = mpc_manifold.make_kte_scenario_mpc(
        spec, prob_fx, DT, qp_iters=ITERS, sqp_iters=1)(x0_fx, xr_fx, u0_fx)
    main_runs["kte_scenario.fixed"] = counts()
    want_fx = mpc.make_kte_mpc(spec, prob_fx, DT, qp_iters=ITERS,
                               sqp_iters=1)(x0_fx, u0_fx, x_ref=xr_fx)
    x0_fr = on(x0_fa_np[:N_REF], f64)
    u0_fr = torch.zeros(N_REF, FA_H, nv_fa, dtype=f64, device=dev)
    reset_counts()
    got_fr = mpc_manifold.make_kte_scenario_mpc(
        fa, prob_fa64, FA_DT, qp_iters=ITERS)(x0_fr, xr_fa64, u0_fr)
    main_runs["kte_scenario.free"] = counts()
    want_fr = manifold_lanes.make_scenario_mpc_lanes(
        *lanes.make_kte_manifold_lanes(fa, FA_DT), prob_fa64,
        tangent_dim=2 * nv_fa, quat_index=3, qp_iters=ITERS, sqp_iters=2)(
        x0_fr, xr_fa64, u0_fr)
    dc["kte_scenario"] = {
        "fixed": {"chain": spec.name, "B": B, "H": H, "sqp_iters": 1,
                  "launches": main_runs["kte_scenario.fixed"],
                  "bitwise": all(torch.equal(a, b)
                                 for a, b in zip(got_fx, want_fx))},
        "free": {"chain": fa.name, "B": N_REF, "H": FA_H, "sqp_iters": 2,
                 "launches": main_runs["kte_scenario.free"],
                 "bitwise": all(torch.equal(a, b)
                                for a, b in zip(got_fr, want_fr))}}
    emit(dc)
    fixed_runs = main_runs["kte_scenario.fixed"]
    check(fixed_runs["kte_step"] == H and fixed_runs["pdip_whole"] == 1,
          f"the fixed branch did not run on K1 and K2: {fixed_runs}")
    check(main_runs["kte_scenario.free"]["pdip_whole"] == 2,
          "the free branch did not run a K2 launch a pass")
    for branch in ("fixed", "free"):
        check(dc["kte_scenario"][branch]["bitwise"],
              f"make_kte_scenario_mpc's {branch} branch differs from the "
              "call it routes to")
    del got_fx, want_fx, got_fr, want_fr, x0_fx, u0_fx

    # ---- the arm builders, IK and integrators, then estimation
    # and LQG (the port's examples, math/are, ctrl/lqg); the card work of
    # the first runs before the wait for the CPU child
    waited = {}

    def cpu_refs():
        if not waited:
            waited["refs"], waited["s"] = cpu_references()
        return waited["refs"]

    og_finish = early["optimizers_geometry"]
    isi_finish = early["interp_spaces_io"]
    pl_finish = early["planning"]
    sme_finish = early["spaces_meaqr_examples"]
    clik_share = arms_ik_integrators(card, dev, cpu_refs, reset_counts,
                                     counts, main_runs, early["stiff_suite"])
    og_finish(cpu_refs(), clik_share)
    isi_finish(cpu_refs())
    pl_finish(cpu_refs())
    sme_finish(child_result("spaces_reference", sme_ref_path())[0])
    estimation(card, dev, cpu_refs, step_k, k64, x_np, u_np, reset_counts,
               counts, main_runs, early["estimation_filters"])
    refs, ref_wait = cpu_refs(), waited["s"]
    err2 = np.abs(us2[:N_REF].double().cpu().numpy()
                  - refs["flagship_sqp_us"]).max(axis=(1, 2))
    sqp = {"phase": "flagship_sqp", "B": B, "H": H, "iters": ITERS,
           "sqp_iters": 2, "dtype": "float32",
           "launches": main_runs["flagship_sqp"],
           "warm_launches": sqp2_warm_launches,
           "first_ms": t_sqp2, "warm_ms": t_sqp2_warm,
           "warm_max_abs_u_vs_first": abs_err(us2w, us2),
           "max_abs_u_vs_cpu_f64": float(err2.max()),
           "share_within_1e-3": float(np.mean(err2 <= 1e-3)),
           "reference_scenarios": N_REF,
           "cpu_reference_seconds": float(refs["seconds"]),
           "waited_for_cpu_reference_seconds": ref_wait,
           "cost_init_mean": float(J_init.mean()),
           "cost_sqp_mean": float(J_sqp.mean()),
           "scenarios_cost_down": int((J_sqp < J_init).sum()),
           "max_cost_rise": float((J_sqp - J_init).max())}
    emit(sqp)
    for name in ("kte_step", "pdip_whole", "chol_lanes.solve_lanes"):
        check(sqp["launches"][name] > 0,
              f"the two-pass flagship solve did not launch {name}")
    # 2 passes × 5 RK4 rollouts (4 priced candidates and the trajectory of
    # the choice) × H steps × 4 rates, on the first and the warm call
    for run in (sqp["launches"], sqp["warm_launches"]):
        check(run["chol_lanes.solve_lanes"] == 2 * 5 * H * 4,
              f"the two-pass flagship launched K3a "
              f"{run['chol_lanes.solve_lanes']} times, not {2 * 5 * H * 4}")
    check(bool(torch.isfinite(us2).all()) and bool(torch.isfinite(xs2).all()),
          "two-pass flagship outputs are not finite")
    # the line search never raises the true RK4 cost; the slack covers the
    # f32 recomputation of the same cost
    check(bool((J_sqp <= J_init + 1e-6 * J_init.abs()).all()),
          "the two-pass flagship raised the true cost of a scenario")
    check(sqp["share_within_1e-3"] >= 0.99,
          "fewer than 99 % of the two-pass flagship controls within 1e-3 "
          "of the CPU f64 solve")

    err_fa = abs_err(us_fa[:N_REF].cpu(),
                     torch.as_tensor(refs["floating_arm_us"]))
    fa_res = {"phase": "floating_arm", "B": FA_B, "H": FA_H, "dt": FA_DT,
              "n": 2 * nv_fa, "m": nv_fa, "sqp_iters": 1, "iters": ITERS,
              "dtype": "float32", "launches": main_runs["floating_arm"],
              "warm_launches": fa_warm_launches,
              "first_ms": t_fa, "warm_ms": t_fa_warm,
              "warm_max_abs_u_vs_first": abs_err(us_faw, us_fa),
              "max_abs_u_vs_cpu_f64": err_fa,
              "max_abs_xs_vs_cpu_f64": abs_err(
                  xs_fa[:N_REF].cpu(),
                  torch.as_tensor(refs["floating_arm_xs"])),
              "reference_scenarios": N_REF,
              "max_abs_u": float(us_fa.abs().max()),
              "active_bounds": int((us_fa.abs() > 30.0 - 1e-4).sum())}
    emit(fa_res)
    for name in ("pdip_whole", "chol_lanes.solve_lanes",
                 "chol_lanes.solve_lanes_multi"):
        check(fa_res["launches"][name] > 0,
              f"the floating-arm solve did not launch {name}")
    # one LTV a stage: K3b FA_H times a one-pass solve, first and warm
    for run in (fa_res["launches"], fa_res["warm_launches"]):
        check(run["chol_lanes.solve_lanes_multi"] == FA_H,
              f"the floating arm launched K3b "
              f"{run['chol_lanes.solve_lanes_multi']} times, not {FA_H}")
    check(tuple(us_fa.shape) == (FA_B, FA_H, nv_fa)
          and bool(torch.isfinite(us_fa).all())
          and bool(torch.isfinite(xs_fa).all()),
          "floating-arm outputs are not finite or of the wrong shape")
    check(err_fa <= 1e-3,
          "floating-arm f32 controls more than 1e-3 from the CPU f64 solve")

    # ---- the belief-sampled scenario MPC (bench.py:223-247, config 4) ----
    # The satellite of phase free_base_sat (mass 10, inertia diag(4, 5, 6),
    # tangent n = 12, m = 6, H = SAT_H, dt = SAT_DT, ±20, ITERS iterations,
    # 2 SQP passes) from the x0 that sample_belief_states drew, on two
    # routes in f32 at B = SAT_B, each timed by CUDA events on a second
    # call:
    #   lanes    ctrl/manifold_lanes.make_sat_scenario_mpc_lanes: the
    #            analytic lanes step and LTV, the QP on K2 in its x_ref
    #            mode, one launch a pass;
    #   generic  ctrl/mpc_manifold.make_scenario_mpc on ss_systems.
    #            satellite3D_imdt: the jacfwd linearization under vmap, then
    #            the batch-first Riccati PDIP (ctrl/riccati.py), each stage
    #            one K3b (G⁻¹F) and two K3a (the vector passes) over the
    #            whole batch: K3a = 2·ITERS·H and K3b = ITERS·H a pass.
    # Then at f64: the two routes on SAT_F64_B scenarios with the settings
    # of tests/test_manifold_lanes.py:101-129 (10 iterations, 4 passes;
    # cost within 2e-3 relative, controls within 0.02 of their scale); the
    # generic route against the CPU child's plain f64 solve of its
    # GEN_REF_B scenarios (≤1e-8 relative); and the config-4 composition:
    # 12 IEKF steps on the card (the arc of tests/test_qp_mpc.py:239-266),
    # then belief_scenario_mpc on that posterior at B = SAT_B in f32, every
    # scenario within 0.2 of the target position.
    F_sat = ss_systems.satellite3D_imdt(params, SAT_DT)
    ret_sat = ss_systems.sat3D_retraction()
    x0_s32 = sat_states(belief, mpc_manifold, ss_systems, SAT_B, dev, f32)
    unit_err = lambda xs_: float((torch.linalg.vector_norm(
        xs_[:, 3:7].double(), dim=1) - 1.0).abs().max())
    bs = {"phase": "belief_scenario", "B": SAT_B, "H": SAT_H, "dt": SAT_DT,
          "iters": ITERS, "sqp_iters": 2, "dtype": "float32",
          "sampled_quat_unit_err": {"f64": unit_err(x0_sat),
                                    "f32": unit_err(x0_s32)},
          "routes": {}}
    check(bs["sampled_quat_unit_err"]["f64"] <= 1e-12
          and bs["sampled_quat_unit_err"]["f32"] <= 1e-6,
          f"a sampled quaternion is not unit: {bs['sampled_quat_unit_err']}")
    sat_routes = {
        "lanes": lambda prob, it, sqp: manifold_lanes.make_sat_scenario_mpc_lanes(
            params, prob, SAT_DT, qp_iters=it, sqp_iters=sqp),
        "generic": lambda prob, it, sqp: mpc_manifold.make_scenario_mpc(
            F_sat, ret_sat, prob, qp_iters=it, sqp_iters=sqp)}
    want_launches = {
        "lanes": {"pdip_whole": 2},
        "generic": {"chol_lanes.solve_lanes": 2 * 2 * ITERS * SAT_H,
                    "chol_lanes.solve_lanes_multi": 2 * ITERS * SAT_H}}
    x0_sat32, u0_sat32 = x0_sat.to(f32), u0_sat.to(f32)
    us_route = {}
    for name, make in sat_routes.items():
        solver = make(prob_sat32, ITERS, 2)
        _, first_ms = timed(lambda: solver(x0_sat32, xr_sat32, u0_sat32))
        reset_counts()
        (us_r, xs_r), ms = timed(lambda: solver(x0_sat32, xr_sat32, u0_sat32))
        runs = main_runs[f"belief_scenario.{name}"] = counts()
        bs["routes"][name] = {"first_ms": first_ms, "ms": ms,
                              "solves_per_s": SAT_B / ms * 1e3,
                              "launches_per_solve": runs}
        want = {k: want_launches[name].get(k, 0) for k in runs}
        check(runs == want, f"the {name} satellite route launched {runs}, "
              f"expected {want}")
        check(tuple(us_r.shape) == (SAT_B, SAT_H, 6)
              and tuple(xs_r.shape) == (SAT_B, SAT_H, 13)
              and bool(torch.isfinite(us_r).all())
              and bool(torch.isfinite(xs_r).all()),
              f"the {name} satellite route's outputs are not finite or of "
              "the wrong shape")
        us_route[name] = us_r
        del xs_r
    # the generic route's f32 controls against its own f64 solve
    us_g64, _ = sat_routes["generic"](prob_sat64, ITERS, 2)(
        x0_sat[:SAT_F64_B], xr_sat64, u0_sat[:SAT_F64_B])
    bs["routes"]["generic"]["max_abs_u_vs_f64"] = abs_err(
        us_route["generic"][:SAT_F64_B], us_g64)
    check(bs["routes"]["generic"]["max_abs_u_vs_f64"] <= 1e-3,
          "generic satellite f32 controls more than 1e-3 from its f64 solve")
    # the two routes at f64, the settings of tests/test_manifold_lanes.py
    us_c, xs_c = {}, {}
    for name, make in sat_routes.items():
        us_c[name], xs_c[name] = make(prob_sat64, 10, 4)(
            x0_sat[:SAT_F64_B], xr_sat64, u0_sat[:SAT_F64_B])
    c_l, c_g = (manifold_cost(prob_sat64, ret_sat, us_c[k], xs_c[k], xr_sat64)
                for k in ("lanes", "generic"))
    scale = float(us_c["generic"].abs().max())
    bs["f64_lanes_vs_generic"] = {
        "B": SAT_F64_B, "iters": 10, "sqp_iters": 4,
        "max_cost_rel": float(((c_l - c_g).abs()
                               / torch.clamp(c_g.abs(), min=1.0)).max()),
        "max_abs_u": abs_err(us_c["lanes"], us_c["generic"]),
        "u_scale": scale}
    check(bs["f64_lanes_vs_generic"]["max_cost_rel"] < 2e-3,
          "the lanes and generic satellite routes' costs differ by 2e-3")
    check(bs["f64_lanes_vs_generic"]["max_abs_u"] < 0.02 * max(scale, 1.0),
          "the lanes and generic satellite routes' controls differ")
    # the generic route against the CPU child's plain f64 solve
    x0_gen = on(refs["generic_x0"], f64)
    us_gc, _ = sat_routes["generic"](prob_sat64, ITERS, 2)(
        x0_gen, xr_sat64, torch.zeros(GEN_REF_B, SAT_H, 6, dtype=f64,
                                      device=dev))
    bs["generic_f64_rel_vs_cpu"] = rel_err(
        us_gc.cpu(), torch.as_tensor(refs["generic_us"]))
    check(bs["generic_f64_rel_vs_cpu"] <= 1e-8,
          "the generic satellite route at f64 against the CPU child's solve")
    del us_c, xs_c, us_g64, us_gc
    # the config-4 composition: the IEKF arc, then the sampled scenarios
    Q_n = 1e-6 * torch.eye(12, dtype=f64, device=dev)
    R_n = torch.diag(on(np.r_[np.full(3, 1e-4), np.full(3, 1e-5)], f64))
    x_true = ss_systems.default_state(device=dev)
    x_true[10:13] = on([0.02, -0.01, 0.03], f64)
    b_post = belief.GaussianBelief(ss_systems.default_state(device=dev),
                                   0.1 * torch.eye(12, dtype=f64, device=dev))
    u_zero = torch.zeros(6, dtype=f64, device=dev)
    rng7 = np.random.default_rng(7)
    t_iekf = time.perf_counter()
    for _ in range(12):
        x_true = F_sat(x_true, u_zero)
        z = ss_systems.h_pose(x_true) + torch.cat([
            on(rng7.normal(0, 1e-2, 3), f64), torch.zeros(4, dtype=f64,
                                                           device=dev)])
        b_post = invariant.iekf_step(F_sat, ss_systems.h_pose, ret_sat,
                                     b_post, u_zero, z, Q_n, R_n,
                                     diff=ss_systems.pose_innovation)
    torch.cuda.synchronize()
    t_iekf = time.perf_counter() - t_iekf
    e_post = ret_sat.local(x_true, b_post.mean)
    x_tgt = ss_systems.default_state(dtype=f32, device=dev)
    x_tgt[0:3] = on([0.5, -0.2, 0.3], f32)
    reset_counts()
    (x0_4, us_4, xs_4), t_c4 = timed(lambda: mpc_manifold.belief_scenario_mpc(
        torch.Generator(device=dev).manual_seed(3), F_sat, ret_sat,
        prob_sat32, belief.GaussianBelief(b_post.mean.float(),
                                          b_post.cov.float()),
        SAT_B, x_tgt, qp_iters=ITERS, sqp_iters=2))
    main_runs["belief_scenario.config4"] = counts()
    perr = torch.linalg.vector_norm(xs_4[:, -1, 0:3] - x_tgt[0:3], dim=-1)
    bs["config4"] = {
        "iekf_steps": 12, "iekf_s": t_iekf,
        "posterior_tangent_err": float(torch.linalg.vector_norm(e_post[0:6])),
        "B": SAT_B, "ms": t_c4, "solves_per_s": SAT_B / t_c4 * 1e3,
        "launches": main_runs["belief_scenario.config4"],
        "sampled_quat_unit_err": unit_err(x0_4),
        "max_target_pos_err": float(perr.max())}
    emit(bs)
    check(bs["config4"]["posterior_tangent_err"] < 0.05,
          "the IEKF posterior is not within 0.05 of the true state")
    check(bs["config4"]["sampled_quat_unit_err"] <= 1e-6,
          "a quaternion the posterior sampled is not unit")
    check(bool(torch.isfinite(us_4).all()) and bs["config4"][
        "max_target_pos_err"] < 0.2,
          "a belief-sampled scenario ends more than 0.2 from the target")
    del x0_4, us_4, xs_4, x0_s32, us_route, x0_sat32, u0_sat32


    # ---- the widest instances, f64 ----------------------------------------
    # K1/K5 on the 16-segment beam (16 joints, n = 32) at B = 77 and 1001;
    # K2 and K4a-c at (32, 16), its exact instance, and at (26, 13), its
    # padded one, H = 12; K3a/K3b at n = 17 and 32 (B = 1001, 5 right-hand
    # sides); then the beam's make_kte_mpc solve through K1 and K2 against
    # the CPU child's plain f64 solve.  All against plain versions, ≤1e-9
    # relative.
    beam = models.flexible_beam(BEAM_SEGMENTS)
    nvb = beam.nv
    wide = {"phase": "wide_widths", "dtype": "float64", "k1_k5": {},
            "tile": {}, "k3": {}}
    for batch in (77, 1001):
        xb = on(np.concatenate([rng.uniform(-0.05, 0.05, (nvb, batch)),
                                rng.uniform(-0.5, 0.5, (nvb, batch))]), f64)
        ub_ = on(rng.uniform(-5.0, 5.0, (nvb, batch)), f64)
        before = (kte_step.launches, kte_core.launches)
        got1 = kte_step.make_step_lanes(beam, BEAM_DT)(xb, ub_)
        got5 = kte_core.make_core_lanes(beam)(xb, ub_)
        want1 = kte_step.make_step_plain(beam, BEAM_DT)(xb, ub_)
        want5 = kte_core.make_core_plain(beam)(xb, ub_)
        torch.cuda.synchronize()
        case = {"k1_f64_rel": {nm: rel_err(a, r)
                               for nm, a, r in zip(names, got1, want1)},
                "k5_f64_rel": {nm: rel_err(a, r) for nm, a, r in
                               zip(("qdd", "dqdd", "minv"), got5, want5)}}
        wide["k1_k5"][f"{beam.name},B={batch}"] = case
        check((kte_step.launches, kte_core.launches)
              == (before[0] + 1, before[1] + 1),
              f"{beam.name} B={batch} did not launch K1 and K5")
        for key in ("k1_f64_rel", "k5_f64_rel"):
            for nm, e in case[key].items():
                check(e <= 1e-9, f"{key[:2].upper()} {beam.name} B={batch} "
                      f"{nm} f64 relative error")
        k1_max_abs = max([k1_max_abs] + [abs_err(a, r)
                                         for a, r in zip(got1, want1)])
        k5_max_abs = max([k5_max_abs] + [abs_err(a, r)
                                         for a, r in zip(got5, want5)])
    del xb, ub_, got1, got5, want1, want5
    for n_, m_, batch, keys in ((32, 16, 1001, ("x_ref",)),
                                (26, 13, 77, ("x_ref", "u_ref"))):
        wide["tile"][f"n={n_},m={m_},B={batch}"] = tile_case(n_, m_, batch,
                                                             keys)
    check(wide["tile"]["n=32,m=16,B=1001"]["exact_instance"]
          and not wide["tile"]["n=26,m=13,B=77"]["exact_instance"],
          "the (32, 16) cases did not run the exact and the padded instance")
    # the widest compile-time instance in float32 (its sums in float32;
    # the runtime tile's accumulate in float64), H = 4 as past the caps
    tile32 = _tile.tile_config(32, 16, f32)
    check(tile32.bound == (32, 16) and tile32.exact,
          "(32, 16) f32 is not the exact compile-time instance")
    wide["tile"]["n=32,m=16,B=77,H=4,f32"] = f32_passes(
        synthetic(32, 16, 77, horizon=4), (32, 16))
    for n in (17, 32):
        G_np, r_np = spd(n, 1001), rng.standard_normal((n, 5, 1001))
        g, r = on(G_np, f64), on(r_np, f64)
        before = dict(chol_lanes.launches)
        got_a = chol_lanes.solve_lanes(g, r[:, 0].contiguous())
        got_b = chol_lanes.solve_lanes_multi(g, r)
        want = riccati_soa._chol_solve_lanes(g, r)
        torch.cuda.synchronize()
        wide["k3"][f"n={n}"] = {"solve_lanes_f64_rel": rel_err(got_a,
                                                               want[:, 0]),
                                "solve_lanes_multi_f64_rel": rel_err(got_b,
                                                                     want)}
        check(all(chol_lanes.launches[e] == before[e] + 1
                  for e in chol_lanes.launches), f"K3 n={n} did not launch")
        for key, e in wide["k3"][f"n={n}"].items():
            check(e <= 1e-9, f"K3 n={n} {key}")
        k3_err["solve_lanes"] = max(k3_err["solve_lanes"],
                                    abs_err(got_a, want[:, 0]))
        k3_err["solve_lanes_multi"] = max(k3_err["solve_lanes_multi"],
                                          abs_err(got_b, want))
    del g, r, got_a, got_b, want
    prob_bm = beam_config(mpc, beam, dev, f64)
    x0_bm = on(beam_states(beam), f64)
    u0_bm = torch.zeros(BEAM_B, BEAM_H, nvb, dtype=f64, device=dev)
    solve_bm = mpc.make_kte_mpc(beam, prob_bm, BEAM_DT, qp_iters=ITERS)
    reset_counts()
    (us_bm, xs_bm), t_bm = timed(lambda: solve_bm(x0_bm, u0_bm))
    main_runs["beam"] = counts()
    wide["beam_solve"] = {
        "segments": BEAM_SEGMENTS, "n": 2 * nvb, "m": nvb, "B": BEAM_B,
        "H": BEAM_H, "dt": BEAM_DT, "iters": ITERS, "ms": t_bm,
        "launches": main_runs["beam"],
        "u_rel_vs_cpu_f64": rel_err(us_bm.cpu(),
                                    torch.as_tensor(refs["beam_us"])),
        "xs_rel_vs_cpu_f64": rel_err(xs_bm.cpu(),
                                     torch.as_tensor(refs["beam_xs"])),
        "active_bounds": int((us_bm.abs() > 30.0 - 1e-6).sum())}
    # each wide instance per launch at B = 8192, f64, beside its bound over
    # the float64 peak: K1/K5 on the beam, K2 and K4a-c at (32, 16) with
    # H = 12, K3a/K3b at n = 32, 48 and 64 (one and n right-hand sides)
    wide["per_launch_f64"] = {}

    def wide_row(key, fn, args, plain, reps, moved=None, ops=None):
        """``moved``: the bytes the function must move, where that is not
        its inputs and outputs whole; ``ops``: the plain version's
        operations per scenario, where they are not counted here"""
        outs = fn(*args)
        outs = (outs,) if torch.is_tensor(outs) else outs
        if ops is None:
            ops = ops_per_scenario(plain, lambda nb: cpu_args(args, B, nb))
        bound_ms, bound_by = bound(moved or nbytes(*args, *outs), B * ops,
                                   PEAK_F64_S)
        wide["per_launch_f64"][key] = {
            "ms": cuda_ms(lambda: fn(*args), reps=reps),
            "bound_ms": bound_ms, "bound_by": bound_by}

    xw = on(np.concatenate([rng.uniform(-0.05, 0.05, (nvb, B)),
                            rng.uniform(-0.5, 0.5, (nvb, B))]), f64)
    uw = on(rng.uniform(-5.0, 5.0, (nvb, B)), f64)
    wide_row("kte_step@16x16", kte_step.make_step_lanes(beam, BEAM_DT),
             (xw, uw), kte_step.make_step_plain(beam, BEAM_DT), 3)
    wide_row("kte_core@16x16", kte_core.make_core_lanes(beam), (xw, uw),
             kte_core.make_core_plain(beam), 3)
    del xw, uw
    pw = synthetic(32, 16, B)
    k2w_args = tuple(pw[k] for k in ("A", "Bm", "c", "Q", "QN", "R", "x0",
                                     "lb", "ub"))
    wide_row("pdip_whole@32x16",
             lambda *a: riccati_soa.solve_box_mpc_riccati_soa_fused(
                 *a, iters=ITERS, use_kernels="whole"), k2w_args, None, 2,
             ops=plain_ops("k2@32x16,H12"))
    pa = tuple(pw[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN", "R"))
    K_w, G_w = riccati_soa.fused_backward_plain(*pa)[1:3]
    for e, a in (("fused_backward", pa),
                 ("vector_backward", (pw["A"], pw["Bm"], pw["rhs"], K_w,
                                      G_w)),
                 ("forward", (pw["A"], pw["Bm"], K_w, pw["k"], pw["dx0"]))):
        wide_row(f"riccati_bwd.{e}@32x16", getattr(riccati_bwd, e), a,
                 plain_pass[e], 3)
    del pw, k2w_args, pa, K_w, G_w
    for n in (32, 48, 64):
        a = on(rng.standard_normal((n, n, B)), f64)
        # contiguous, so that the wrapper makes no copy inside the timing
        # (einsum's product comes out in another layout)
        g = (torch.einsum("ikz,jkz->ijz", a, a)
             + 3.0 * torch.eye(n, dtype=f64, device=dev)[:, :, None]
             ).contiguous()
        del a
        for e, k in (("solve_lanes", 1), ("solve_lanes_multi", n)):
            r = on(rng.standard_normal((n, B) if k == 1 else (n, k, B)), f64)
            wide_row(f"chol_lanes.{e}@{n}", getattr(chol_lanes, e), (g, r),
                     lambda gg, rr: riccati_soa._chol_solve_lanes(
                         gg, rr if rr.dim() == 3 else rr[:, None]), 5,
                     moved=k3_bytes(g, r))
    del g, r
    emit(wide)
    check(main_runs["beam"]["kte_step"] == BEAM_H
          and main_runs["beam"]["pdip_whole"] == 1,
          f"the beam solve did not run on K1 and K2: {main_runs['beam']}")
    check(tuple(us_bm.shape) == (BEAM_B, BEAM_H, nvb)
          and bool(torch.isfinite(us_bm).all())
          and bool(torch.isfinite(xs_bm).all()),
          "beam outputs are not finite or of the wrong shape")
    for key in ("u_rel_vs_cpu_f64", "xs_rel_vs_cpu_f64"):
        check(wide["beam_solve"][key] <= 1e-9, f"beam solve {key}")
    check(wide["beam_solve"]["active_bounds"] > 0,
          "no active bound in the beam solve")
    del us_bm, xs_bm, x0_bm, u0_bm

    # ---- past the compile-time widths: the runtime-width instances -------
    # K1/K5 on 17- and 24-segment beams (their runtime-width instance, its
    # work in device memory), B = 77; K2 and K4a-c at (33, 17) and (48, 24)
    # (the runtime tile, its rows in shared memory), H = 4, B = 77; the
    # tile's device-memory branch at the smallest width that reaches it by
    # the mirror (ops/_tile.tile_config: (62, 31) in f64, (88, 44) in f32 at
    # m = n/2), B = 33; each at f64 within 1e-9 relative of its plain
    # version, one f32 case each within twice the plain f32 error; each
    # case timed per launch beside its f64 bound.  Then one make_kte_mpc
    # solve of the 24-segment beam (B = 64, H = 8, f64; its fastest mode
    # has |λ| ≈ 2.6e6 /s, so dt = 4e-7 gives |λ| dt ≈ 1.04, inside the
    # order-4 series' 2.78) through K1's and K2's runtime instances against
    # the plain f64 solve on the card.
    ptc = {"phase": "past_the_caps", "dtype": "float64", "k1_k5": {},
           "tile": {}}

    def per_launch(fn, args, plain, batch, reps=3, ops=None):
        """ms per launch by CUDA events beside the f64 bound of the call;
        the plain version's operations per scenario are ``ops`` where
        given, else counted on the card (at these widths a count on the
        host takes tens of seconds)."""
        outs = fn(*args)
        outs = (outs,) if torch.is_tensor(outs) else outs
        first = lambda nb: tuple(
            t[..., :nb].contiguous() if t.dim() > 1 and t.shape[-1] == batch
            else t for t in args)
        if ops is None:
            ops = ops_per_scenario(plain, first)
        bound_ms, bound_by = bound(nbytes(*args, *outs), batch * ops,
                                   PEAK_F64_S)
        return {"ms": cuda_ms(lambda: fn(*args), reps=reps),
                "bound_ms": bound_ms, "bound_by": bound_by}

    for segs in OP_COUNT_BEAMS:
        chain = models.flexible_beam(segs)
        nvc = chain.nv
        xb_np = np.concatenate([rng.uniform(-0.05, 0.05, (nvc, 77)),
                                rng.uniform(-0.5, 0.5, (nvc, 77))])
        ub_np = rng.uniform(-5.0, 5.0, (nvc, 77))
        case = {"shape": dict(vars(kte_step.launch_shape(nvc, nvc, f64)))}
        for dt in (f64, f32):
            k1 = kte_step.make_step_lanes(chain, BEAM_DT)
            k5 = kte_core.make_core_lanes(chain)
            p1 = kte_step.make_step_plain(chain, BEAM_DT)
            p5 = kte_core.make_core_plain(chain)
            xc, uc = on(xb_np, dt), on(ub_np, dt)
            before = (kte_step.launches, kte_core.launches)
            got1, got5 = k1(xc, uc), k5(xc, uc)
            torch.cuda.synchronize()
            check((kte_step.launches, kte_core.launches)
                  == (before[0] + 1, before[1] + 1),
                  f"{chain.name} {dt} did not launch K1 and K5")
            x64, u64 = on(xb_np, f64), on(ub_np, f64)
            want1, want5 = p1(x64, u64), p5(x64, u64)
            if dt == f64:
                case["k1_f64_rel"] = [rel_err(a, r)
                                      for a, r in zip(got1, want1)]
                case["k5_f64_rel"] = [rel_err(a, r)
                                      for a, r in zip(got5, want5)]
                for key in ("k1_f64_rel", "k5_f64_rel"):
                    for i, e in enumerate(case[key]):
                        check(e <= 1e-9, f"{key} {chain.name} output {i}")
                k1_max_abs = max([k1_max_abs] + [
                    abs_err(a, r) for a, r in zip(got1, want1)])
                k5_max_abs = max([k5_max_abs] + [
                    abs_err(a, r) for a, r in zip(got5, want5)])
                case["k1_per_launch"] = per_launch(
                    k1, (xc, uc), p1, 77, ops=plain_ops(f"k1@beam{segs}"))
                case["k5_per_launch"] = per_launch(
                    k5, (xc, uc), p5, 77, ops=plain_ops(f"k5@beam{segs}"))
            else:
                q1, q5 = p1(xc, uc), p5(xc, uc)
                for key, got, plain32, want in (("k1", got1, q1, want1),
                                                ("k5", got5, q5, want5)):
                    case[f"{key}_f32_abs"] = [abs_err(a, r)
                                              for a, r in zip(got, want)]
                    case[f"{key}_plain_f32_abs"] = [
                        abs_err(a, r) for a, r in zip(plain32, want)]
                    for i, (e, ep) in enumerate(zip(
                            case[f"{key}_f32_abs"],
                            case[f"{key}_plain_f32_abs"])):
                        check(e <= 2.0 * ep, f"{key} {chain.name} f32 "
                              f"output {i} above twice the plain f32 error")
        ptc["k1_k5"][chain.name] = case
    del xc, uc, got1, got5, want1, want5

    def wide_tile_case(n_, m_, batch, f32_too):
        """K2 and K4a-c of the runtime tile at (n_, m_), H = 4, against their
        plain versions at f64 (K4 leaving its inputs as they were), and at
        f32 against twice the plain f32 error; timed per launch at f64."""
        nonlocal k2_max_abs, k4_max_abs
        p = synthetic(n_, m_, batch, horizon=4)
        tile = _tile.tile_config(n_, m_, f64)
        check(tile.runtime, f"{n_, m_} is not past the compile-time bounds")
        case = {"branch": tile.branch, "tile_scenarios": tile.scenarios,
                "threads": tile.threads, "shared_bytes": tile.shared_bytes,
                "work_values_per_block": tile.block_values}
        k2a = [p[k] for k in ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb",
                              "ub")]
        whole = lambda *a: riccati_soa.solve_box_mpc_riccati_soa_fused(
            *a, iters=ITERS, use_kernels="whole")
        plain_k2 = lambda *a: riccati_soa._fused_scan(*a, iters=ITERS)
        before = pdip_whole.launches
        u_k, x_k = whole(*k2a)
        u_p, x_p = plain_k2(*k2a)
        torch.cuda.synchronize()
        check(pdip_whole.launches == before + 1, f"{n_, m_} did not launch K2")
        case["k2_f64_rel"] = {"u": rel_err(u_k, u_p), "xs": rel_err(x_k, x_p)}
        for o, e in case["k2_f64_rel"].items():
            check(e <= 1e-9, f"K2 {n_, m_} f64 {o}")
        k2_max_abs = max(k2_max_abs, abs_err(u_k, u_p), abs_err(x_k, x_p))
        case.update(edge_passes(p))
        case["k2_per_launch"] = per_launch(
            whole, k2a, plain_k2, batch, 2,
            ops=plain_ops(f"k2@{n_}x{m_},H4"))
        pa = [p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN", "R")]
        K_, G_ = riccati_soa.fused_backward_plain(*pa)[1:3]
        for e, a in (("fused_backward", pa),
                     ("vector_backward", [p["A"], p["Bm"], p["rhs"], K_,
                                          G_]),
                     ("forward", [p["A"], p["Bm"], K_, p["k"], p["dx0"]])):
            case[f"{e}_per_launch"] = per_launch(
                getattr(riccati_bwd, e), a, plain_pass[e], batch,
                ops=plain_ops(f"{e}@{n_}x{m_},H4"))
        if f32_too:
            case.update(f32_passes(p, (n_, m_), k2_ref=(u_p, x_p)))
        return case

    for n_, m_, batch in ((33, 17, 77), (48, 24, 77), (62, 31, 33)):
        ptc["tile"][f"n={n_},m={m_},B={batch}"] = wide_tile_case(
            n_, m_, batch, f32_too=(n_, m_) != (62, 31))
    check(ptc["tile"]["n=62,m=31,B=33"]["branch"] == "device"
          and ptc["tile"]["n=48,m=24,B=77"]["branch"] == "shared",
          "the tile cases did not take both branches of the runtime tile")
    # the f32 device-memory branch, where the mirror puts its first width;
    # K2 at PTC_F32_DEVICE_ITERS iterations (each runs the same code): at
    # this width its plain version, run at f64 and f32, is the longest
    # part of the phase
    f32_dev = next((2 * m_, m_) for m_ in range(16, 256)
                   if _tile.tile_config(2 * m_, m_, f32).branch == "device")
    ptc["tile"][f"n={f32_dev[0]},m={f32_dev[1]},B=33,f32"] = {
        "branch": _tile.tile_config(*f32_dev, f32).branch,
        "k2_iters": PTC_F32_DEVICE_ITERS,
        **f32_passes(synthetic(*f32_dev, 33, horizon=4), f32_dev,
                     iters=PTC_F32_DEVICE_ITERS)}
    # the 24-segment beam through make_kte_mpc: K1 and K2 at run-time widths
    beam24 = models.flexible_beam(24)
    nv24, dt24 = beam24.nv, 4e-7
    prob24 = beam_config(mpc, beam24, dev, f64)
    x0_24 = on(np.concatenate([rng.uniform(-0.05, 0.05, (BEAM_B, nv24)),
                               rng.uniform(-0.5, 0.5, (BEAM_B, nv24))],
                              axis=1), f64)
    u0_24 = torch.zeros(BEAM_B, BEAM_H, nv24, dtype=f64, device=dev)
    reset_counts()
    (us24, xs24), t24 = timed(lambda: mpc.make_kte_mpc(
        beam24, prob24, dt24, qp_iters=ITERS)(x0_24, u0_24))
    main_runs["beam24"] = counts()
    A24, B24, c24, _ = lanes.make_rollout_ltv_lanes(beam24, dt24, BEAM_H)(
        x0_24, u0_24)
    ul24, xl24 = riccati_soa.solve_box_mpc_riccati_soa_fused(
        A24, B24, c24, prob24.Q, prob24.QN, prob24.R, x0_24.T.contiguous(),
        prob24.u_min, prob24.u_max, iters=ITERS, use_kernels="never")
    ptc["beam24_solve"] = {
        "segments": 24, "n": 2 * nv24, "m": nv24, "B": BEAM_B, "H": BEAM_H,
        "dt": dt24, "iters": ITERS, "ms": t24,
        "launches": main_runs["beam24"],
        "u_rel_vs_plain_f64": rel_err(us24, ul24.permute(2, 0, 1)),
        "xs_rel_vs_plain_f64": rel_err(xs24, xl24.permute(2, 0, 1)),
        "active_bounds": int((us24.abs() > 30.0 - 1e-6).sum())}
    emit(ptc)
    check(main_runs["beam24"]["kte_step"] == BEAM_H
          and main_runs["beam24"]["pdip_whole"] == 1,
          f"the 24-segment solve did not run on K1 and K2: "
          f"{main_runs['beam24']}")
    check(bool(torch.isfinite(us24).all()) and bool(torch.isfinite(xs24).all()),
          "24-segment beam outputs are not finite")
    for key in ("u_rel_vs_plain_f64", "xs_rel_vs_plain_f64"):
        check(ptc["beam24_solve"][key] <= 1e-9, f"24-segment beam {key}")
    del us24, xs24, x0_24, u0_24, A24, B24, c24, ul24, xl24

    # ---- the flagship chain at H=256 on K5 and K4a-c ---------------------
    # bench.py:139-149's phase split, composed from the public functions, at
    # a horizon past the TPU kernel's VMEM bound (the JAX package itself
    # runs its per-pass kernels there); B=8192, f32, zero warm start
    HL = H_LONG
    roll_L = lanes.make_rollout_ltv_fused(spec, DT, HL)
    prob_L = {dt: flagship_problem(mpc, dev, dt, horizon=HL)
              for dt in (f32, f64)}
    x0_L = {dt: on(x0_np, dt) for dt in (f32, f64)}
    u0_L = {dt: torch.zeros(B, HL, M, dtype=dt, device=dev)
            for dt in (f32, f64)}

    def pdip_L(seqs, dt, uk):
        p = prob_L[dt]
        return riccati_soa.solve_box_mpc_riccati_soa_fused(
            seqs[0], seqs[1], seqs[2], p.Q, p.QN, p.R,
            x0_L[dt].T.contiguous(), p.u_min, p.u_max, iters=ITERS,
            use_kernels=uk)

    reset_counts()
    seqs32, t_roll_L = timed(lambda: roll_L(x0_L[f32], u0_L[f32]))
    (u_L, xs_L), t_pdip_L = timed(lambda: pdip_L(seqs32, f32, "passes"))
    main_runs["long_horizon_passes"] = counts()
    lh = {"phase": "long_horizon_passes", "B": B, "H": HL, "iters": ITERS,
          "dtype": "float32", "launches": main_runs["long_horizon_passes"],
          "rollout_ms": t_roll_L, "pdip_ms": t_pdip_L,
          "full_ms": t_roll_L + t_pdip_L,
          "solves_per_s": B / (t_roll_L + t_pdip_L) * 1e3}
    check(lh["launches"]["kte_core"] > 0
          and all(lh["launches"][f"riccati_bwd.{e}"] > 0
                  for e in riccati_bwd.launches),
          f"the long-horizon path did not launch K5 and K4a-c: "
          f"{lh['launches']}")
    check(lh["launches"]["kte_step"] == 0
          and lh["launches"]["pdip_whole"] == 0,
          f"the long-horizon path launched K1 or K2: {lh['launches']}")
    check(tuple(u_L.shape) == (HL, M, B) and tuple(xs_L.shape) == (HL, N, B)
          and bool(torch.isfinite(u_L).all())
          and bool(torch.isfinite(xs_L).all()),
          "long-horizon outputs are not finite or of the wrong shape")
    # the reference: the plain f64 PDIP on the f64 K5 rollout; beside it
    # the plain f32 PDIP and K2 on the same f32 rollout as the passes, and
    # both kernels at f64 on the f64 rollout
    seqs64 = roll_L(x0_L[f64], u0_L[f64])
    u_L64, xs_L64 = pdip_L(seqs64, f64, "never")
    for route in ("passes", "whole"):
        u_k, xs_k = pdip_L(seqs64, f64, route)
        # the trajectory each route returns is the rollout of its controls
        xs_of_u = riccati_soa.rollout_affine_soa(*seqs64[:3],
                                                 x0_L[f64].T, u_k)
        lh[f"{route}_f64_rel"] = {"u": rel_err(u_k, u_L64),
                                  "xs": rel_err(xs_k, xs_L64),
                                  "xs_vs_rollout_of_u": rel_err(xs_k,
                                                                xs_of_u)}
    # how far the f32 rollout drifts from the f64 one over the horizon
    lh["rollout_f32_max_abs_xs_vs_f64"] = abs_err(seqs32[3], seqs64[3])
    del seqs64, u_k, xs_k, xs_of_u, xs_L64
    (u_Lp32, _), lh["plain_pdip_ms"] = timed(
        lambda: pdip_L(seqs32, f32, "never"))
    u_Lw, _ = pdip_L(seqs32, f32, "whole")
    torch.cuda.synchronize()
    lh["max_abs_u_vs_plain_f64"] = abs_err(u_L, u_L64)
    lh["whole_max_abs_u_vs_plain_f64"] = abs_err(u_Lw, u_L64)
    lh["plain_f32_max_abs_u_vs_plain_f64"] = abs_err(u_Lp32, u_L64)
    # the repo's 1e-3 bar, or twice the plain f32 PDIP's own error where
    # that misses it at this horizon
    lh["bar"] = max(1e-3, 2.0 * lh["plain_f32_max_abs_u_vs_plain_f64"])
    # the PDIP's own f32 error, apart from the rollout's: the plain f64 PDIP
    # on the f32 rollout's LTV, the same bar against it
    u_Ld, _ = pdip_L([t.double() for t in seqs32[:3]], f64, "never")
    torch.cuda.synchronize()
    lh["same_ltv"] = {"max_abs_u_vs_plain_f64": abs_err(u_L, u_Ld),
                      "whole_max_abs_u_vs_plain_f64": abs_err(u_Lw, u_Ld),
                      "plain_f32_max_abs_u_vs_plain_f64": abs_err(u_Lp32,
                                                                  u_Ld)}
    # the share of scenarios whose f32 controls stay within 1e-3 of f64
    within = lambda u, ref: float(((u.double() - ref).abs().amax(dim=(0, 1))
                                   <= 1e-3).double().mean())
    lh["share_within_1e-3"] = {
        "passes": within(u_L, u_L64), "whole": within(u_Lw, u_L64),
        "plain_f32": within(u_Lp32, u_L64),
        "same_ltv_passes": within(u_L, u_Ld),
        "same_ltv_whole": within(u_Lw, u_Ld),
        "same_ltv_plain_f32": within(u_Lp32, u_Ld)}
    lh["max_abs_u"] = float(u_L.abs().max())
    lh["active_bounds"] = int((u_L.abs() > 40.0 - 1e-4).sum())
    lh["pdip_passes_ms"] = cuda_ms(lambda: pdip_L(seqs32, f32, "passes"),
                                   reps=3)
    lh["pdip_whole_ms"] = cuda_ms(lambda: pdip_L(seqs32, f32, "whole"),
                                  reps=3)
    lh["rollout_ms_mean"] = cuda_ms(lambda: roll_L(x0_L[f32], u0_L[f32]),
                                    reps=2)
    # K2's bound at this horizon, from this call's inputs and outputs
    k2_long_args = (*seqs32[:3], prob_L[f32].Q, prob_L[f32].QN,
                    prob_L[f32].R, x0_L[f32].T.contiguous(),
                    prob_L[f32].u_min, prob_L[f32].u_max)
    lh["pdip_whole_bound_ms"], lh["pdip_whole_bound_by"] = bound(
        nbytes(*k2_long_args, u_L, xs_L),
        B * plain_ops(f"k2@{N}x{M},H{HL}"))
    lh["pdip_whole_design_floor_ms"] = (k2_design_bytes(HL, N, M, B, ITERS, 4)
                                        / PEAK_BYTES_S * 1e3)
    del k2_long_args
    emit(lh)
    # at f64 each route's controls match the plain PDIP's (≤1e-9).  Over
    # 256 stages this LTV amplifies f64 rounding ~1e8-fold (K2's in-kernel
    # rollout and torch's rollout of the same controls differ by ~1e-8
    # relative), so each trajectory is held to the rollout of its own
    # controls at 1e-6, which still catches a wrong trajectory
    for route in ("passes", "whole"):
        check(lh[f"{route}_f64_rel"]["u"] <= 1e-9,
              f"long-horizon {route} f64 u relative to the plain PDIP")
        check(lh[f"{route}_f64_rel"]["xs_vs_rollout_of_u"] <= 1e-6,
              f"long-horizon {route} f64 xs against the rollout of its u")
    check(lh["max_abs_u_vs_plain_f64"] <= lh["bar"],
          "long-horizon f32 controls on the passes beyond the bar from the "
          "plain f64 PDIP")
    check(lh["whole_max_abs_u_vs_plain_f64"] <= lh["bar"],
          "long-horizon f32 controls on K2 beyond the bar from the plain "
          "f64 PDIP")
    del u_L64, u_Lp32, u_Lw, u_Ld

    # each K4 entry and K5 per launch at this shape, f32, beside its plain
    # version and its bound; the pass inputs drawn as above
    A_L, B_L = seqs32[0], seqs32[1]
    long_np = {"q": rng.standard_normal((HL, N, B)),
               "u_eff": rng.standard_normal((HL, M, B)),
               "D": rng.uniform(0.5, 2.0, (HL, M, B)),
               "rhs": rng.standard_normal((HL, M, B)),
               "k": rng.standard_normal((HL, M, B)),
               "dx0": rng.standard_normal((N, B))}
    _, K_L, G_L, _ = riccati_bwd.fused_backward(
        *pass_args(f32, A_L, B_L, long_np)["fused_backward"])
    pf = pass_args(f32, A_L, B_L, long_np, (K_L, G_L))
    pass_rows = {}
    for e, plain in plain_pass.items():
        outs = getattr(riccati_bwd, e)(*pf[e])
        outs = (outs,) if torch.is_tensor(outs) else outs
        pass_rows[e] = {
            "ms": cuda_ms(lambda: getattr(riccati_bwd, e)(*pf[e]), reps=5),
            "plain_ms": cuda_ms(lambda: plain(*pf[e]), reps=1),
            "bytes": nbytes(*pf[e], *outs),
            "ops": B * ops_per_scenario(
                plain, lambda nb: cpu_args(pf[e], B, nb))}
        del outs
    del pf, K_L, G_L, A_L, B_L, seqs32
    x32, u32 = on(x_np, f32), on(u_np, f32)
    k5_ms = cuda_ms(lambda: core_k(x32, u32), reps=20)
    k5_plain_ms = cuda_ms(lambda: core_p(x32, u32), reps=2)
    emit({"phase": "times_long_horizon", "card": card, "B": B, "H": HL,
          "dtype": "float32", "passes_per_launch": pass_rows,
          "passes_flagship_shape_ms": k4["flagship_shape_ms"],
          "passes_flagship_shape_plain_ms": k4["flagship_shape_plain_ms"],
          "kte_core_launch_ms": k5_ms, "plain_core_ms": k5_plain_ms,
          "rollout_ms": lh["rollout_ms_mean"],
          "pdip_passes_ms": lh["pdip_passes_ms"],
          "pdip_whole_ms": lh["pdip_whole_ms"],
          "pdip_whole_bound_ms": lh["pdip_whole_bound_ms"],
          "pdip_whole_bound_by": lh["pdip_whole_bound_by"],
          "pdip_whole_design_floor_ms": lh["pdip_whole_design_floor_ms"],
          "plain_pdip_ms": lh["plain_pdip_ms"]})

    # ---- phase 7: times on the card -------------------------------------
    t_full = cuda_ms(lambda: solve(x0_32, u0_32), reps=5)
    t_roll = cuda_ms(lambda: roll_k(x0_32, u0_32), reps=5)
    A32, B32, c32, _ = roll_k(x0_32, u0_32)
    x0T32 = x0_32.T.contiguous()
    pdip = lambda uk: riccati_soa.solve_box_mpc_riccati_soa_fused(
        A32, B32, c32, prob32.Q, prob32.QN, prob32.R, x0T32, prob32.u_min,
        prob32.u_max, iters=ITERS, use_kernels=uk)
    t_pdip = cuda_ms(lambda: pdip("whole"), reps=5)
    # K2's time over its iterations: at 0 the two rollouts alone, the
    # slope one iteration (the shipped kernel, CUDA events)
    def k2_at(iters):
        return riccati_soa.solve_box_mpc_riccati_soa_fused(
            A32, B32, c32, prob32.Q, prob32.QN, prob32.R, x0T32,
            prob32.u_min, prob32.u_max, iters=iters, use_kernels="whole")

    k2_iters = {it: cuda_ms(lambda: k2_at(it), reps=5)
                for it in K2_PHASE_ITERS}
    k2_slope, k2_intercept = np.polyfit(K2_PHASE_ITERS,
                                        [k2_iters[it] for it in
                                         K2_PHASE_ITERS], 1)
    # the plain rollout (host-bound, ~40 s) was timed on phase 5's run
    t_pdip_p = cuda_ms(lambda: pdip("never"), reps=2)
    xk, uk = x0_32.T.contiguous(), u0_32[:, 0].T.contiguous()
    t_step = cuda_ms(lambda: step_k(xk, uk), reps=20)
    t_step_p = cuda_ms(lambda: step_p(xk, uk), reps=3, warmup=0)
    # K3's device time alone, by the profiler, which runs last: its tracing
    # could leave costs on the host for what follows
    for key, call in k3_profiled.items():
        k3_cases[key]["device_ms"] = device_ms(call, 50, "chol_lanes_kernel")
    del k3_profiled
    # K1's and K5's kernels alone: their wrappers' host time a call can pass
    # the kernels' own (the kernels line gives both)
    k1_device = device_ms(lambda: step_k(xk, uk), 50,
                          "kte_step_kernel<float, 6, 6, false>")
    k5_device = device_ms(lambda: core_k(x32, u32), 50,
                          "kte_step_kernel<float, 6, 6, true>")
    check(k1_device is not None and k5_device is not None,
          "the profiler saw K1's and K5's (6, 6) f32 kernels")
    # what each timed launch must move and compute, for its bound: inputs
    # and outputs of the call; operations of its plain version per scenario
    # (the K3 rows were filled in their phase, the K4 rows above)
    k1_moved = nbytes(xk, uk, *step_k(xk, uk))
    k1_ops = B * ops_per_scenario(step_p, lambda nb: cpu_args((xk, uk), B,
                                                              nb))
    k2_args = (A32, B32, c32, prob32.Q, prob32.QN, prob32.R, x0T32,
               prob32.u_min, prob32.u_max)
    k2_moved = nbytes(*k2_args, *pdip("whole"))
    k2_ops = B * plain_ops(f"k2@{N}x{M},H{H}")
    k5_moved = nbytes(x32, u32, *core_k(x32, u32))
    k5_ops = B * ops_per_scenario(core_p, lambda nb: cpu_args((x32, u32), B,
                                                              nb))
    emit({"phase": "times", "card": card, "B": B, "H": H, "iters": ITERS,
          "dtype": "float32", "full_ms": t_full, "solves_per_s": B / t_full
          * 1e3, "rollout_ms": t_roll, "pdip_ms": t_pdip,
          "plain_rollout_ms": t_roll_p, "plain_pdip_ms": t_pdip_p,
          "kte_step_launch_ms": t_step, "kte_step_device_ms": k1_device,
          "kte_core_device_ms": k5_device, "plain_step_ms": t_step_p,
          "pdip_design_floor_ms": k2_design_bytes(H, N, M, B, ITERS, 4)
          / PEAK_BYTES_S * 1e3,
          "op_counts_seconds": float(op_count["npz"]["seconds"]),
          "waited_for_op_counts_seconds": op_count["waited_s"]})
    emit({"phase": "k2_phases", "card": card, "B": B, "H": H, "n": N,
          "m": M, "dtype": "float32", "ms_by_iters": k2_iters,
          "iteration_ms": float(k2_slope), "rollouts_ms": float(k2_intercept),
          "iteration_design_floor_ms": k2_design_bytes(H, N, M, B, 1, 4)
          / PEAK_BYTES_S * 1e3})
    k1_split(card, dev, step_k, core_k, x_np, u_np)
    # the free-base and two-pass solves, each timed on its checked run
    emit({"phase": "times_slice2", "card": card, "dtype": "float32",
          "flagship_sqp2_ms": t_sqp2, "flagship_sqp2_solves_per_s":
          B / t_sqp2 * 1e3, "flagship_sqp2_warm_ms": t_sqp2_warm,
          "flagship_sqp2_warm_solves_per_s": B / t_sqp2_warm * 1e3,
          "floating_arm_warm_ms": t_fa_warm,
          "floating_arm_warm_solves_per_s": FA_B / t_fa_warm * 1e3,
          "sat_ms": t_sat,
          "sat_solves_per_s": SAT_B / t_sat * 1e3, "floating_arm_ms": t_fa,
          "floating_arm_solves_per_s": FA_B / t_fa * 1e3,
          "k3a_line_search_shape_ms": k3a_case["ms"],
          "k3a_line_search_shape_device_ms": k3a_case["device_ms"],
          "k3a_line_search_shape_wall_ms": k3a_case["wall_ms"],
          "k3b_ltv_shape_device_ms": k3b_case["device_ms"],
          "k3b_ltv_shape_wall_ms": k3b_case["wall_ms"],
          "k3a_line_search_shape_plain_ms": k3a_case["plain_ms"],
          "k3b_ltv_shape_ms": k3b_case["ms"],
          "k3b_ltv_shape_plain_ms": k3b_case["plain_ms"],
          "k3b_line_search_shape_ms":
          k3_cases[f"solve_lanes_multi(n=6,k=1,B={B})"].get("ms"),
          "k2_wide_ms": k2w["ms"], "k2_wide_plain_ms": k2w["plain_ms"]})

    trace_flagship(card, solve, x0_32, u0_32)
    mesh_flagship(card, dev, solve, x0_32, u0_32, main_runs)

    # launches over the main-path runs (flagship one and two passes,
    # satellite on K2 and on the passes, floating arm, the long-horizon
    # flagship), each counted from 0
    total = {k: sum(run[k] for run in main_runs.values())
             for k in launches}

    def row(name, source, replaces, err, ms, plain_ms, moved, ops,
            library_ms=None, count=None):
        bound_ms, bound_by = bound(moved, ops)
        return {"name": name, "route": "cuda",
                "source": f"reak_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": total[count or name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    # K3's ms is per call by CUDA events, as in earlier runs; beside it the
    # device alone (profiler) and the host's wall time per call
    k3_rows = [{**row(f"chol_lanes.{entry}", "chol_lanes.cu",
                      f"reak_tpu/ops/chol_lanes.py:{line}", k3_err[entry],
                      case["ms"], case["plain_ms"], case["bytes"],
                      case["ops"], case["library_ms"]),
                "device_ms": case["device_ms"], "wall_ms": case["wall_ms"]}
               for entry, line, case in (("solve_lanes", 68, k3a_case),
                                         ("solve_lanes_multi", 130,
                                          k3b_case))]
    k4_rows = [row(f"riccati_bwd.{e}", "riccati_bwd.cu",
                   f"reak_tpu/ops/riccati_bwd_pallas.py:{line}", k4_max_abs,
                   pass_rows[e]["ms"], pass_rows[e]["plain_ms"],
                   pass_rows[e]["bytes"], pass_rows[e]["ops"])
               for e, line in (("fused_backward", 79),
                               ("vector_backward", 182), ("forward", 236))]
    print(card, flush=True)
    # each ms is one launch in f32 by CUDA events: K1 and K5 at B=8192
    # (the kernel alone by the profiler beside it as device_ms, as K3's);
    # K2 at the flagship shape (H=50); K3a at the line-search shape
    # (6, 1, 8192), K3b at the floating-arm LTV shape (12, 36, 2048); K4a-c
    # at H=256, B=8192
    emit({"kernels": [
        {**row("kte_step", "kte_step.cu",
               "reak_tpu/ops/kte_core_pallas.py:215", k1_max_abs, t_step,
               t_step_p, k1_moved, k1_ops), "device_ms": k1_device},
        row("pdip_whole", "pdip_whole.cu",
            "reak_tpu/ops/pdip_whole_pallas.py:226", k2_max_abs, t_pdip,
            t_pdip_p, k2_moved, k2_ops),
        *k3_rows, *k4_rows,
        {**row("kte_core.make_core_lanes", "kte_step.cu",
               "reak_tpu/ops/kte_core_pallas.py:88", k5_max_abs, k5_ms,
               k5_plain_ms, k5_moved, k5_ops, count="kte_core"),
         "device_ms": k5_device},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-reference"]:
        sys.exit(cpu_reference(sys.argv[2]))
    if sys.argv[1:2] == ["--op-counts"]:
        sys.exit(op_count_process(sys.argv[2]))
    if sys.argv[1:2] == ["--spaces-reference"]:
        sys.exit(spaces_meaqr_references(sys.argv[2]))
    sys.exit(main())
