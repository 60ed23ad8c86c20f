#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``reak_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``reak_tpu_torch/csrc`` (one ``nvcc``
per source, all started together), holds each against its plain torch
version on the card, and drives the port's main paths through the kernels:

- the flagship batched KTE-MPC solve ``ctrl.mpc.make_kte_mpc`` (6-DoF
  CRS-A465 arm, n=12, m=6, H=50, 8 Mehrotra iterations, f32, B=8192), one
  SQP pass and two passes with the line search;
- the free-base satellite scenario MPC
  ``ctrl.manifold_lanes.make_sat_scenario_mpc_lanes`` (H=20, B=8192);
- the floating-arm scenario MPC (free base + 6-DoF arm, tangent n=24,
  m=12, H=16, B=2048) through ``kte.lanes.make_kte_manifold_lanes``.

It checks the port at f64 against the independent C++ oracle
``native/mpc_oracle.cpp`` and against its own plain f64 solves, and times
the solves and the kernels with CUDA events.  The plain f64 CPU references
run in a child process (``--cpu-reference``) beside the card's phases.
Each phase prints one JSON line; the card's name and power limit follow as
``nvidia-smi`` prints them, then one JSON line of the kernels, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no last line; with no CUDA device it exits 1 at
once.  Imports no JAX.
"""
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 0.01
B, H, N, M, ITERS = 8192, 50, 12, 6, 8
FLAGSHIP_W = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
# the free-base cells of bench.py:223-313
SAT_B, SAT_H, SAT_DT = 8192, 20, 0.1
FA_B, FA_H, FA_DT = 2048, 16, 0.02
N_REF = 256  # scenarios of the plain f64 CPU references


def emit(obj):
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


def sat_states(rot_lanes, batch):
    """e ~ N(0, 0.05 I₁₂) (numpy seed 0) retracted about the rest state:
    p = δp, q = exp(δθ), v = δv, ω = δω (ctrl/invariant.
    quat_state_retraction of the JAX package); (batch, 13) float64."""
    e = torch.as_tensor(np.sqrt(0.05)
                        * np.random.default_rng(0).standard_normal((12, batch)))
    ident = torch.zeros(4, batch, dtype=torch.float64)
    ident[0] = 1.0
    q = rot_lanes.qmul_l(ident, rot_lanes.q_exp_l(e[3:6]))
    return torch.cat([e[0:3], q, e[6:12]], dim=0).T.contiguous()


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


def cpu_reference(path):
    """The plain f64 solves on CPU tensors that the card's f32 solves are
    held to, for the first N_REF scenarios: the flagship with two SQP
    passes and the line search, and the floating arm.  Saved to ``path``."""
    sys.path.insert(0, ROOT)
    from reak_tpu_torch.ctrl import manifold_lanes, mpc
    from reak_tpu_torch.kte import lanes, models

    torch.set_num_threads(4)
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
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, flagship_sqp_us=us_flag.numpy(), floating_arm_us=us_fa.numpy(),
             floating_arm_xs=xs_fa.numpy())
    os.replace(tmp, path)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import reak_tpu_torch
    from reak_tpu_torch.ops import _build

    ref_path = _build.BUILD_DIR / "cpu_reference.npz"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if ref_path.exists():
        ref_path.unlink()
    with open(_build.BUILD_DIR / "cpu_reference.log", "w") as log:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             str(ref_path)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        return smoke(reak_tpu_torch, child, ref_path)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def smoke(reak_tpu_torch, child, ref_path):
    from reak_tpu_torch.ctrl import (manifold_lanes, mpc, riccati_soa,
                                     ss_systems)
    from reak_tpu_torch.kte import lanes, models
    from reak_tpu_torch.math import rot_lanes
    from reak_tpu_torch.ops import _build, chol_lanes, kte_step, pdip_whole

    def cpu_references():
        rc = child.wait(timeout=900)
        log = (_build.BUILD_DIR / "cpu_reference.log").read_text()
        check(rc == 0, f"the CPU reference process failed:\n{log[-4000:]}")
        return np.load(ref_path)

    def reset_counts():
        kte_step.launches = 0
        pdip_whole.launches = 0
        for key in chol_lanes.launches:
            chol_lanes.launches[key] = 0

    def counts():
        return {"kte_step": kte_step.launches,
                "pdip_whole": pdip_whole.launches,
                **{f"chol_lanes.{k}": v for k, v in chol_lanes.launches.items()}}

    # ---- phase 1: device -------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    reak_tpu_torch.enable_full_precision()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # ---- phase 2: build --------------------------------------------------
    t0 = time.perf_counter()
    sources = {"kte_step": kte_step.SIGNATURES,
               "pdip_whole": pdip_whole.SIGNATURES,
               "chol_lanes": chol_lanes.SIGNATURES}
    _build.build_all(sources)
    for name, signatures in sources.items():
        _build.load(name, signatures)
    # registers and stack frame of the kernels the main paths launch most
    # (ptxas -v); the whole report lands beside each library
    ptxas = {}
    for name, kernels in (("pdip_whole", ("IfLi16ELi8E", "IdLi16ELi8E",
                                          "IfLi24ELi12E", "IdLi24ELi12E")),
                          ("chol_lanes", ("IfLi6E", "IdLi6E", "IfLi12E",
                                          "IdLi12E"))):
        lines = _build.ptxas_report(name).splitlines()
        for i, line in enumerate(lines):
            hit = [k for k in kernels if f"kernel{k}" in line]
            if hit and "Compiling entry" in line:
                ptxas[f"{name}<{hit[0]}>"] = " | ".join(
                    s.replace("ptxas info    :", "").strip()
                    for s in lines[i + 2:i + 4])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": os.path.relpath(_build.BUILD_DIR, ROOT), "ptxas": ptxas})

    spec = models.manip_3r3r()
    rng = np.random.default_rng(0)
    x0_np = bench_states(rng, B)
    f64, f32 = torch.float64, torch.float32

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

    # ---- phase 4: K2 against its plain version at the flagship shape -----
    roll_k = lanes.make_rollout_ltv_fullfused(spec, DT, H)
    u0_64 = torch.zeros(B, H, M, dtype=f64, device=dev)
    A64, B64, c64, _ = roll_k(on(x0_np, f64), u0_64)
    x0T64 = on(x0_np.T, f64)
    refs_np = {"x_ref": 0.05 * rng.standard_normal((H, N, B)),
               "u_ref": 0.5 * rng.standard_normal((H, M, B))}
    k2 = {"phase": "k2_vs_plain", "H": H, "n": N, "m": M, "iters": ITERS,
          "B": B, "modes": {}}
    k2_max_abs = 0.0
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
                for uk in ("whole", "never")]
        torch.cuda.synchronize()
        (uk64, xk64), (up64, xp64) = out[f64]
        (uk32, xk32), (up32, xp32) = out[f32]
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
    del A64, B64, c64, out

    # ---- K3a/K3b against their plain version -----------------------------
    # G SPD as bench.py:193-195 makes it (G Gᵀ + 3I); shapes of the main
    # paths: the line-search rollout (n=6, one right-hand side, B=8192), the
    # floating-arm LTV (n=12, k=36, B=2048), bench.py's (6, 18, 1024), and
    # K3a through the standard-layout chol_lanes.solve at (12, 2048)
    def spd(n, batch):
        g = rng.standard_normal((n, n, batch))
        return np.einsum("ikz,jkz->ijz", g, g) + 3.0 * np.eye(n)[:, :, None]

    k3_cases = {}
    for entry, n, k, batch in (("solve_lanes", 6, 1, B),
                               ("solve_lanes_multi", 6, 1, B),
                               ("solve_lanes_multi", 12, 36, FA_B),
                               ("solve_lanes_multi", 6, 18, 1024),
                               ("solve", 12, 1, FA_B)):
        G_np, r_np = spd(n, batch), rng.standard_normal((n, k, batch))
        if entry == "solve_lanes_multi":
            kern = lambda g, r: chol_lanes.solve_lanes_multi(g, r)
        elif entry == "solve_lanes":
            kern = lambda g, r: chol_lanes.solve_lanes(g, r[:, 0])[:, None]
        else:  # (B, n, n), (B, n) standard layout
            kern = lambda g, r: chol_lanes.solve(
                g.permute(2, 0, 1).contiguous(),
                r[:, 0].T.contiguous()).T[:, None]
        res = {}
        for dt in (f64, f32):
            g, r = on(G_np, dt), on(r_np, dt)
            res[dt] = (kern(g, r), riccati_soa._chol_solve_lanes(g, r))
        torch.cuda.synchronize()
        (k64_, p64_), (k32_, p32_) = res[f64], res[f32]
        key = f"{entry}(n={n},k={k},B={batch})"
        k3_cases[key] = {"f64_rel": rel_err(k64_, p64_),
                         "f64_abs": abs_err(k64_, p64_),
                         "f32_abs": abs_err(k32_, p64_),
                         "plain_f32_abs": abs_err(p32_, p64_)}
        check(k3_cases[key]["f64_rel"] <= 1e-9, f"K3 {key} f64 relative")
        check(k3_cases[key]["f32_abs"] <= 2.0 * k3_cases[key]["plain_f32_abs"],
              f"K3 {key} f32 error above twice the plain f32 error")
        if entry != "solve" and k in (1, 36):
            # times at the line-search and the floating-arm LTV shapes
            g, r = on(G_np, f32), on(r_np, f32)
            k3_cases[key]["ms"] = cuda_ms(lambda: kern(g, r), reps=50)
            k3_cases[key]["plain_ms"] = cuda_ms(
                lambda: riccati_soa._chol_solve_lanes(g, r), reps=5)
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
            for uk in ("whole", "never")]
    torch.cuda.synchronize()
    (uk64, xk64), (up64, xp64) = out[f64]
    (uk32, xk32), (up32, xp32) = out[f32]
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
        A, Bm, c, _ = roll_p(x0s, u0s)
        ul, xl = riccati_soa.solve_box_mpc_riccati_soa_fused(
            A, Bm, c, prob.Q, prob.QN, prob.R, x0s.T.contiguous(),
            prob.u_min, prob.u_max, iters=ITERS, use_kernels="never")
        return ul.permute(2, 0, 1), xl.permute(2, 0, 1)

    us_p32, _ = plain_solve(prob32, x0_32, u0_32)
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

    # ---- the satellite scenario MPC (bench.py:223-263) -------------------
    params, prob_sat32, xr_sat32 = sat_config(mpc, ss_systems, dev, f32)
    _, prob_sat64, xr_sat64 = sat_config(mpc, ss_systems, dev, f64)
    x0_sat = sat_states(rot_lanes, SAT_B).to(dev)
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
    del us_sat_p, xs_sat

    # ---- the flagship with two SQP passes and the line search -----------
    solve2 = mpc.make_kte_mpc(spec, prob32, DT, qp_iters=ITERS, sqp_iters=2)
    reset_counts()
    (us2, xs2), t_sqp2 = timed(lambda: solve2(x0_32, u0_32))
    main_runs["flagship_sqp"] = counts()
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

    refs = cpu_references()
    err2 = np.abs(us2[:N_REF].double().cpu().numpy()
                  - refs["flagship_sqp_us"]).max(axis=(1, 2))
    sqp = {"phase": "flagship_sqp", "B": B, "H": H, "iters": ITERS,
           "sqp_iters": 2, "dtype": "float32",
           "launches": main_runs["flagship_sqp"],
           "max_abs_u_vs_cpu_f64": float(err2.max()),
           "share_within_1e-3": float(np.mean(err2 <= 1e-3)),
           "reference_scenarios": N_REF,
           "cost_init_mean": float(J_init.mean()),
           "cost_sqp_mean": float(J_sqp.mean()),
           "scenarios_cost_down": int((J_sqp < J_init).sum()),
           "max_cost_rise": float((J_sqp - J_init).max())}
    emit(sqp)
    for name in ("kte_step", "pdip_whole", "chol_lanes.solve_lanes"):
        check(sqp["launches"][name] > 0,
              f"the two-pass flagship solve did not launch {name}")
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
    check(tuple(us_fa.shape) == (FA_B, FA_H, nv_fa)
          and bool(torch.isfinite(us_fa).all())
          and bool(torch.isfinite(xs_fa).all()),
          "floating-arm outputs are not finite or of the wrong shape")
    check(err_fa <= 1e-3,
          "floating-arm f32 controls more than 1e-3 from the CPU f64 solve")

    # ---- phase 7: times on the card -------------------------------------
    t_full = cuda_ms(lambda: solve(x0_32, u0_32), reps=5)
    t_roll = cuda_ms(lambda: roll_k(x0_32, u0_32), reps=5)
    A32, B32, c32, _ = roll_k(x0_32, u0_32)
    x0T32 = x0_32.T.contiguous()
    pdip = lambda uk: riccati_soa.solve_box_mpc_riccati_soa_fused(
        A32, B32, c32, prob32.Q, prob32.QN, prob32.R, x0T32, prob32.u_min,
        prob32.u_max, iters=ITERS, use_kernels=uk)
    t_pdip = cuda_ms(lambda: pdip("whole"), reps=5)
    # the plain versions are host-bound and already warm from phase 5
    t_roll_p = cuda_ms(lambda: roll_p(x0_32, u0_32), reps=1, warmup=0)
    t_pdip_p = cuda_ms(lambda: pdip("never"), reps=2)
    xk, uk = x0_32.T.contiguous(), u0_32[:, 0].T.contiguous()
    t_step = cuda_ms(lambda: step_k(xk, uk), reps=20)
    t_step_p = cuda_ms(lambda: step_p(xk, uk), reps=3, warmup=0)
    emit({"phase": "times", "card": card, "B": B, "H": H, "iters": ITERS,
          "dtype": "float32", "full_ms": t_full, "solves_per_s": B / t_full
          * 1e3, "rollout_ms": t_roll, "pdip_ms": t_pdip,
          "plain_rollout_ms": t_roll_p, "plain_pdip_ms": t_pdip_p,
          "kte_step_launch_ms": t_step, "plain_step_ms": t_step_p})
    # the free-base and two-pass solves, each timed on its checked run
    emit({"phase": "times_slice2", "card": card, "dtype": "float32",
          "flagship_sqp2_ms": t_sqp2, "flagship_sqp2_solves_per_s":
          B / t_sqp2 * 1e3, "sat_ms": t_sat,
          "sat_solves_per_s": SAT_B / t_sat * 1e3, "floating_arm_ms": t_fa,
          "floating_arm_solves_per_s": FA_B / t_fa * 1e3,
          "k3a_line_search_shape_ms": k3a_case["ms"],
          "k3a_line_search_shape_plain_ms": k3a_case["plain_ms"],
          "k3b_ltv_shape_ms": k3b_case["ms"],
          "k3b_ltv_shape_plain_ms": k3b_case["plain_ms"],
          "k3b_line_search_shape_ms":
          k3_cases[f"solve_lanes_multi(n=6,k=1,B={B})"].get("ms"),
          "k2_wide_ms": k2w["ms"], "k2_wide_plain_ms": k2w["plain_ms"]})

    # launches over the main-path runs (flagship one and two passes,
    # satellite, floating arm), each counted from 0
    total = {k: sum(run[k] for run in main_runs.values())
             for k in launches}
    print(card, flush=True)
    emit({"kernels": [
        {"name": "kte_step", "route": "cuda",
         "source": "reak_tpu_torch/csrc/kte_step.cu",
         "replaces": "reak_tpu/ops/kte_core_pallas.py:215",
         "launches": total["kte_step"], "max_abs_err": k1_max_abs,
         "ms": t_roll, "plain_ms": t_roll_p},
        {"name": "pdip_whole", "route": "cuda",
         "source": "reak_tpu_torch/csrc/pdip_whole.cu",
         "replaces": "reak_tpu/ops/pdip_whole_pallas.py:226",
         "launches": total["pdip_whole"], "max_abs_err": k2_max_abs,
         "ms": t_pdip, "plain_ms": t_pdip_p},
        {"name": "chol_lanes.solve_lanes", "route": "cuda",
         "source": "reak_tpu_torch/csrc/chol_lanes.cu",
         "replaces": "reak_tpu/ops/chol_lanes.py:68",
         "launches": total["chol_lanes.solve_lanes"],
         "max_abs_err": k3_err["solve_lanes"],
         "ms": k3a_case["ms"], "plain_ms": k3a_case["plain_ms"]},
        {"name": "chol_lanes.solve_lanes_multi", "route": "cuda",
         "source": "reak_tpu_torch/csrc/chol_lanes.cu",
         "replaces": "reak_tpu/ops/chol_lanes.py:130",
         "launches": total["chol_lanes.solve_lanes_multi"],
         "max_abs_err": k3_err["solve_lanes_multi"],
         "ms": k3b_case["ms"], "plain_ms": k3b_case["plain_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-reference"]:
        sys.exit(cpu_reference(sys.argv[2]))
    sys.exit(main())
