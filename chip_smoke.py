#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``reak_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``reak_tpu_torch/csrc``, holds each
against its plain torch version on the card, drives the flagship batched
KTE-MPC solve through ``reak_tpu_torch.ctrl.mpc.make_kte_mpc`` (6-DoF
CRS-A465 arm, n=12, m=6, H=50, 8 Mehrotra iterations, f32, B=8192), checks
the port at f64 against the independent C++ oracle ``native/mpc_oracle.cpp``
and times the solve and its two phases with CUDA events.  Each phase prints
one JSON line; the card's name and power limit follow as ``nvidia-smi``
prints them, then one JSON line of the kernels, and last
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import reak_tpu_torch
    from reak_tpu_torch.ctrl import mpc, riccati_soa
    from reak_tpu_torch.kte import lanes, models
    from reak_tpu_torch.ops import _build, kte_step, pdip_whole

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
    _build.load("kte_step", kte_step.SIGNATURES)
    _build.load("pdip_whole", pdip_whole.SIGNATURES)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": os.path.relpath(_build.BUILD_DIR, ROOT)})

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

    # ---- phase 5: the flagship solve through the kernels -----------------
    prob32 = flagship_problem(mpc, dev, f32)
    solve = mpc.make_kte_mpc(spec, prob32, DT, qp_iters=ITERS, sqp_iters=1)
    x0_32 = on(x0_np, f32)
    u0_32 = torch.zeros(B, H, M, dtype=f32, device=dev)
    kte_step.launches = 0
    pdip_whole.launches = 0
    us, xs = solve(x0_32, u0_32)
    torch.cuda.synchronize()
    launches = {"kte_step": kte_step.launches,
                "pdip_whole": pdip_whole.launches}
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

    print(card, flush=True)
    emit({"kernels": [
        {"name": "kte_step", "route": "cuda",
         "source": "reak_tpu_torch/csrc/kte_step.cu",
         "replaces": "reak_tpu/ops/kte_core_pallas.py:215",
         "launches": launches["kte_step"], "max_abs_err": k1_max_abs,
         "ms": t_roll, "plain_ms": t_roll_p},
        {"name": "pdip_whole", "route": "cuda",
         "source": "reak_tpu_torch/csrc/pdip_whole.cu",
         "replaces": "reak_tpu/ops/pdip_whole_pallas.py:226",
         "launches": launches["pdip_whole"], "max_abs_err": k2_max_abs,
         "ms": t_pdip, "plain_ms": t_pdip_p},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
