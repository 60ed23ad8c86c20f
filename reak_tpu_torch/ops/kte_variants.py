"""Measure the rollout-step kernel (K1) and its core instance (K5) under
other launch shapes than the one they ship with — the experiment behind the
knobs of ``csrc/kte_step.cu``: ``StepShape::TS0`` (scenarios a tile),
``TILE_THREADS`` (threads a block, at most), ``REG_WARPS_NARROW``
and ``REG_WARPS_WIDE`` (the warps an SM's registers are shared among, so
the blocks an SM that ``__launch_bounds__`` asks for).

Run on a machine with one NVIDIA GPU and ``nvcc``, from the root of a
checkout:

    python3 -m reak_tpu_torch.ops.kte_variants

For each variant it patches a copy of ``csrc/`` under
``build/kte_variants/``, builds the flagship arm's (6, 6) and the SSRMS's
(7, 7) f32 libraries (one nvcc per library, all started together), and
times K1 and K5 at B=8192 on the flagship's states and the SSRMS's drawn
the same way (CUDA events), after checking both against the plain
versions.  It prints the card's name and power limit, then one JSON line
per variant and width with the launch shape the patched library reports,
ptxas' registers and stack frame, the blocks an SM holds, the nvcc seconds, the largest relative errors in f32 (against the
plain f64 versions) and the times in ms.  The shipped variant is the first.
Nothing of the package is changed.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from reak_tpu_torch.kte import models
from reak_tpu_torch.ops import _build, kte_core, kte_step

B = 8192
# (joints = dofs, chain) of the instances timed
CHAINS = ((6, models.manip_3r3r), (7, models.manip_ssrms))
# knob: the line of the source that sets it, with {} for its value
KNOBS = {"ts": "static constexpr int TS0 = {};",
         "tile_threads": "constexpr int TILE_THREADS = {};",
         "narrow": "constexpr int REG_WARPS_NARROW = {};",
         "wide": "constexpr int REG_WARPS_WIDE = {};"}
# the variants beside the shipped one (which is read from the source):
# tiles of 32 scenarios (six warps a (6, 6) block, two an SM; seven a (7, 7)
# block, one an SM); eight warps an SM at 255 registers for (6, 6) (no
# spills); (7, 7) at three blocks an SM (12 warps, 168 registers)
OTHERS = ({"ts": 32}, {"narrow": 8}, {"wide": 12})


def shipped(text):
    """The knobs as the source sets them."""
    out = {}
    for knob, line in KNOBS.items():
        m = re.search(re.escape(line).replace(r"\{\}", r"(\d+)"), text)
        if m is None:
            raise RuntimeError(f"kte_step.cu no longer holds {line!r}")
        out[knob] = int(m.group(1))
    return out


def _variant(root, knobs, base):
    """A patched copy of csrc/ and the nvcc processes that build its
    (joints, joints) f32 libraries, {joints: (library, process)}."""
    d = root / "_".join(f"{k}{v}" for k, v in knobs.items())
    shutil.copytree(_build.CSRC, d)
    text = (d / "kte_step.cu").read_text()
    for knob, line in KNOBS.items():
        text = text.replace(line.format(base[knob]), line.format(knobs[knob]))
    (d / "kte_step.cu").write_text(text)
    procs = {}
    for nj, _ in CHAINS:
        defines = (f"-DREAK_NMAX={nj}", f"-DREAK_MMAX={nj}",
                   "-DREAK_TYPE=float", "-DREAK_SUFFIX=f32")
        lib = d / f"kte_step_{nj}.so"
        procs[nj] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(d),
             "-o", str(lib), str(d / "kte_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return d, procs, time.perf_counter()


def _ptxas(report, core, nj):
    """Registers and stack frame of the (nj, nj) f32 K1 or K5 instance."""
    lines = report.splitlines()
    fragment = f"kte_step_kernelIfLi{nj}ELi{nj}ELb{int(core)}E"
    for i, line in enumerate(lines):
        if "Compiling entry" in line and fragment in line:
            return " | ".join(s.replace("ptxas info    :", "").strip()
                              for s in lines[i + 2:i + 4])
    raise RuntimeError(f"no {fragment} in the report")


def _cuda_ms(fn, reps):
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


def _measure(knobs, nj, spec, lib_path, err, seconds, dev):
    f32 = torch.float32
    widths = (nj, nj)
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for kind, args in kte_step.SIGNATURES.items():
        fns[kind] = getattr(lib, kte_step.entry_point(kind, widths, f32))
        fns[kind].argtypes = args
    rng = np.random.default_rng(0)
    x_np = np.concatenate([rng.uniform(-0.5, 0.5, (nj, B)),
                           rng.uniform(-0.2, 0.2, (nj, B))])
    u_np = rng.uniform(-5.0, 5.0, (nj, B))
    x, u = (torch.as_tensor(a, dtype=f32, device=dev).contiguous()
            for a in (x_np, u_np))
    ref = kte_step.make_step_plain(spec, 0.01)(x.double(), u.double())
    cref = kte_core.make_core_plain(spec)(x.double(), u.double())
    table = kte_step.chain_table(spec, "cpu", f32)
    stream = _build.stream_ptr(dev)
    p = _build.ptr
    shape = {core: kte_step.read_shape(fns["shape"], core)
             for core in (False, True)}
    smem = {core: shape[core]["shared_bytes"] for core in (False, True)}
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    n = 2 * nj
    k1_out = (new(n, n, B), new(n, nj, B), new(n, B), new(n, B))
    k5_out = (new(nj, B), new(nj, n, B), new(nj, nj, B))

    def k1():
        rc = fns["step"](p(x), p(u), p(table), nj, nj, 0.01, 4,
                         *(p(t) for t in k1_out), B, smem[False], stream)
        if rc != 0:
            raise RuntimeError(f"K1 launch refused: CUDA error {rc}")

    def k5():
        rc = fns["core"](p(x), p(u), p(table), nj, nj,
                         *(p(t) for t in k5_out), B, smem[True], stream)
        if rc != 0:
            raise RuntimeError(f"K5 launch refused: CUDA error {rc}")

    k1()
    k5()
    torch.cuda.synchronize()
    occ = {}
    for core in (0, 1):
        n_blocks = ctypes.c_int(0)
        rc = fns["occupancy"](core, ctypes.byref(n_blocks))
        if rc != 0:
            raise RuntimeError(f"occupancy: CUDA error {rc}")
        occ["k5" if core else "k1"] = n_blocks.value
    rel = lambda a, r: float((a.double() - r).abs().max() / r.abs().max())
    return {
        **knobs, "widths": list(widths), "k1_shape": shape[False],
        "k5_shape": shape[True], "nvcc_s": seconds,
        "k1_ptxas": _ptxas(err, False, nj), "k5_ptxas": _ptxas(err, True, nj),
        "blocks_per_sm": occ,
        "k1_f32_rel": max(rel(a, r) for a, r in zip(k1_out, ref)),
        "k5_f32_rel": max(rel(a, r) for a, r in zip(k5_out, cref)),
        "k1_ms": _cuda_ms(k1, 20), "k5_ms": _cuda_ms(k5, 20)}


def main():
    if not torch.cuda.is_available():
        print("kte_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip(), flush=True)
    root = _build.BUILD_DIR.parent / "kte_variants"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    base = shipped((_build.CSRC / "kte_step.cu").read_text())
    variants = [base] + [{**base, **o} for o in OTHERS]
    built = [(v, *_variant(root, v, base)) for v in variants]
    for knobs, d, procs, t0 in built:
        for nj, spec in CHAINS:
            lib, proc = procs[nj]
            _, err = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {d.name} ({nj}):\n{err}")
            print(json.dumps(_measure(knobs, nj, spec(), lib, err, seconds,
                                      dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
