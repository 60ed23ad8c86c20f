"""Measure the tile kernels under other tile shapes than the ones they ship
with — the experiment behind the constants of ``csrc/riccati_tile.cuh``.

Run on a machine with one NVIDIA GPU and ``nvcc``, from the root of a
checkout:

    python3 -m reak_tpu_torch.ops.tile_shapes

For each shape — the bytes of a shared-memory row of the tile
(``riccati_tile.cuh``) and the blocks an SM that K4a's ``__launch_bounds__``
asks for, and the stage slots in the ring, the elements a column loads at
once in the μ_aff sweep, the bytes of a row and the blocks an SM of the
whole-solve PDIP's pipeline (``pdip_whole.cu``) —
it patches a copy of ``csrc/`` under ``build/tile_shapes/``, builds the
(16, 8) f32 libraries of the whole-solve PDIP (K2) and the fused reverse
pass (K4a), which hold the (12, 6) instance, and times K4a at H=256 and
H=50 and K2 at H=50 (B=8192, 8 iterations, CUDA events) on a random LTV
near the identity.  It prints the card's name and power limit, then one
JSON line per shape with ptxas' registers and stack frame of the (12, 6)
instances and the times in ms.  The shipped shape is the first.  Nothing of
the package is changed.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from reak_tpu_torch.ops import _build, _tile, pdip_whole, riccati_bwd

# (tile row bytes, K4a blocks an SM, K2 ring slots, K2 sweep elements, K2
# row bytes, K2 blocks an SM); the first is what ships.  Four slots at
# (12, 6) in f32 do not fit 128 B rows, and the pipeline halves them; at
# 64 B rows two blocks fit an SM's shared memory.
SHAPES = ((128, 2, 3, 8, 128, 1), (128, 1, 3, 8, 128, 1),
          (64, 2, 3, 8, 128, 1), (128, 2, 2, 8, 128, 1),
          (128, 2, 4, 8, 128, 1), (128, 2, 3, 1, 128, 1),
          (128, 2, 3, 4, 128, 1), (128, 2, 3, 16, 128, 1),
          (128, 2, 3, 8, 64, 1), (128, 2, 3, 8, 64, 2),
          (128, 2, 2, 8, 64, 2))
N, M, B, ITERS = 12, 6, 8192, 8
DEFINES = ("-DREAK_NMAX=16", "-DREAK_MMAX=8", "-DREAK_TYPE=float",
           "-DREAK_SUFFIX=f32")


# what a shape changes: (source, the text it ships with, the text of a shape)
PATCHES = (
    ("riccati_tile.cuh", "(NB_ <= 12 ? 128 : 64)",
     "(NB_ <= 12 ? {row_bytes} : 64)"),
    ("riccati_bwd.cu", "Tile<T, NB, MB, EXACT>::BLOCKS_PER_SM)",
     "{k4_blocks})"),
    ("pdip_whole.cu", "static constexpr int RING = 3;",
     "static constexpr int RING = {ring};"),
    ("pdip_whole.cu", "constexpr int SWEEP = 8;",
     "constexpr int SWEEP = {sweep};"),
    ("pdip_whole.cu", "fit_rows((NB_ <= 12 ? 128 : 64) / SIZE,",
     "fit_rows((NB_ <= 12 ? {k2_row_bytes} : 64) / SIZE,"),
    ("pdip_whole.cu", "__launch_bounds__(Pipe<T, NB, MB>::NT, 1)",
     "__launch_bounds__(Pipe<T, NB, MB>::NT, {k2_blocks})"),
)


def _variant(root, row_bytes, k4_blocks, ring, sweep, k2_row_bytes,
             k2_blocks):
    """A patched copy of csrc/ and the two nvcc processes that build it."""
    d = root / (f"rows{row_bytes}_k4a{k4_blocks}_ring{ring}_sweep{sweep}"
                f"_k2rows{k2_row_bytes}_k2{k2_blocks}")
    shutil.copytree(_build.CSRC, d)
    for name, old, new in PATCHES:
        text = (d / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name} no longer holds {old!r} once")
        (d / name).write_text(text.replace(old, new.format(
            row_bytes=row_bytes, k4_blocks=k4_blocks, ring=ring,
            sweep=sweep, k2_row_bytes=k2_row_bytes, k2_blocks=k2_blocks)))
    procs = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *DEFINES, "-I", str(d), "-o",
         str(d / f"{src}.so"), str(d / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src in ("riccati_bwd", "pdip_whole")}
    return d, procs


def _ptxas(report, kernel):
    """Registers and stack frame of the (12, 6) f32 instance of ``kernel``."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and f"{kernel}IfLi12ELi6ELb1E" in line:
            return " | ".join(s.replace("ptxas info    :", "").strip()
                              for s in lines[i + 2:i + 4])
    raise RuntimeError(f"no (12, 6) f32 instance of {kernel} in the report")


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


def _problem(rng, H, dev):
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=dev).contiguous()
    return {"A": t(0.1 * rng.standard_normal((H, N, N, B))
                   + np.eye(N)[None, :, :, None]),
            "Bm": t(0.2 * rng.standard_normal((H, N, M, B))),
            "c": t(0.05 * rng.standard_normal((H, N, B))),
            "x0": t(rng.standard_normal((N, B))), "Q": t(np.eye(N)),
            "QN": t(5.0 * np.eye(N)), "R": t(0.1 * np.eye(M)),
            "lb": t(np.full(M, -1.5)), "ub": t(np.full(M, 1.5)),
            "q": t(rng.standard_normal((H, N, B))),
            "u_eff": t(rng.standard_normal((H, M, B))),
            "D": t(rng.uniform(0.5, 2.0, (H, M, B)))}


def _shared_bytes(row_bytes):
    """``Tile::SMEM`` of the (12, 6) f32 instance at this row size (K4a)."""
    ts = row_bytes // 4
    rows = 2 * (N * N + N * M) + (N * N + 2 * N * M + M * M) + 4 * N + 4 * M
    return 4 * (rows * ts + 2 * N * N + M * M), ts


def main():
    if not torch.cuda.is_available():
        print("tile_shapes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip(), flush=True)
    root = _build.BUILD_DIR.parent / "tile_shapes"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    built = {shape: _variant(root, *shape) for shape in SHAPES}
    rng = np.random.default_rng(0)
    data = {H: _problem(rng, H, dev) for H in (256, 50)}
    stream = _build.stream_ptr(dev)
    ptr = _build.ptr
    f32 = torch.float32
    for shape, (d, procs) in built.items():
        reports = {}
        for src, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {shape} {src}:\n{err}")
            reports[src] = err
        shared, _ = _shared_bytes(shape[0])
        pipe = _tile.pipe_config(N, M, f32, ring=shape[2],
                                 row_bytes=shape[4])
        k4 = ctypes.CDLL(str(d / "riccati_bwd.so"))
        k4a = getattr(k4, riccati_bwd.entry_point("fused_backward", (16, 8),
                                                  f32))
        k4a.argtypes = riccati_bwd._ARGS["fused_backward"]
        k2 = getattr(ctypes.CDLL(str(d / "pdip_whole.so")),
                     pdip_whole.entry_point((16, 8), f32))
        k2.argtypes = pdip_whole._ARGS
        out = {"row_bytes": shape[0], "tile_scenarios": shape[0] // 4,
               "k4a_blocks_per_sm": shape[1], "k2_ring": shape[2],
               "k2_sweep": shape[3], "k2_row_bytes": shape[4],
               "k2_blocks_per_sm": shape[5], "k2_scenarios": pipe.scenarios,
               "k4a_ptxas": _ptxas(reports["riccati_bwd"],
                                   "fused_backward_kernel"),
               "k2_ptxas": _ptxas(reports["pdip_whole"], "pdip_pipe_kernel")}
        for H, p in data.items():
            outs = [torch.empty(s, dtype=f32, device=dev)
                    for s in ((H, M, B), (H, M, N, B), (H, M, M, B),
                              (H, M, B))]
            ins = [p[k] for k in ("A", "Bm", "q", "u_eff", "D", "Q", "QN",
                                  "R")]

            def run_k4a():
                rc = k4a(*(ptr(t) for t in ins + outs), H, N, M, B, shared,
                         stream)
                if rc != 0:
                    raise RuntimeError(f"K4a launch refused: CUDA error {rc}")

            out[f"k4a_H{H}_ms"] = _cuda_ms(run_k4a, 5)
        H, p = 50, data[50]
        u = torch.empty(H, M, B, dtype=f32, device=dev)
        xs = torch.empty(H, N, B, dtype=f32, device=dev)
        scratch = torch.empty(pdip_whole.scratch_values(H, N, M)
                              * pipe.padded_batch(B), dtype=f32, device=dev)
        ins = [p[k] for k in ("A", "Bm", "c")] + [None, None] + [
            p[k] for k in ("x0", "Q", "QN", "R", "lb", "ub")]

        def run_k2():
            rc = k2(*(None if t is None else ptr(t) for t in ins), ptr(u),
                    ptr(xs), ptr(scratch), scratch.numel(), H, N, M, B, ITERS,
                    pipe.shared_bytes, stream)
            if rc != 0:
                raise RuntimeError(f"K2 launch refused: CUDA error {rc}")

        out["k2_H50_ms"] = _cuda_ms(run_k2, 3)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
