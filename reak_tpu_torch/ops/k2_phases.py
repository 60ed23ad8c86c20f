"""Where the whole-solve PDIP kernel (K2, ``csrc/pdip_whole.cu``) spends its
time on the card, phase by phase, and how two trees of its sources compare.

Run on a machine with one NVIDIA GPU and ``nvcc``, from the root of a
checkout:

    python3 -m reak_tpu_torch.ops.k2_phases [--parent DIR] [--out FILE]

For each tree of sources (this checkout's ``reak_tpu_torch/csrc``, and with
``--parent`` the ``reak_tpu_torch/csrc`` of another checkout in DIR, timed
in turns: parent, this, this, parent) it builds under ``build/k2_phases/``
the (16, 8) and (24, 12) f32 libraries of K2, and a copy of the (16, 8)
library with ``clock64()`` stamps (``-DREAK_K2_STAMPS``): thread 0 of each
block adds the cycles since its last stamp to the slot of the phase that
just ended (``SLOTS``), and single threads time the spans of ``SPANS``.
The shipped library has no stamps: this checkout's source calls the
``REAK_K2_*`` hooks, which are empty unless the stamps block below is
inserted; a source without the hooks (the scenario-tile design before the
TMA pipeline) gets them inserted at its phase boundaries (``OLD_HOOKS``).

On a random LTV near the identity (numpy seed 0; regulator mode; Q = I,
QN = 5 I, R = 0.1 I, bounds ±1.5) it times with CUDA events: K2 at
H = 50, B = 8192 (the flagship's shape) at 8 iterations and at 0, 1 and 2
(the slope is one iteration, the intercept the two rollouts), at H = 256,
the floating arm's (24, 12) at H = 16, B = 2048, and the SSRMS's (14, 7)
on the padded (16, 8) instance at H = 50, B = 8192; and the stamped copy at
the flagship's shape, whose shares of each block's cycles split the
unstamped kernel's time.  It prints the card's name and power limit, then
one JSON line per tree and round, and writes them all to FILE.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from reak_tpu_torch.ops import _build, _tile, pdip_whole

# thread 0's phase slots, in the order of a solve, and the spans timed by
# one thread each (slot numbers follow): the last column's Schur factor,
# thread 0's waits at the reverse pass's barrier after the factor and at
# its other barriers, and (the pipeline only) thread 0's waits for a stage
# to land
SLOTS = ("rollout_in", "reverse", "affine_forward", "centering",
         "corrector_reverse", "corrector_forward", "step_update",
         "clip_rollout_out")
SPANS = ("schur_factor", "reverse_wait_factor", "reverse_wait_other",
         "stage_wait")
N_SLOTS = 16
MAX_BLOCKS = 1024

# the stamps: inserted before the first #include of pdip_whole.cu
STAMPS = r"""
#include <cuda_runtime.h>
#define REAK_K2_SLOTS 16
__device__ unsigned long long reak_k2_cycles[1024][REAK_K2_SLOTS];
__shared__ unsigned long long reak_k2_acc[REAK_K2_SLOTS + 1];
#define REAK_K2_BEGIN()                                                    \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      for (int q_ = 0; q_ < REAK_K2_SLOTS; ++q_) reak_k2_acc[q_] = 0;      \
      reak_k2_acc[REAK_K2_SLOTS] = clock64();                              \
    }                                                                      \
    __syncthreads();                                                       \
  } while (0)
#define REAK_K2_STAMP(slot)                                                \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      const unsigned long long t_ = clock64();                             \
      reak_k2_acc[slot] += t_ - reak_k2_acc[REAK_K2_SLOTS];                \
      reak_k2_acc[REAK_K2_SLOTS] = t_;                                     \
    }                                                                      \
  } while (0)
#define REAK_K2_SPAN_BEGIN(who) \
  const unsigned long long t_span_ = (who) ? clock64() : 0ull
#define REAK_K2_SPAN_END(who, slot)                                        \
  do {                                                                     \
    if (who) atomicAdd(&reak_k2_acc[slot], clock64() - t_span_);           \
  } while (0)
#define REAK_K2_END()                                                      \
  do {                                                                     \
    if (threadIdx.x == 0 && blockIdx.x < 1024)                             \
      for (int q_ = 0; q_ < REAK_K2_SLOTS; ++q_)                           \
        reak_k2_cycles[blockIdx.x][q_] = reak_k2_acc[q_];                  \
  } while (0)
extern "C" int reak_k2_cycles_read(void* dst, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, reak_k2_cycles,
      sizeof(unsigned long long) * REAK_K2_SLOTS * blocks));
}
"""

# the scenario-tile design (one cp.async stage ahead, six phases an
# iteration): (file, text, text with the hooks)
OLD_HOOKS = (
    ("pdip_whole.cu", "  tile_setup(wd, sm, Q, QN, R, n, m, th);\n",
     "  REAK_K2_BEGIN();\n  tile_setup(wd, sm, Q, QN, R, n, m, th);\n"),
    ("pdip_whole.cu",
     "  rollout_pass(wd, sm, ltv, c, x0, w.u, w.xs, H, th);\n",
     "  rollout_pass(wd, sm, ltv, c, x0, w.u, w.xs, H, th);\n"
     "  REAK_K2_STAMP(0);\n"),
    ("pdip_whole.cu", "    reverse_pass(wd, sm, io, ltv, H, th);\n",
     "    reverse_pass(wd, sm, io, ltv, H, th);\n    REAK_K2_STAMP(1);\n"),
    ("pdip_whole.cu",
     "no_dx0, no_dx, H,\n                 th);\n",
     "no_dx0, no_dx, H,\n                 th);\n    REAK_K2_STAMP(2);\n"),
    ("pdip_whole.cu", "    // ---- phase 4:",
     "    REAK_K2_STAMP(3);\n    // ---- phase 4:"),
    ("pdip_whole.cu", "                          w.w2, H, th);\n",
     "                          w.w2, H, th);\n    REAK_K2_STAMP(4);\n"),
    ("pdip_whole.cu", "no_dx0, &w.dxs, H,\n                 th);\n",
     "no_dx0, &w.dxs, H,\n                 th);\n    REAK_K2_STAMP(5);\n"),
    ("pdip_whole.cu", "    });\n  }\n\n  // ---- clip to the box",
     "    });\n    REAK_K2_STAMP(6);\n  }\n\n  // ---- clip to the box"),
    ("pdip_whole.cu",
     "  rollout_pass(wd, sm, ltv, c, x0, w.u, xs_out, H, th);\n}",
     "  rollout_pass(wd, sm, ltv, c, x0, w.u, xs_out, H, th);\n"
     "  REAK_K2_STAMP(7);\n  REAK_K2_END();\n}"),
    ("riccati_tile.cuh",
     "    if (w.owns(th, NB - 1)) tile_chol_factor(w, L, s);\n",
     "    {\n      REAK_K2_SPAN_BEGIN(th.tid == (NB - 1) * TS);\n"
     "      if (w.owns(th, NB - 1)) tile_chol_factor(w, L, s);\n"
     "      REAK_K2_SPAN_END(th.tid == (NB - 1) * TS, 8);\n    }\n"),
    ("riccati_tile.cuh",
     "    __syncthreads();  // (4) the factor and w are there\n",
     "    {\n      REAK_K2_SPAN_BEGIN(th.tid == 0);\n      __syncthreads();\n"
     "      REAK_K2_SPAN_END(th.tid == 0, 9);\n    }\n"),
) + tuple(
    ("riccati_tile.cuh", f"    __syncthreads();  // ({k}) {what}\n",
     "    {\n      REAK_K2_SPAN_BEGIN(th.tid == 0);\n      __syncthreads();\n"
     "      REAK_K2_SPAN_END(th.tid == 0, 10);\n    }\n")
    for k, what in ((1, "A_h, B_h, V, v and the stage vectors are there"),
                    (2, "V B is there"),
                    (3, "G, F and λ_full are there"),
                    (5, "the unsymmetrized V is there, v has been read")))

FLAGSHIP = (12, 6, 50, 8192)
# (label, n, m, H, B): the other shapes each tree is timed at, 8 iterations
SHAPES = (("h256", 12, 6, 256, 8192), ("floating_arm_24x12", 24, 12, 16,
                                       2048),
          ("ssrms_14x7_padded", 14, 7, 50, 8192))
ITERS = 8


def stamped_source(csrc: Path, dst: Path) -> None:
    """A copy of ``csrc`` whose K2 records its phase cycles."""
    shutil.copytree(csrc, dst)
    path = dst / "pdip_whole.cu"
    text = path.read_text()
    if "REAK_K2_STAMP(" not in text:
        for name, old, new in OLD_HOOKS:
            f = dst / name
            t = f.read_text()
            if t.count(old) != 1:
                raise RuntimeError(f"{name} no longer holds {old!r} once")
            f.write_text(t.replace(old, new))
        text = path.read_text()
    at = text.index("#include")
    path.write_text(text[:at] + STAMPS + "#define REAK_K2_STAMPS 1\n"
                    + text[at:])


def _nvcc(src_dir: Path, bound, out: Path):
    defines = [f"-DREAK_NMAX={bound[0]}", f"-DREAK_MMAX={bound[1]}",
               "-DREAK_TYPE=float", "-DREAK_SUFFIX=f32"]
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(src_dir),
         "-o", str(out), str(src_dir / "pdip_whole.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _k2_config(root: Path):
    """The K2 launch shapes of a tree: its ``ops/_tile.py``'s
    ``k2_config``, or ``tile_config`` in a tree from before the pipeline."""
    mod = _tile
    if root is not None:
        spec = importlib.util.spec_from_file_location(
            "k2_phases_tile", root / "reak_tpu_torch" / "ops" / "_tile.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # its dataclasses look it up
        spec.loader.exec_module(mod)
    return getattr(mod, "k2_config", mod.tile_config)


class Tree:
    """One tree of K2's sources, built: the (16, 8) and (24, 12) libraries
    and the stamped (16, 8) copy."""

    def __init__(self, label, root, work):
        self.label = label
        self.config = _k2_config(root)
        csrc = (_build.CSRC if root is None
                else root / "reak_tpu_torch" / "csrc")
        d = work / label
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        shutil.copytree(csrc, d / "plain")
        stamped_source(csrc, d / "stamped")
        self.paths = {"16x8": d / "k2_16x8.so", "24x12": d / "k2_24x12.so",
                      "stamped": d / "k2_stamped.so"}
        self.procs = {"16x8": _nvcc(d / "plain", (16, 8), self.paths["16x8"]),
                      "24x12": _nvcc(d / "plain", (24, 12),
                                     self.paths["24x12"]),
                      "stamped": _nvcc(d / "stamped", (16, 8),
                                       self.paths["stamped"])}

    def load(self):
        self.ptxas, self.fns = {}, {}
        for key, proc in self.procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.label} {key}:\n"
                                   f"{err}")
            lines = err.splitlines()
            self.ptxas[key] = {
                re.search(r"kernel(I\w+E)", line).group(1): " | ".join(
                    s.replace("ptxas info    :", "").strip()
                    for s in lines[i + 2:i + 4])
                for i, line in enumerate(lines)
                if "Compiling entry" in line and "pdip_" in line
                and re.search(r"kernel(I\w+E)", line)}
            lib = ctypes.CDLL(str(self.paths[key]))
            bound = (24, 12) if key == "24x12" else (16, 8)
            fn = getattr(lib, pdip_whole.entry_point(bound, torch.float32))
            fn.argtypes = pdip_whole._ARGS
            fn.restype = ctypes.c_int
            self.fns[key] = fn
            if key == "stamped":
                self.read = lib.reak_k2_cycles_read
                self.read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                self.read.restype = ctypes.c_int


def problem(rng, n, m, H, B, dev):
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=dev).contiguous()
    return {"A": t(0.1 * rng.standard_normal((H, n, n, B))
                   + np.eye(n)[None, :, :, None]),
            "Bm": t(0.2 * rng.standard_normal((H, n, m, B))),
            "c": t(0.05 * rng.standard_normal((H, n, B))),
            "x0": t(rng.standard_normal((n, B))), "Q": t(np.eye(n)),
            "QN": t(5.0 * np.eye(n)), "R": t(0.1 * np.eye(m)),
            "lb": t(np.full(m, -1.5)), "ub": t(np.full(m, 1.5))}


def cuda_ms(fn, reps):
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


def launcher(tree, key, p, n, m, H, B, iters, dev):
    """A call of one of ``tree``'s libraries on problem ``p``; it raises if
    the launch is refused."""
    f32 = torch.float32
    tile = tree.config(n, m, f32)
    u = torch.empty(H, m, B, dtype=f32, device=dev)
    xs = torch.empty(H, n, B, dtype=f32, device=dev)
    scratch = torch.empty(pdip_whole.scratch_values(H, n, m)
                          * tile.padded_batch(B), dtype=f32, device=dev)
    ptr = _build.ptr
    args = [ptr(p["A"]), ptr(p["Bm"]), ptr(p["c"]), None, None,
            *(ptr(p[k]) for k in ("x0", "Q", "QN", "R", "lb", "ub")),
            ptr(u), ptr(xs), ptr(scratch), scratch.numel(), H, n, m, B,
            iters, tile.shared_bytes, _build.stream_ptr(dev)]
    fn = tree.fns[key]

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{tree.label} {key}: launch refused, CUDA "
                               f"error {rc}")
        return u, xs

    return run


def split(tree, p, dev, kernel_ms):
    """The stamped copy's cycles a block by slot, and the unstamped
    kernel's ms split by thread 0's phase shares."""
    n, m, H, B = FLAGSHIP
    run = launcher(tree, "stamped", p, n, m, H, B, ITERS, dev)
    stamped_ms = cuda_ms(run, 3)
    blocks = tree.config(n, m, torch.float32).blocks(B)
    buf = np.zeros((blocks, N_SLOTS), dtype=np.uint64)
    rc = tree.read(buf.ctypes.data, blocks)
    if rc != 0:
        raise RuntimeError(f"reading the stamps: CUDA error {rc}")
    cyc = buf.astype(np.float64).mean(axis=0)
    total = float(cyc[:len(SLOTS)].sum())
    out = {"stamped_ms": stamped_ms, "cycles_a_block": total,
           "blocks": blocks, "phases": {}}
    for i, name in enumerate(SLOTS):
        out["phases"][name] = {"share": cyc[i] / total,
                               "ms": kernel_ms * cyc[i] / total}
    for j, name in enumerate(SPANS):
        c = cyc[len(SLOTS) + j]
        out["phases"][name] = {"share": c / total, "ms": kernel_ms * c / total}
    return out


def measure(tree, data, dev, round_):
    n, m, H, B = FLAGSHIP
    p = data[FLAGSHIP]
    row = {"tree": tree.label, "round": round_, "ptxas": tree.ptxas,
           "shared_bytes": tree.config(n, m, torch.float32).shared_bytes}
    row["flagship_ms"] = cuda_ms(launcher(tree, "16x8", p, n, m, H, B, ITERS,
                                          dev), 5)
    row["iters_ms"] = {it: cuda_ms(launcher(tree, "16x8", p, n, m, H, B, it,
                                            dev), 5) for it in (0, 1, 2, 8)}
    its = np.array([0, 1, 2, 8], dtype=np.float64)
    slope, intercept = np.polyfit(its, [row["iters_ms"][i] for i in
                                        (0, 1, 2, 8)], 1)
    row["iteration_ms"], row["rollouts_ms"] = float(slope), float(intercept)
    for label, n_, m_, H_, B_ in SHAPES:
        key = "24x12" if (n_, m_) == (24, 12) else "16x8"
        row[f"{label}_ms"] = cuda_ms(launcher(
            tree, key, data[(n_, m_, H_, B_)], n_, m_, H_, B_, ITERS, dev), 3)
    row["split"] = split(tree, p, dev, row["flagship_ms"])
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout, timed in turns")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    work = _build.BUILD_DIR.parent / "k2_phases"
    trees = [Tree("this", None, work)]
    if args.parent is not None:
        trees.insert(0, Tree("parent", args.parent.resolve(), work))
    rng = np.random.default_rng(0)
    data = {s: problem(rng, *s, dev) for s in
            (FLAGSHIP, *(sh[1:] for sh in SHAPES))}
    for tree in trees:
        tree.load()
    order = trees if len(trees) == 1 else [trees[0], trees[1], trees[1],
                                          trees[0]]
    rows = []
    for i, tree in enumerate(order):
        rows.append({"card": card, **measure(tree, data, dev, i)})
        print(json.dumps(rows[-1]), flush=True)
    if len(trees) == 2:
        # the two trees' outputs on the flagship shape
        n, m, H, B = FLAGSHIP
        outs = [launcher(t, "16x8", data[FLAGSHIP], n, m, H, B, ITERS,
                         dev)() for t in trees]
        torch.cuda.synchronize()
        diff = {"card": card, "max_abs_u_parent_vs_this": float(
            (outs[0][0] - outs[1][0]).abs().max()),
            "max_abs_xs_parent_vs_this": float(
                (outs[0][1] - outs[1][1]).abs().max())}
        rows.append(diff)
        print(json.dumps(diff), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
