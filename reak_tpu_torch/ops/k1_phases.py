"""Where the rollout-step kernel (K1, ``csrc/kte_step.cu``) and its core
instance (K5) spend their time on the card, phase by phase, and how two
trees of their sources compare.

Run on a machine with one NVIDIA GPU and ``nvcc``, from the root of a
checkout:

    python3 -m reak_tpu_torch.ops.k1_phases [--parent DIR] [--out FILE]

For each tree of sources (this checkout's ``reak_tpu_torch/csrc``, and with
``--parent`` the ``reak_tpu_torch/csrc`` of another checkout in DIR, timed
in turns: parent, this, this, parent) it builds under ``build/k1_phases/``
the (6, 6) and (7, 7) f32 libraries of ``kte_step.cu`` (the flagship arm
and the 7-DoF SSRMS), and a copy of each with ``clock64()`` stamps
(``-DREAK_K1_STAMPS``): one recording thread of each direction (the
earlier design) or pair slot (the present one) adds the cycles since its
last stamp to the slot of the phase that just ended, and the block's first
thread and every recorder note the global timer at the block's start and
end.  The shipped libraries have no stamps: the source calls the
``REAK_K1_*`` hooks, which are empty unless the stamps block below is
inserted; a source without the hooks (the earlier design) gets them
inserted at its phase boundaries (``OLD_HOOKS``).

On the flagship's states (as ``chip_smoke.k1_inputs`` draws them: numpy
seed 0, q ~ U(±0.5), q̇ ~ U(±0.2), u ~ U(±5)) and the SSRMS's (the same
draws over seven joints) it times with CUDA events K1 and K5 at B = 8192,
at one block an SM (B = SMs × TS) and at the small batches ``SMALL_B``,
and the f64 instances of the other routes that launch K1 (``ROUTES``: the
16-segment beam, the 2-link closed loop, the flagship arm) at their
batches (f64 within 1e-9 relative of the plain versions), each also in
the split mode (``*_split_mode_ms``) where the tree has one.  It checks
the f32 K1 and K5, in both modes, against the plain versions (within
twice the plain f32 error against the plain f64 result), splits the
stamped copy's cycles by phase at B = 8192 and at one block an SM (the
pair slots), and reads ptxas' registers, stack and spills and the SASS
instruction mix of each instance (``cuobjdump -sass``; the kernel's loops
are unrolled, so its static count is close to what a thread executes).  It
prints the card's name and power limit, then one JSON line per tree and
round, and writes them all to FILE.
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
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from reak_tpu_torch.kte import models
from reak_tpu_torch.ops import _build, kte_core, kte_step

MAX_BLOCKS, MAX_WHO, N_SLOTS = 1024, 32, 16
B = 8192
DT = 0.01
# (label, chain constructor, joints): the instances timed
CHAINS = (("6x6", models.manip_3r3r, 6), ("7x7", models.manip_ssrms, 7))
# small batches of those, timed beside B = 8192: a grid far under one wave
# takes one block's latency, not the SMs' throughput
SMALL_B = (64, 16)
# the instances of the other routes that launch K1 (label, chain, joints,
# type, batches), timed only (no stamps): the 16-segment beam's solve
# (B = 64) and its widest-instance timing (B = 8192), the 2-link closed
# loop (B = 1), the flagship arm in f64 (B = 1 and 77 of its checks)
ROUTES = (("16x16_f64", lambda: models.flexible_beam(16), 16, torch.float64,
           (64, 8192)),
          ("2x2_f64", models.planar_2link, 2, torch.float64, (1, 8192)),
          ("6x6_f64", models.manip_3r3r, 6, torch.float64, (1, 77, 8192)))
# {key: (chain constructor, joints = dofs, type)} of every instance built
CHAINS_F32 = {key for key, _, _ in CHAINS}
INSTANCES = {**{key: (build, nj, torch.float32) for key, build, nj in CHAINS},
             **{key: (build, nj, dt) for key, build, nj, dt, _ in ROUTES}}

# the stamps: inserted before the first #include of kte_step.cu.  Each
# recorder (one thread of each direction; the source's REAK_K1_BEGIN names
# it) adds the cycles since its last stamp to cycles[block][who][slot]; the
# block's start and its last recorder's end on the global timer (ns).
STAMPS = r"""
#include <cuda_runtime.h>
#define REAK_K1_SLOTS 16
#define REAK_K1_WHO 32
__device__ unsigned long long reak_k1_cycles[1024][REAK_K1_WHO][REAK_K1_SLOTS];
__device__ unsigned long long reak_k1_span[1024][2];
__device__ inline unsigned long long reak_k1_ns() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}
#define REAK_K1_BEGIN(who)                                                 \
  const int reak_k1_who_ = (who);                                          \
  unsigned long long reak_k1_last_ = clock64();                            \
  if (threadIdx.x == 0 && threadIdx.y == 0 && blockIdx.x < 1024)           \
    reak_k1_span[blockIdx.x][0] = reak_k1_ns()
#define REAK_K1_STAMP(slot)                                                \
  do {                                                                     \
    if (reak_k1_who_ >= 0 && blockIdx.x < 1024) {                          \
      const unsigned long long t_ = clock64();                             \
      atomicAdd(&reak_k1_cycles[blockIdx.x][reak_k1_who_][slot],           \
                t_ - reak_k1_last_);                                       \
      reak_k1_last_ = t_;                                                  \
    }                                                                      \
  } while (0)
#define REAK_K1_END()                                                      \
  do {                                                                     \
    if (reak_k1_who_ >= 0 && blockIdx.x < 1024)                            \
      atomicMax(&reak_k1_span[blockIdx.x][1], reak_k1_ns());               \
  } while (0)
extern "C" int reak_k1_stamps_read(void* cycles, void* span, int blocks) {
  cudaError_t rc = cudaMemcpyFromSymbol(
      cycles, reak_k1_cycles,
      sizeof(unsigned long long) * REAK_K1_WHO * REAK_K1_SLOTS * blocks);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaMemcpyFromSymbol(
      span, reak_k1_span, sizeof(unsigned long long) * 2 * blocks));
}
extern "C" int reak_k1_stamps_clear() {
  static unsigned long long zero[1024 * REAK_K1_WHO * REAK_K1_SLOTS];
  cudaError_t rc = cudaMemcpyToSymbol(reak_k1_cycles, zero, sizeof(zero));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(
      cudaMemcpyToSymbol(reak_k1_span, zero, sizeof(reak_k1_span)));
}
"""

# the slots of each design, in the order of a tile.  The earlier design
# (a warp a direction, which the runtime-width instance keeps): a block is
# one tile; the last direction's threads run the primal kinematics while
# the others wait at the first barrier, direction 0 factors M while the
# others wait at the second.
OLD_SLOTS = ("primal", "wait_primal", "terms_q", "terms_qd", "factor",
             "wait_factor", "dqdd", "wait_dqdd", "series", "wait_series",
             "step_row")
# the pair-slot design: a block is a tile of pair slots; after the primal
# phase each thread runs its q direction, factors M, takes that
# direction's columns, runs its q̇ direction and takes its column; then
# (K1) the columns to the series rows, two columns of S, two step rows
NEW_SLOTS = ("primal", "wait_primal", "terms_q", "factor", "columns_q",
             "terms_qd", "column_qd", "wait_runs", "store_columns",
             "wait_columns", "series", "wait_series", "step_rows")

# the earlier design's compile-time kernel, and the same with the hooks: (text,
# text with the hooks) in kte_step.cu's compile-time kernel
OLD_HOOKS = (
    ("  using Shape = StepShape<T, NJ, NV, kCoreOnly>;\n"
     "  constexpr int TS = Shape::TS, N = Shape::N;\n",
     "  REAK_K1_BEGIN(threadIdx.x == 0 ? static_cast<int>(threadIdx.y) : -1);\n"
     "  using Shape = StepShape<T, NJ, NV, kCoreOnly>;\n"
     "  constexpr int TS = Shape::TS, N = Shape::N;\n"),
    ("    primal_phase<T>(ch, NJ, jt, xq, xqd, keep);\n  }\n"
     "  __syncthreads();\n  const TakePrimal<T, TS> take{fk, s};\n",
     "    primal_phase<T>(ch, NJ, jt, xq, xqd, keep);\n  }\n"
     "  REAK_K1_STAMP(0);\n  __syncthreads();\n  REAK_K1_STAMP(1);\n"
     "  const TakePrimal<T, TS> take{fk, s};\n"),
    ("    terms<T>(ch, NJ, jt, xq, xqd, AlongQd<T>{jd}, take, dw);\n"
     "  // direction 0",
     "    terms<T>(ch, NJ, jt, xq, xqd, AlongQd<T>{jd}, take, dw);\n"
     "  REAK_K1_STAMP(d < NV ? 2 : 3);\n  // direction 0"),
    ("                                s);\n  __syncthreads();\n",
     "                                s);\n  REAK_K1_STAMP(4);\n"
     "  __syncthreads();\n  REAK_K1_STAMP(5);\n"),
    ("  if constexpr (kCoreOnly) return;  // K5 ends here, no barrier "
     "follows\n  __syncthreads();\n",
     "  REAK_K1_STAMP(6);\n  if constexpr (kCoreOnly) {\n"
     "    REAK_K1_END();\n    return;\n  }\n  __syncthreads();\n"
     "  REAK_K1_STAMP(7);\n"),
    ("  series_column(d, NV, TS, dw, dt, order, ser, s);\n"
     "  __syncthreads();\n",
     "  series_column(d, NV, TS, dw, dt, order, ser, s);\n"
     "  REAK_K1_STAMP(8);\n  __syncthreads();\n  REAK_K1_STAMP(9);\n"),
    ("  step_row(d, NV, TS, xv, uv, f0, x, ser, Ad, Bd, cd, xn, B, b, live, "
     "s);\n}\n",
     "  step_row(d, NV, TS, xv, uv, f0, x, ser, Ad, Bd, cd, xn, B, b, live, "
     "s);\n  REAK_K1_STAMP(10);\n  REAK_K1_END();\n}\n"),
)


def stamped_source(csrc: Path, dst: Path) -> tuple:
    """A copy of ``csrc`` whose K1/K5 record their phase cycles; returns
    the slot names of its design."""
    shutil.copytree(csrc, dst)
    path = dst / "kte_step.cu"
    text = path.read_text()
    slots = NEW_SLOTS
    if "REAK_K1_STAMP(" not in text:
        slots = OLD_SLOTS
        for old, new in OLD_HOOKS:
            if text.count(old) != 1:
                raise RuntimeError(f"kte_step.cu no longer holds {old!r} "
                                   "once")
            text = text.replace(old, new)
    at = text.index("#include")
    path.write_text(text[:at] + STAMPS + "#define REAK_K1_STAMPS 1\n"
                    + text[at:])
    return slots


def _nvcc(src_dir: Path, nj: int, out: Path, dtype=torch.float32):
    suffix = kte_step.type_suffix(dtype)
    defines = [f"-DREAK_NMAX={nj}", f"-DREAK_MMAX={nj}",
               f"-DREAK_TYPE={'float' if suffix == 'f32' else 'double'}",
               f"-DREAK_SUFFIX={suffix}"]
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(src_dir),
         "-o", str(out), str(src_dir / "kte_step.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _launch_shape(root):
    """A tree's ``ops/kte_step.py::launch_shape``."""
    if root is None:
        return kte_step.launch_shape
    spec = importlib.util.spec_from_file_location(
        "k1_phases_kte_step", root / "reak_tpu_torch" / "ops" / "kte_step.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod.launch_shape


def ptxas_of(report: str, nj: int, dtype=torch.float32) -> dict:
    """{K1 or K5, and their split mode's: registers, stack, spills} of the
    (nj, nj) kernels."""
    lines = report.splitlines()
    out = {}
    t = "f" if dtype == torch.float32 else "d"
    for mode, core in ((m, c) for m in ("step", "split") for c in (0, 1)):
        frag = f"kte_{mode}_kernelI{t}Li{nj}ELi{nj}ELb{core}E"
        tag = ("k5" if core else "k1") + ("_split" if mode == "split" else "")
        for i, line in enumerate(lines):
            if "Compiling entry" in line and frag in line:
                text = " ".join(lines[i + 1:i + 4])

                def num(pat):
                    m = re.search(pat, text)
                    return int(m.group(1)) if m else None

                out[tag] = {
                    "registers": num(r"Used (\d+) registers"),
                    "stack_bytes": num(r"(\d+) bytes stack frame"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads"),
                    "text": " | ".join(s.replace("ptxas info    :",
                                                 "").strip()
                                       for s in lines[i + 1:i + 4])}
    return out


# SASS opcodes by what they do
SASS_KINDS = {"fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL",
                       "FCHK"),
              "fp64": ("DFMA", "DMUL", "DADD", "DSETP"),
              "mufu": ("MUFU",), "shared": ("LDS", "STS"),
              "local": ("LDL", "STL"), "global": ("LDG", "STG", "RED", "ATOM",
                                                  "ATOMG"),
              "constant": ("LDC", "ULDC"), "barrier": ("BAR", "WARPSYNC",
                                                       "SYNCS", "BSYNC",
                                                       "BSSY"),
              "move": ("MOV", "IMAD.MOV", "UMOV", "S2R", "CS2R", "S2UR")}


def sass_mix(lib: Path, nj: int) -> dict:
    """{K1 or K5: {instructions, bytes, by kind}} of the (nj, nj) f32
    kernels from ``cuobjdump -sass``; {} where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out, current = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            current = None
            for core in (0, 1):
                if f"kte_step_kernelIfLi{nj}ELi{nj}ELb{core}E" in line:
                    current = out.setdefault("k5" if core else "k1",
                                             Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if current is not None and m:
            current[m.group(1)] += 1
    res = {}
    for key, ops in out.items():
        total = sum(ops.values())
        kinds = {k: sum(v for op, v in ops.items()
                        if op.split(".")[0] in names or op in names)
                 for k, names in SASS_KINDS.items()}
        kinds["other"] = total - sum(kinds.values())
        res[key] = {"instructions": total, "bytes": 16 * total,
                    "by_kind": kinds}
    return res


class Tree:
    """One tree of K1's sources, built: the (6, 6) and (7, 7) f32
    libraries and their stamped copies, and the other routes' instances."""

    def __init__(self, label, root, work):
        self.label = label
        self.shape = _launch_shape(root)
        csrc = (_build.CSRC if root is None
                else root / "reak_tpu_torch" / "csrc")
        d = work / label
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        shutil.copytree(csrc, d / "plain")
        self.slots = stamped_source(csrc, d / "stamped")
        self.paths, self.procs = {}, {}
        for key, _, nj in CHAINS:
            for kind in ("plain", "stamped"):
                path = d / f"k1_{key}_{kind}.so"
                self.paths[key, kind] = path
                self.procs[key, kind] = _nvcc(d / kind, nj, path)
        for key, _, nj, dtype, _ in ROUTES:
            path = d / f"k1_{key}_plain.so"
            self.paths[key, "plain"] = path
            self.procs[key, "plain"] = _nvcc(d / "plain", nj, path, dtype)

    def has_split(self, key):
        """Whether the tree's libraries have the split mode."""
        return "step_split" in self.fns[key, "plain"]

    def load(self):
        self.ptxas, self.sass, self.fns, self.read = {}, {}, {}, {}
        for (key, kind), proc in self.procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.label} {key} "
                                   f"{kind}:\n{err}")
            _, nj, dtype = INSTANCES[key]
            lib = ctypes.CDLL(str(self.paths[key, kind]))
            fns = {}
            # an earlier tree's library may lack the shape query and the
            # split mode
            for k, args in kte_step.SIGNATURES.items():
                name = kte_step.entry_point(k, (nj, nj), dtype)
                if k != "step" and k != "core" and not hasattr(lib, name):
                    continue
                fns[k] = getattr(lib, name)
                fns[k].argtypes = args
                fns[k].restype = ctypes.c_int
            self.fns[key, kind] = fns
            if key not in CHAINS_F32:
                self.ptxas[key] = ptxas_of(err, nj, dtype)
            elif kind == "plain":
                self.ptxas[key] = ptxas_of(err, nj)
                self.sass[key] = sass_mix(self.paths[key, kind], nj)
            else:
                rd = lib.reak_k1_stamps_read
                rd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                rd.restype = ctypes.c_int
                clear = lib.reak_k1_stamps_clear
                clear.restype = ctypes.c_int
                self.read[key] = (rd, clear)


def inputs(nj, batch, dev, dtype=torch.float32):
    """x (2nj, batch), u (nj, batch) on the card, as
    ``chip_smoke.k1_inputs`` draws the flagship's (numpy seed 0)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.5, 0.5, (batch, nj)),
                        rng.uniform(-0.2, 0.2, (batch, nj))], axis=1).T
    u = rng.uniform(-5.0, 5.0, (nj, batch))
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=dtype, device=dev)
    return on(x), on(u)


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


def launcher(tree, key, kind, core, x, u, dev, split=False):
    """A launch of K1 (core False) or K5 of one of ``tree``'s libraries, in
    the split mode where ``split``; it raises if the launch is refused."""
    build, nj, dtype = INSTANCES[key]
    batch = x.shape[1]
    n = 2 * nj
    new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    smem = (tree.shape(nj, nj, dtype, core=core, split=True) if split
            else tree.shape(nj, nj, dtype, core=core)).shared_bytes
    table = kte_step.chain_table(build(), "cpu", dtype)
    p = _build.ptr
    stream = _build.stream_ptr(dev)
    fns = tree.fns[key, kind]
    if core:
        outs = (new(nj, batch), new(nj, n, batch), new(nj, nj, batch))
        args = [p(x), p(u), p(table), nj, nj, *(p(t) for t in outs), batch,
                smem, stream]
        fn = fns["core_split" if split else "core"]
    else:
        outs = (new(n, n, batch), new(n, nj, batch), new(n, batch),
                new(n, batch))
        args = [p(x), p(u), p(table), nj, nj, DT, 4, *(p(t) for t in outs),
                batch, smem, stream]
        fn = fns["step_split" if split else "step"]

    def run():
        rc = fn(*args)  # reads the table (a CPU tensor kept alive here)
        if rc != 0 or table.numel() == 0:
            raise RuntimeError(f"{tree.label} {key} {kind}: launch refused, "
                               f"CUDA error {rc}")
        return outs

    return run


def split(tree, key, core, x, u, dev, kernel_ms):
    """The stamped copy's cycles by slot (mean over blocks, per kind of
    recorder), the unstamped kernel's ms split by the shares of the
    slowest recorder's cycles, and the blocks' start spread."""
    nj = INSTANCES[key][1]
    rd, clear = tree.read[key]
    run = launcher(tree, key, "stamped", core, x, u, dev)
    stamped_ms = cuda_ms(run, 3)  # warm: the kernel's code in the caches
    if clear() != 0:
        raise RuntimeError("clearing the stamps")
    run()
    torch.cuda.synchronize()
    cyc = np.zeros((MAX_BLOCKS, MAX_WHO, N_SLOTS), dtype=np.uint64)
    span = np.zeros((MAX_BLOCKS, 2), dtype=np.uint64)
    rc = rd(cyc.ctypes.data, span.ctypes.data, MAX_BLOCKS)
    if rc != 0:
        raise RuntimeError(f"reading the stamps: CUDA error {rc}")
    used = np.flatnonzero(span[:, 0])
    cyc = cyc[used].astype(np.float64)
    n = 2 * nj
    per_who = cyc.sum(axis=2)  # (blocks, who): each recorder's cycles
    # the recorders: the first thread of each direction (the earlier design:
    # who = d, the q directions then the q̇), or of each pair slot (who =
    # slot, a spare primal slot who = nj)
    seen = [w for w in range(n + 1) if per_who[:, w].any()]
    if tree.slots == OLD_SLOTS:
        groups = {"q": [w for w in seen if w < nj],
                  "qd": [w for w in seen if nj <= w < n]}
    else:
        groups = {"slots": [w for w in seen if w < nj],
                  "spare_primal": [w for w in seen if w == nj]}
    total = per_who[:, seen].max(axis=1).mean()
    out = {"stamped_ms": stamped_ms, "blocks": int(len(used)),
           "cycles_a_block": float(total), "recorders": seen, "slots": {}}
    for i, name in enumerate(tree.slots):
        row = {f"{g}_cycles": float(cyc[:, ws, i].mean()) if ws else 0.0
               for g, ws in groups.items()}
        row["max_cycles"] = float(cyc[:, seen, i].max(axis=1).mean())
        if not any(row.values()):
            continue
        for g in groups:
            row[f"{g}_ms"] = kernel_ms * row[f"{g}_cycles"] / total
        out["slots"][name] = row
    start = span[used, 0].astype(np.float64)
    end = span[used, 1].astype(np.float64)
    t0 = start.min()
    out["span"] = {
        "kernel_us": float((end.max() - t0) / 1e3),
        "block_us_mean": float((end - start).mean() / 1e3),
        "start_us_quantiles": [float(np.quantile(start - t0, q) / 1e3)
                               for q in (0.0, 0.25, 0.5, 0.75, 1.0)],
        # blocks that started after the first block ended: the later waves
        "late_blocks": int(((start - t0) > (end.min() - t0)).sum())}
    return out


def check_f64(tree, key, x, u, dev):
    """f64 K1 and K5 (in both modes, where the tree has two) against the
    plain versions: the largest error relative to the plain result's
    largest value (must be ≤ 1e-9)."""
    spec = INSTANCES[key][0]()
    res = {}
    for core in (False, True):
        plain = (kte_core.make_core_plain(spec) if core
                 else kte_step.make_step_plain(spec, DT))
        ref = plain(x, u)
        for split in (False, True) if tree.has_split(key) else (False,):
            got = launcher(tree, key, "plain", core, x, u, dev, split)()
            torch.cuda.synchronize()
            rel = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref))
            tag = ("k5" if core else "k1") + ("_split_mode" if split else "")
            res[tag] = rel
            if not rel <= 1e-9:
                raise RuntimeError(f"{tree.label} {key} {tag} f64 error "
                                   f"{rel:.2e}")
    return res


def check(tree, key, x, u, dev):
    """f32 K1 and K5 (in both modes, where the tree has two) against the
    plain versions: the kernel's largest error against plain f64 over the
    plain f32 path's (must be ≤ 2)."""
    spec = INSTANCES[key][0]()
    res = {}
    for core in (False, True):
        plain = (kte_core.make_core_plain(spec) if core
                 else kte_step.make_step_plain(spec, DT))
        ref = plain(x.double(), u.double())
        p32 = plain(x, u)
        for split in (False, True) if tree.has_split(key) else (False,):
            got = launcher(tree, key, "plain", core, x, u, dev, split)()
            torch.cuda.synchronize()
            ratio = max(float((g.double() - r).abs().max())
                        / max(float((q.double() - r).abs().max()), 1e-30)
                        for g, q, r in zip(got, p32, ref))
            tag = ("k5" if core else "k1") + ("_split_mode" if split else "")
            res[tag] = ratio
            if not ratio <= 2.0:
                raise RuntimeError(f"{tree.label} {key} {tag} f32 error "
                                   f"{ratio:.2f}× the plain f32 error")
    return res


def measure(tree, data, dev, round_, sms):
    row = {"tree": tree.label, "round": round_, "ptxas": tree.ptxas,
           "sass": tree.sass, "slots": list(tree.slots), "chains": {},
           "routes": {}}
    for key, _, nj in CHAINS:
        ts = tree.shape(nj, nj, torch.float32).scenarios
        one_wave = sms * ts
        res = {"tile_scenarios": ts, "one_wave_B": one_wave,
               "shared_bytes": {"k1": tree.shape(nj, nj, torch.float32)
                                .shared_bytes,
                                "k5": tree.shape(nj, nj, torch.float32,
                                                 core=True).shared_bytes}}
        res["f32_error_over_plain"] = check(tree, key, *data[key, B], dev)
        for batch in (B, one_wave, *SMALL_B):
            x, u = data[key, batch]
            for core in (False, True):
                tag = f"{'k5' if core else 'k1'}_B{batch}"
                ms = cuda_ms(launcher(tree, key, "plain", core, x, u, dev),
                             20)
                res[f"{tag}_ms"] = ms
                if batch in (B, one_wave):
                    res[f"{tag}_split"] = split(tree, key, core, x, u, dev,
                                                ms)
                if tree.has_split(key):
                    res[f"{tag}_split_mode_ms"] = cuda_ms(launcher(
                        tree, key, "plain", core, x, u, dev, split=True), 20)
        row["chains"][key] = res
    for key, _, nj, dtype, batches in ROUTES:
        res = {"tile_scenarios": tree.shape(nj, nj, dtype).scenarios,
               "ptxas": tree.ptxas[key],
               "f64_rel": check_f64(tree, key, *data[key, batches[0]], dev)}
        for batch in batches:
            x, u = data[key, batch]
            for core in (False, True):
                tag = f"{'k5' if core else 'k1'}_B{batch}"
                res[f"{tag}_ms"] = cuda_ms(
                    launcher(tree, key, "plain", core, x, u, dev), 20)
                if tree.has_split(key):
                    res[f"{tag}_split_mode_ms"] = cuda_ms(launcher(
                        tree, key, "plain", core, x, u, dev, split=True), 20)
        row["routes"][key] = res
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout, timed in turns")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    work = _build.BUILD_DIR.parent / "k1_phases"
    trees = [Tree("this", None, work)]
    if args.parent is not None:
        trees.insert(0, Tree("parent", args.parent.resolve(), work))
    data = {}
    for key, _, nj in CHAINS:
        for tree in trees:
            ts = tree.shape(nj, nj, torch.float32).scenarios
            for batch in (B, sms * ts, *SMALL_B):
                if (key, batch) not in data:
                    data[key, batch] = inputs(nj, batch, dev)
    for key, _, nj, dtype, batches in ROUTES:
        for batch in batches:
            data[key, batch] = inputs(nj, batch, dev, dtype)
    for tree in trees:
        tree.load()
    order = trees if len(trees) == 1 else [trees[0], trees[1], trees[1],
                                          trees[0]]
    rows = []
    for i, tree in enumerate(order):
        rows.append({"card": card, "sms": sms,
                     **measure(tree, data, dev, i, sms)})
        print(json.dumps(rows[-1]), flush=True)
    if len(trees) == 2:
        # the two trees' K1 outputs at B = 8192, f32
        diff = {"card": card}
        for key, _, _ in CHAINS:
            outs = [launcher(t, key, "plain", False, *data[key, B], dev)()
                    for t in trees]
            torch.cuda.synchronize()
            diff[f"max_abs_k1_{key}_parent_vs_this"] = max(
                float((a - b).abs().max()) for a, b in zip(*outs))
        rows.append(diff)
        print(json.dumps(diff), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
