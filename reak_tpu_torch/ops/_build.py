"""Build the hand-written CUDA kernels at their first use.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"`` interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded
with ``ctypes``.  A source whose instances take long to compile is built once
per instance, each into a library of its own, so the builds run side by
side: the library ``<name>@<NMAX>x<MMAX>_<f32|f64>`` is ``csrc/<name>.cu``
compiled for that one bound and type, ``<name>@any_<f32|f64>`` its
runtime-width instance for that type.  The library lands in
``build/reak_tpu_torch/`` beside the package (listed in ``.gitignore``),
named by a hash of the sources and the flags, so an edited source is rebuilt
and an unchanged one is not.  Nothing here runs at import: a machine without
``nvcc`` or CUDA imports the ops modules and uses their plain versions on CPU
tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reak_tpu_torch"
# -split-compile=0: a library's instances are optimized on all the cores, so
# the longest build (the (24, 12) whole-solve kernel in f64) speeds up once
# the shorter ones have finished
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "-split-compile=0")

_libs: dict[str, ctypes.CDLL] = {}
# {(library, function): the function, its argtypes declared}
_functions: dict = {}
# {module name: module} of every kernel wrapper; each one's ``launches`` (an
# int, or a dict of ints by entry) counts its kernel's launches, and
# ops/graphs credits a replayed graph's launches to them
launch_counters: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def instance_library(name: str, bound, suffix: str) -> str:
    """The library of ``csrc/<name>.cu`` built for one (NMAX, MMAX) bound
    and one type (``f32`` or ``f64``); ``bound=None`` names the
    runtime-width instance, ``<name>@any_<type>``."""
    if bound is None:
        return f"{name}@any_{suffix}"
    return f"{name}@{bound[0]}x{bound[1]}_{suffix}"


def _source_and_defines(name: str):
    """``name``, ``name@<NMAX>x<MMAX>_<f32|f64>`` or ``name@any_<f32|f64>``
    → the source file and the macros that select the instance."""
    base, _, instance = name.partition("@")
    if not instance:
        return CSRC / f"{base}.cu", []
    widths, suffix = instance.split("_")
    ctype = {"f32": "float", "f64": "double"}[suffix]
    if widths == "any":
        return CSRC / f"{base}.cu", ["-DREAK_RUNTIME=1",
                                     f"-DREAK_TYPE={ctype}",
                                     f"-DREAK_SUFFIX={suffix}"]
    nmax, mmax = widths.split("x")
    return CSRC / f"{base}.cu", [f"-DREAK_NMAX={int(nmax)}",
                                 f"-DREAK_MMAX={int(mmax)}",
                                 f"-DREAK_TYPE={ctype}",
                                 f"-DREAK_SUFFIX={suffix}"]


def library_path(name: str) -> Path:
    """Where the library ``name`` goes, keyed by its sources and flags."""
    source, defines = _source_and_defines(name)
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    for src in [source] + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when the library ``name`` was built:
    registers, stack frame and spills of every kernel instance."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def build_all(names) -> dict:
    """Compile each library of ``names`` that is not built yet, one ``nvcc``
    per library, all started together; returns {name: library}."""
    outs = {name: library_path(name) for name in names}
    procs = {}
    for name, out in outs.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, defines = _source_and_defines(name)
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o",
               str(tmp), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{err}")
            continue
        outs[name].with_suffix(".ptxas.txt").write_text(err)
        os.replace(tmp, outs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile the library ``name`` unless it is already built."""
    return build_all([name])[name]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use, with
    ``signatures`` ({function: argtypes}, each returning a CUDA error
    code) declared on it.  Several wrappers may share one library, each
    declaring its own functions; a function is declared once."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        lib.reak_cuda_error_string.argtypes = [ctypes.c_int]
        lib.reak_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    for fn, argtypes in signatures.items():
        if (name, fn) not in _functions:
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _functions[(name, fn)] = f
    return lib


def function(name: str, fn: str, signatures: dict):
    """The C function ``fn`` of the library ``name``, ready to call: a
    launch's one lookup (the first also builds and loads the library and
    declares ``signatures`` on it, as ``load``)."""
    f = _functions.get((name, fn))
    if f is None:
        load(name, signatures)
        f = _functions[(name, fn)]
    return f


def count_launches(module_name: str) -> None:
    """Register the wrapper module ``module_name`` (called by the module
    at its import) as one whose ``launches`` counts its kernel's
    launches."""
    launch_counters[module_name] = sys.modules[module_name]


def check(name: str, rc: int, what: str) -> None:
    """Raise if a launch of the library ``name`` returned a CUDA error
    code."""
    if rc != 0:
        msg = _libs[name].reak_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
