"""Tracing/profiling: section timers + device trace capture (port of
``reak_tpu/io/profiling.py``).

Equivalent of the reference's observability hooks (SURVEY.md §5.1):
exec_time_profiler (ref: core/base/exec_time_profiler.hpp:37-80 — markTime
IDs → per-interval microsecond rows to a file) and the planner timing
reporters.  Device work is profiled with ``torch.profiler`` (a Chrome trace
that Perfetto or chrome://tracing opens), host sections with a wall-clock
section timer that streams rows through the recorder data plane
(:mod:`reak_tpu_torch.io.recorder`).
"""
from __future__ import annotations

import contextlib
import os
import time
import zlib
from typing import Dict, List


def section_id(name: str) -> int:
    """The id of a section in the recorder's rows: a CRC-32 of its name,
    the same in every process (Python's ``hash`` of a string is salted per
    process, so the JAX package's ids cannot be matched to their names
    after the run)."""
    return zlib.crc32(name.encode()) % 10**9


class ExecTimeProfiler:
    """Named-section wall-clock profiler.

    with prof.section("fk"):
        ...
    prof.summary()  →  {"fk": {"count", "total_s", "mean_s", "max_s"}}

    Rows stream to ``recorder`` (any io.recorder sink) as they close, giving
    the same row-per-interval file the reference's profiler writes; the
    ``section`` column is ``section_id(name)``.  The clock is the host's: a
    section that launches work on a card times the launches unless it waits
    for them (``block_timed``, ``torch.cuda.synchronize``).
    """

    def __init__(self, recorder=None, enabled: bool = True):
        self.enabled = enabled
        self.recorder = recorder
        self._acc: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc.setdefault(name, []).append(dt)
            if self.recorder is not None:
                self.recorder.record({"t": time.time(), "section_us": dt * 1e6,
                                      "section": section_id(name)})

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._acc.items():
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "max_s": max(xs),
            }
        return out

    def report(self) -> str:
        lines = [f"{'section':<24}{'count':>8}{'total ms':>12}{'mean ms':>12}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<24}{s['count']:>8}"
                         f"{s['total_s']*1e3:>12.2f}{s['mean_s']*1e3:>12.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device: str = "cuda"):
    """Record the block's CPU activity, and its CUDA activity unless
    ``device="cpu"``, with ``torch.profiler`` and write a Chrome trace
    (``trace.json``) into ``log_dir`` — the device-side replacement for the
    reference's host-only profiler.  Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read after the
    block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_devices(out):
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples and
    dicts)."""
    import torch

    if torch.is_tensor(out):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in out))
    return set()


def block_timed(fn, *args, **kwargs):
    """Run ``fn`` and wait for its outputs; returns (result, seconds) — the
    correct way to wall-clock a function on an asynchronous device: every
    CUDA device holding one of the output tensors is synchronized."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
