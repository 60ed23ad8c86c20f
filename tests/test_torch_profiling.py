"""The port's profiler (reak_tpu_torch.io.profiling) on the CPU: the
section timer's summary, report and recorder rows (as
``tests/test_io.py:175-196`` checks the JAX package's), ``block_timed``,
and ``device_trace(device="cpu")`` writing a Chrome trace of CPU activity.
The section id of a recorded row is a CRC-32 of its name, the same in every
process (fault F16: the JAX package writes ``hash(name) % 10**9``, which
Python salts per process)."""
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from reak_tpu_torch.io import profiling
from reak_tpu_torch.io.recorder import MemoryRecorder


def test_sections_summary_report_and_rows():
    rec = MemoryRecorder(["t", "section_us", "section"])
    prof = profiling.ExecTimeProfiler(recorder=rec)
    for _ in range(3):
        with prof.section("work"):
            time.sleep(0.002)
    with prof.section("other"):
        pass
    s = prof.summary()
    assert s["work"]["count"] == 3 and s["other"]["count"] == 1
    assert s["work"]["total_s"] >= 0.005
    assert s["work"]["max_s"] >= s["work"]["mean_s"] > 0
    report = prof.report().splitlines()
    assert report[1].startswith("work") and report[2].startswith("other")
    rows = rec.as_array()
    assert rows.shape == (4, 3)
    ids = [profiling.section_id("work")] * 3 + [profiling.section_id("other")]
    np.testing.assert_array_equal(rows[:, 2], ids)
    assert np.all(rows[:3, 1] >= 2000.0)
    assert profiling.section_id("work") == zlib.crc32(b"work") % 10**9


def test_disabled_profiler_and_raising_section():
    rec = MemoryRecorder(["t", "section_us", "section"])
    off = profiling.ExecTimeProfiler(recorder=rec, enabled=False)
    with off.section("x"):
        pass
    assert off.summary() == {} and rec.rows == []
    on = profiling.ExecTimeProfiler(recorder=rec)
    with pytest.raises(ValueError):
        with on.section("fails"):
            raise ValueError
    assert on.summary()["fails"]["count"] == 1 and len(rec.rows) == 1


def test_section_id_is_the_same_in_every_process():
    """F16: two interpreters with different string-hash seeds agree on the
    port's id (and on Python's ``hash``, which the JAX package uses, they
    do not)."""
    # the module alone, loaded from its file (it imports no torch at the
    # top), so each interpreter starts in milliseconds
    code = ("import importlib.util, sys;"
            "spec = importlib.util.spec_from_file_location('p', sys.argv[1]);"
            "m = importlib.util.module_from_spec(spec);"
            "spec.loader.exec_module(m);"
            "print(m.section_id('rollout'), hash('rollout') % 10**9)")
    out = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        out.append(subprocess.run([sys.executable, "-c", code,
                                   profiling.__file__],
                                  env=env, capture_output=True, text=True,
                                  check=True).stdout.split())
    assert out[0][0] == out[1][0] == str(zlib.crc32(b"rollout") % 10**9)
    assert out[0][1] != out[1][1]


def test_block_timed():
    out, dt = profiling.block_timed(lambda x: (torch.sum(x * x), {"y": x}),
                                    torch.arange(100.0))
    assert float(out[0]) > 0 and dt >= 0
    assert profiling._cuda_devices(out) == set()


def test_device_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        y = x @ x
    assert y.shape == (64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert any("mm" in n for n in names)
    assert any("mm" in e.key for e in prof.key_averages())
