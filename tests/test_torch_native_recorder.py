"""The port's native recorder (reak_tpu_torch.io.native_recorder) on the
CPU: the six cases of ``tests/test_native_recorder.py`` (file round trips
in binary and CSV, the Python extractor reading the native binary, the row
width check, a TCP loopback on 127.0.0.1 and the throughput floor), rows
given as tensors, a file of the port's recorder read back by the JAX
package's extractor, and the library built under ``build/native/`` of the
checkout, never into ``native/``."""
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from reak_tpu.io.recorder import open_extractor as jax_open_extractor
from reak_tpu_torch.io import native_recorder as nr
from reak_tpu_torch.io.recorder import BinaryRecorder, open_extractor

pytestmark = pytest.mark.skipif(not nr.available(),
                                reason="no native toolchain")


def test_binary_roundtrip(tmp_path, rng):
    path = str(tmp_path / "rows.bin")
    rows = rng.standard_normal((100, 4))
    with nr.NativeRecorder(path, ["t", "x", "y", "z"]) as rec:
        rec.record_rows(rows)
        rec.flush()
    with nr.NativeExtractor(path) as ext:
        assert ext.columns == ["t", "x", "y", "z"]
        got = ext.read_all()
    assert np.array_equal(got, rows)


def test_csv_roundtrip(tmp_path):
    path = str(tmp_path / "rows.csv")
    with nr.NativeRecorder(path, ["a", "b"]) as rec:
        rec.record([1.5, -2.25])
        rec.record({"a": 3.0, "b": 4.0})
        rec.record(torch.tensor([5.0, 6.5]))
    with nr.NativeExtractor(path) as ext:
        got = ext.read_all()
    np.testing.assert_allclose(got, [[1.5, -2.25], [3.0, 4.0], [5.0, 6.5]])


def test_python_extractors_read_native_binary(tmp_path, rng):
    """Wire-format interop with the port's and the JAX package's
    pure-Python extractors, and with the port's Python writer."""
    path = str(tmp_path / "interop.bin")
    rows = rng.standard_normal((10, 3))
    with nr.NativeRecorder(path, ["u", "v", "w"]) as rec:
        rec.record_rows(torch.as_tensor(rows))
    for extract in (open_extractor, jax_open_extractor):
        cols, got = extract(path)
        assert list(cols) == ["u", "v", "w"]
        assert np.array_equal(np.asarray(got), rows)
    py = str(tmp_path / "python.bin")
    rec = BinaryRecorder(py, ["u", "v", "w"])
    for r in rows:
        rec.record(r)
    rec.close()
    with open(py, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()  # the same bytes from both writers


def test_row_width_mismatch_raises(tmp_path):
    with nr.NativeRecorder(str(tmp_path / "x.bin"), ["a", "b"]) as rec:
        with pytest.raises(ValueError):
            rec.record([1.0, 2.0, 3.0])


def test_tcp_loopback(rng):
    """Native TCP recorder → Python socket server on 127.0.0.1."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    received = bytearray()
    done = threading.Event()

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(10.0)
        try:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                received.extend(chunk)
        except socket.timeout:
            pass
        conn.close()
        done.set()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    rows = rng.standard_normal((50, 2))
    rec = nr.NativeRecorder(f"tcp://127.0.0.1:{port}", ["p", "q"])
    rec.record_rows(rows)
    rec.flush()
    rec.close()
    assert done.wait(timeout=10.0)
    srv.close()
    header, _, body = bytes(received).partition(b"\n")
    assert b'"columns"' in header and b'"p"' in header
    assert np.array_equal(np.frombuffer(body, np.float64).reshape(-1, 2), rows)


def test_throughput_smoke(tmp_path, rng):
    """Background-thread buffering should sustain >100k rows/s to file."""
    path = str(tmp_path / "perf.bin")
    rows = rng.standard_normal((20000, 8))
    rec = nr.NativeRecorder(path, [f"c{i}" for i in range(8)])
    t0 = time.perf_counter()
    rec.record_rows(rows)
    rec.flush()
    dt = time.perf_counter() - t0
    rec.close()
    assert rows.shape[0] / dt > 1e5, f"only {rows.shape[0]/dt:.0f} rows/s"


def test_library_is_built_under_build_not_native():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert nr.LIBRARY == os.path.join(root, "build", "native",
                                      "libreak_recorder.so")
    assert nr.SOURCE == os.path.join(root, "native", "recorder.cpp")
    assert os.path.exists(nr.LIBRARY)
    assert os.path.getmtime(nr.LIBRARY) >= os.path.getmtime(nr.SOURCE)
    lib = nr.load_library()
    assert os.path.realpath(lib._name) == os.path.realpath(nr.LIBRARY)
