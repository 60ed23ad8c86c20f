"""ctypes bindings for the native C++ recorder data plane (port of
``reak_tpu/io/native_recorder.py`` on the repo's ``native/recorder.cpp``).

The reference's recorder runtime is native C++ with threaded buffering and
Boost.Asio sockets (ref: core/recorders/data_record.cpp, network_recorder.cpp
:28,128-129); this module loads the equivalent C++17 shared library,
compiling it with g++ at first use into the git-ignored
``build/native/libreak_recorder.so`` of the checkout (never into
``native/``).  The library is written under a name of its own process and
then moved into place with ``os.replace``, so two processes that build at
once never load a half-written file.  All back-ends share the wire format of
``reak_tpu_torch.io.recorder`` (JSON column header + packed float64 rows),
so native and Python recorders/extractors interoperate.

``available()`` says whether the library builds and loads here; callers
use ``reak_tpu_torch.io.recorder``'s pure-Python classes otherwise.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Sequence

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "recorder.cpp")
LIBRARY = os.path.join(_ROOT, "build", "native", "libreak_recorder.so")

_lib = None
_lib_lock = threading.Lock()


def build_library() -> str:
    """Compile ``native/recorder.cpp`` into ``LIBRARY`` (g++ -O2 -std=c++17
    -shared -fPIC -lpthread) and return its path."""
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", SOURCE, "-o",
             tmp, "-lpthread"], check=True, capture_output=True)
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIBRARY


def load_library() -> ctypes.CDLL:
    """Load the native recorder library, building it first where it is
    missing or older than its source."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(LIBRARY)
                or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
            build_library()
        lib = ctypes.CDLL(LIBRARY)
        lib.rk_rec_open.restype = ctypes.c_int64
        lib.rk_rec_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.rk_rec_write.restype = ctypes.c_int
        lib.rk_rec_write.argtypes = [ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_double),
                                     ctypes.c_int64]
        lib.rk_rec_write_batch.restype = ctypes.c_int
        lib.rk_rec_write_batch.argtypes = [ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_double),
                                           ctypes.c_int64, ctypes.c_int64]
        lib.rk_rec_flush.restype = ctypes.c_int
        lib.rk_rec_flush.argtypes = [ctypes.c_int64]
        lib.rk_rec_close.restype = ctypes.c_int
        lib.rk_rec_close.argtypes = [ctypes.c_int64]
        lib.rk_ext_open.restype = ctypes.c_int64
        lib.rk_ext_open.argtypes = [ctypes.c_char_p]
        lib.rk_ext_ncols.restype = ctypes.c_int64
        lib.rk_ext_ncols.argtypes = [ctypes.c_int64]
        lib.rk_ext_colname.restype = ctypes.c_char_p
        lib.rk_ext_colname.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.rk_ext_read.restype = ctypes.c_int
        lib.rk_ext_read.argtypes = [ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_double)]
        lib.rk_ext_close.restype = ctypes.c_int
        lib.rk_ext_close.argtypes = [ctypes.c_int64]
        lib.rk_rec_last_error.restype = ctypes.c_char_p
        lib.rk_rec_last_error.argtypes = []
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds (a g++ toolchain) and loads here."""
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRecorder:
    """Named-column row sink on the C++ background-flush thread.

    URIs: ``out.bin``, ``out.csv``, ``tcp://host:port``, ``udp://host:port``
    (the reference's ssv/bin/tcp/udp recorder family)."""

    def __init__(self, uri: str, columns: Sequence[str]):
        self._lib = load_library()
        self.columns = list(columns)
        self._h = self._lib.rk_rec_open(
            uri.encode(), ",".join(self.columns).encode())
        if self._h == 0:
            raise OSError("rk_rec_open failed: "
                          + self._lib.rk_rec_last_error().decode())
        self._n = len(self.columns)

    def record(self, row):
        if isinstance(row, dict):
            row = [row[c] for c in self.columns]
        arr = np.ascontiguousarray(row, dtype=np.float64)
        if arr.size != self._n:
            raise ValueError("row width mismatch")
        rc = self._lib.rk_rec_write(self._h, _ptr(arr), self._n)
        if rc != 0:
            raise OSError(self._lib.rk_rec_last_error().decode())

    def record_rows(self, rows):
        """Bulk enqueue: one native call for the whole (K, n) block."""
        arr = np.ascontiguousarray(rows, dtype=np.float64).reshape(-1, self._n)
        rc = self._lib.rk_rec_write_batch(self._h, _ptr(arr), arr.shape[0],
                                          self._n)
        if rc != 0:
            raise OSError(self._lib.rk_rec_last_error().decode())

    def flush(self):
        self._lib.rk_rec_flush(self._h)

    def close(self):
        if self._h:
            self._lib.rk_rec_close(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class NativeExtractor:
    """File-backed row reader (ref: data_extractor >> protocol)."""

    def __init__(self, uri: str):
        self._lib = load_library()
        self._h = self._lib.rk_ext_open(uri.encode())
        if self._h == 0:
            raise OSError("rk_ext_open failed: "
                          + self._lib.rk_rec_last_error().decode())
        n = self._lib.rk_ext_ncols(self._h)
        self.columns = [self._lib.rk_ext_colname(self._h, i).decode()
                        for i in range(n)]
        self._buf = np.zeros(n, np.float64)

    def read_row(self):
        rc = self._lib.rk_ext_read(self._h, _ptr(self._buf))
        if rc != 1:
            return None
        return self._buf.copy()

    def read_all(self):
        rows = []
        while (r := self.read_row()) is not None:
            rows.append(r)
        return np.asarray(rows)

    def close(self):
        if self._h:
            self._lib.rk_ext_close(self._h)
            self._h = 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
