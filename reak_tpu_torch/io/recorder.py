"""Row-stream recorders/extractors: named columns, buffered async sinks (a
copy of ``reak_tpu/io/recorder.py``, numpy only; the port keeps its own).

A re-design of the reference's data_recorder/data_extractor protocol
(ref: core/recorders/data_record.hpp:159 data_recorder, :334 data_extractor,
ssv_recorder.hpp, tsv_recorder.hpp, bin_recorder.hpp:47, vector_recorder.hpp,
tcp_recorder.hpp, udp_recorder.hpp, network_recorder.hpp:51 + .cpp:28,128).

This is the host-side metrics/telemetry plane of the framework: simulations,
estimators, planners, and benchmarks push named rows; sinks flush on a
background thread (the reference's threaded row-buffer, data_record.cpp).
Network back-ends speak a simple newline-JSON header + packed float rows —
the same column-name-handshake-then-binary-rows scheme as the reference.
"""
from __future__ import annotations

import json
import queue
import socket
import struct
import threading
from typing import Iterable, Optional, Sequence

import numpy as np


class Recorder:
    """Base: named-column row sink with background flushing.

    Usage mirrors the reference's stream protocol (data_record.hpp:270-296):
        rec = CsvRecorder("out.csv", ["time", "q", "qd"])
        rec.record([0.0, 0.1, 0.2])     # or rec.record({"time": …})
        rec.close()
    """

    def __init__(self, columns: Sequence[str], buffered: bool = True):
        self.columns = list(columns)
        self._buffered = buffered
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = None
        if buffered:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- subclass interface -------------------------------------------------
    def _write_header(self):
        pass

    def _write_row(self, row: np.ndarray):
        raise NotImplementedError

    def _flush(self):
        pass

    # -- public -------------------------------------------------------------
    def record(self, row):
        if self._closed:
            raise RuntimeError("recorder closed (ref: data_record end-of-record)")
        if isinstance(row, dict):
            row = [row[c] for c in self.columns]
        arr = np.asarray(row, dtype=np.float64)
        if arr.shape != (len(self.columns),):
            raise ValueError(
                f"row has {arr.shape} values, expected {len(self.columns)} "
                "(ref: data_record.hpp out_of_bounds)"
            )
        if self._buffered:
            self._q.put(arr)
        else:
            self._write_row(arr)

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            self._write_row(item)

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=10)
        self._flush()


class MemoryRecorder(Recorder):
    """In-memory rows (ref: vector_recorder.hpp) — the test fake."""

    def __init__(self, columns):
        self.rows: list = []
        super().__init__(columns, buffered=False)

    def _write_row(self, row):
        self.rows.append(row)

    def as_array(self):
        return np.stack(self.rows) if self.rows else np.zeros((0, len(self.columns)))


class CsvRecorder(Recorder):
    """Separated-values file sink (ref: ssv_recorder.hpp / tsv_recorder.hpp)."""

    def __init__(self, path, columns, sep=" ", buffered: bool = True):
        self._f = open(path, "w")
        self._sep = sep
        super().__init__(columns, buffered)
        self._f.write(sep.join(self.columns) + "\n")

    def _write_row(self, row):
        self._f.write(self._sep.join(f"{v:.17g}" for v in row) + "\n")

    def _flush(self):
        self._f.flush()
        self._f.close()


class BinaryRecorder(Recorder):
    """Packed binary rows with a JSON header line (ref: bin_recorder.hpp:47)."""

    def __init__(self, path, columns, buffered: bool = True):
        self._f = open(path, "wb")
        super().__init__(columns, buffered)
        header = json.dumps({"columns": self.columns}).encode() + b"\n"
        self._f.write(header)

    def _write_row(self, row):
        self._f.write(struct.pack(f"<{len(row)}d", *row))

    def _flush(self):
        self._f.flush()
        self._f.close()


class _SocketRecorder(Recorder):
    """Shared impl for TCP/UDP sinks: JSON column handshake, then packed rows
    (ref: tcp_recorder.hpp / udp_recorder.hpp / network_recorder.cpp:128)."""

    def _handshake_bytes(self):
        return json.dumps({"columns": self.columns}).encode() + b"\n"

    def _pack(self, row):
        return struct.pack(f"<{len(row)}d", *row)


class TcpRecorder(_SocketRecorder):
    def __init__(self, host, port, columns, buffered: bool = True):
        self._sock = socket.create_connection((host, port), timeout=10)
        super().__init__(columns, buffered)
        self._sock.sendall(self._handshake_bytes())

    def _write_row(self, row):
        self._sock.sendall(self._pack(row))

    def _flush(self):
        self._sock.close()


class UdpRecorder(_SocketRecorder):
    """Datagram rows; header sent once per construction (ref: udp_recorder.hpp;
    raw-UDP = header-less, set ``raw=True`` — raw_udp_recorder.hpp)."""

    def __init__(self, host, port, columns, raw: bool = False, buffered: bool = True):
        self._addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        super().__init__(columns, buffered)
        if not raw:
            self._sock.sendto(self._handshake_bytes(), self._addr)

    def _write_row(self, row):
        self._sock.sendto(self._pack(row), self._addr)

    def _flush(self):
        self._sock.close()


class NetworkServer:
    """Accepting side of the TCP row stream — the data_extractor over the
    network (ref: network_recorder.hpp:51 negotiated server).

    ``accept()`` blocks for one client, reads the column handshake, then
    ``read_row()`` yields rows.
    """

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._conn = None
        self.columns = None

    def accept(self, timeout=10.0):
        self._srv.settimeout(timeout)
        self._conn, _ = self._srv.accept()
        buf = b""
        while b"\n" not in buf:
            buf += self._conn.recv(1024)
        header, _, rest = buf.partition(b"\n")
        self.columns = json.loads(header)["columns"]
        self._rest = rest
        return self.columns

    def read_row(self):
        n = len(self.columns) * 8
        buf = self._rest
        while len(buf) < n:
            chunk = self._conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        self._rest = buf[n:]
        return np.frombuffer(buf[:n], dtype="<f8").copy()

    def close(self):
        if self._conn:
            self._conn.close()
        self._srv.close()


# ---------------------------------------------------------------------------
# extractors (file readers) + factory
# ---------------------------------------------------------------------------


def open_recorder(uri: str, columns) -> Recorder:
    """Factory from a URI-ish spec (ref: data_record_options.hpp):
    'mem:', 'file.csv'/'file.ssv', 'file.bin', 'tcp://host:port',
    'udp://host:port'."""
    if uri == "mem:":
        return MemoryRecorder(columns)
    if uri.startswith("tcp://"):
        host, port = uri[6:].split(":")
        return TcpRecorder(host, int(port), columns)
    if uri.startswith("udp://"):
        host, port = uri[6:].split(":")
        return UdpRecorder(host, int(port), columns)
    if uri.endswith(".bin"):
        return BinaryRecorder(uri, columns)
    sep = "\t" if uri.endswith(".tsv") else " "
    return CsvRecorder(uri, columns, sep=sep)


def open_extractor(uri: str):
    """Read back (columns, rows array) from a recorded file
    (ref: data_extractor back-ends, data_record.hpp:334)."""
    if uri.endswith(".bin"):
        with open(uri, "rb") as f:
            header = json.loads(f.readline())
            cols = header["columns"]
            data = np.frombuffer(f.read(), dtype="<f8")
        return cols, data.reshape(-1, len(cols))
    with open(uri) as f:
        sep = "\t" if uri.endswith(".tsv") else None
        cols = f.readline().split(sep)
        cols = [c.strip() for c in cols if c.strip()]
        rows = np.loadtxt(f, ndmin=2)
    return cols, rows
