"""The launch shapes of the tile kernels: the whole-solve PDIP
(``csrc/pdip_whole.cu``) and the per-pass kernels (K4a–c of
``csrc/riccati_bwd.cu``), all on ``csrc/riccati_tile.cuh``.

A block takes TS neighbouring scenarios × NB matrix columns.  ``tile_config``
mirrors ``riccati_tile.cuh::Tile`` and, past the widest bound,
``riccati_tile.cuh::any_tile``: it says which instance a problem of
widths (n, m) and a type runs on, and that instance's threads a block,
scenarios a tile and dynamic shared memory, and for the runtime-width
instance where its rows lie (shared or device memory), its grid and its
device-memory work area.  The wrappers hand these to the C entry point,
which refuses the launch if its own differ, so the two cannot drift apart
unnoticed.  Nothing here depends on the horizon: the stages are streamed
through two buffers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# the (NMAX, MMAX) bounds the C entry points are named by, smallest first
INSTANCES = ((16, 8), (24, 12), (32, 16))
# the widths each bound's entry point runs at compile-time widths of their
# own (riccati_tile.cuh::ExactWidths: the fixed-base arms and the
# satellite; the floating arm's tangent; a 16-segment beam); every other
# (n, m) within the bound runs its padded instance
EXACT = {(16, 8): (12, 6), (24, 12): (24, 12), (32, 16): (32, 16)}
# an H100 block: dynamic shared memory and threads
MAX_SHARED_BYTES = 232448
MAX_THREADS = 1024


def type_suffix(dtype) -> str:
    """``f32`` or ``f64``, as the C entry points and libraries are named."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{dtype}: expected float32 or float64")
    return "f32" if dtype == torch.float32 else "f64"


def instance_for(n: int, m: int, what: str = "the whole-solve kernel"):
    """The smallest (NMAX, MMAX) bound that holds (n, m), or None past the
    widest: the runtime-width instance.  The per-pass kernels
    (``ops/riccati_bwd.py``) are built for the same bounds."""
    if n < 1 or m < 1:
        raise ValueError(f"{what} takes n, m >= 1; got n={n}, m={m}")
    for bound in INSTANCES:
        if n <= bound[0] and m <= bound[1]:
            return bound
    return None


# riccati_tile.cuh: blocks of a runtime-width launch and threads a block,
# at most
ANY_GRID = 264
ANY_THREADS = 1024


@dataclass(frozen=True)
class TileConfig:
    """One instance of the tile kernels for one type."""
    bound: tuple    # the entry point's (NMAX, MMAX); None: runtime widths
    widths: tuple   # the instance's (NB, MB)
    exact: bool     # (n, m) == (NB, MB): no predicates on the widths
    scenarios: int  # TS, scenarios a block
    threads: int    # TS × the column threads a scenario
    shared_bytes: int
    branch: str = "shared"  # where the block's rows lie: shared or device
    block_values: int = 0   # the device-memory work area of a block

    @property
    def runtime(self) -> bool:
        return self.bound is None

    def padded_batch(self, B: int) -> int:
        """B rounded up to whole tiles: the scenario stride of the
        whole-solve kernel's scratch."""
        return -(-B // self.scenarios) * self.scenarios

    def blocks(self, B: int) -> int:
        tiles = -(-B // self.scenarios)
        return min(tiles, ANY_GRID) if self.runtime else tiles

    def work_values(self, B: int) -> int:
        """Values of the device-memory work area a launch over B scenarios
        takes (0 on a compile-time instance)."""
        return self.blocks(B) * self.block_values


def _rows(nb: int, mb: int):
    """Rows of TS values (two A+B stage buffers, the work area, the
    vectors) and the constants (Q, QN, R) of a block."""
    rows = (2 * (nb * nb + nb * mb) + (nb * nb + 2 * nb * mb + mb * mb)
            + 4 * nb + 4 * mb)
    return rows, 2 * nb * nb + mb * mb


def tile_config(n: int, m: int, dtype,
                what: str = "the whole-solve kernel") -> TileConfig:
    """The instance that takes widths (n, m) in ``dtype`` and its launch
    shape (``riccati_tile.cuh::Tile``): rows of TS values for two A+B stage
    buffers, the work area (V, V·B, F, the Schur block) and the vectors,
    then Q, QN, R once.  TS gives 128 B rows up to NB = 12 and 64 B above,
    halved while the rows do not fit a block's shared memory.  Past the
    widest bound, the runtime-width instance (``any_tile``): NB = max(n, m)
    columns, MB = m, TS halved while TS × NB passes 1,024 threads and then
    while the rows do not fit (down to 1); where they do not fit even at 1
    they lie in device memory at the TS the threads allow.  A thread takes
    every ``threads / TS``-th column, and each column keeps 2 NB + 6 MB + 8
    rows of its own in the device-memory work area, in float64 for float32
    data (its sums' type); a block's area is rounded up to 16 B."""
    size = {"f32": 4, "f64": 8}[type_suffix(dtype)]
    bound = instance_for(n, m, what)
    if bound is None:
        nb, mb = max(n, m), m
        rows, consts = _rows(nb, mb)
        ts = (128 if nb <= 12 else 64) // size
        while ts > 1 and ts * nb > ANY_THREADS:
            ts //= 2
        fit = ts
        while fit > 1 and size * (rows * fit + consts) > MAX_SHARED_BYTES:
            fit //= 2
        shared = size * (rows * fit + consts) <= MAX_SHARED_BYTES
        ts = fit if shared else ts
        nc = min(nb, ANY_THREADS // ts)
        # the columns' rows in the accumulator's type (float64 for float32)
        cols = (2 * nb + 6 * mb + 8) * nb * ts * (2 if size == 4 else 1)
        per_16 = 16 // size
        return TileConfig(
            bound=None, widths=(nb, mb), exact=False, scenarios=ts,
            threads=ts * nc,
            shared_bytes=size * (rows * ts + consts) if shared else 0,
            branch="shared" if shared else "device",
            block_values=-(-(cols + (0 if shared else rows * ts + consts))
                           // per_16) * per_16)
    exact = (n, m) == EXACT[bound]
    nb, mb = (n, m) if exact else bound
    rows, consts = _rows(nb, mb)
    ts = (128 if nb <= 12 else 64) // size
    while size * (rows * ts + consts) > MAX_SHARED_BYTES:
        ts //= 2
    return TileConfig(bound=bound, widths=(nb, mb), exact=exact,
                      scenarios=ts, threads=ts * nb,
                      shared_bytes=size * (rows * ts + consts))
