"""The launch shapes of the tile kernels: the whole-solve PDIP
(``csrc/pdip_whole.cu``) and the per-pass kernels (K4a–c of
``csrc/riccati_bwd.cu``).  ``pipe_config`` mirrors the whole-solve
kernel's TMA pipeline on the compile-time widths (``pdip_whole.cu::Pipe``);
``tile_config`` the tile of ``csrc/riccati_tile.cuh``, which the per-pass
kernels run at every width and the whole-solve kernel past (32, 16);
``k2_config`` picks the whole-solve kernel's.

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


# pdip_whole.cu::Pipe: stage slots in the ring, bytes of the mbarriers at
# the head of shared memory, the SM's registers and shared memory
RING = 3
BAR_BYTES = 1024
SM_REGISTERS = 65536
SM_SHARED_BYTES = 233472


@dataclass(frozen=True)
class PipeConfig:
    """One compile-time instance of the whole-solve kernel's TMA pipeline
    for one type (``pdip_whole.cu::Pipe``)."""
    bound: tuple     # the entry point's (NMAX, MMAX)
    widths: tuple    # the instance's (NB, MB)
    exact: bool
    scenarios: int   # TS
    consumers: int   # TS × NB threads
    threads: int     # the consumers and the producer (a warp, or a
                     # warpgroup where setmaxnreg moves its registers)
    shared_bytes: int
    realloc: bool    # setmaxnreg moves the producer's registers
    size: int        # bytes a value
    ring: int = RING
    runtime: bool = False

    def padded_batch(self, B: int) -> int:
        """B rounded up to whole tiles: the scenario stride of the
        scratch."""
        return -(-B // self.scenarios) * self.scenarios

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)

    @property
    def batch_quantum(self) -> int:
        """The scenarios of 16 B: TMA takes a scenario-last array only where
        its row of B values is a whole number of 16 B."""
        return 16 // self.size

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by shared memory (the SM's 228 KB, 1 KB of it
        a block's reserve)."""
        return SM_SHARED_BYTES // (self.shared_bytes + 1024)


def _pipe_rows(nb: int, mb: int):
    """Rows of TS values of the pipeline's regions: the work area, the
    block's vectors and one ring slot; and the constants Q, QN, R."""
    slot = nb * nb + 2 * nb * mb + mb * mb + 3 * nb + 8 * mb
    work = nb * nb + 2 * nb * mb + mb * mb
    return work, 5 * nb + 2 * mb, slot, 2 * nb * nb + mb * mb


def pipe_config(n: int, m: int, dtype, ring: int = RING,
                row_bytes: int = 128) -> PipeConfig:
    """The pipeline instance of widths (n, m) within (32, 16) in ``dtype``
    (``pdip_whole.cu::Pipe``): TS from 128 B rows up to NB = 12 and 64 B
    above, halved while the mbarriers, Q, QN, R (rounded to 128 B), the
    work area, the vectors and RING slots do not fit a block; TS × NB
    consumers and one producer warp, or, where the consumers are whole
    warpgroups and they and a warp at 255 registers would not fit the SM,
    a producer warpgroup whose registers setmaxnreg gives the consumers
    (each warpgroup enters with an equal share of the SM's registers).
    ``ring`` other than ``RING`` and ``row_bytes`` (up to NB = 12) other
    than 128 are for ``ops/tile_shapes.py``'s patched copies."""
    size = {"f32": 4, "f64": 8}[type_suffix(dtype)]
    bound = instance_for(n, m)
    if bound is None:
        raise ValueError(f"({n}, {m}) is past the widest compile-time "
                         f"instance {INSTANCES[-1]}")
    exact = (n, m) == EXACT[bound]
    nb, mb = (n, m) if exact else bound
    work, vec, slot, consts = _pipe_rows(nb, mb)
    const_bytes = -(-consts * size // 128) * 128
    rows = work + vec + ring * slot
    ts = (row_bytes if nb <= 12 else 64) // size
    while BAR_BYTES + const_bytes + rows * ts * size > MAX_SHARED_BYTES:
        ts //= 2
    consumers = ts * nb
    realloc = (consumers % 128 == 0
               and (consumers + 32) * 255 > SM_REGISTERS)
    return PipeConfig(bound=bound, widths=(nb, mb), exact=exact,
                      scenarios=ts, consumers=consumers,
                      threads=consumers + (128 if realloc else 32),
                      shared_bytes=BAR_BYTES + const_bytes + rows * ts * size,
                      realloc=realloc, size=size, ring=ring)


def k2_config(n: int, m: int, dtype):
    """The whole-solve kernel's launch shape: the pipeline within
    (32, 16), the runtime-width tile past it."""
    if instance_for(n, m) is None:
        return tile_config(n, m, dtype)
    return pipe_config(n, m, dtype)
