"""The launch shapes of the tile kernels: the whole-solve PDIP
(``csrc/pdip_whole.cu``) and the per-pass kernels (K4a–c of
``csrc/riccati_bwd.cu``), all on ``csrc/riccati_tile.cuh``.

A block takes TS neighbouring scenarios × NB matrix columns.  ``tile_config``
mirrors ``riccati_tile.cuh::Tile``: it says which instance a problem of
widths (n, m) and a type runs on, and that instance's threads a block,
scenarios a tile and dynamic shared memory.  The wrappers hand the shared
memory size to the C entry point, which refuses the launch if its own
differs, so the two cannot drift apart unnoticed.  Nothing here depends on
the horizon: the stages are streamed through two buffers.
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
    """The smallest (NMAX, MMAX) bound that holds (n, m); the per-pass
    kernels (``ops/riccati_bwd.py``) are built for the same bounds."""
    for bound in INSTANCES:
        if n <= bound[0] and m <= bound[1]:
            return bound
    raise NotImplementedError(
        f"{what} takes n <= {INSTANCES[-1][0]}, "
        f"m <= {INSTANCES[-1][1]}; got n={n}, m={m}")


@dataclass(frozen=True)
class TileConfig:
    """One instance of the tile kernels for one type."""
    bound: tuple    # the entry point's (NMAX, MMAX)
    widths: tuple   # the instance's compile-time (NB, MB)
    exact: bool     # (n, m) == (NB, MB): no predicates on the widths
    scenarios: int  # TS, scenarios a block
    threads: int    # TS × NB
    shared_bytes: int

    def padded_batch(self, B: int) -> int:
        """B rounded up to whole tiles: the scenario stride of the
        whole-solve kernel's scratch."""
        return -(-B // self.scenarios) * self.scenarios

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)


def tile_config(n: int, m: int, dtype,
                what: str = "the whole-solve kernel") -> TileConfig:
    """The instance that takes widths (n, m) in ``dtype`` and its launch
    shape (``riccati_tile.cuh::Tile``): rows of TS values for two A+B stage
    buffers, the work area (V, V·B, F, the Schur block) and the vectors,
    then Q, QN, R once.  TS gives 128 B rows up to NB = 12 and 64 B above,
    halved while the rows do not fit a block's shared memory."""
    size = {"f32": 4, "f64": 8}[type_suffix(dtype)]
    bound = instance_for(n, m, what)
    exact = (n, m) == EXACT[bound]
    nb, mb = (n, m) if exact else bound
    rows = (2 * (nb * nb + nb * mb) + (nb * nb + 2 * nb * mb + mb * mb)
            + 4 * nb + 4 * mb)
    consts = 2 * nb * nb + mb * mb
    ts = (128 if nb <= 12 else 64) // size
    while size * (rows * ts + consts) > MAX_SHARED_BYTES:
        ts //= 2
    return TileConfig(bound=bound, widths=(nb, mb), exact=exact,
                      scenarios=ts, threads=ts * nb,
                      shared_bytes=size * (rows * ts + consts))
