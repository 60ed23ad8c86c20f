"""Batched Cholesky factor and solve of tiny SPD systems — the Hopper port of
the Pallas kernels ``reak_tpu/ops/chol_lanes.py::solve_lanes`` (K3a) and
``::solve_lanes_multi`` (K3b), both in ``csrc/chol_lanes.cu``.

- ``solve_lanes(G (n, n, B), rhs (n, B)) → x (n, B)``, one right-hand side;
- ``solve_lanes_multi(G (n, n, B), rhs (n, k, B)) → x (n, k, B)``, k
  right-hand sides and one factorization;
- ``solve(G (B, n, n), rhs (B, n)) → x (B, n)``, the standard layout over
  ``solve_lanes``;
- ``chol_solve_auto(G (..., n, n), rhs (..., n, k) | (..., n))``, the
  batch-first dispatch of the Riccati PDIP (``ctrl/riccati.py``): on CUDA
  tensors the batch flattened into B (an unbatched call is B = 1), moved to
  the lanes layout once and solved by K3a (k = 1) or K3b; on CPU tensors
  ``math/linalg.small_chol_solve``, as the JAX function off the TPU.  It is
  the port of ``reak_tpu/ops/chol_lanes.py::chol_solve_auto``, whose vmap
  rule finds the batch; here the batch axes are explicit, since
  ``torch.func.vmap`` cannot see through a kernel launch.

On CUDA tensors each wrapper launches the kernel (any n ≥ 1, any B); on CPU
tensors it takes the plain version, ``ctrl/riccati_soa._chol_solve_lanes``
(the same recurrence as tensor ops, whose result the kernel gives bit for
bit: it rounds each product before subtracting it, as the plain version
does).  The plain version itself never dispatches, so the plain paths that
call it stay plain on the card.  Inputs
are made contiguous before a launch (the right-hand sides are often built
from expanded views); that copy is a layout step, not a fallback, and
contiguous inputs are not copied.  Where one scenario's packed factor does
not fit a block's shared memory (n > 240 in f64, n > 340 in f32) the
wrapper hands the kernel a workspace in device memory.
"""
from __future__ import annotations

import ctypes

import torch

from reak_tpu_torch.ctrl.riccati_soa import _chol_solve_lanes as solve_plain
from reak_tpu_torch.ops import _build

# csrc/chol_lanes.cu's kSmemMax: a block's shared memory on the H100
SMEM_MAX = 232448

# launches of each kernel entry since the counts were last set to 0
launches = {"solve_lanes": 0, "solve_lanes_multi": 0}
_build.count_launches(__name__)

_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# G, rhs, x, workspace, workspace values, n, k, B, stream; K3a is k = 1
SIGNATURES = {f"reak_chol_solve_{s}": [_VP, _VP, _VP, _VP, _LL, _CI, _CI,
                                       _CI, _VP] for s in ("f32", "f64")}
_ENTRY = {torch.float32: "reak_chol_solve_f32",
          torch.float64: "reak_chol_solve_f64"}


def workspace_values(n: int, B: int, itemsize: int) -> int:
    """Values of the device-memory work area that the kernel needs at
    width n (0 where a scenario's packed triangle, padded to an odd length,
    fits a block's shared memory): that length for each of B scenarios
    rounded up to 32, as ``csrc/chol_lanes.cu::launch`` checks."""
    stride = (n * (n + 1) // 2) | 1
    return 0 if stride * itemsize <= SMEM_MAX else -(-B // 32) * 32 * stride


def _checked(G, rhs, rhs_shape):
    """Contiguous G and rhs after checking shape, type and device."""
    n, B = G.shape[0], G.shape[-1]
    if G.shape != (n, n, B) or n < 1 or B < 1:
        raise ValueError(f"G has shape {tuple(G.shape)}: expected (n, n, B)")
    if tuple(rhs.shape) != rhs_shape(n, B):
        raise ValueError(f"rhs has shape {tuple(rhs.shape)}: expected "
                         f"{rhs_shape(n, B)}")
    if G.dtype not in (torch.float32, torch.float64) or rhs.dtype != G.dtype:
        raise TypeError(f"G {G.dtype}, rhs {rhs.dtype}: expected float32 or "
                        "float64, the same for both")
    if not (G.is_cuda and rhs.device == G.device):
        raise ValueError(f"G on {G.device}, rhs on {rhs.device}: expected "
                         "both on one CUDA device")
    return G.contiguous(), rhs.contiguous()


def _launch(entry, G, rhs, n, k, B):
    launch = _build.function("chol_lanes", _ENTRY[G.dtype], SIGNATURES)
    x = torch.empty_like(rhs)
    ws_values = workspace_values(n, B, G.element_size())
    ws = (torch.empty(ws_values, dtype=G.dtype, device=G.device)
          if ws_values else None)
    p = _build.ptr
    rc = launch(p(G), p(rhs), p(x), None if ws is None else p(ws), ws_values,
                n, k, B, _build.stream_ptr(G.device))
    _build.check("chol_lanes", rc, f"chol_lanes {entry} kernel")
    launches[entry] += 1
    return x


def solve_lanes(G, rhs):
    """K3a: G (n, n, B) SPD per scenario, rhs (n, B) → x (n, B)."""
    if G.device.type == "cpu" and rhs.device.type == "cpu":
        return solve_plain(G, rhs[:, None])[:, 0]
    G, rhs = _checked(G, rhs, lambda n, B: (n, B))
    n, B = rhs.shape
    return _launch("solve_lanes", G, rhs, n, 1, B)


def solve_lanes_multi(G, rhs):
    """K3b: G (n, n, B) SPD per scenario, rhs (n, k, B) → x (n, k, B)."""
    if G.device.type == "cpu" and rhs.device.type == "cpu":
        return solve_plain(G, rhs)
    k = rhs.shape[1] if rhs.ndim == 3 else -1
    G, rhs = _checked(G, rhs, lambda n, B: (n, k, B))
    n, k, B = rhs.shape
    return _launch("solve_lanes_multi", G, rhs, n, k, B)


def solve(G, rhs):
    """Batched SPD solve, standard layout: G (B, n, n), rhs (B, n) → (B, n),
    through ``solve_lanes``."""
    return solve_lanes(G.permute(1, 2, 0), rhs.T).T


def chol_solve_auto(G, rhs):
    """SPD solve G x = rhs, batch first: G (..., n, n), rhs (..., n, k) or
    (..., n) (a vector when it has one axis fewer than G); the leading axes
    broadcast.  CUDA tensors: K3a for one right-hand side, K3b for several,
    on the batch moved to the lanes layout (one copy of G and one of rhs).
    CPU tensors: ``math/linalg.small_chol_solve``."""
    if G.device.type == "cpu" and rhs.device.type == "cpu":
        from reak_tpu_torch.math.linalg import small_chol_solve

        return small_chol_solve(G, rhs)
    n = G.shape[-1]
    vec = rhs.ndim == G.ndim - 1
    if vec:
        rhs = rhs[..., None]
    k = rhs.shape[-1]
    batch = torch.broadcast_shapes(G.shape[:-2], rhs.shape[:-2])
    B = 1
    for d in batch:
        B *= d
    Gl = G.expand(*batch, n, n).reshape(B, n, n).permute(1, 2, 0)
    rl = rhs.expand(*batch, n, k).reshape(B, n, k).permute(1, 2, 0)
    if k == 1:
        x = solve_lanes(Gl, rl[:, 0])[:, None]
    else:
        x = solve_lanes_multi(Gl, rl)
    x = x.permute(2, 0, 1).reshape(*batch, n, k)
    return x[..., 0] if vec else x
