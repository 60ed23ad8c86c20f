"""Batched Cholesky factor and solve of tiny SPD systems — the Hopper port of
the Pallas kernels ``reak_tpu/ops/chol_lanes.py::solve_lanes`` (K3a) and
``::solve_lanes_multi`` (K3b), both in ``csrc/chol_lanes.cu``.

- ``solve_lanes(G (n, n, B), rhs (n, B)) → x (n, B)``, one right-hand side;
- ``solve_lanes_multi(G (n, n, B), rhs (n, k, B)) → x (n, k, B)``, k
  right-hand sides and one factorization;
- ``solve(G (B, n, n), rhs (B, n)) → x (B, n)``, the standard layout over
  ``solve_lanes``.

On CUDA tensors each wrapper launches the kernel (n ≤ 32, any B); on CPU
tensors it takes the plain version, ``ctrl/riccati_soa._chol_solve_lanes``
(the same recurrence as tensor ops).  The plain version itself never
dispatches, so the plain paths that call it stay plain on the card.  Inputs
are made contiguous before a launch (the right-hand sides are often built
from expanded views); that copy is a layout step, not a fallback.
"""
from __future__ import annotations

import ctypes

import torch

from reak_tpu_torch.ctrl.riccati_soa import _chol_solve_lanes as solve_plain
from reak_tpu_torch.ops import _build

MAX_N = 32  # csrc/chol_lanes.cu template range

# launches of each kernel entry since the counts were last set to 0
launches = {"solve_lanes": 0, "solve_lanes_multi": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # G, rhs, x, n, B, stream
    "reak_chol_solve_lanes_f32": [_VP, _VP, _VP, _CI, _CI, _VP],
    "reak_chol_solve_lanes_f64": [_VP, _VP, _VP, _CI, _CI, _VP],
    # G, rhs, x, n, k, B, stream
    "reak_chol_solve_lanes_multi_f32": [_VP, _VP, _VP, _CI, _CI, _CI, _VP],
    "reak_chol_solve_lanes_multi_f64": [_VP, _VP, _VP, _CI, _CI, _CI, _VP],
}


def _checked(G, rhs, rhs_shape):
    """Contiguous G and rhs after checking shape, device and type."""
    n, B = G.shape[0], G.shape[-1]
    if G.shape != (n, n, B) or B < 1:
        raise ValueError(f"G has shape {tuple(G.shape)}: expected (n, n, B)")
    if n > MAX_N:
        raise ValueError(f"the Cholesky kernel takes n <= {MAX_N}, got {n}")
    if tuple(rhs.shape) != rhs_shape(n, B):
        raise ValueError(f"rhs has shape {tuple(rhs.shape)}: expected "
                         f"{rhs_shape(n, B)}")
    if not (G.is_cuda and rhs.device == G.device):
        raise ValueError(f"G on {G.device}, rhs on {rhs.device}: expected "
                         "both on one CUDA device")
    if G.dtype not in (torch.float32, torch.float64) or rhs.dtype != G.dtype:
        raise TypeError(f"G {G.dtype}, rhs {rhs.dtype}: expected float32 or "
                        "float64, the same for both")
    return G.contiguous(), rhs.contiguous()


def _launch(entry, G, rhs, *dims):
    lib = _build.load("chol_lanes", SIGNATURES)
    suffix = "f32" if G.dtype == torch.float32 else "f64"
    x = torch.empty_like(rhs)
    p = _build.ptr
    rc = getattr(lib, f"reak_chol_{entry}_{suffix}")(
        p(G), p(rhs), p(x), *dims, _build.stream_ptr(G.device))
    _build.check(lib, rc, f"chol_lanes {entry} kernel")
    launches[entry] += 1
    return x


def solve_lanes(G, rhs):
    """K3a: G (n, n, B) SPD per scenario, rhs (n, B) → x (n, B)."""
    if G.device.type == "cpu" and rhs.device.type == "cpu":
        return solve_plain(G, rhs[:, None])[:, 0]
    G, rhs = _checked(G, rhs, lambda n, B: (n, B))
    n, B = rhs.shape
    return _launch("solve_lanes", G, rhs, n, B)


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
