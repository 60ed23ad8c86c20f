"""The per-pass PDIP kernels: each of the three horizon passes of one
Mehrotra iteration in one launch — the Hopper port of the Pallas kernels
``reak_tpu/ops/riccati_bwd_pallas.py::make_fused_backward`` (K4a),
``::make_vector_backward`` (K4b) and ``::make_forward`` (K4c), all three in
``csrc/riccati_bwd.cu``.

- ``fused_backward(A (H,n,n,B), Bm (H,n,m,B), q (H,n,B), u_eff (H,m,B),
  D (H,m,B), Q (n,n), QN (n,n), R (m,m)) → (grad (H,m,B), K (H,m,n,B),
  G (H,m,m,B), k (H,m,B))``: the cost-gradient adjoint, the Riccati matrix
  recursion and the affine vector recursion in one reverse pass;
- ``vector_backward(A, Bm, rhs (H,m,B), K, G) → k (H,m,B)``: the corrector's
  vector reverse pass, factoring each G again;
- ``forward(A, Bm, K, k, dx0 (n,B)) → (du (H,m,B), dx (H,n,B))``: the
  closed-loop forward pass.

The inputs are never written.

On CUDA tensors each wrapper launches its kernel; on CPU tensors it takes
its plain version in ``ctrl/riccati_soa`` (``fused_backward_plain``,
``vector_backward_plain``, ``forward_plain``), the passes of the plain scan.
The entry points are named by the whole-solve kernel's (NMAX, MMAX) bounds,
(16, 8), (24, 12) and (32, 16); the wrappers take the smallest that holds
(n, m), and past the widest the runtime-width instance of the type
(``reak_riccati_<pass>_any_<type>``, ``csrc/riccati_tile.cuh``'s runtime
policy), with
the device-memory work area that ``tile_config`` sizes.
Inputs are made contiguous before a launch (a layout step, not a
fallback); any B ≥ 1 is taken.

By the card's peaks each pass is bound by bytes (a stage reads A and B once:
0.8–0.9 ms a pass at H=256, B=8192 in f32); what a kernel reaches depends on
how it hides the latency along the chain of stages.  All three run on the
tile of ``csrc/riccati_tile.cuh`` (a tile of scenarios per block, a warp per
matrix column, widths at compile time, the next stage copied into shared
memory while this one computes), with the launch shape of
``ops/_tile.tile_config``: (12, 6), (24, 12) and (32, 16) on instances of
their own, other widths on padded ones; K4b factors each stage's G in
shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from reak_tpu_torch.ctrl.riccati_soa import (forward_plain,
                                             fused_backward_plain,
                                             vector_backward_plain)
from reak_tpu_torch.ops import _build
from reak_tpu_torch.ops._tile import INSTANCES, tile_config, type_suffix

# launches of each kernel entry since the counts were last set to 0
launches = {"fused_backward": 0, "vector_backward": 0, "forward": 0}
_build.count_launches(__name__)

_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = {
    # A, Bm, q, u_eff, D, Q, QN, R, grad, K, G, k, H, n, m, B, shared
    # bytes, stream
    "fused_backward": [_VP] * 12 + [_CI] * 5 + [_VP],
    # A, Bm, rhs, K, G, k, H, n, m, B, shared bytes, stream
    "vector_backward": [_VP] * 6 + [_CI] * 5 + [_VP],
    # A, Bm, K, k, dx0, du, dx, H, n, m, B, shared bytes, stream
    "forward": [_VP] * 7 + [_CI] * 5 + [_VP],
}
# the runtime-width instance: after B, TS, the grid, the work area and its
# values
_ANY_ARGS = {e: args[:-2] + [_CI, _CI, _VP, _LL] + args[-2:]
             for e, args in _ARGS.items()}


def entry_point(entry: str, bound, dtype) -> str:
    """The C function of one pass, bound and type (``bound=None``: the
    runtime-width instance)."""
    tag = "any" if bound is None else f"{bound[0]}x{bound[1]}"
    return f"reak_riccati_{entry}_{tag}_{type_suffix(dtype)}"


def library(bound, dtype) -> str:
    """The library that holds the three passes of one bound and type: the
    source is built once per bound and type, and once per type at run-time
    widths (``_build.instance_library``)."""
    return _build.instance_library("riccati_bwd", bound, type_suffix(dtype))


# {library: {function: argtypes}}, for a build of everything at once
LIBRARIES = {library(b, d): {entry_point(e, b, d): args for e, args in
                             (_ARGS if b is not None else _ANY_ARGS).items()}
             for b in (*INSTANCES, None)
             for d in (torch.float32, torch.float64)}
SIGNATURES = {fn: args for lib in LIBRARIES.values()
              for fn, args in lib.items()}


def _launch(entry, named, outs, H, n, m):
    """Check ``named`` ({name: (tensor, shape)}) against the first tensor's
    CUDA device and type, launch ``entry`` on them and ``outs``."""
    first = next(iter(named.values()))[0]
    device, dtype = first.device, first.dtype
    if not first.is_cuda:
        raise ValueError(f"inputs on {device}: expected CUDA tensors")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"inputs are {dtype}: expected float32 or float64")
    ins = []
    for name, (t, shape) in named.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}: expected "
                             f"{dtype} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}: expected "
                             f"{shape}")
        ins.append(t.contiguous())
    tile = tile_config(n, m, dtype, what="the per-pass kernels")
    B = first.shape[-1]
    name = library(tile.bound, dtype)
    launch = _build.function(name, entry_point(entry, tile.bound, dtype),
                             LIBRARIES[name])
    ptrs = [_build.ptr(t) for t in ins + list(outs)]
    if tile.runtime:
        work = torch.empty(tile.work_values(B), dtype=dtype, device=device)
        rc = launch(*ptrs, H, n, m, B, tile.scenarios, tile.blocks(B),
                    _build.ptr(work), work.numel(), tile.shared_bytes,
                    _build.stream_ptr(device))
    else:
        rc = launch(*ptrs, H, n, m, B, tile.shared_bytes,
                    _build.stream_ptr(device))
    _build.check(name, rc, f"riccati_bwd {entry} kernel")
    launches[entry] += 1


def _empty(like, *shape):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def fused_backward(A, Bm, q, u_eff, D, Q, QN, R):
    """K4a: one reverse pass → (grad, K, G, k) (see module)."""
    if A.device.type == "cpu":
        return fused_backward_plain(A, Bm, q, u_eff, D, Q, QN, R)
    H, n, B = A.shape[0], A.shape[1], A.shape[-1]
    m = Bm.shape[2]
    outs = (_empty(A, H, m, B), _empty(A, H, m, n, B), _empty(A, H, m, m, B),
            _empty(A, H, m, B))
    _launch("fused_backward",
            {"A": (A, (H, n, n, B)), "Bm": (Bm, (H, n, m, B)),
             "q": (q, (H, n, B)), "u_eff": (u_eff, (H, m, B)),
             "D": (D, (H, m, B)), "Q": (Q, (n, n)), "QN": (QN, (n, n)),
             "R": (R, (m, m))}, outs, H, n, m)
    return outs


def vector_backward(A, Bm, rhs, K, G):
    """K4b: the corrector's vector reverse pass → k (see module)."""
    if A.device.type == "cpu":
        return vector_backward_plain(A, Bm, rhs, K, G)
    H, n, B = A.shape[0], A.shape[1], A.shape[-1]
    m = Bm.shape[2]
    k = _empty(A, H, m, B)
    _launch("vector_backward",
            {"A": (A, (H, n, n, B)), "Bm": (Bm, (H, n, m, B)),
             "rhs": (rhs, (H, m, B)), "K": (K, (H, m, n, B)),
             "G": (G, (H, m, m, B))}, (k,), H, n, m)
    return k


def forward(A, Bm, K, k, dx0):
    """K4c: the closed-loop forward pass → (du, dx) (see module)."""
    if A.device.type == "cpu":
        return forward_plain(A, Bm, K, k, dx0)
    H, n, B = A.shape[0], A.shape[1], A.shape[-1]
    m = Bm.shape[2]
    outs = (_empty(A, H, m, B), _empty(A, H, n, B))
    _launch("forward",
            {"A": (A, (H, n, n, B)), "Bm": (Bm, (H, n, m, B)),
             "K": (K, (H, m, n, B)), "k": (k, (H, m, B)),
             "dx0": (dx0, (n, B))}, outs, H, n, m)
    return outs
