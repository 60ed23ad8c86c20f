"""The whole-solve PDIP kernel: every Mehrotra iteration of the box-
constrained LTV-MPC QP in one launch — the Hopper port of the Pallas kernel
``reak_tpu/ops/pdip_whole_pallas.py::make_whole_pdip``.

``make_whole_pdip(H, n, m, iters, with_xref, with_uref)`` returns
``fn(A (H,n,n,B), Bm (H,n,m,B), c (H,n,B), [x_ref (H,n,B|1)],
[u_ref (H,m,B|1)], x0 (n,B), Q (n,n), QN (n,n), R (m,m), lb (m,), ub (m,))
→ (u (H,m,B), xs (H,n,B))``.  On CUDA tensors it launches
``csrc/pdip_whole.cu``; on CPU tensors it takes the plain version,
``solve_plain`` (the scan path of ``ctrl/riccati_soa``).

What bounds it on the H100 is the traffic of its own design: each of the
eight iterations streams A and B four times with the gains, the factors and
the iterate through a device-memory scratch (``chip_smoke.k2_design_bytes``),
because the TPU kernel's residency of the whole horizon in on-chip memory
does not fit an SM.  So the kernel has no horizon cap, and it goes after
latency instead: a tile of scenarios per block, a warp per matrix column,
widths at compile time.  On those widths a producer warp streams every stage
(A, B, the gains, the factor and the iterate's slacks and duals) by TMA into
a ring of three shared-memory slots ahead of their use, and the
interior-point sweeps are folded into the passes (``csrc/pdip_whole.cu``).
The launch shape and the scratch size come from ``ops/_tile.k2_config``:
the widths (12, 6), (24, 12) and (32, 16) run instances of their own, every
other width within (32, 16) a padded one (``pipe_config``), and every wider
(n, m) the runtime-width instance (the passes of ``csrc/riccati_tile.cuh``
on its runtime policy, ``tile_config``: the widths as arguments, the
columns' values and, where a scenario's rows do not fit a block's shared
memory, the rows too in a device-memory work area that the wrapper
allocates).  Any B ≥ 1 is taken: TMA describes a scenario-last array only
where its row of B values is a whole number of 16 B from a 16 B aligned
base, so the wrapper copies a batch that is not into one padded with zero
scenarios (B = 77 in f32 runs as 80) and hands back the first B.
"""
from __future__ import annotations

import ctypes

import torch

from reak_tpu_torch.ctrl.riccati_soa import _fused_scan as solve_plain
from reak_tpu_torch.ops import _build
from reak_tpu_torch.ops._tile import (INSTANCES, instance_for, k2_config,
                                      type_suffix)

# launches of the kernel since the count was last set to 0
launches = 0
_build.count_launches(__name__)


def scratch_values(H: int, n: int, m: int) -> int:
    """Scratch values per scenario: K (H,m,n), packed factors (H,m,m),
    u, sl, su, zl, zu, w1, w2 (H,m), xs, dxs (H,n)."""
    return H * (m * n + m * m + 7 * m + 2 * n)


# A, Bm, c, x_ref, u_ref, x0, Q, QN, R, lb, ub, u, xs, scratch (pointers),
# the scratch's values, H, n, m, B, iters, shared bytes, stream
_ARGS = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 6
         + [ctypes.c_void_p])
# the runtime-width instance: after the scratch's values, the work area and
# its values; after iters, TS and the grid
_ANY_ARGS = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong, ctypes.c_void_p,
                                       ctypes.c_longlong]
             + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def entry_point(bound, dtype) -> str:
    """The C function of one bound and type (``bound=None``: the
    runtime-width instance)."""
    tag = "any" if bound is None else f"{bound[0]}x{bound[1]}"
    return f"reak_pdip_whole_{tag}_{type_suffix(dtype)}"


def library(bound, dtype) -> str:
    """The library that holds ``entry_point(bound, dtype)``: the source is
    built once per bound and type, and once per type at run-time widths
    (``_build.instance_library``)."""
    return _build.instance_library("pdip_whole", bound, type_suffix(dtype))


# {library: {function: argtypes}}, for a build of everything at once
LIBRARIES = {library(b, d): {entry_point(b, d):
                             _ARGS if b is not None else _ANY_ARGS}
             for b in (*INSTANCES, None)
             for d in (torch.float32, torch.float64)}
SIGNATURES = {fn: args for lib in LIBRARIES.values()
              for fn, args in lib.items()}


def _tma_batch(tile, A, Bm, c, x0, refs):
    """The scenario-last inputs as the pipeline's tensor maps take them:
    as they are where every row of B values is a whole number of 16 B from
    a 16 B aligned base, else copied (x0 too, which the kernel reads at
    the same batch) into a batch padded with zero scenarios to the next
    multiple of ``tile.batch_quantum``; and that batch."""
    B = A.shape[-1]
    q = tile.batch_quantum
    Bq = -(-B // q) * q
    mapped = [A, Bm, c, *(r for r in refs if r is not None)]
    if Bq == B and all(t.data_ptr() % 16 == 0 for t in mapped):
        return A, Bm, c, x0, refs, B

    def pad(t):
        if t is None:
            return None
        out = t.new_zeros(*t.shape[:-1], Bq)
        out[..., :B] = t
        return out

    return pad(A), pad(Bm), pad(c), pad(x0), [pad(r) for r in refs], Bq


def make_whole_pdip(H: int, n: int, m: int, iters: int,
                    with_xref: bool = False, with_uref: bool = False):
    """The complete box-constrained LTV-MPC solve in one launch (see
    module)."""
    instance_for(n, m)  # raises on a width below 1

    def fn(A, Bm, c, *rest):
        global launches
        rest = list(rest)
        x_ref = rest.pop(0) if with_xref else None
        u_ref = rest.pop(0) if with_uref else None
        x0, Q, QN, R, lb, ub = rest
        if A.device.type == "cpu":
            return solve_plain(A, Bm, c, Q, QN, R, x0, lb, ub, x_ref=x_ref,
                               u_ref=u_ref, iters=iters)
        if not A.is_cuda:
            raise ValueError(f"A on {A.device}: expected a CUDA tensor")
        B = A.shape[-1]
        dtype, device = A.dtype, A.device
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"A is {dtype}: expected float32 or float64")
        shapes = {"A": (A, (H, n, n, B)), "Bm": (Bm, (H, n, m, B)),
                  "c": (c, (H, n, B)), "x0": (x0, (n, B)), "Q": (Q, (n, n)),
                  "QN": (QN, (n, n)), "R": (R, (m, m)), "lb": (lb, (m,)),
                  "ub": (ub, (m,))}
        for name, (t, shape) in shapes.items():
            if t.device != device or t.dtype != dtype:
                raise ValueError(f"{name} is {t.dtype} on {t.device}: "
                                 f"expected {dtype} on {device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}: "
                                 f"expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        refs = []
        for name, ref, shape in (("x_ref", x_ref, (H, n, B)),
                                 ("u_ref", u_ref, (H, m, B))):
            if ref is None:
                refs.append(None)
                continue
            if ref.device != device or ref.dtype != dtype:
                raise ValueError(f"{name} is {ref.dtype} on {ref.device}: "
                                 f"expected {dtype} on {device}")
            refs.append(ref.expand(shape).contiguous())
        tile = k2_config(n, m, dtype)
        B_out = B
        if not tile.runtime:
            A, Bm, c, x0, refs, B = _tma_batch(tile, A, Bm, c, x0, refs)
        u = torch.empty(H, m, B, dtype=dtype, device=device)
        xs = torch.empty(H, n, B, dtype=dtype, device=device)
        # scenario last over the batch padded to whole tiles
        scratch = torch.empty(scratch_values(H, n, m) * tile.padded_batch(B),
                              dtype=dtype, device=device)
        name = library(tile.bound, dtype)
        launch = _build.function(name, entry_point(tile.bound, dtype),
                                 LIBRARIES[name])
        p = lambda t: None if t is None else _build.ptr(t)
        args = [p(A), p(Bm), p(c), p(refs[0]), p(refs[1]), p(x0), p(Q),
                p(QN), p(R), p(lb), p(ub), p(u), p(xs), p(scratch),
                scratch.numel()]
        if tile.runtime:
            work = torch.empty(tile.work_values(B), dtype=dtype,
                               device=device)
            rc = launch(*args, p(work), work.numel(), H, n, m, B, iters,
                        tile.scenarios, tile.blocks(B), tile.shared_bytes,
                        _build.stream_ptr(device))
        else:
            rc = launch(*args, H, n, m, B, iters, tile.shared_bytes,
                        _build.stream_ptr(device))
        _build.check(name, rc, "pdip_whole kernel")
        launches += 1
        if B != B_out:
            return u[..., :B_out].contiguous(), xs[..., :B_out].contiguous()
        return u, xs

    return fn
