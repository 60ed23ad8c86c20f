"""The rollout core kernel: q̈, ∂q̈/∂x and M⁻¹ of a fixed-base KTE chain in
one launch — the Hopper port of the Pallas kernel
``reak_tpu/ops/kte_core_pallas.py::make_core_lanes`` (K5), the core of the
rollout step without its exponential series.

``make_core_lanes(spec)`` returns ``fn(x (n, B), u (nv, B)) → (qdd (nv, B),
dqdd (nv, n, B), minv (nv, nv, B))``.  On CUDA tensors it launches the
core-only instance of ``csrc/kte_step.cu`` (the step kernel K1 stopped
before its series); on CPU tensors it takes the plain version,
``make_core_plain`` (``kte/lanes.make_core_ltv_lanes``, the core of the
plain step).
"""
from __future__ import annotations

import ctypes

import torch

from reak_tpu_torch.kte.lanes import make_core_ltv_lanes as make_core_plain
from reak_tpu_torch.kte.spec import ChainSpec, JointType, FREE
from reak_tpu_torch.ops import _build
from reak_tpu_torch.ops.kte_step import MAX_JOINTS, chain_table

# launches of the kernel since the count was last set to 0
launches = 0

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# x, u, chain, nj, nv, qdd, dqdd, minv, B, stream
_ARGS = [_VP, _VP, _VP, _CI, _CI, _VP, _VP, _VP, _CI, _VP]
SIGNATURES = {"reak_kte_core_f32": _ARGS, "reak_kte_core_f64": _ARGS}


def make_core_lanes(spec: ChainSpec):
    """q̈, ∂q̈/∂x and M⁻¹ in one kernel launch, lanes layout (see module)."""
    if spec.n_joints > MAX_JOINTS or any(
            JointType(t) == FREE for t in spec.joint_types):
        raise NotImplementedError(
            f"the core kernel takes fixed-base chains of at most {MAX_JOINTS} "
            "joints")
    nj, nv = spec.n_joints, spec.nv
    n = 2 * nv
    plain = make_core_plain(spec)
    tables = {}

    def fn(x, u):
        global launches
        if x.device.type == "cpu" and u.device.type == "cpu":
            return plain(x, u)
        if not (x.is_cuda and u.device == x.device):
            raise ValueError(f"x on {x.device}, u on {u.device}: expected "
                             "both on one CUDA device")
        if x.dtype not in (torch.float32, torch.float64) or u.dtype != x.dtype:
            raise TypeError(f"x {x.dtype}, u {u.dtype}: expected float32 or "
                            "float64, the same for both")
        B = x.shape[-1]
        if x.shape != (n, B) or u.shape != (nv, B) or B < 1:
            raise ValueError(f"x {tuple(x.shape)}, u {tuple(u.shape)}: "
                             f"expected ({n}, B) and ({nv}, B)")
        x, u = x.contiguous(), u.contiguous()
        key = (x.device, x.dtype)
        if key not in tables:
            tables[key] = chain_table(spec, x.device, x.dtype)
        new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
        qdd, dqdd, minv = new(nv, B), new(nv, n, B), new(nv, nv, B)
        lib = _build.load("kte_step", SIGNATURES)
        launch = (lib.reak_kte_core_f32 if x.dtype == torch.float32
                  else lib.reak_kte_core_f64)
        p = _build.ptr
        rc = launch(p(x), p(u), p(tables[key]), nj, nv, p(qdd), p(dqdd),
                    p(minv), B, _build.stream_ptr(x.device))
        _build.check(lib, rc, "kte_core kernel")
        launches += 1
        return qdd, dqdd, minv

    return fn
