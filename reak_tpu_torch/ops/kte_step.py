"""The rollout-step kernel: one launch per step of the KTE rollout with its
LTV linearization — the Hopper port of the Pallas kernel
``reak_tpu/ops/kte_core_pallas.py::make_step_lanes``.

``make_step_lanes(spec, dt)`` returns ``fn(x (n, B), u (nv, B)) → (Ad
(n, n, B), Bd (n, nv, B), cd (n, B), x_new (n, B))``.  On CUDA tensors it
launches ``csrc/kte_step.cu``; on CPU tensors it takes the plain version,
``make_step_plain`` (the step of ``kte/lanes.make_rollout_ltv_lanes``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from reak_tpu_torch.kte.lanes import make_step_ltv_lanes as make_step_plain
from reak_tpu_torch.kte.spec import ChainSpec, JointType, FREE
from reak_tpu_torch.ops import _build

MAX_JOINTS = 8  # csrc/kte_step.cu MAXJ

# launches of the kernel since the count was last set to 0
launches = 0


def chain_table(spec: ChainSpec, device, dtype) -> torch.Tensor:
    """The chain constants as the kernel reads them: per joint [type,
    axis (3), offset pos (3), offset quat (4), com (3), mass, inertia (9),
    stiffness, rest_q, damping], then gravity (3)."""
    rows = []
    for i, jt in enumerate(spec.joint_types):
        rows.append(np.concatenate([
            [float(int(jt))], spec.axes[i], spec.offsets_pos[i],
            spec.offsets_quat[i], spec.com_pos[i], [spec.masses[i]],
            np.asarray(spec.inertias[i]).ravel(), [spec.stiffness[i]],
            [spec.rest_q[i]], [spec.damping[i]]]))
    rows.append(np.asarray(spec.gravity, np.float64))
    return torch.as_tensor(np.concatenate(rows), dtype=dtype, device=device)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# x, u, chain, nj, nv, dt, order, Ad, Bd, cd, x_new, B, stream
_ARGS = [_VP, _VP, _VP, _CI, _CI, ctypes.c_double, _CI, _VP, _VP, _VP, _VP,
         _CI, _VP]
SIGNATURES = {"reak_kte_step_f32": _ARGS, "reak_kte_step_f64": _ARGS}


def make_step_lanes(spec: ChainSpec, dt: float, order: int = 4):
    """One rollout step in one kernel launch, lanes layout (see module)."""
    if spec.n_joints > MAX_JOINTS or any(
            JointType(t) == FREE for t in spec.joint_types):
        raise NotImplementedError(
            f"the step kernel takes fixed-base chains of at most {MAX_JOINTS} "
            "joints")
    nj, nv = spec.n_joints, spec.nv
    n = 2 * nv
    plain = make_step_plain(spec, dt, order)
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
        if not (x.is_contiguous() and u.is_contiguous()):
            raise ValueError("x and u must be contiguous")
        key = (x.device, x.dtype)
        if key not in tables:
            tables[key] = chain_table(spec, x.device, x.dtype)
        new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
        Ad, Bd, cd, xn = new(n, n, B), new(n, nv, B), new(n, B), new(n, B)
        lib = _build.load("kte_step", SIGNATURES)
        launch = (lib.reak_kte_step_f32 if x.dtype == torch.float32
                  else lib.reak_kte_step_f64)
        p = _build.ptr
        rc = launch(p(x), p(u), p(tables[key]), nj, nv, float(dt), order,
                    p(Ad), p(Bd), p(cd), p(xn), B,
                    _build.stream_ptr(x.device))
        _build.check(lib, rc, "kte_step kernel")
        launches += 1
        return Ad, Bd, cd, xn

    return fn
