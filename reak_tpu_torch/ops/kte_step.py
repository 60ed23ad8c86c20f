"""The rollout-step kernel (K1): one launch per step of the KTE rollout with
its LTV linearization — the Hopper port of the Pallas kernel
``reak_tpu/ops/kte_core_pallas.py::make_step_lanes``.

``make_step_lanes(spec, dt)`` returns ``fn(x (n, B), u (nv, B)) → (Ad
(n, n, B), Bd (n, nv, B), cd (n, B), x_new (n, B))``.  On CUDA tensors it
launches ``csrc/kte_step.cu``; on CPU tensors it takes the plain version,
``make_step_plain`` (the step of ``kte/lanes.make_rollout_ltv_lanes``).

What bounds it on the H100 is per-thread state and latency (likely also
the instruction stream), not memory: a scenario moves ~100 values but
evaluates the chain's kinematics in hyper-dual numbers along each of its n
state directions.  The kernel is a template on the chain's widths (joints,
dofs), built at first use into a library of its own per width and type
(``kte_step@6x6_f32``), so its chain loops unroll and its per-joint arrays
are indexed by constants (registers, with what exceeds them spilled).  A
block is a tile of TS scenarios × n directions (a warp is 32 scenarios of
one direction in f32); the value and inner tangent of the
kinematics are computed once per scenario and shared through shared memory,
as are the factor of M and q̈; the q and q̇ directions run code of their own
(a q̇ direction moves no position and skips M); the chain's constants are a
kernel parameter passed by value.  Any fixed-base chain of at most 16
joints runs (REVOLUTE, PRISMATIC and FIXED joints, offsets, springs,
dampers, full inertia tensors), at any B ≥ 1, in float32 and float64; the
tile halves where a block would pass 384 threads (8 scenarios at 16 dofs).
The instance is chosen, and a chain it cannot take refused, at the first
call on a device tensor, so a caller on CPU tensors never needs one.
``ops/kte_variants.py`` re-measures the tile (TS) and the blocks an SM that
``__launch_bounds__`` asks for.

``launch_shape`` mirrors the source's ``StepShape``: the wrapper hands its
shared-memory size to the C entry point, which refuses a launch whose own
differs.  ``chain_table`` is the one place that packs the chain's constants.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from reak_tpu_torch.kte.lanes import make_step_ltv_lanes as make_step_plain
from reak_tpu_torch.kte.spec import ChainSpec, JointType, FREE
from reak_tpu_torch.ops import _build

MAX_JOINTS = 16  # csrc/kte_step.cu MAXJ
STEP_THREADS = 384  # csrc/kte_step.cu: threads a block, at most
SLOTS = 21  # csrc/kte_step.cu: the values a joint leaves for the directions

# launches of the kernel since the count was last set to 0
launches = 0
_build.count_launches(__name__)


def type_suffix(dtype) -> str:
    """``f32`` or ``f64``, as the C entry points and libraries are named."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{dtype}: expected float32 or float64")
    return "f32" if dtype == torch.float32 else "f64"


def instance_for(spec: ChainSpec, what: str = "the step kernel"):
    """The compile-time widths (joints, dofs) of the instance that takes
    ``spec``: every fixed-base chain of at most ``MAX_JOINTS`` joints."""
    if spec.n_joints > MAX_JOINTS or any(
            JointType(t) == FREE for t in spec.joint_types):
        raise NotImplementedError(
            f"{what} takes fixed-base chains of at most {MAX_JOINTS} joints; "
            f"got {spec.n_joints} joints"
            + (" with a free base" if spec.has_free_base else ""))
    if spec.nv < 1:
        raise NotImplementedError(f"{what} takes chains with a dof")
    return spec.n_joints, spec.nv


@dataclass(frozen=True)
class StepShape:
    """The launch shape of one instance (``csrc/kte_step.cu::StepShape``)."""
    widths: tuple   # (NJ, NV)
    scenarios: int  # TS, scenarios a block
    threads: int    # TS × n, a warp of scenarios per direction
    shared_bytes: int

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)


def launch_shape(nj: int, nv: int, dtype, core: bool = False) -> StepShape:
    """Scenarios a block, threads and shared memory of the instance (nj, nv)
    in ``dtype``: rows of TS values for the factor of M, 1/its diagonal and
    q̈ (joint and dof order), then the larger of the kinematics' anchors
    (value and inner tangent, SLOTS a joint) and K1's series (∂q̈/∂x, M⁻¹,
    S), which reuses their rows.  TS is 32 in float32 and 16 in float64 (one
    128 B row), halved while the block would pass ``STEP_THREADS``."""
    size = {"f32": 4, "f64": 8}[type_suffix(dtype)]
    n = 2 * nv
    ts = 32 if size == 4 else 16
    while ts * n > STEP_THREADS:
        ts //= 2
    chol = nj * nj + 2 * nj + nv
    fk = 2 * SLOTS * nj
    series = 0 if core else nv * n + nv * nv + n * n
    return StepShape(widths=(nj, nv), scenarios=ts, threads=ts * n,
                     shared_bytes=size * ts * (chol + max(fk, series)))


def library(widths, dtype) -> str:
    """The library of one chain width and type: ``csrc/kte_step.cu`` built
    for (joints, dofs) (``_build.instance_library``)."""
    return _build.instance_library("kte_step", widths, type_suffix(dtype))


def entry_point(kind: str, widths, dtype) -> str:
    """The C function ``reak_kte_<kind>_<NJ>x<NV>_<type>`` (kind: step,
    core or occupancy)."""
    return f"reak_kte_{kind}_{widths[0]}x{widths[1]}_{type_suffix(dtype)}"


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# {kind: argtypes}.  step: x, u, table, nj, nv, dt, order, Ad, Bd, cd,
# x_new, B, shared bytes, stream; occupancy: core, blocks (out)
SIGNATURES = {"step": [_VP, _VP, _VP, _CI, _CI, ctypes.c_double, _CI, _VP,
                       _VP, _VP, _VP, _CI, _CI, _VP],
              "occupancy": [_CI, ctypes.POINTER(ctypes.c_int)]}


def signatures(widths, dtype, kinds=SIGNATURES) -> dict:
    """{C function: argtypes} of ``kinds`` for one width and type."""
    return {entry_point(k, widths, dtype): args for k, args in kinds.items()}


def chain_table(spec: ChainSpec, device, dtype) -> torch.Tensor:
    """The chain constants as the kernel reads them: per joint [type,
    axis (3), offset pos (3), offset quat (4), com (3), mass, inertia (9),
    stiffness, rest_q, damping], then gravity (3).  The kernel takes them by
    value, so the wrappers pack them on the CPU."""
    rows = []
    for i, jt in enumerate(spec.joint_types):
        rows.append(np.concatenate([
            [float(int(jt))], spec.axes[i], spec.offsets_pos[i],
            spec.offsets_quat[i], spec.com_pos[i], [spec.masses[i]],
            np.asarray(spec.inertias[i]).ravel(), [spec.stiffness[i]],
            [spec.rest_q[i]], [spec.damping[i]]]))
    rows.append(np.asarray(spec.gravity, np.float64))
    return torch.as_tensor(np.concatenate(rows), dtype=dtype, device=device)


def check_inputs(x, u, n: int, nv: int) -> int:
    """Raise unless x (n, B) and u (nv, B) are one CUDA device's, of one
    float type; returns B."""
    if not (x.is_cuda and u.device == x.device):
        raise ValueError(f"x on {x.device}, u on {u.device}: expected both "
                         "on one CUDA device")
    if x.dtype not in (torch.float32, torch.float64) or u.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, u {u.dtype}: expected float32 or "
                        "float64, the same for both")
    B = x.shape[-1]
    if x.shape != (n, B) or u.shape != (nv, B) or B < 1:
        raise ValueError(f"x {tuple(x.shape)}, u {tuple(u.shape)}: expected "
                         f"({n}, B) and ({nv}, B)")
    return B


def make_step_lanes(spec: ChainSpec, dt: float, order: int = 4):
    """One rollout step in one kernel launch, lanes layout (see module)."""
    n = 2 * spec.nv
    plain = make_step_plain(spec, dt, order)
    tables = {}

    def fn(x, u):
        global launches
        if x.device.type == "cpu" and u.device.type == "cpu":
            return plain(x, u)
        widths = instance_for(spec)
        nj, nv = widths
        B = check_inputs(x, u, n, nv)
        if not (x.is_contiguous() and u.is_contiguous()):
            raise ValueError("x and u must be contiguous")
        if x.dtype not in tables:
            tables[x.dtype] = chain_table(spec, "cpu", x.dtype)
        new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
        Ad, Bd, cd, xn = new(n, n, B), new(n, nv, B), new(n, B), new(n, B)
        name = library(widths, x.dtype)
        launch = _build.function(name, entry_point("step", widths, x.dtype),
                                 signatures(widths, x.dtype))
        p = _build.ptr
        rc = launch(p(x), p(u), p(tables[x.dtype]), nj, nv, float(dt), order,
                    p(Ad), p(Bd), p(cd), p(xn), B,
                    launch_shape(nj, nv, x.dtype).shared_bytes,
                    _build.stream_ptr(x.device))
        _build.check(name, rc, "kte_step kernel")
        launches += 1
        return Ad, Bd, cd, xn

    return fn


def occupancy(widths, dtype, core: bool = False) -> int:
    """Blocks of the instance an SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    name = library(widths, dtype)
    blocks = ctypes.c_int(0)
    rc = _build.function(name, entry_point("occupancy", widths, dtype),
                         signatures(widths, dtype))(int(core),
                                                    ctypes.byref(blocks))
    _build.check(name, rc, "kte_step occupancy")
    return blocks.value
