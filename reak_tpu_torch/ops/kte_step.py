"""The rollout-step kernel (K1): one launch per step of the KTE rollout with
its LTV linearization — the Hopper port of the Pallas kernel
``reak_tpu/ops/kte_core_pallas.py::make_step_lanes``.

``make_step_lanes(spec, dt)`` returns ``fn(x (n, B), u (nv, B)) → (Ad
(n, n, B), Bd (n, nv, B), cd (n, B), x_new (n, B))``.  On CUDA tensors it
launches ``csrc/kte_step.cu``; on CPU tensors it takes the plain version,
``make_step_plain`` (the step of ``kte/lanes.make_rollout_ltv_lanes``).

What bounds it on the H100 is latency: a scenario moves ~100 values but
evaluates the chain's kinematics in hyper-dual numbers along each of its n
state directions, a long dependent chain per direction.  The kernel is a
template on the chain's widths (joints, dofs), built at first use into a
library of its own per width and type (``kte_step@6x6_f32``), so its chain
loops unroll and its per-joint arrays are indexed by constants.  A block is
a tile of 16 scenarios × nv pair slots: each thread runs its q direction,
factors M and solves for q̈ itself, then runs its q̇ direction (a q̇ run is
under half a q run), so every warp carries the same work and a (6, 6) f32
batch of 8192 runs in one wave (a grid under one wave, whose time one
block's latency sets, takes the split mode instead: a thread a direction,
``split_mode``); the value and inner tangent of the
kinematics are computed once per scenario (one slot, first) and shared
through shared memory, where each thread also keeps the outer parts of its
joints' anchors and axes; the chain's constants are a kernel parameter
passed by value.  Chains of up to 16 joints run their compile-time instance
(REVOLUTE, PRISMATIC and FIXED joints, offsets, springs, dampers, full
inertia tensors), at any B ≥ 1, in float32 and float64; the tile halves
where a block would pass ``TILE_THREADS`` threads or the shared memory.  A
wider fixed-base chain runs the runtime-width instance of its type
(``kte_step@any_<type>``, on the earlier design of a warp a direction):
the same recurrences with the joints and dofs as arguments, its
per-scenario and per-direction work in a device-memory area that the
wrapper allocates (a grid of at most
``RT_GRID`` blocks walks the batch, so the area does not grow with B), a
thread taking several directions where TS × n would pass the block's
threads.  The instance is chosen, and a free-base chain refused, at the first
call on a device tensor, so a caller on CPU tensors never needs one.
``ops/kte_variants.py`` re-measures the knobs of the launch shape;
``ops/k1_phases.py`` splits a launch's cycles by phase.

``launch_shape`` mirrors the source's ``StepShape`` and ``rt_shape``: the
wrapper hands the shared-memory size (or the runtime instance's tile, grid
and work area) to the C entry point, which refuses a launch whose own
differ.  ``chain_table`` is the one place that packs the chain's constants.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from reak_tpu_torch.kte.lanes import make_step_ltv_lanes as make_step_plain
from reak_tpu_torch.kte.spec import ChainSpec, JointType, FIXED, FREE
from reak_tpu_torch.ops import _build

UNROLLED_JOINTS = 16  # csrc/kte_step.cu: the widest compile-time instance
STEP_THREADS = 384  # csrc/kte_step.cu: threads a runtime-width block, at most
TILE_THREADS = 384  # csrc/kte_step.cu: threads a compile-time block, at most
STEP_SHARED = 232448  # csrc/kte_step.cu: shared bytes a block, at most
REGISTERS = 65536  # 32-bit registers an SM of an H100
SLOTS = 21  # csrc/kte_step.cu: the values a joint leaves for the directions
RT_GRID = 264  # csrc/kte_step.cu: blocks of a runtime-width launch, at most
# csrc/kte_step.cu's knobs (ops/kte_variants.py re-measures them): the warps
# an SM's registers are shared among for f32 chains of at most six joints
# and for the others
REG_WARPS_NARROW = 12
REG_WARPS_WIDE = 8

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
    ``spec`` (a fixed-base chain of at most ``UNROLLED_JOINTS`` joints), or
    None for the runtime-width instance (a wider fixed-base chain).  A free
    base is refused: the JAX package runs it on the generic assembly, with
    no kernel."""
    if any(JointType(t) == FREE for t in spec.joint_types):
        raise NotImplementedError(
            f"{what} takes fixed-base chains; got {spec.n_joints} joints "
            "with a free base")
    if spec.nv < 1:
        raise NotImplementedError(f"{what} takes chains with a dof")
    if spec.n_joints > UNROLLED_JOINTS:
        return None
    return spec.n_joints, spec.nv


@dataclass(frozen=True)
class StepShape:
    """The launch shape of one instance (``csrc/kte_step.cu::StepShape``,
    or ``rt_shape`` for the runtime-width instance)."""
    widths: tuple   # (NJ, NV)
    scenarios: int  # TS, scenarios a tile (a block of a compile-time launch)
    threads: int    # threads a block
    shared_bytes: int
    runtime: bool = False  # the runtime-width instance
    directions: int = 0    # dy: direction threads a scenario (runtime)
    block_values: int = 0  # the work area of a block (runtime)
    # compile-time instances: the slot that runs the primal kinematics,
    # whether the anchors' and axes' outer parts are in shared memory, the
    # blocks an SM that __launch_bounds__ asks for and the registers a
    # thread that leaves
    primal_slot: int = 0
    outer_shared: bool = False
    blocks_per_sm: int = 1
    registers: int = 0
    split: bool = False  # the split mode of a compile-time instance

    def blocks(self, B: int) -> int:
        """Blocks of a launch over B scenarios: its tiles (a runtime
        launch: at most ``RT_GRID``, which walk the tiles)."""
        tiles = -(-B // self.scenarios)
        return min(tiles, RT_GRID) if self.runtime else tiles

    def work_values(self, B: int) -> int:
        """Values of the device-memory work area a launch over B scenarios
        takes (0 for a compile-time instance)."""
        return self.blocks(B) * self.block_values if self.runtime else 0


def tile_rows(nj: int, nv: int, core: bool) -> int:
    """Shared rows of TS values a tile (``kte_step.cu::tile_rows``): the
    anchors, whose rows K1's series reuses."""
    fk = 2 * SLOTS * nj
    return fk if core or fk >= 7 * nv * nv else 7 * nv * nv


def registers_a_thread(threads_an_sm: int) -> int:
    """Registers a thread when an SM runs ``threads_an_sm``: each of its
    four schedulers has a quarter of the 65,536, and a warp takes whole
    steps of 8 a thread, at most 255."""
    warps = -(-threads_an_sm // 32)
    per_scheduler = -(-warps // 4)
    return min(255, REGISTERS // 4 // (32 * per_scheduler) // 8 * 8)


@functools.lru_cache(maxsize=None)
def launch_shape(nj: int, nv: int, dtype, core: bool = False,
                 split: bool = False) -> StepShape:
    """Scenarios a tile, threads and shared memory of the instance (nj, nv)
    in ``dtype``.  A compile-time block is one tile: nv pair slots of TS
    threads, whole warps (the thread of slot j runs the q direction j, then
    the q̇ direction nv + j); the first spare slot (or the last slot) runs
    the primal kinematics.  Its shared rows of TS values hold the
    kinematics' anchors (value and inner tangent, SLOTS a joint), which
    K1's series (∂q̈/∂x, M⁻¹, S) reuses; then, where they fit, each
    thread's outer parts of the joints' anchors and axes (12 values a
    joint).  TS is 16, halved while the threads pass ``TILE_THREADS`` or
    the rows ``STEP_SHARED``.  An SM should hold as many blocks as
    ``REG_WARPS_NARROW`` warps (f32, ≤ 6 joints) or ``REG_WARPS_WIDE``
    warps allow.  ``split``: the split mode of a grid under one wave, a
    thread a direction, the q ones on the pair slots' warps and the q̇
    ones on as many more, at one block an SM.  Past ``UNROLLED_JOINTS`` joints the rows lie in the
    runtime instance's work area instead, beside each (direction, scenario)
    slot's own work (M and f in Dual numbers, the anchors and axes in HD,
    the Jacobian columns in Dual, three joint and three state vectors); TS
    is 32 in float32 and 16 in float64 (one 128 B row), halved down to 1,
    and a thread takes every ``directions``-th direction.  A built library
    reports its own shape (``SHAPE_FIELDS``)."""
    size = {"f32": 4, "f64": 8}[type_suffix(dtype)]
    n = 2 * nv
    if nj > UNROLLED_JOINTS:
        ts = 32 if size == 4 else 16
        chol = nj * nj + 2 * nj + nv
        fk = 2 * SLOTS * nj
        series = 0 if core else nv * n + nv * nv + n * n
        rows = chol + max(fk, series)
        while ts > 1 and ts * n > STEP_THREADS:
            ts //= 2
        dy = min(n, STEP_THREADS // ts)
        slot = nj * (nj + 1) + 2 * nj + 24 * nj + 12 * nj + 3 * nj + 3 * n
        return StepShape(widths=(nj, nv), scenarios=ts, threads=ts * dy,
                         shared_bytes=0, runtime=True, directions=dy,
                         block_values=rows * ts + slot * n * ts)
    ts = 16
    copies = 2 if split else 1
    rows = tile_rows(nj, nv, core)
    warps = lambda ts: -(-(ts * nv) // 32)  # the pair slots'
    while ts > 1 and (copies * 32 * warps(ts) > TILE_THREADS
                      or rows * ts * size > STEP_SHARED):
        ts //= 2
    threads = copies * 32 * warps(ts)
    q_slots = 32 * warps(ts) // ts  # the first q̇ slot of the split mode
    reg_warps = (REG_WARPS_NARROW if size == 4 and nj <= 6
                 else REG_WARPS_WIDE)
    want = 1 if split else max(1, reg_warps // warps(ts))
    outer = (rows * ts + 12 * nj * threads) * size * want <= STEP_SHARED
    shared = (rows * ts + (12 * nj * threads if outer else 0)) * size
    blocks = min(want, STEP_SHARED // shared)
    return StepShape(
        widths=(nj, nv), scenarios=ts, threads=threads, shared_bytes=shared,
        directions=n,
        primal_slot=(nv if q_slots > nv
                     else (q_slots if split else 0) + nv - 1),
        outer_shared=outer, blocks_per_sm=blocks,
        registers=registers_a_thread(threads * blocks), split=split)


def library(widths, dtype) -> str:
    """The library of one chain width and type: ``csrc/kte_step.cu`` built
    for (joints, dofs), or its runtime-width instance for ``widths=None``
    (``_build.instance_library``)."""
    return _build.instance_library("kte_step", widths, type_suffix(dtype))


def entry_point(kind: str, widths, dtype) -> str:
    """The C function ``reak_kte_<kind>_<NJ>x<NV>_<type>`` (kind: step,
    core, occupancy or shape), ``reak_kte_<kind>_any_<type>`` for ``widths=None``."""
    tag = "any" if widths is None else f"{widths[0]}x{widths[1]}"
    return f"reak_kte_{kind}_{tag}_{type_suffix(dtype)}"


_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# {kind: argtypes}.  step (and its split mode): x, u, table, nj, nv, dt,
# order, Ad, Bd, cd, x_new, B, shared bytes, stream; core (and its split
# mode): x, u, table, nj, nv, qdd, dqdd, minv, B, shared bytes, stream;
# occupancy: core, blocks (out); shape: core, split, SHAPE_FIELDS (out)
_STEP = [_VP, _VP, _VP, _CI, _CI, ctypes.c_double, _CI, _VP, _VP, _VP, _VP,
         _CI, _CI, _VP]
_CORE = [_VP, _VP, _VP, _CI, _CI, _VP, _VP, _VP, _CI, _CI, _VP]
SIGNATURES = {"step": _STEP, "core": _CORE, "step_split": _STEP,
              "core_split": _CORE,
              "occupancy": [_CI, ctypes.POINTER(ctypes.c_int)],
              "shape": [_CI, _CI, ctypes.POINTER(ctypes.c_int)]}
# the StepShape fields a compile-time library's shape entry point reports
SHAPE_FIELDS = ("scenarios", "threads", "shared_bytes", "primal_slot",
                "outer_shared", "blocks_per_sm")
# the runtime-width instance, the same with the joints' table after the
# chain's and TS, the grid and the work area in place of the shared bytes;
# occupancy: core, threads, blocks (out)
ANY_SIGNATURES = {
    "step": [_VP] * 4 + [_CI, _CI, ctypes.c_double, _CI] + [_VP] * 4
    + [_CI] * 3 + [_VP, _LL, _VP],
    "core": [_VP] * 4 + [_CI, _CI] + [_VP] * 3 + [_CI] * 3 + [_VP, _LL, _VP],
    "occupancy": [_CI, _CI, ctypes.POINTER(ctypes.c_int)]}


def signatures(widths, dtype, kinds=None) -> dict:
    """{C function: argtypes} of ``kinds`` for one width and type."""
    if kinds is None:
        kinds = SIGNATURES if widths is not None else ANY_SIGNATURES
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


def joint_table(spec: ChainSpec, device) -> torch.Tensor:
    """Each joint's type and dof (-1 for a FIXED joint), int32 (nj, 2): what
    the runtime-width instance reads beside the chain table."""
    rows, k = [], 0
    for jt in spec.joint_types:
        fixed = JointType(jt) == FIXED
        rows.append((int(jt), -1 if fixed else k))
        k += 0 if fixed else 1
    return torch.as_tensor(np.asarray(rows, np.int32), device=device)


def launch(kind: str, spec: ChainSpec, x, u, outs, dt: float = 0.0,
           order: int = 1, tables: dict = None, split: bool = None) -> None:
    """Launch the kernel of ``kind`` (step: K1; core: K5) that takes
    ``spec`` on x, u and the outputs ``outs`` (step: Ad, Bd, cd, x_new;
    core: qdd, dqdd, minv); raise on a CUDA error.  ``tables`` caches the
    chain's tables per (type, device).  A compile-time instance takes its
    split mode where ``split_mode`` says (or ``split``, where given)."""
    widths = instance_for(spec, f"the {kind} kernel")
    nj, nv = spec.n_joints, spec.nv
    core = kind == "core"
    B = x.shape[-1]
    if widths is None:
        split = False
    elif split is None:
        split = split_mode(nj, nv, x.dtype, B, x.device, core)
    shape = launch_shape(nj, nv, x.dtype, core=core, split=split)
    key = (x.dtype, x.device)
    if key not in tables:
        # the compile-time instances take the table by value (packed on the
        # CPU), the runtime one reads it and the joints' types in device
        # memory
        where = "cpu" if widths is not None else x.device
        tables[key] = (chain_table(spec, where, x.dtype),
                       None if widths is not None
                       else joint_table(spec, x.device))
    table, joints = tables[key]
    name = library(widths, x.dtype)
    fn = _build.function(
        name, entry_point(kind + "_split" if split else kind, widths,
                          x.dtype), signatures(widths, x.dtype))
    p = _build.ptr
    head = [p(x), p(u), p(table)]
    if widths is None:
        head.append(p(joints))
    head += [nj, nv]
    if not core:
        head += [float(dt), order]
    head += [p(t) for t in outs] + [B]
    if widths is None:
        work = torch.empty(shape.work_values(B), dtype=x.dtype,
                           device=x.device)
        tail = [shape.scenarios, shape.blocks(B), p(work), work.numel()]
    else:
        tail = [shape.shared_bytes]
    rc = fn(*head, *tail, _build.stream_ptr(x.device))
    _build.check(name, rc, f"kte_{kind} kernel")


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
        instance_for(spec)
        B = check_inputs(x, u, n, spec.nv)
        if not (x.is_contiguous() and u.is_contiguous()):
            raise ValueError("x and u must be contiguous")
        new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
        outs = (new(n, n, B), new(n, spec.nv, B), new(n, B), new(n, B))
        launch("step", spec, x, u, outs, dt, order, tables)
        launches += 1
        return outs

    return fn


def read_shape(fn, core: bool, split: bool = False) -> dict:
    """{SHAPE_FIELDS: value} of K1's (K5's where ``core``; in the split mode
    where ``split``) launch shape as a library was built, from its
    ``shape`` entry point ``fn``."""
    out = (ctypes.c_int * len(SHAPE_FIELDS))()
    fn(int(core), int(split), out)
    return dict(zip(SHAPE_FIELDS, out))


def built_shape(widths, dtype, core: bool = False,
                split: bool = False) -> dict:
    """``read_shape`` of the compile-time library of ``widths``."""
    return read_shape(_build.function(
        library(widths, dtype), entry_point("shape", widths, dtype),
        signatures(widths, dtype)), core, split)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_mode(nj: int, nv: int, dtype, B: int, device,
               core: bool = False) -> bool:
    """Whether a compile-time launch over B scenarios on ``device`` takes
    the split mode: its grid fills at most one wave (a block an SM), so a
    block's latency, not the SMs' throughput, sets its time."""
    if device.type != "cuda":
        return False
    shape = launch_shape(nj, nv, dtype, core=core, split=True)
    return shape.blocks(B) <= _sms(device.index or 0) * shape.blocks_per_sm


def occupancy(widths, dtype, core: bool = False, threads: int = 0) -> int:
    """Blocks of the instance an SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); the runtime-width
    instance (``widths=None``) at ``threads`` a block."""
    name = library(widths, dtype)
    blocks = ctypes.c_int(0)
    fn = _build.function(name, entry_point("occupancy", widths, dtype),
                         signatures(widths, dtype))
    args = (int(core),) if widths is not None else (int(core), threads)
    rc = fn(*args, ctypes.byref(blocks))
    _build.check(name, rc, "kte_step occupancy")
    return blocks.value
