"""The rollout core kernel (K5): q̈, ∂q̈/∂x and M⁻¹ of a fixed-base KTE
chain in one launch — the Hopper port of the Pallas kernel
``reak_tpu/ops/kte_core_pallas.py::make_core_lanes``, the core of the
rollout step without its exponential series.

``make_core_lanes(spec)`` returns ``fn(x (n, B), u (nv, B)) → (qdd (nv, B),
dqdd (nv, n, B), minv (nv, nv, B))``.  On CUDA tensors it launches the
core-only instance of ``csrc/kte_step.cu`` (the step kernel K1 stopped
before its series, entry ``reak_kte_core_<NJ>x<NV>_<type>`` of the same
library, or ``reak_kte_core_any_<type>`` of the runtime-width instance past
16 joints); on CPU tensors it takes the plain version, ``make_core_plain``
(``kte/lanes.make_core_ltv_lanes``, the core of the plain step).

What bounds it on the H100, and what the design does about it, is K1's
(``ops/kte_step.py``): the hyper-dual kinematics of n directions a
scenario, bound by the latency of each direction's chain; the kernel runs
at compile-time chain widths, a block a tile of 16 scenarios × nv pair
slots, each thread running a q direction (and its own factor of M) and
then a q̇ direction, the work all directions share done once per scenario.
Each thread writes its columns of ∂q̈/∂x (and of M⁻¹) straight to device
memory as its runs end.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.kte.lanes import make_core_ltv_lanes as make_core_plain
from reak_tpu_torch.kte.spec import ChainSpec
from reak_tpu_torch.ops import _build
from reak_tpu_torch.ops.kte_step import check_inputs, instance_for, launch

# launches of the kernel since the count was last set to 0
launches = 0
_build.count_launches(__name__)


def make_core_lanes(spec: ChainSpec):
    """q̈, ∂q̈/∂x and M⁻¹ in one kernel launch, lanes layout (see module)."""
    n = 2 * spec.nv
    plain = make_core_plain(spec)
    tables = {}

    def fn(x, u):
        global launches
        if x.device.type == "cpu" and u.device.type == "cpu":
            return plain(x, u)
        instance_for(spec, "the core kernel")
        nv = spec.nv
        B = check_inputs(x, u, n, nv)
        x, u = x.contiguous(), u.contiguous()
        new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
        outs = (new(nv, B), new(nv, n, B), new(nv, nv, B))
        launch("core", spec, x, u, outs, tables=tables)
        launches += 1
        return outs

    return fn
