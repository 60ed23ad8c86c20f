"""reak_tpu_torch — the PyTorch/CUDA port of ``reak_tpu``.

A second package beside the JAX one, with the same module paths and function
names (``reak_tpu_torch/kte/lanes.py::make_rollout_ltv_lanes`` ports
``reak_tpu/kte/lanes.py::make_rollout_ltv_lanes``).  Arrays keep the JAX
package's lanes layout at every public function: the scenario batch is the
last axis.  Every Pallas kernel of the JAX package that the port has reached
is a hand-written CUDA kernel here (``reak_tpu_torch/csrc``), bound through
``reak_tpu_torch/ops``; each wrapper launches its kernel on CUDA tensors and
takes its plain torch version on CPU tensors.

Ported so far: the flagship batched KTE-MPC solve,
``reak_tpu_torch.ctrl.mpc.make_kte_mpc`` on fixed-base chains (one or
several SQP passes, and the JAX package's cross-check routes
``qp_layout="vmap"`` and ``rollout="register"`` on ``ctrl.riccati``,
``kte.soa`` and ``math.linalg``), the free-base scenario MPC
(``reak_tpu_torch.ctrl.manifold_lanes``), and the long-horizon chain on the
rollout core and the per-pass PDIP (``kte.lanes.make_rollout_ltv_fused``,
``ctrl.riccati_soa.solve_box_mpc_riccati_soa_fused(use_kernels="passes")``);
the belief-sampled scenario MPC and the generic MPC entry points
(``ctrl.mpc_manifold``, batch first; ``ctrl.mpc.solve`` and
``receding_horizon``; ``ctrl.belief``, ``ctrl.invariant``, ``ctrl.qp``,
``ctrl.systems``, ``ctrl.ss_systems``, ``kte.dynamics``, ``math.rotations``,
``math.frames``, ``errors``); estimation and LQG (``ctrl.kalman``,
``ukf``, ``aug_kalman``, ``predictor``, ``lqg``, ``options``,
``aqr_space``, ``math.are``, the ``io`` config and recorders, and the
examples ``reak_tpu_torch.examples.estimate_satellite3d``,
``predict_satellite3d`` and ``satellite_mpc``); the arm builders, task
forces and inverse kinematics (``kte.models``, ``kte.forces``,
``kte.ik``), ``math.sorting``, ``math.tensors`` and the integrators
(``reak_tpu_torch.integrators``); the optimization toolbox
(``reak_tpu_torch.opt``), the geometry (``reak_tpu_torch.geom``) and the
profiler (``io.profiling``); the interpolators (``reak_tpu_torch.interp``),
the joint-space and tangent-bundle spaces (``reak_tpu_torch.spaces``), the
archives (``io.serialization``, byte for byte the JAX package's), the
scenarios (``kte.scenarios``), the planning queries (``planning.queries``)
and the native recorder (``io.native_recorder``); every Pallas kernel of
the JAX package has its CUDA counterpart, and on CUDA tensors they take
every width the JAX package takes (past their compile-time instances on
runtime-width ones).

Importing the package changes no global torch state and needs neither CUDA
nor a compiler; the kernels are built at their first launch.
"""

__version__ = "0.1.0"

import torch as _torch


def enable_full_precision() -> None:
    """Keep float32 matrix products and convolutions in full float32.

    The counterpart of ``reak_tpu.enable_full_precision``: on an NVIDIA card
    the risk is TF32, which keeps about three decimal digits and would break
    the ≤1e-4 parity bars.  Explicit opt-in, never run at import time:
    drivers such as ``chip_smoke.py`` call it."""
    _torch.backends.cuda.matmul.allow_tf32 = False
    _torch.backends.cudnn.allow_tf32 = False
