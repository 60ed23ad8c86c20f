"""reak_tpu_torch — the PyTorch/CUDA port of ``reak_tpu``.

A second package beside the JAX one, with the same module paths and function
names (``reak_tpu_torch/kte/lanes.py::make_rollout_ltv_lanes`` ports
``reak_tpu/kte/lanes.py::make_rollout_ltv_lanes``).  Arrays keep the JAX
package's lanes layout at every public function: the scenario batch is the
last axis.  Every Pallas kernel of the JAX package is a hand-written CUDA
kernel here (``reak_tpu_torch/csrc``), bound through ``reak_tpu_torch/ops``;
each wrapper launches its kernel on CUDA tensors and takes its plain torch
version on CPU tensors.

Every module of the JAX package has its counterpart here
(``tests/test_torch_completeness.py`` holds the two trees to each other):
the flagship batched KTE-MPC solve ``ctrl.mpc.make_kte_mpc`` (both
branches), the free-base and generic scenario MPC (``ctrl.manifold_lanes``,
``ctrl.mpc_manifold``), the dense MPC, the Kalman-family filters, the
predictor, LQR/LQG and the AQR topologies with their MEAQR planners
(``ctrl``); the chains, models, dynamics, forces and inverse kinematics
(``kte``); ``math``; the integrators; the optimizers (``opt``); the
geometry (``geom``); the interpolators (``interp``); every space of
``spaces`` (joint-space, tangent-bundle, SE(2), SE(3), belief and the
kinematics topomaps); the planners (``planning``: trees, roadmaps, graph
search, interception, each draw through ``planning/draws.py``); the
config, recorders, archives, native recorder and profiler (``io``);
scenario-batch sharding over ``torch.distributed`` (``parallel``); and the
examples (``reak_tpu_torch.examples``: the satellite estimation,
prediction and MPC, the CRS planner, the X8 quadrotor planner and the
CRS dynamic-execution pipeline).  On CUDA tensors the kernels take every
width the JAX package takes (past their compile-time instances on
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
