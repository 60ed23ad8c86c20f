"""Control (port of ``reak_tpu.ctrl``): the batched KTE-MPC solvers, the
Riccati PDIPs, the scenario MPC on manifolds, the generic MPC, the dense
QPs, the vehicle models, beliefs, the Kalman-family filters (EKF, IEKF,
UKF, TSOS), belief prediction, LQR/LQG, estimator options and the AQR
topologies.

The package exports its twelve public submodules, as the JAX package does;
each is imported at its first use (``reak_tpu_torch.ctrl.mpc``), since
``ops`` and ``kte`` import modules of this package while it loads."""
import importlib

__all__ = ["systems", "qp", "mpc", "belief", "kalman", "ukf", "invariant",
           "lqg", "ss_systems", "aug_kalman", "predictor", "aqr_space"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
