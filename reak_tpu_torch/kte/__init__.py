"""KTE multibody dynamics (port of ``reak_tpu.kte``): chain specs, the
model zoo, the single-sample kinematics and dynamics of ``kte.dynamics``,
and the lanes and register rollouts of ``kte.lanes`` and ``kte.soa``."""
from reak_tpu_torch.kte.spec import (
    ChainSpec,
    JointType,
    REVOLUTE,
    PRISMATIC,
    FIXED,
    FREE,
)
from reak_tpu_torch.kte.dynamics import (
    fk,
    body_frames,
    jacobians,
    velocities,
    mass_matrix,
    mass_matrix_and_derivative,
    bias_force,
    forward_dynamics,
    inverse_dynamics,
    state_rate,
    pack_state,
    unpack_state,
)
from reak_tpu_torch.kte import models

__all__ = [
    "ChainSpec",
    "JointType",
    "REVOLUTE",
    "PRISMATIC",
    "FIXED",
    "FREE",
    "fk",
    "body_frames",
    "jacobians",
    "velocities",
    "mass_matrix",
    "mass_matrix_and_derivative",
    "bias_force",
    "forward_dynamics",
    "inverse_dynamics",
    "state_rate",
    "pack_state",
    "unpack_state",
    "models",
]
