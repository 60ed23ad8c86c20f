"""KTE multibody dynamics (port of ``reak_tpu.kte``): chain specs, the
model zoo, the single-sample kinematics and dynamics of ``kte.dynamics``,
inverse kinematics (``kte.ik``), task-space forces (``kte.forces``), and
the lanes and register rollouts of ``kte.lanes`` and ``kte.soa``."""
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
from reak_tpu_torch.kte import ik
from reak_tpu_torch.kte import forces

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
    "ik",
    "forces",
]
