"""Estimator configuration bundles: the reference's model/predictor options
layer as one dataclass (port of ``reak_tpu/ctrl/options.py``; ref:
ss_systems/satellite_modeling_options.hpp:73 satellite_model_options, :537
satellite_predictor_options, satellite_modeling_po.hpp; airship variants
assembled in airship_assembled_models.hpp:56-151).

One dataclass knows how to build every satellite/airship system variant,
its measurement model (sonar-in-room grounding included) and its noise
model and initial belief.  The covariances and the initial belief are
float64 tensors on ``device``, the card unless the caller says otherwise.

The class is registered with the typed-JSON archive layer under the JAX
package's tag (``register_type("reak.EstimatorOptions", …)``,
``reak_tpu/ctrl/options.py:154``), so a whole configuration is one
serialized scene that either package reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from reak_tpu_torch.ctrl import ss_systems as ss
from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.io.serialization import register_type

# default sonar array: 6 axis-aligned rays from the body origin
_DEF_SONAR_DIR = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                  (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
_DEF_SONAR_POS = tuple((0.0, 0.0, 0.0) for _ in range(6))


@dataclass
class EstimatorOptions:
    """Complete estimation setup.

    ``system_kind``: "satellite" | "airship" | "airship_aug" (the augmented
    variant carries the [δm, r_ecc(3), log-drag] parameter states of
    near_buoyant_airship_models.hpp:342 and enables the TSOS filter).
    ``measurements``: "pose" | "pose_gyro" | "pose_imu" | "pose_sonars" —
    pose_sonars appends the sonar-in-room distances
    (airship_sonar_mixins.hpp:157) to the pose output.
    """

    # -- model (satellite_model_options fields) ---------------------------
    system_kind: str = "satellite"
    mass: float = 1.0
    inertia_diag: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    time_step: float = 0.05
    # airship extras
    buoyancy: float = -1.0          # <0 → neutral (mass·g)
    drag_lin: float = 0.1
    drag_rot: float = 0.1
    r_cm: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gravity: float = 9.81

    # -- measurement configuration ----------------------------------------
    measurements: str = "pose"
    room_lower: Tuple[float, float, float] = (-5.0, -5.0, -5.0)
    room_upper: Tuple[float, float, float] = (5.0, 5.0, 5.0)
    sonar_pos: tuple = _DEF_SONAR_POS
    sonar_dir: tuple = _DEF_SONAR_DIR

    # -- noise model (diagonals; ref input_disturbance/measurement_noise/
    #    artificial_noise of satellite_modeling_options.hpp:133-139) -------
    input_disturbance: tuple = (1e-6,) * 6
    measurement_noise: tuple = (1e-3,) * 6
    artificial_noise: tuple = ()

    # -- initial belief + run length --------------------------------------
    initial_state: tuple = ()       # empty → default_state()
    initial_cov_diag: tuple = (1e-2,) * 12
    steps: int = 100
    tsos: bool = False              # two-stage online-steady aug filter

    # ------------------------------------------------------------------ API

    @property
    def n_aug(self) -> int:
        return ss.N_AUG_AIRSHIP if self.system_kind == "airship_aug" else 0

    def params(self):
        J = np.diag(np.asarray(self.inertia_diag, np.float64))
        if self.system_kind == "satellite":
            return ss.satellite3D(mass=self.mass, inertia=J)
        buoy = None if self.buoyancy < 0 else self.buoyancy
        return ss.airship3D(mass=self.mass, inertia=J, buoyancy=buoy,
                            r_cm=self.r_cm, drag_lin=self.drag_lin,
                            drag_rot=self.drag_rot, gravity=self.gravity)

    def continuous(self):
        p = self.params()
        if self.system_kind == "satellite":
            return ss.satellite3D_cont(p)
        if self.system_kind == "airship":
            return ss.airship3D_cont(p)
        return ss.airship3D_aug_cont(p)

    def discrete(self):
        """One-step discrete map F(x, u, t) (imdt for the satellite, RK4 +
        quaternion renormalization for the airships — the reference's
        num_int_dtnl route)."""
        if self.system_kind == "satellite":
            return ss.satellite3D_imdt(self.params(), self.time_step)
        return ss.rk4_quat_discrete(self.continuous(), self.time_step,
                                    n_aug=self.n_aug)

    def output(self):
        """Measurement function h(x, t) per ``measurements``."""
        if self.measurements == "pose":
            return ss.h_pose
        if self.measurements == "pose_gyro":
            return ss.h_pose_gyro
        if self.measurements == "pose_imu":
            return ss.make_h_pose_imu(self.params())
        if self.measurements == "pose_sonars":
            h_sonar = ss.make_h_sonars_in_room(
                self.room_lower, self.room_upper,
                np.asarray(self.sonar_pos), np.asarray(self.sonar_dir))

            def h(x, t=0.0):
                return torch.cat([ss.h_pose(x, t), h_sonar(x, t)], dim=-1)

            return h
        raise ValueError(f"unknown measurements kind {self.measurements!r}")

    def innovation(self):
        """Measurement-difference function (quaternion-aware for pose
        blocks; ref invariant output error)."""
        return ss.pose_innovation

    def retraction(self):
        return ss.sat3D_retraction(self.n_aug)

    def process_cov(self, device="cuda"):
        return torch.diag(_tensor(self.input_disturbance, device))

    def measurement_cov(self, device="cuda"):
        return torch.diag(_tensor(self.measurement_noise, device))

    def initial_belief(self, device="cuda") -> GaussianBelief:
        x0 = (_tensor(self.initial_state, device) if len(self.initial_state)
              else ss.default_state(self.n_aug, device=device))
        P0 = torch.diag(_tensor(self.initial_cov_diag, device))
        return GaussianBelief(x0, P0)


def _tensor(values, device):
    return torch.as_tensor(np.asarray(values, np.float64), device=device)


register_type("reak.EstimatorOptions", EstimatorOptions)
