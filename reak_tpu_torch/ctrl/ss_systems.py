"""State-space systems (port of ``reak_tpu/ctrl/ss_systems.py``): the free
rigid-body satellite that the free-base scenario MPC drives.

Only the satellite's parameters and its default state are ported here; the
satellite's step and error-state linearization in lanes form live in
``ctrl/manifold_lanes.py``.  The rest of the module waits for the
estimation slice.  (ref: satellite_basic_models.hpp:70,
satellite_invar_models.hpp)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SatelliteParams(NamedTuple):
    mass: torch.Tensor         # scalar
    inertia: torch.Tensor      # (3, 3) body-frame inertia tensor


def satellite3D(mass=1.0, inertia=None) -> SatelliteParams:
    """Satellite parameters as float64 CPU tensors (identity inertia when
    None)."""
    inertia = torch.eye(3, dtype=torch.float64) if inertia is None else \
        torch.as_tensor(inertia, dtype=torch.float64)
    return SatelliteParams(torch.as_tensor(mass, dtype=torch.float64), inertia)


def default_state(n_aug: int = 0, dtype=torch.float64, device="cuda"):
    """[p (3), q (4), v (3), ω (3), aug (n_aug)] at rest: origin, identity
    attitude.  On the card unless ``device`` says otherwise (the JAX
    function lands on the default accelerator); with no card it raises,
    and a CPU caller passes ``device="cpu"``."""
    x = torch.zeros(13 + n_aug, dtype=dtype, device=device)
    x[3] = 1.0
    return x
