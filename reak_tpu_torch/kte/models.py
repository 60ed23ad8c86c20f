"""Named robot chain builders (port of ``reak_tpu/kte/models.py``).

Only the flagship arm is ported so far; the rest of the zoo follows with
the later slices.
"""
from __future__ import annotations

import numpy as np

from reak_tpu_torch.kte.spec import ChainSpec, REVOLUTE


def manip_3r3r(
    base_to_shoulder=0.3302,
    shoulder_to_elbow=0.3048,
    elbow_to_joint4=0.1500,
    joint4_to_wrist=0.1802,
    wrist_to_flange=0.0762,
    link_masses=(9.0, 6.0, 4.0, 1.0, 0.7, 0.3),
    rotor_inertia=0.05,
    gravity=9.81,
) -> ChainSpec:
    """6-DoF decoupled 3R-3R manipulator, CRS-A465 geometry — the flagship
    benchmark arm (BASELINE config 3).

    Joint layout matches the reference (manip_3R3R_arm.cpp:107-212):
    axes z, −y, −y, z, −y, z with inter-joint offsets along local +z.
    Link inertias are simple solid-rod estimates about each COM.
    """
    offs = [
        [0.0, 0.0, 0.0],
        [0.0, 0.0, base_to_shoulder],
        [0.0, 0.0, shoulder_to_elbow],
        [0.0, 0.0, elbow_to_joint4],
        [0.0, 0.0, joint4_to_wrist],
        [0.0, 0.0, wrist_to_flange],
    ]
    lengths = [
        base_to_shoulder,
        shoulder_to_elbow,
        elbow_to_joint4,
        joint4_to_wrist,
        wrist_to_flange,
        0.05,
    ]
    axes = np.array(
        [
            [0.0, 0.0, 1.0],
            [0.0, -1.0, 0.0],
            [0.0, -1.0, 0.0],
            [0.0, 0.0, 1.0],
            [0.0, -1.0, 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    com = np.zeros((6, 3))
    inert = np.zeros((6, 3, 3))
    for i, (m, L) in enumerate(zip(link_masses, lengths)):
        com[i] = [0.0, 0.0, L / 2.0]
        # solid rod along z plus reflected rotor/gearbox inertia on every axis
        # (keeps M well-conditioned, as on the physical CRS-A465 where geared
        # drives dominate the wrist inertia)
        I_perp = m * L * L / 12.0
        inert[i] = np.diag(
            [I_perp + rotor_inertia, I_perp + rotor_inertia, rotor_inertia]
        )
    return ChainSpec.build(
        joint_types=[REVOLUTE] * 6,
        axes=axes,
        offsets_pos=offs,
        com_pos=com,
        masses=list(link_masses),
        inertias=inert,
        gravity=(0.0, 0.0, -gravity),
        name="manip_3R3R",
    )
