"""Math helpers (port of ``reak_tpu.math``): batched linear algebra, the
Riccati equation solvers, rotations (per point and in the lanes layout),
kinematic frames, tensor algebra and sorting."""
from reak_tpu_torch.math import (are, frames, linalg, rot_lanes, rotations,
                                 sorting, tensors)

__all__ = ["rotations", "frames", "linalg", "are", "tensors", "sorting",
           "rot_lanes"]
