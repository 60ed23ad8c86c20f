"""SO(3) rotation space (port of ``reak_tpu/spaces/so3.py``; ref:
ctrl/topologies/so3_topologies.hpp — quaternion_topology /
rate_limited_quat_space).

Points are unit quaternions (..., 4); metric is the geodesic angle; sampling
is uniform (Shoemake via Gaussian normalization), float64 on the
generator's device; interpolation is slerp.
"""
from __future__ import annotations

import torch

from reak_tpu_torch.math import rotations as rot


class SO3Space:
    def __init__(self, max_angular_speed: float | None = None):
        # max_angular_speed gives the rate-limited variant a time-metric
        self.max_angular_speed = max_angular_speed

    dim = 4  # ambient; tangent dim is 3

    def sample(self, generator, batch=()):
        q = torch.randn(tuple(batch) + (4,), generator=generator,
                        dtype=torch.float64, device=generator.device)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)

    def distance(self, a, b):
        ang = torch.linalg.vector_norm(rot.q_log(rot.qmul(rot.qconj(a), b)),
                                       dim=-1)
        if self.max_angular_speed is not None:
            return ang / self.max_angular_speed
        return ang

    def interpolate(self, a, b, t):
        return rot.qslerp(a, b, t)

    def difference(self, a, b):
        """Tangent (rotation vector) taking b to a."""
        return rot.q_log(rot.qmul(rot.qconj(b), a))

    def clamp(self, p):
        return p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
