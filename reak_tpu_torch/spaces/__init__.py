"""Metric spaces / topologies for sampling-based planning and interpolation
(port of ``reak_tpu/spaces``).

A re-design of the reference's configuration-space library
(ref: ctrl/topologies/* — metric_space_concept.hpp, differentiable_space.hpp:220,
metric_space_tuple.hpp, joint_space_topologies.hpp:63, Ndof_spaces.hpp:138,
temporal_space.hpp, rate_limited_spaces.hpp).

A space is a small value object exposing functions over tensor "points":

    sample(generator, batch)  random points      (random_sampler_concept.hpp)
    distance(a, b)            metric             (metric_space_concept.hpp)
    interpolate(a, b, t)      geodesic move      (the LERP of move_position_toward)
    clamp(p)                  project into bounds (bounded_space_concept.hpp)
    difference(a, b)          tangent delta

Points are plain tensors (leading batch axes everywhere), so planners batch
thousands of distance/steer evaluations per call.  ``sample`` takes a
``torch.Generator`` where the JAX package takes a PRNG key.
"""
from reak_tpu_torch.spaces.base import Space, ProductSpace
from reak_tpu_torch.spaces.vector import (HyperboxSpace, HyperballSpace,
                                          NdofSpace, LineSpace)
from reak_tpu_torch.spaces.so3 import SO3Space
from reak_tpu_torch.spaces.se3 import (SE3Space, SE31stOrderSpace,
                                       SE32ndOrderSpace, make_se3_space)
from reak_tpu_torch.spaces.se2 import (SE2Space, SE21stOrderSpace,
                                       SE22ndOrderSpace, FlatSE2Space,
                                       make_se2_space)
from reak_tpu_torch.spaces.topomaps import DirectKinTopoMap, InverseKinTopoMap
from reak_tpu_torch.spaces.belief import GaussianBeliefSpace
from reak_tpu_torch.spaces.temporal import TemporalSpace
from reak_tpu_torch.spaces.rate_limited import (RateLimitedNdofSpace,
                                                joint_limits_mapping)
from reak_tpu_torch.spaces.interpolated import InterpolatedSpace
from reak_tpu_torch.spaces.tangent import (
    DifferentiableSpace,
    make_differentiable_ndof,
    Ndof1stOrderSpace,
    Ndof2ndOrderSpace,
    NdofPoint1,
    NdofPoint2,
    ReachabilitySpace,
    make_ndof_space,
)

__all__ = [
    "Space",
    "ProductSpace",
    "HyperboxSpace",
    "HyperballSpace",
    "NdofSpace",
    "LineSpace",
    "SO3Space",
    "SE3Space",
    "SE31stOrderSpace",
    "SE32ndOrderSpace",
    "make_se3_space",
    "SE2Space",
    "SE21stOrderSpace",
    "SE22ndOrderSpace",
    "FlatSE2Space",
    "make_se2_space",
    "DirectKinTopoMap",
    "InverseKinTopoMap",
    "GaussianBeliefSpace",
    "TemporalSpace",
    "RateLimitedNdofSpace",
    "joint_limits_mapping",
    "InterpolatedSpace",
    "DifferentiableSpace",
    "make_differentiable_ndof",
    "Ndof1stOrderSpace",
    "Ndof2ndOrderSpace",
    "NdofPoint1",
    "NdofPoint2",
    "ReachabilitySpace",
    "make_ndof_space",
]
