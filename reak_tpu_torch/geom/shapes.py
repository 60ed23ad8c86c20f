"""Shape primitives as tensor records (port of ``reak_tpu/geom/shapes.py``).

(ref: geometry/shapes/sphere.hpp, box.hpp, cylinder.hpp, capped_cylinder.hpp,
plane.hpp, rectangle.hpp, circle.hpp, composite_shape*.hpp, colored_model.hpp)

Each shape is a NamedTuple of tensors; leading batch axes everywhere, so a
"composite model" is just a batched shape record (the reference's
composite_shape / colored_model lists collapse into stacking).  Cylinder
pairs get EXACT flat-cap distances via the alternating-projection solver in
``geom.convex`` (the reference handles these pairs with an NLP fallback,
prox_fundamentals_3D.hpp:57).

``torch.func.vmap`` refuses a record with ``None`` fields under the default
``in_dims=0``: map over the configurations and close over the shape
records, as the planner's workspace does, or pass an ``in_dims`` prefix
with ``None`` in the absent fields.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reak_tpu_torch.math import rotations as rot


class Sphere(NamedTuple):
    """(ref: geometry/shapes/sphere.hpp; circle.hpp in 2D)"""

    center: torch.Tensor  # (..., 3)
    radius: torch.Tensor  # (...)


class Capsule(NamedTuple):
    """Segment + radius (ref: capped_cylinder.hpp; capped_rectangle.hpp 2D)."""

    a: torch.Tensor  # (..., 3) segment start
    b: torch.Tensor  # (..., 3) segment end
    radius: torch.Tensor  # (...)


class Cylinder(NamedTuple):
    """(ref: cylinder.hpp) — exact flat-capped cylinder."""

    a: torch.Tensor
    b: torch.Tensor
    radius: torch.Tensor

    @property
    def as_capsule(self) -> Capsule:
        return Capsule(self.a, self.b, self.radius)


class Box(NamedTuple):
    """Oriented box: pose + half extents (ref: box.hpp; rectangle.hpp 2D)."""

    center: torch.Tensor  # (..., 3)
    quat: torch.Tensor  # (..., 4) local→world
    half_extents: torch.Tensor  # (..., 3)


class Plane(NamedTuple):
    """Half-space boundary: unit normal + offset, n·x = d (ref: plane.hpp)."""

    normal: torch.Tensor  # (..., 3)
    offset: torch.Tensor  # (...)


class ShapeSet(NamedTuple):
    """Aggregate of same-type shape batches with local poses relative to an
    anchor frame — the chain-anchored geometry of the reference
    (kte_chain_geometry.hpp:52): ``attach``ed to body indices, ``posed``
    through FK results.
    """

    spheres: Optional[Sphere] = None
    capsules: Optional[Capsule] = None
    boxes: Optional[Box] = None
    cylinders: Optional[Cylinder] = None
    sphere_body: Optional[torch.Tensor] = None  # (ns,) int body index (-1 = world)
    capsule_body: Optional[torch.Tensor] = None
    box_body: Optional[torch.Tensor] = None
    cylinder_body: Optional[torch.Tensor] = None


def _body_frames(idx, body_pos, body_quat):
    """(position (k, 3), quaternion (k, 4)) of the bodies ``idx`` (k,) among
    the stacked frames ``body_pos`` (nb, 3) / ``body_quat`` (nb, 4); index
    −1 is the world frame (the identity pose).  The JAX package indexes the
    frames with −1 as well, which selects the last body instead."""
    idx = torch.as_tensor(idx, device=body_pos.device)
    world = idx < 0
    safe = torch.where(world, 0, idx)
    p = torch.where(world[..., None], 0.0, body_pos[safe])
    ident = torch.eye(1, 4, dtype=body_quat.dtype, device=body_quat.device)[0]
    q = torch.where(world[..., None], ident, body_quat[safe])
    return p, q


def pose_shapes(shapes: ShapeSet, body_pos, body_quat) -> ShapeSet:
    """Transform local shapes to world given stacked body frames (nb, 3)/(nb, 4)
    (the reference's proxy-model updater, proxy_model_updater.hpp); a shape
    on body −1 stays where it is (the world frame)."""

    def body_of(idx):
        return _body_frames(idx, body_pos, body_quat)

    out = {}
    if shapes.spheres is not None:
        p, q = body_of(shapes.sphere_body)
        out["spheres"] = Sphere(p + rot.qrot(q, shapes.spheres.center),
                                shapes.spheres.radius)
        out["sphere_body"] = shapes.sphere_body
    if shapes.capsules is not None:
        p, q = body_of(shapes.capsule_body)
        out["capsules"] = Capsule(
            p + rot.qrot(q, shapes.capsules.a),
            p + rot.qrot(q, shapes.capsules.b),
            shapes.capsules.radius,
        )
        out["capsule_body"] = shapes.capsule_body
    if shapes.boxes is not None:
        p, q = body_of(shapes.box_body)
        out["boxes"] = Box(
            p + rot.qrot(q, shapes.boxes.center),
            rot.qmul(q, shapes.boxes.quat),
            shapes.boxes.half_extents,
        )
        out["box_body"] = shapes.box_body
    if shapes.cylinders is not None:
        p, q = body_of(shapes.cylinder_body)
        out["cylinders"] = Cylinder(
            p + rot.qrot(q, shapes.cylinders.a),
            p + rot.qrot(q, shapes.cylinders.b),
            shapes.cylinders.radius,
        )
        out["cylinder_body"] = shapes.cylinder_body
    return ShapeSet(**out)
