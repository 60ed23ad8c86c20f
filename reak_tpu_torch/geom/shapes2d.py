"""2D shape primitives as tensor records (port of
``reak_tpu/geom/shapes2d.py``).

(ref: geometry/shapes/circle.hpp, rectangle.hpp, capped_rectangle.hpp,
line_seg_2D.hpp, composite_shape_2D.hpp, kte_chain_geometry.hpp:52 —
kte_chain_geometry_2D)

Same design as :mod:`reak_tpu_torch.geom.shapes`: each shape is a NamedTuple
of tensors with leading batch axes; a composite model is a stacked record.
A rectangle carries its orientation as a single planar angle (the
reference's ``rot_mat_2D``); a capped rectangle is the reference's stadium —
a rectangle whose ±x ends are capped by half-discs, represented here by its
spine half-length and cap radius (= half the y-extent).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Circle(NamedTuple):
    """(ref: geometry/shapes/circle.hpp)"""

    center: torch.Tensor  # (..., 2)
    radius: torch.Tensor  # (...)


class Rectangle(NamedTuple):
    """Oriented rectangle (ref: geometry/shapes/rectangle.hpp)."""

    center: torch.Tensor  # (..., 2)
    angle: torch.Tensor   # (...)  planar rotation of the local frame
    half: torch.Tensor    # (..., 2) half-extents along local x/y


class CappedRectangle(NamedTuple):
    """Stadium: rectangle with half-disc caps on the ±x ends
    (ref: geometry/shapes/capped_rectangle.hpp).  ``half_len`` is the spine
    half-length (the flat part along local x); ``radius`` the cap radius
    (= half the y-extent)."""

    center: torch.Tensor    # (..., 2)
    angle: torch.Tensor     # (...)
    half_len: torch.Tensor  # (...)
    radius: torch.Tensor    # (...)


class Seg2D(NamedTuple):
    """Line segment (ref: geometry/shapes/line_seg_2D.hpp)."""

    a: torch.Tensor  # (..., 2)
    b: torch.Tensor  # (..., 2)


def rot2(angle):
    """2x2 rotation matrix (ref: core/kinetostatics/rotations_2D.hpp
    rot_mat_2D) — broadcasts over leading axes."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def rot2_apply(angle, v):
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def _unit(k, like):
    """The k-th unit 2-vector in the type and on the device of ``like``."""
    return torch.eye(2, dtype=like.dtype, device=like.device)[k]


def rect_corners(r: Rectangle):
    """(..., 4, 2) corners in CCW order."""
    u0 = rot2_apply(r.angle, _unit(0, r.center))
    u1 = rot2_apply(r.angle, _unit(1, r.center))
    e0 = r.half[..., 0:1] * u0
    e1 = r.half[..., 1:2] * u1
    c = r.center
    return torch.stack([c + e0 + e1, c - e0 + e1, c - e0 - e1, c + e0 - e1],
                       dim=-2)


def crect_spine(cr: CappedRectangle):
    """Spine segment endpoints of a capped rectangle: (..., 2), (..., 2)."""
    u = rot2_apply(cr.angle, _unit(0, cr.center))
    e = cr.half_len[..., None] * u
    return cr.center - e, cr.center + e


class ShapeSet2D(NamedTuple):
    """Aggregate of same-type 2D shape batches anchored to body indices —
    the planar chain-anchored geometry (ref: kte_chain_geometry.hpp:52
    kte_chain_geometry_2D; posed through FK like proxy_model_updater.hpp).
    """

    circles: Optional[Circle] = None
    rects: Optional[Rectangle] = None
    crects: Optional[CappedRectangle] = None
    segs: Optional[Seg2D] = None
    circle_body: Optional[torch.Tensor] = None  # (nc,) int body index (-1 = world)
    rect_body: Optional[torch.Tensor] = None
    crect_body: Optional[torch.Tensor] = None
    seg_body: Optional[torch.Tensor] = None


def _body_frames_2d(idx, body_pos, body_ang):
    """(position (k, 2), angle (k,)) of the planar bodies ``idx`` (k,);
    index −1 is the world frame (origin, angle 0).  The JAX package indexes
    the frames with −1 as well, which selects the last body instead."""
    idx = torch.as_tensor(idx, device=body_pos.device)
    world = idx < 0
    safe = torch.where(world, 0, idx)
    return (torch.where(world[..., None], 0.0, body_pos[safe]),
            torch.where(world, 0.0, body_ang[safe]))


def pose_shapes_2d(shapes: ShapeSet2D, body_pos, body_ang) -> ShapeSet2D:
    """Transform local 2D shapes to world given stacked planar body frames
    ``body_pos (nb, 2)``, ``body_ang (nb,)`` (ref: proxy_model_updater.hpp,
    specialized to pose_2D chains); a shape on body −1 stays where it is."""

    out = {}
    if shapes.circles is not None:
        p, a = _body_frames_2d(shapes.circle_body, body_pos, body_ang)
        out["circles"] = Circle(p + rot2_apply(a, shapes.circles.center),
                                shapes.circles.radius)
        out["circle_body"] = shapes.circle_body
    if shapes.rects is not None:
        p, a = _body_frames_2d(shapes.rect_body, body_pos, body_ang)
        out["rects"] = Rectangle(p + rot2_apply(a, shapes.rects.center),
                                 a + shapes.rects.angle, shapes.rects.half)
        out["rect_body"] = shapes.rect_body
    if shapes.crects is not None:
        p, a = _body_frames_2d(shapes.crect_body, body_pos, body_ang)
        out["crects"] = CappedRectangle(p + rot2_apply(a, shapes.crects.center),
                                        a + shapes.crects.angle,
                                        shapes.crects.half_len,
                                        shapes.crects.radius)
        out["crect_body"] = shapes.crect_body
    if shapes.segs is not None:
        p, a = _body_frames_2d(shapes.seg_body, body_pos, body_ang)
        out["segs"] = Seg2D(p + rot2_apply(a, shapes.segs.a),
                            p + rot2_apply(a, shapes.segs.b))
        out["seg_body"] = shapes.seg_body
    return ShapeSet2D(**out)
