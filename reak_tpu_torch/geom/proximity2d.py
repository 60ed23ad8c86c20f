"""2D pairwise SIGNED distance functions + aggregate proxy-query dispatch
(port of ``reak_tpu/geom/proximity2d.py``).

(ref: geometry/proximity/prox_circle_circle.cpp, prox_circle_rectangle.cpp,
prox_circle_crect.cpp, prox_rectangle_rectangle.cpp, prox_crect_rectangle.cpp,
prox_crect_crect.cpp, proximity_finder_2D.hpp:49, proxy_query_model.hpp:51-92
— proxy_query_pair_2D / proxy_query_model_2D)

All functions return SIGNED distance (negative = penetration depth),
matching the 3D stack in :mod:`reak_tpu_torch.geom.proximity`:

* circle pairs are exact everywhere (point SDFs minus radii);
* rectangle-rectangle uses edge-pair distances when separated (exact for
  disjoint convex polygons) and the 2D SAT minimum-translation depth on
  overlap (exact for convex polygons — the MTV is along a face normal);
* capped-rectangle (stadium) pairs reduce to spine-segment distances minus
  cap radii — exact while the spines do not cross (the same regime the
  reference's closed-form kernels handle; beyond it the value stays a
  correctly-signed penetration bound).

Everything broadcasts over leading batch axes; ``proxy_query_2d`` evaluates
all registered cross-pairs of two models by broadcasting the two shape
lists against each other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reak_tpu_torch.geom.convex import _dot, _norm
from reak_tpu_torch.geom.proximity import _inf_like
from reak_tpu_torch.geom.shapes2d import (
    CappedRectangle,
    Circle,
    Rectangle,
    Seg2D,
    ShapeSet2D,
    _unit,
    crect_spine,
    rect_corners,
    rot2_apply,
)

_EPS = 1e-30


# ---------------------------------------------------------------------------
# point / segment primitives
# ---------------------------------------------------------------------------


def sdf_point_rect(p, r: Rectangle):
    """Exact signed distance point → oriented rectangle (negative inside)."""
    q = rot2_apply(-r.angle, p - r.center)
    d = torch.abs(q) - r.half
    outside = _norm(torch.clamp(d, min=0.0))
    inside = torch.clamp(torch.maximum(d[..., 0], d[..., 1]), max=0.0)
    return outside + inside


def closest_on_seg_2d(p, a, b):
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=_EPS)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def dist_point_seg(p, a, b):
    return _norm(p - closest_on_seg_2d(p, a, b))


def dist_seg_seg_2d(a0, a1, b0, b1):
    """Min distance between planar segments: 0 when they cross, else the min
    endpoint-to-segment distance (exact — for disjoint planar segments the
    closest pair involves an endpoint)."""
    d1, d2 = a1 - a0, b1 - b0

    def side(p, a, d):
        v = p - a
        return d[..., 0] * v[..., 1] - d[..., 1] * v[..., 0]

    s1, s2 = side(b0, a0, d1), side(b1, a0, d1)
    s3, s4 = side(a0, b0, d2), side(a1, b0, d2)
    crossing = (s1 * s2 < 0.0) & (s3 * s4 < 0.0)
    d = torch.minimum(
        torch.minimum(dist_point_seg(a0, b0, b1), dist_point_seg(a1, b0, b1)),
        torch.minimum(dist_point_seg(b0, a0, a1), dist_point_seg(b1, a0, a1)),
    )
    return torch.where(crossing, 0.0, d)


# ---------------------------------------------------------------------------
# the reference's six 2D pair functions (signed)
# ---------------------------------------------------------------------------


def dist_circle_circle(c1: Circle, c2: Circle):
    """(ref: prox_circle_circle.cpp)"""
    return _norm(c1.center - c2.center) - c1.radius - c2.radius


def dist_circle_rect(c: Circle, r: Rectangle):
    """(ref: prox_circle_rectangle.cpp) — exact signed everywhere."""
    return sdf_point_rect(c.center, r) - c.radius


def dist_circle_crect(c: Circle, cr: CappedRectangle):
    """(ref: prox_circle_crect.cpp)"""
    a, b = crect_spine(cr)
    return dist_point_seg(c.center, a, b) - c.radius - cr.radius


def dist_crect_crect(c1: CappedRectangle, c2: CappedRectangle):
    """(ref: prox_crect_crect.cpp) — spine-segment distance minus radii."""
    a0, a1 = crect_spine(c1)
    b0, b1 = crect_spine(c2)
    return dist_seg_seg_2d(a0, a1, b0, b1) - c1.radius - c2.radius


def _rect_axes(r: Rectangle):
    return (rot2_apply(r.angle, _unit(0, r.center)),
            rot2_apply(r.angle, _unit(1, r.center)))


def _next_corner(corners):
    """Each corner's successor in CCW order: corners[(i + 1) % 4]."""
    return torch.roll(corners, -1, dims=-2)


def _edge_pairs_min(cornersA, cornersB):
    """Min distance over all 4x4 edge pairs of two quads (..., 4, 2)."""
    a0, a1 = cornersA, _next_corner(cornersA)
    b0, b1 = cornersB, _next_corner(cornersB)
    d = dist_seg_seg_2d(
        a0[..., :, None, :], a1[..., :, None, :],
        b0[..., None, :, :], b1[..., None, :, :],
    )
    return torch.amin(d, dim=(-2, -1))


def dist_rect_rect(r1: Rectangle, r2: Rectangle):
    """(ref: prox_rectangle_rectangle.cpp) — exact signed OBB-OBB: edge-pair
    min distance when disjoint, SAT minimum-translation depth on overlap."""
    u10, u11 = _rect_axes(r1)
    u20, u21 = _rect_axes(r2)
    t = r2.center - r1.center
    seps = []
    for L in (u10, u11, u20, u21):
        ra = (r1.half[..., 0] * torch.abs(_dot(u10, L))
              + r1.half[..., 1] * torch.abs(_dot(u11, L)))
        rb = (r2.half[..., 0] * torch.abs(_dot(u20, L))
              + r2.half[..., 1] * torch.abs(_dot(u21, L)))
        seps.append(torch.abs(_dot(t, L)) - (ra + rb))
    max_sep = torch.amax(torch.stack(seps, dim=-1), dim=-1)
    pos = _edge_pairs_min(rect_corners(r1), rect_corners(r2))
    return torch.where(max_sep > 0.0, pos, max_sep)


def _signed_seg_rect(a, b, r: Rectangle):
    """Signed distance spine segment → rectangle: SAT (axes = rect faces +
    segment normal) for the overlap depth, edge distances when disjoint."""
    u0, u1 = _rect_axes(r)
    d = b - a
    n = torch.stack([-d[..., 1], d[..., 0]], dim=-1)
    n = n / torch.clamp(_norm(n, keepdim=True), min=_EPS)
    mid = 0.5 * (a + b)
    half_seg = 0.5 * (b - a)
    t = r.center - mid
    seps = []
    for L in (u0, u1, n):
        rs = torch.abs(_dot(half_seg, L))
        rb = (r.half[..., 0] * torch.abs(_dot(u0, L))
              + r.half[..., 1] * torch.abs(_dot(u1, L)))
        seps.append(torch.abs(_dot(t, L)) - (rs + rb))
    max_sep = torch.amax(torch.stack(seps, dim=-1), dim=-1)
    c = rect_corners(r)
    pos = torch.amin(
        dist_seg_seg_2d(a[..., None, :], b[..., None, :], c, _next_corner(c)),
        dim=-1)
    return torch.where(max_sep > 0.0, pos, max_sep)


def dist_crect_rect(cr: CappedRectangle, r: Rectangle):
    """(ref: prox_crect_rectangle.cpp) — signed spine-rectangle distance
    minus the cap radius."""
    a, b = crect_spine(cr)
    return _signed_seg_rect(a, b, r) - cr.radius


def dist_seg_circle(s: Seg2D, c: Circle):
    return dist_point_seg(c.center, s.a, s.b) - c.radius


# ---------------------------------------------------------------------------
# aggregate proxy-query model (2D)
# ---------------------------------------------------------------------------


class ProxyModel2D(NamedTuple):
    """(ref: proxy_query_model_2D, proxy_query_model.hpp:51-92)"""

    circles: Circle | None = None
    rects: Rectangle | None = None
    crects: CappedRectangle | None = None

    @staticmethod
    def from_shapes(s: ShapeSet2D) -> "ProxyModel2D":
        return ProxyModel2D(circles=s.circles, rects=s.rects, crects=s.crects)


def _pairwise(fn, A, B):
    a = type(A)(*(x[:, None] for x in A))
    b = type(B)(*(x[None, :] for x in B))
    return torch.amin(fn(a, b))


def proxy_query_2d(m1: ProxyModel2D, m2: ProxyModel2D):
    """Min signed distance over all registered cross-pairs of two models —
    one batch (ref: proxy_query_pair_2D::findMinimumDistance); +inf where
    no pair is registered."""
    best = None
    P = [
        (m1.circles, m2.circles, dist_circle_circle),
        (m1.circles, m2.rects, dist_circle_rect),
        (m1.rects, m2.circles, lambda r, c: dist_circle_rect(c, r)),
        (m1.circles, m2.crects, dist_circle_crect),
        (m1.crects, m2.circles, lambda cr, c: dist_circle_crect(c, cr)),
        (m1.rects, m2.rects, dist_rect_rect),
        (m1.crects, m2.crects, dist_crect_crect),
        (m1.crects, m2.rects, dist_crect_rect),
        (m1.rects, m2.crects, lambda r, cr: dist_crect_rect(cr, r)),
    ]
    for A, B, fn in P:
        if A is not None and B is not None:
            d = _pairwise(fn, A, B)
            best = d if best is None else torch.minimum(best, d)
    return _inf_like(m1, m2) if best is None else best
