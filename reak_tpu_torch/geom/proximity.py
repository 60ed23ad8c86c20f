"""Pairwise distance functions + aggregate proxy-query dispatch, batched
(port of ``reak_tpu/geom/proximity.py``).

(ref: geometry/proximity/prox_sphere_sphere.cpp, prox_sphere_box.cpp,
prox_ccylinder_ccylinder.cpp, prox_plane_*.cpp, … — ~20 pair TUs; NLP
fallback for the hard convex pairs prox_fundamentals_3D.hpp:57-264;
aggregate dispatch proxy_query_model.hpp:51-196)

ALL pair functions return SIGNED distance (negative = penetration depth).
The "hard" convex pairs (box-box, cylinder-anything, capsule-box) dispatch
to :func:`reak_tpu_torch.geom.convex.signed_pair`: alternating-projection
closest points when separated, SAT-seeded support-function minimization for
the penetration depth on overlap.  Everything broadcasts over leading batch
axes; ``proxy_query`` evaluates ALL registered pairs of two ProxyModels in
one batch (nested ``torch.func.vmap`` over the two shape lists) — the
planner collision inner loop.  Plain torch, no kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reak_tpu_torch.geom.convex import _dot, _norm, signed_pair
from reak_tpu_torch.geom.shapes import Box, Capsule, Cylinder, Plane, Sphere
from reak_tpu_torch.math import rotations as rot


# ---------------------------------------------------------------------------
# point / segment primitives
# ---------------------------------------------------------------------------


def _closest_on_segment(p, a, b):
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-30)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def dist_segment_segment(a0, a1, b0, b1):
    """Min distance between segments (the core of the reference's
    ccylinder-ccylinder kernel, prox_ccylinder_ccylinder.cpp)."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-30),
                                0.0, 1.0), 0.0)
    t = (b * s + f) / torch.clamp(e, min=1e-30)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / torch.clamp(a, min=1e-30), 0.0, 1.0)
    p1 = a0 + s[..., None] * d1
    p2 = b0 + t_cl[..., None] * d2
    return _norm(p1 - p2)


def dist_point_box(p, box: Box):
    """Signed distance point↔oriented box (ref: prox_*_box kernels)."""
    local = rot.qrot_inv(box.quat, p - box.center)
    d = torch.abs(local) - box.half_extents
    outside = _norm(torch.clamp(d, min=0.0))
    inside = torch.clamp(torch.amax(d, dim=-1), max=0.0)
    return outside + inside


# ---------------------------------------------------------------------------
# pair functions (signed distances)
# ---------------------------------------------------------------------------


def dist_sphere_sphere(s1: Sphere, s2: Sphere):
    """(ref: prox_sphere_sphere.cpp)"""
    return _norm(s1.center - s2.center) - s1.radius - s2.radius


def dist_sphere_capsule(s: Sphere, c: Capsule):
    """(ref: prox_sphere_ccylinder.cpp)"""
    q = _closest_on_segment(s.center, c.a, c.b)
    return _norm(s.center - q) - s.radius - c.radius


def dist_sphere_box(s: Sphere, b: Box):
    """(ref: prox_sphere_box.cpp)"""
    return dist_point_box(s.center, b) - s.radius


def dist_sphere_plane(s: Sphere, p: Plane):
    """(ref: prox_plane_sphere.cpp) — signed: below the plane is negative."""
    return _dot(s.center, p.normal) - p.offset - s.radius


def dist_capsule_capsule(c1: Capsule, c2: Capsule):
    """(ref: prox_ccylinder_ccylinder.cpp)"""
    return dist_segment_segment(c1.a, c1.b, c2.a, c2.b) - c1.radius - c2.radius


def dist_capsule_plane(c: Capsule, p: Plane):
    """(ref: prox_plane_ccylinder.cpp)"""
    da = _dot(c.a, p.normal) - p.offset
    db = _dot(c.b, p.normal) - p.offset
    return torch.minimum(da, db) - c.radius


def dist_capsule_box(c: Capsule, b: Box, iters: int = 60):
    """Exact capsule↔box via the convex solver (the reference's pair needs an
    iterative NLP fallback, prox_fundamentals_3D.hpp:57).  Signed: POCS
    closest points when separated, −penetration depth on overlap.
    ``iters`` is accepted for the JAX package's signature; the solver runs
    ``signed_pair``'s defaults."""
    return signed_pair(c, b).distance


def dist_box_plane(b: Box, p: Plane):
    """(ref: prox_plane_box — support point of the box along -n)"""
    R = rot.q_to_matrix(b.quat)
    # projection radius of the box onto the plane normal
    r = torch.sum(torch.abs(torch.einsum("...ij,...i->...j", R, p.normal))
                  * b.half_extents, dim=-1)
    dc = _dot(b.center, p.normal) - p.offset
    return dc - r


def dist_box_box(b1: Box, b2: Box, iters: int = 60):
    """Signed box↔box: SAT-seeded support minimization on overlap, POCS when
    separated (ref: NLP/EPA fallback, prox_fundamentals_3D.hpp:57-264).
    ``iters`` as in ``dist_capsule_box``."""
    return signed_pair(b1, b2).distance


def dist_point_cylinder(p, c: Cylinder):
    """Signed distance point ↔ solid flat-capped cylinder."""
    axis = c.b - c.a
    L = _norm(axis)
    u = axis / torch.clamp(L, min=1e-12)[..., None]
    w = p - c.a
    t = _dot(w, u)
    radial = w - t[..., None] * u
    r = _norm(radial)
    dr = r - c.radius  # >0 outside the side wall
    dt = torch.maximum(-t, t - L)  # >0 beyond a cap
    outside = _norm(torch.stack([torch.clamp(dr, min=0.0),
                                 torch.clamp(dt, min=0.0)], dim=-1))
    inside = torch.clamp(torch.maximum(dr, dt), max=0.0)
    return outside + inside


def dist_sphere_cylinder(s: Sphere, c: Cylinder):
    """(ref: prox_sphere_cylinder.cpp — exact flat caps)"""
    return dist_point_cylinder(s.center, c) - s.radius


def dist_cylinder_plane(c: Cylinder, p: Plane):
    """Signed distance cylinder ↔ plane: support of the nearer cap rim along
    −n (ref: prox_plane_cylinder.cpp)."""
    axis = c.b - c.a
    L = _norm(axis)
    u = axis / torch.clamp(L, min=1e-12)[..., None]
    cosn = _dot(u, p.normal)
    rim_drop = c.radius * torch.sqrt(torch.clamp(1.0 - cosn * cosn, min=0.0))
    da = _dot(c.a, p.normal) - p.offset - rim_drop
    db = _dot(c.b, p.normal) - p.offset - rim_drop
    return torch.minimum(da, db)


def dist_cylinder_cylinder(c1: Cylinder, c2: Cylinder, iters: int = 60):
    """(ref: prox_cylinder_cylinder — exact flat caps).  Signed.  ``iters``
    as in ``dist_capsule_box``."""
    return signed_pair(c1, c2).distance


def dist_cylinder_box(c: Cylinder, b: Box, iters: int = 60):
    """(ref: prox_cylinder_box via NLP fallback).  Signed.  ``iters`` as in
    ``dist_capsule_box``."""
    return signed_pair(c, b).distance


def dist_cylinder_capsule(c: Cylinder, cap: Capsule, iters: int = 60):
    """Exact cylinder↔capsule via the convex solver.  Signed.  ``iters`` as
    in ``dist_capsule_box``."""
    return signed_pair(c, cap).distance


# ---------------------------------------------------------------------------
# aggregate proxy-query models
# ---------------------------------------------------------------------------


class ProxyModel(NamedTuple):
    """World-posed shape aggregate (ref: proxy_query_model_3D,
    proxy_query_model.hpp:92)."""

    spheres: Optional[Sphere] = None  # batched (ns, …)
    capsules: Optional[Capsule] = None  # (nc, …)
    boxes: Optional[Box] = None  # (nb, …)
    planes: Optional[Plane] = None  # (np, …)
    cylinders: Optional[Cylinder] = None  # (ncy, …)


def _pairwise(fn, A, B):
    """All-pairs evaluation: A batched (n,…), B batched (m,…) → (n, m)."""
    vmap = torch.func.vmap
    return vmap(lambda a: vmap(lambda b: fn(a, b))(B))(A)


def _inf_like(*models):
    """+inf in the type and on the device of the models' first tensor
    (float64 on the CPU when they hold none)."""
    for m in models:
        for shape in m:
            if shape is not None:
                return shape[0].new_full((), torch.inf)
    return torch.tensor(torch.inf, dtype=torch.float64)


def proxy_query(m1: ProxyModel, m2: ProxyModel):
    """Minimum signed distance between two shape aggregates, evaluating every
    registered pair function in batch (ref:
    proxy_query_pair_3D::findMinimumDistance, proxy_query_model.hpp:155);
    +inf where no pair is registered."""
    dists = []

    def add(d):
        dists.append(torch.amin(d))

    if m1.spheres is not None and m2.spheres is not None:
        add(_pairwise(dist_sphere_sphere, m1.spheres, m2.spheres))
    if m1.spheres is not None and m2.capsules is not None:
        add(_pairwise(dist_sphere_capsule, m1.spheres, m2.capsules))
    if m1.capsules is not None and m2.spheres is not None:
        add(_pairwise(lambda c, s: dist_sphere_capsule(s, c), m1.capsules,
                      m2.spheres))
    if m1.spheres is not None and m2.boxes is not None:
        add(_pairwise(dist_sphere_box, m1.spheres, m2.boxes))
    if m1.boxes is not None and m2.spheres is not None:
        add(_pairwise(lambda b, s: dist_sphere_box(s, b), m1.boxes,
                      m2.spheres))
    if m1.capsules is not None and m2.capsules is not None:
        add(_pairwise(dist_capsule_capsule, m1.capsules, m2.capsules))
    if m1.capsules is not None and m2.boxes is not None:
        add(_pairwise(dist_capsule_box, m1.capsules, m2.boxes))
    if m1.boxes is not None and m2.capsules is not None:
        add(_pairwise(lambda b, c: dist_capsule_box(c, b), m1.boxes,
                      m2.capsules))
    if m1.boxes is not None and m2.boxes is not None:
        add(_pairwise(dist_box_box, m1.boxes, m2.boxes))
    if m1.spheres is not None and m2.planes is not None:
        add(_pairwise(dist_sphere_plane, m1.spheres, m2.planes))
    if m1.capsules is not None and m2.planes is not None:
        add(_pairwise(dist_capsule_plane, m1.capsules, m2.planes))
    if m1.boxes is not None and m2.planes is not None:
        add(_pairwise(dist_box_plane, m1.boxes, m2.planes))
    # exact flat-capped cylinder pairs (ref handles these via its NLP
    # fallback; here: closed forms + the alternating-projection solver)
    if m1.cylinders is not None and m2.spheres is not None:
        add(_pairwise(lambda c, s: dist_sphere_cylinder(s, c), m1.cylinders,
                      m2.spheres))
    if m1.spheres is not None and m2.cylinders is not None:
        add(_pairwise(dist_sphere_cylinder, m1.spheres, m2.cylinders))
    if m1.cylinders is not None and m2.capsules is not None:
        add(_pairwise(dist_cylinder_capsule, m1.cylinders, m2.capsules))
    if m1.capsules is not None and m2.cylinders is not None:
        add(_pairwise(lambda cp, cy: dist_cylinder_capsule(cy, cp),
                      m1.capsules, m2.cylinders))
    if m1.cylinders is not None and m2.boxes is not None:
        add(_pairwise(dist_cylinder_box, m1.cylinders, m2.boxes))
    if m1.boxes is not None and m2.cylinders is not None:
        add(_pairwise(lambda b, cy: dist_cylinder_box(cy, b), m1.boxes,
                      m2.cylinders))
    if m1.cylinders is not None and m2.cylinders is not None:
        add(_pairwise(dist_cylinder_cylinder, m1.cylinders, m2.cylinders))
    if m1.cylinders is not None and m2.planes is not None:
        add(_pairwise(dist_cylinder_plane, m1.cylinders, m2.planes))
    if not dists:
        return _inf_like(m1, m2)
    return torch.amin(torch.stack(dists))
