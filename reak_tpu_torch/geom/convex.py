"""Exact convex-pair distances for the "hard" shape pairs (port of
``reak_tpu/geom/convex.py``).

Replacement for the reference's NLP support-function fallback
(ref: geometry/proximity/prox_fundamentals_3D.hpp:57-264
findProximityByGJKEPA / NLP proximity, used for box-box, cylinder-cylinder,
box-cylinder — the pairs with no closed form).

Method: alternating closed-form projections between the two convex sets
(POCS).  Each shape has an exact Euclidean projection operator; iterating
  p ← proj_A(q),  q ← proj_B(p)
converges linearly to a closest-point pair for separated convex sets and to
a common point (distance 0) for intersecting ones.  Fixed iteration counts
(Python loops; ``lax.scan`` in JAX) → ``torch.func.vmap``-friendly; every
step is a handful of elementwise ops.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from reak_tpu_torch.geom.shapes import Box, Capsule, Cylinder, Sphere
from reak_tpu_torch.math import rotations as rot


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


# ---------------------------------------------------------------------------
# exact point projections (world coords)
# ---------------------------------------------------------------------------


def project_sphere(p, s: Sphere):
    d = p - s.center
    n = _norm(d, keepdim=True)
    inside = n[..., 0] <= s.radius
    on_surf = s.center + d / torch.clamp(n, min=1e-12) * s.radius[..., None]
    return torch.where(inside[..., None], p, on_surf)


def project_box(p, b: Box):
    """Clamp in the box frame (ref: prox box support math, re-derived)."""
    local = rot.qrot_inv(b.quat, p - b.center)
    clamped = torch.clamp(local, -b.half_extents, b.half_extents)
    return b.center + rot.qrot(b.quat, clamped)


def project_capsule(p, c: Capsule):
    ab = c.b - c.a
    t = _dot(p - c.a, ab) / torch.clamp(_dot(ab, ab), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    q = c.a + t[..., None] * ab
    d = p - q
    n = _norm(d, keepdim=True)
    inside = n[..., 0] <= c.radius
    on_surf = q + d / torch.clamp(n, min=1e-12) * c.radius[..., None]
    return torch.where(inside[..., None], p, on_surf)


def project_cylinder(p, c: Cylinder):
    """Exact flat-capped cylinder projection (the pair the reference can only
    handle via its NLP fallback).  Returns (projection of the solid, nearest
    boundary point of an interior point)."""
    axis = c.b - c.a
    L = _norm(axis)
    u = axis / torch.clamp(L, min=1e-12)[..., None]
    w = p - c.a
    t = _dot(w, u)                              # axial coordinate ∈ [0, L]
    radial = w - t[..., None] * u
    r = _norm(radial)
    rdir = radial / torch.clamp(r, min=1e-12)[..., None]

    t_cl = torch.clamp(torch.clamp(t, min=0.0), max=L)
    r_cl = torch.minimum(r, c.radius)
    inside = (t >= 0.0) & (t <= L) & (r <= c.radius)
    # nearest boundary for interior points: side wall vs nearer cap
    d_side = c.radius - r
    d_cap = torch.minimum(t, L - t)
    side_pt = c.a + t_cl[..., None] * u + rdir * c.radius[..., None]
    cap_t = torch.where(t < L - t, 0.0, L)
    cap_pt = c.a + cap_t[..., None] * u + rdir * r_cl[..., None]
    interior_proj = torch.where((d_side < d_cap)[..., None], side_pt, cap_pt)
    exterior_proj = c.a + t_cl[..., None] * u + rdir * r_cl[..., None]
    # NOTE: for *set* projection (closest point of the solid), interior
    # points project to themselves
    return torch.where(inside[..., None], p, exterior_proj), interior_proj


def _proj_fn(shape) -> Callable:
    if isinstance(shape, Sphere):
        return lambda p: project_sphere(p, shape)
    if isinstance(shape, Box):
        return lambda p: project_box(p, shape)
    if isinstance(shape, Capsule):
        return lambda p: project_capsule(p, shape)
    if isinstance(shape, Cylinder):
        return lambda p: project_cylinder(p, shape)[0]
    raise TypeError(f"no projection for {type(shape).__name__}")


def _center(shape):
    if isinstance(shape, (Sphere, Box)):
        return shape.center
    if isinstance(shape, (Capsule, Cylinder)):
        return 0.5 * (shape.a + shape.b)
    raise TypeError(f"no center for {type(shape).__name__}")


class PairResult(NamedTuple):
    """(ref: proximity record proximity_record_3D, proximity_finder_3D.hpp:49)"""

    distance: torch.Tensor   # ≥ 0; 0 when intersecting
    point_a: torch.Tensor    # closest point on A
    point_b: torch.Tensor    # closest point on B


def convex_pair(shape_a, shape_b, iters: int = 60) -> PairResult:
    """Closest points between two convex shapes by alternating projection.

    Works for any combination of Sphere/Capsule/Cylinder/Box (the reference
    needs per-pair analytic kernels plus an NLP fallback; one batched
    fixed-point loop covers them all here).  Shapes broadcast over leading
    axes.  Distance is exact at convergence; with the default 60 iterations
    the residual is far below collision-margin scales for separated pairs.
    """
    pa = _proj_fn(shape_a)
    pb = _proj_fn(shape_b)
    p = pa(_center(shape_b))
    q = pb(p)
    for _ in range(iters):
        p = pa(q)
        q = pb(p)
    return PairResult(distance=_norm(p - q), point_a=p, point_b=q)


# ---------------------------------------------------------------------------
# signed distance via support-function minimization (penetration depth)
# ---------------------------------------------------------------------------
#
# For convex A, B with Minkowski difference C = A ⊖ B, the signed distance is
#   sd(A, B) = −min_{|d|=1} h_C(d),   h_C(d) = h_A(d) + h_B(−d),
# where h_S is the support function: positive min ⇒ overlap with penetration
# depth = min (the minimal translation distance), negative min ⇒ separation
# with gap = −min.  This replaces the reference's GJK/EPA fallback
# (prox_fundamentals_3D.hpp:57-264 findProximityByGJKEPA), which returns
# closest/deepest points even in contact — but as one fixed-shape batched
# minimization over the direction sphere instead of an expanding polytope:
# SAT-complete candidate directions (face normals, axes, box edge-crosses)
# seed the search, projected subgradient refines, and the witness support
# points give the deepest-point pair.


def support(shape, d):
    """Support h_S(d) = max_{x∈S} d·x and its witness point.

    ``d`` may carry extra leading axes (e.g. a candidate-direction axis)
    relative to the shape's batch axes.  Returns (h, witness)."""
    if isinstance(shape, Sphere):
        h = _dot(d, shape.center) + shape.radius
        w = shape.center + shape.radius[..., None] * d
        return h, w
    if isinstance(shape, Capsule):
        ha = _dot(d, shape.a)
        hb = _dot(d, shape.b)
        end = torch.where((ha >= hb)[..., None], shape.a + 0.0 * d,
                          shape.b + 0.0 * d)
        h = torch.maximum(ha, hb) + shape.radius
        return h, end + shape.radius[..., None] * d
    if isinstance(shape, Box):
        local = rot.qrot_inv(shape.quat, d)  # box-frame direction
        corner = torch.sign(local) * shape.half_extents
        h = _dot(d, shape.center) + _dot(torch.abs(local), shape.half_extents)
        return h, shape.center + rot.qrot(shape.quat, corner)
    if isinstance(shape, Cylinder):
        axis = shape.b - shape.a
        L = _norm(axis)
        u = axis / torch.clamp(L, min=1e-12)[..., None]
        mid = 0.5 * (shape.a + shape.b)
        ax_c = _dot(d, u)
        d_perp = d - ax_c[..., None] * u
        np_ = _norm(d_perp)
        rdir = d_perp / torch.clamp(np_, min=1e-12)[..., None]
        h = _dot(d, mid) + 0.5 * L * torch.abs(ax_c) + shape.radius * np_
        w = (mid + (0.5 * L * torch.sign(ax_c))[..., None] * u
             + shape.radius[..., None] * rdir)
        return h, w
    raise TypeError(f"no support function for {type(shape).__name__}")


def _face_dirs(shape):
    """SAT-style candidate normals of a shape (list of (..., 3) tensors)."""
    if isinstance(shape, Box):
        eye = torch.eye(3, dtype=shape.center.dtype,
                        device=shape.center.device)
        return [rot.qrot(shape.quat, eye[i]) for i in range(3)]
    if isinstance(shape, (Cylinder, Capsule)):
        axis = shape.b - shape.a
        return [axis / torch.clamp(_norm(axis, keepdim=True), min=1e-12)]
    return []


def _fibonacci_dirs(k: int, like):
    """k roughly-uniform unit directions (constants, made on the host and
    carried to the device and type of ``like``)."""
    i = np.arange(k) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / k)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    dirs = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    )
    return torch.as_tensor(dirs, dtype=like.dtype, device=like.device)


def signed_pair(shape_a, shape_b, n_dirs: int = 64, refine_iters: int = 30
                ) -> PairResult:
    """Signed distance + witness points between two convex shapes.

    Positive = separation gap (matches ``convex_pair``), negative =
    penetration depth (minimal translation distance).  Witness points are the
    closest points when separated, the deepest points when overlapping.
    (ref: findProximityByGJKEPA, prox_fundamentals_3D.hpp:57-264.)
    """
    ca, cb = _center(shape_a), _center(shape_b)
    batch = torch.broadcast_shapes(ca.shape[:-1], cb.shape[:-1])

    def h_and_grad(d):
        hA, wA = support(shape_a, d)
        hB, wB = support(shape_b, -d)
        return hA + hB, wA - wB, (wA, wB)

    # --- seed set: Fibonacci sphere + SAT candidates + center axis ----------
    fib = _fibonacci_dirs(n_dirs, ca)
    seeds = [fib.reshape((n_dirs,) + (1,) * len(batch) + (3,)).expand(
        (n_dirs,) + tuple(batch) + (3,))]
    fa, fb = _face_dirs(shape_a), _face_dirs(shape_b)
    cands = []
    for f in fa + fb:
        cands.extend([f, -f])
    # box-box edge-cross directions complete the SAT set; degenerate
    # (parallel-edge) crosses are replaced by a face normal — a zero vector
    # would spuriously win the argmin with h_C(0) = 0
    if isinstance(shape_a, Box) and isinstance(shape_b, Box):
        for ea in fa:
            for eb in fb:
                cr = rot.cross(ea, eb)
                nrm = _norm(cr, keepdim=True)
                cands.append(torch.where(nrm > 1e-8,
                                         cr / torch.clamp(nrm, min=1e-12),
                                         ea))
    dc = cb - ca
    dcn = _norm(dc, keepdim=True)
    # coincident centers would make this a zero vector (h_C(0) = radii sum,
    # spuriously winning the argmin) — substitute a fixed axis
    ex = torch.zeros_like(dc) + torch.eye(1, 3, dtype=dc.dtype,
                                          device=dc.device)[0]
    cands.append(torch.where(dcn > 1e-8, dc / torch.clamp(dcn, min=1e-12),
                             ex))
    seeds.append(torch.stack([c.expand(tuple(batch) + (3,)) for c in cands]))
    D = torch.cat(seeds, dim=0)  # (K, ..., 3)

    hs, _, _ = h_and_grad(D)  # (K, ...)
    best = torch.argmin(hs, dim=0)
    d = torch.take_along_dim(D, best[None, ..., None], dim=0)[0]  # (..., 3)

    # --- projected subgradient refinement on the sphere ---------------------
    scale = torch.clamp(_norm(dc), min=1e-3)
    h_best, _, _ = h_and_grad(d)
    d_best = d
    for k in range(refine_iters):
        h, g, _ = h_and_grad(d)
        gt = g - _dot(g, d)[..., None] * d
        eta = 0.5 * (0.8 ** k) / scale
        d_new = d - eta[..., None] * gt
        d_new = d_new / torch.clamp(_norm(d_new, keepdim=True), min=1e-12)
        better = h < h_best
        h_best = torch.where(better, h, h_best)
        d_best = torch.where(better[..., None], d, d_best)
        d = d_new
    h_fin, _, (wA, wB) = h_and_grad(d_best)
    h_best = torch.where(h_fin < h_best, h_fin, h_best)

    # positive branch: POCS closest points are exact — keep them
    pocs = convex_pair(shape_a, shape_b)
    separated = pocs.distance > 1e-6
    dist = torch.where(separated, pocs.distance, -h_best)
    pa = torch.where(separated[..., None], pocs.point_a, wA)
    pb = torch.where(separated[..., None], pocs.point_b, wB)
    return PairResult(distance=dist, point_a=pa, point_b=pb)


def dist_box_box(b1: Box, b2: Box, iters: int = 60):
    """Signed box-box distance: exact SAT on overlap, POCS when separated
    (ref: prox_box_box fallback via NLP/EPA, prox_fundamentals_3D.hpp:57).
    ``iters`` is accepted for the JAX package's signature; the solver runs
    ``signed_pair``'s defaults."""
    return signed_pair(b1, b2).distance


def dist_cylinder_cylinder(c1: Cylinder, c2: Cylinder, iters: int = 60):
    """(ref: prox_cylinder_cylinder.hpp — exact flat caps, not the capsule
    approximation).  Signed: negative depth on overlap.  ``iters`` as in
    ``dist_box_box``."""
    return signed_pair(c1, c2).distance


def dist_cylinder_box(c: Cylinder, b: Box, iters: int = 60):
    """(ref: prox_cylinder_box.hpp)  Signed: negative depth on overlap.
    ``iters`` as in ``dist_box_box``."""
    return signed_pair(c, b).distance
