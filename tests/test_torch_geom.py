"""The port's 3-D geometry (reak_tpu_torch.geom: shapes, convex,
proximity) against the JAX package, f64 on the CPU, on the same numpy
shapes: the projections, support functions and closed-form pair distances
≤1e-12 absolute; the iterative pairs (``convex_pair``, ``signed_pair`` and
the pairs that run it) ≤1e-10; ``pose_shapes`` and ``proxy_query`` with
every pair type it registers; the planner's scene (the 6-DoF CRS-A465
``manip_3r3r`` with its chain capsules against a sphere and the floor,
``examples/run_crs_planner.py``) composed as ``planning/workspace.py``
composes it, ``kte.fk`` → ``pose_shapes`` → ``proxy_query``, at B = 64
under ``torch.func.vmap`` against ``jax.vmap``.  Body index −1 is the world
frame in the port (fault F15 of the JAX package, where it selects the last
body).  The JAX functions run op by op, but the composition (FK of a
6-joint chain and two closed-form pairs, under ``jax.jit``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu import kte as jkte
from reak_tpu.geom import convex as jconvex, proximity as jprox
from reak_tpu.geom import shapes as jshapes
from reak_tpu.kte import models as jmodels
from reak_tpu_torch import convert, kte
from reak_tpu_torch.geom import convex, proximity as prox, shapes
from reak_tpu_torch.kte import models

torch.set_num_threads(1)
CLOSED, ITERATIVE = 1e-12, 1e-10


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want), initial=0.0) <= tol


def _quats(rng, k):
    q = rng.standard_normal((k, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _draw(rng, kind, k, spread=1.5, shift=0.0):
    """k random shapes of one kind as numpy fields, their positions shifted
    by ``shift`` along x."""
    c = lambda: rng.uniform(-spread, spread, (k, 3)) + [shift, 0.0, 0.0]
    r = lambda: rng.uniform(0.1, 0.6, k)
    if kind == "spheres":
        return jshapes.Sphere(c(), r())
    if kind in ("capsules", "cylinders"):
        a = c()
        cls = jshapes.Capsule if kind == "capsules" else jshapes.Cylinder
        return cls(a, a + rng.uniform(-1.0, 1.0, (k, 3)), r())
    if kind == "boxes":
        return jshapes.Box(c(), _quats(rng, k), rng.uniform(0.1, 0.8, (k, 3)))
    n = rng.standard_normal((k, 3))
    return jshapes.Plane(n / np.linalg.norm(n, axis=1, keepdims=True),
                         rng.uniform(-0.5, 0.5, k))


def _pair(rng, kind, k=24, spread=1.5, shift=0.0):
    """(JAX record, port record) of k random shapes."""
    rec = _draw(rng, kind, k, spread, shift)
    j = type(rec)(*(jnp.asarray(f) for f in rec))
    t = convert.proxy_from(jprox.ProxyModel(**{kind: rec}), "cpu",
                           torch.float64)
    return j, getattr(t, kind)


@pytest.mark.parametrize("kind", ["spheres", "capsules", "boxes",
                                  "cylinders"])
def test_projections(kind):
    rng = np.random.default_rng(0)
    js, ts = _pair(rng, kind)
    p = rng.uniform(-2.5, 2.5, (24, 3))
    if kind == "cylinders":
        for got, want in zip(convex.project_cylinder(torch.as_tensor(p), ts),
                             jconvex.project_cylinder(jnp.asarray(p), js)):
            _close(got, want, CLOSED)
    else:
        name = {"spheres": "project_sphere", "capsules": "project_capsule",
                "boxes": "project_box"}[kind]
        _close(getattr(convex, name)(torch.as_tensor(p), ts),
               getattr(jconvex, name)(jnp.asarray(p), js), CLOSED)


@pytest.mark.parametrize("kind", ["spheres", "capsules", "boxes",
                                  "cylinders"])
def test_support(kind):
    """Support values and witnesses, with an extra leading direction axis
    as ``signed_pair``'s seeds carry."""
    rng = np.random.default_rng(1)
    js, ts = _pair(rng, kind)
    d = rng.standard_normal((5, 24, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for got, want in zip(convex.support(ts, torch.as_tensor(d)),
                         jconvex.support(js, jnp.asarray(d))):
        _close(got, want, CLOSED)


CLOSED_PAIRS = [
    ("dist_sphere_sphere", "spheres", "spheres"),
    ("dist_sphere_capsule", "spheres", "capsules"),
    ("dist_sphere_box", "spheres", "boxes"),
    ("dist_sphere_plane", "spheres", "planes"),
    ("dist_capsule_capsule", "capsules", "capsules"),
    ("dist_capsule_plane", "capsules", "planes"),
    ("dist_box_plane", "boxes", "planes"),
    ("dist_sphere_cylinder", "spheres", "cylinders"),
    ("dist_cylinder_plane", "cylinders", "planes"),
]


@pytest.mark.parametrize("name,ka,kb", CLOSED_PAIRS,
                         ids=[c[0] for c in CLOSED_PAIRS])
def test_closed_form_pairs(name, ka, kb):
    rng = np.random.default_rng(2)
    ja, ta = _pair(rng, ka)
    jb, tb = _pair(rng, kb)
    got = getattr(prox, name)(ta, tb)
    _close(got, getattr(jprox, name)(ja, jb), CLOSED)
    assert bool((got < 0).any()) and bool((got > 0).any())


def test_point_and_segment_functions():
    rng = np.random.default_rng(3)
    jb, tb = _pair(rng, "boxes")
    jc, tc = _pair(rng, "cylinders")
    p = rng.uniform(-2.0, 2.0, (24, 3))
    _close(prox.dist_point_box(torch.as_tensor(p), tb),
           jprox.dist_point_box(jnp.asarray(p), jb), CLOSED)
    _close(prox.dist_point_cylinder(torch.as_tensor(p), tc),
           jprox.dist_point_cylinder(jnp.asarray(p), jc), CLOSED)
    seg = rng.uniform(-1.0, 1.0, (4, 24, 3))
    seg[:, :3] = seg[:, :1]  # degenerate segments (points)
    seg[1, 5] = seg[0, 5] + 1e-14  # and a parallel-ish pair below
    seg[3, 6] = seg[2, 6] + (seg[1, 6] - seg[0, 6])
    _close(prox.dist_segment_segment(*torch.as_tensor(seg)),
           jprox.dist_segment_segment(*jnp.asarray(seg)), CLOSED)


ITERATIVE_PAIRS = [
    ("dist_capsule_box", "capsules", "boxes"),
    ("dist_box_box", "boxes", "boxes"),
    ("dist_cylinder_cylinder", "cylinders", "cylinders"),
    ("dist_cylinder_box", "cylinders", "boxes"),
    ("dist_cylinder_capsule", "cylinders", "capsules"),
]


@pytest.mark.parametrize("name,ka,kb", ITERATIVE_PAIRS,
                         ids=[c[0] for c in ITERATIVE_PAIRS])
def test_iterative_pairs(name, ka, kb):
    """Overlapping and separated pairs (centres within ±0.8), through the
    proximity functions; ``convex`` exports the box and cylinder ones too.
    A separated pair's distance is the POCS closest-point distance, a
    contraction: ≤1e-10.  An overlapping pair's depth comes from a
    subgradient search seeded at the SAT face normals, where a box's
    support witness is the sign of a rounding residue: the direction it
    refines along, and so its depth after 30 steps, is decided by rounding
    (the JAX package itself gives other depths under ``jax.jit`` than op
    by op on the same boxes).  There the port is held to the sign and to
    1e-2."""
    rng = np.random.default_rng(4)
    ja, ta = _pair(rng, ka, k=24, spread=0.8)
    jb, tb = _pair(rng, kb, k=24, spread=0.8)
    got = getattr(prox, name)(ta, tb).numpy()
    want = np.asarray(getattr(jprox, name)(ja, jb))
    sep = want > 1e-6
    assert sep.any() and (~sep).any()
    _close(got[sep], want[sep], ITERATIVE)
    assert np.all(got[~sep] <= 1e-6)
    _close(got[~sep], want[~sep], 1e-2)
    if hasattr(convex, name):
        assert np.array_equal(getattr(convex, name)(ta, tb).numpy(), got)


@pytest.mark.parametrize("ka,kb", [("boxes", "boxes"),
                                   ("spheres", "cylinders"),
                                   ("capsules", "boxes"),
                                   ("cylinders", "capsules")])
def test_convex_and_signed_pair(ka, kb):
    """Distances and witness points of ``convex_pair`` (overlapping and
    separated pairs: the alternating projections contract) and of
    ``signed_pair`` on separated pairs (B's centres 4 further along x)."""
    rng = np.random.default_rng(5)
    ja, ta = _pair(rng, ka, k=12, spread=0.8)
    jb, tb = _pair(rng, kb, k=12, spread=0.8)
    for got, want in zip(convex.convex_pair(ta, tb, iters=40),
                         jconvex.convex_pair(ja, jb, iters=40)):
        _close(got, want, ITERATIVE)
    ja, ta = _pair(rng, ka, k=12, spread=0.8)
    jb, tb = _pair(rng, kb, k=12, spread=0.8, shift=4.0)
    got = convex.signed_pair(ta, tb)
    assert bool((got.distance > 1e-6).all())
    for g, w in zip(got, jconvex.signed_pair(ja, jb)):
        _close(g, w, ITERATIVE)


def test_exact_cases_of_the_reference_tests():
    """tests/test_convex_prox.py's closed cases on the port."""
    f64 = torch.float64
    box = lambda c, h, q=(1.0, 0, 0, 0): shapes.Box(
        torch.tensor(c, dtype=f64), torch.tensor(q, dtype=f64),
        torch.tensor(h, dtype=f64))
    assert abs(float(convex.dist_box_box(box([0.0, 0, 0], [1.0, 1, 1]),
                                         box([4.0, 0, 0], [1.0, 1, 1])))
               - 2.0) < 1e-9
    b1, b2 = box([0.0, 0, 0], [1.0, 0.8, 0.6]), box([1.3, 0.2, 0.1],
                                                     [0.7, 0.9, 0.5])
    assert abs(float(convex.signed_pair(b1, b2).distance) + 0.4) < 1e-6
    cyl = lambda a, b, r: shapes.Cylinder(torch.tensor(a, dtype=f64),
                                          torch.tensor(b, dtype=f64),
                                          torch.tensor(r, dtype=f64))
    c1, c2 = cyl([0.0, 0, 0], [0.0, 0, 1], 0.5), cyl([0.0, 0, 3], [0.0, 0, 4],
                                                     0.5)
    assert abs(float(convex.dist_cylinder_cylinder(c1, c2)) - 2.0) < 1e-6
    assert abs(float(prox.dist_capsule_capsule(c1.as_capsule, c2.as_capsule))
               - 1.0) < 1e-9


def _shape_set(rng):
    """Spheres, capsules, boxes and cylinders on bodies 0…5 of a chain."""
    recs = {k: _draw(rng, k, 3, 0.2) for k in ("spheres", "capsules",
                                               "boxes", "cylinders")}
    body = {"spheres": [0, 2, 5], "capsules": [1, 3, 4], "boxes": [5, 0, 2],
            "cylinders": [3, 3, 1]}
    return jshapes.ShapeSet(**recs, **{f"{k[:-1] if k != 'boxes' else 'box'}"
                                       f"_body": np.array(v)
                                       for k, v in body.items()})


def _frames(rng, nb=6):
    return rng.uniform(-1.0, 1.0, (nb, 3)), _quats(rng, nb)


def test_pose_shapes_matches_jax():
    rng = np.random.default_rng(6)
    s = _shape_set(rng)
    pos, quat = _frames(rng)
    got = shapes.pose_shapes(convert.shapes_from(s, "cpu", torch.float64),
                             torch.as_tensor(pos), torch.as_tensor(quat))
    want = jshapes.pose_shapes(
        jshapes.ShapeSet(*(None if f is None else jax.tree_util.tree_map(
            jnp.asarray, f) for f in s)), jnp.asarray(pos), jnp.asarray(quat))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                _close(a, b, CLOSED)


def test_pose_shapes_body_minus_one_is_the_world():
    """F15: a shape on body −1 keeps its local pose (the world frame), where
    the JAX package takes the last body's frame; the other shapes are posed
    as the JAX package poses them."""
    rng = np.random.default_rng(7)
    s = _shape_set(rng)._replace(sphere_body=np.array([0, -1, 5]),
                                 box_body=np.array([-1, 0, 2]))
    pos, quat = _frames(rng)
    ts = convert.shapes_from(s, "cpu", torch.float64)
    got = shapes.pose_shapes(ts, torch.as_tensor(pos), torch.as_tensor(quat))
    assert torch.equal(got.spheres.center[1], ts.spheres.center[1])
    assert torch.equal(got.boxes.center[0], ts.boxes.center[0])
    assert torch.equal(got.boxes.quat[0], ts.boxes.quat[0])
    want = jshapes.pose_shapes(
        jshapes.ShapeSet(*(None if f is None else jax.tree_util.tree_map(
            jnp.asarray, f) for f in s)), jnp.asarray(pos), jnp.asarray(quat))
    _close(got.spheres.center[[0, 2]], np.asarray(want.spheres.center)[[0, 2]],
           CLOSED)
    _close(got.boxes.center[1:], np.asarray(want.boxes.center)[1:], CLOSED)
    # the JAX package's −1 is the last body: the same as index 5
    _close(np.asarray(want.spheres.center)[1],
           pos[5] + np.asarray(jnp.asarray(jax.numpy.zeros(3)))
           + np.asarray(__import__("reak_tpu.math.rotations", fromlist=["x"])
                        .qrot(jnp.asarray(quat[5]),
                              jnp.asarray(s.spheres.center[1]))), CLOSED)


SIGNED_PAIR_TYPES = {frozenset(p) for p in (
    ("capsules", "boxes"), ("boxes",), ("cylinders",),
    ("cylinders", "boxes"), ("cylinders", "capsules"))}
KINDS_1 = ("spheres", "capsules", "boxes", "cylinders")
KINDS_2 = ("spheres", "capsules", "boxes", "planes", "cylinders")
REGISTERED = [(a, b) for a in KINDS_1 for b in KINDS_2
              if (a, b) not in (("spheres", "cylinders"),)] + [
                  ("spheres", "cylinders")]


@pytest.mark.parametrize("ka,kb", REGISTERED,
                         ids=[f"{a}-{b}" for a, b in REGISTERED])
def test_proxy_query_every_pair_type(ka, kb):
    """Each pair type that ``proxy_query`` registers, alone in two models
    (2 × 3 shapes), against the JAX package: ≤1e-10, or where the minimum
    is an overlap of a pair that ``signed_pair`` measures, the sign and
    1e-2 (``test_iterative_pairs``)."""
    rng = np.random.default_rng(8)
    m1 = jprox.ProxyModel(**{ka: _draw(rng, ka, 2, 1.0)})
    m2 = jprox.ProxyModel(**{kb: _draw(rng, kb, 3, 1.0)})
    jm = lambda m: jprox.ProxyModel(*(None if f is None else type(f)(
        *(jnp.asarray(x) for x in f)) for f in m))
    got = prox.proxy_query(convert.proxy_from(m1, "cpu", torch.float64),
                           convert.proxy_from(m2, "cpu", torch.float64))
    want = float(jprox.proxy_query(jm(m1), jm(m2)))
    if want <= 1e-6 and frozenset((ka, kb)) in SIGNED_PAIR_TYPES:
        assert float(got) <= 1e-6
        _close(got, want, 1e-2)
    else:
        _close(got, want, ITERATIVE)


def test_proxy_query_no_pair_is_inf():
    m = prox.ProxyModel(planes=shapes.Plane(torch.zeros(1, 3),
                                            torch.zeros(1)))
    assert float(prox.proxy_query(m, m)) == float("inf")


def _crs_scene(jax_side):
    """examples/run_crs_planner.py:47-75: chain capsules r = 0.05 on
    manip_3r3r, the sphere obstacle and the floor plane."""
    spec = jmodels.manip_3r3r()
    n = len(spec.joint_types)
    offs = np.asarray(spec.offsets_pos, float)
    ends = np.vstack([offs[1:], [[0.0, 0.0, 0.06]]])
    robot = jshapes.ShapeSet(capsules=jshapes.Capsule(
        np.zeros((n, 3)), ends, np.full(n, 0.05)), capsule_body=np.arange(n))
    env = jprox.ProxyModel(
        spheres=jshapes.Sphere(np.array([[0.35, 0.0, 0.55]]),
                               np.array([0.18])),
        planes=jshapes.Plane(np.array([[0.0, 0.0, 1.0]]), np.array([-0.12])))
    if jax_side:
        j = lambda m: type(m)(*(None if f is None else (
            type(f)(*(jnp.asarray(x) for x in f)) if isinstance(f, tuple)
            else jnp.asarray(f)) for f in m))
        return spec, j(robot), j(env)
    return (models.manip_3r3r(), convert.shapes_from(robot, "cpu",
                                                     torch.float64),
            convert.proxy_from(env, "cpu", torch.float64))


def test_crs_scene_composition_batched():
    """The planner's clearance of scene A at 64 configurations ~ U(±2.8)⁶
    (the scene's space bounds), one vmap over q, closing over the shapes."""
    q = np.random.default_rng(9).uniform(-2.8, 2.8, (64, 6))
    spec, robot, env = _crs_scene(False)
    jspec, jrobot, jenv = _crs_scene(True)

    def one(q):
        res = kte.fk(spec, q)
        posed = shapes.pose_shapes(robot, res.body_pos, res.body_quat)
        return prox.proxy_query(prox.ProxyModel(capsules=posed.capsules), env)

    def jone(q):
        res = jkte.fk(jspec, q)
        posed = jshapes.pose_shapes(jrobot, res.body_pos, res.body_quat)
        return jprox.proxy_query(jprox.ProxyModel(capsules=posed.capsules),
                                 jenv)

    got = torch.func.vmap(one)(torch.as_tensor(q))
    want = jax.jit(jax.vmap(jone))(jnp.asarray(q))
    _close(got, want, CLOSED)
    assert bool((got < 0).any()) and bool((got > 0).any())
