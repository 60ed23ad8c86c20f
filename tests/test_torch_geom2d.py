"""The port's planar geometry (reak_tpu_torch.geom.shapes2d, proximity2d)
against the JAX package, f64 on the CPU, on the same numpy shapes: every
pair function and primitive ≤1e-12 absolute (all closed forms);
``pose_shapes_2d`` with body −1 as the world frame (fault F15 of the JAX
package); ``proxy_query_2d`` with every pair type it registers; and the
planar 2-link arm's capped rectangles against a circle and a rotated
rectangle, composed as ``planning/workspace.py`` composes a planar chain
(``kte.fk`` → plane angles → ``pose_shapes_2d`` → ``proxy_query_2d``), at
B = 64 under ``torch.func.vmap`` against ``jax.vmap``.  The JAX references
of the pair functions, of ``proxy_query_2d`` and of the composition run
under ``jax.jit`` (closed forms: each compiles in about a second, where op
by op they took up to 5 s); the primitives run op by op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu import kte as jkte
from reak_tpu.geom import proximity2d as jp2, shapes2d as js2
from reak_tpu.kte import models as jmodels
from reak_tpu_torch import convert, kte
from reak_tpu_torch.geom import proximity2d as p2, shapes2d as s2
from reak_tpu_torch.kte import models

torch.set_num_threads(1)
TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want), initial=0.0) <= tol


def _draw(rng, kind, k, spread=1.5):
    c = rng.uniform(-spread, spread, (k, 2))
    ang = rng.uniform(-np.pi, np.pi, k)
    if kind == "circles":
        return js2.Circle(c, rng.uniform(0.1, 0.6, k))
    if kind == "rects":
        return js2.Rectangle(c, ang, rng.uniform(0.1, 0.8, (k, 2)))
    if kind == "crects":
        return js2.CappedRectangle(c, ang, rng.uniform(0.1, 0.8, k),
                                   rng.uniform(0.05, 0.4, k))
    return js2.Seg2D(c, c + rng.uniform(-1.0, 1.0, (k, 2)))


def _pair(rng, kind, k=32, spread=1.5):
    rec = _draw(rng, kind, k, spread)
    j = type(rec)(*(jnp.asarray(f) for f in rec))
    t = type(getattr(s2, type(rec).__name__)(*rec))(
        *(torch.as_tensor(f) for f in rec))
    return j, t


PAIRS = [("dist_circle_circle", "circles", "circles"),
         ("dist_circle_rect", "circles", "rects"),
         ("dist_circle_crect", "circles", "crects"),
         ("dist_rect_rect", "rects", "rects"),
         ("dist_crect_rect", "crects", "rects"),
         ("dist_crect_crect", "crects", "crects"),
         ("dist_seg_circle", "segs", "circles")]


@pytest.mark.parametrize("name,ka,kb", PAIRS, ids=[p[0] for p in PAIRS])
def test_pair_functions(name, ka, kb):
    rng = np.random.default_rng(0)
    ja, ta = _pair(rng, ka)
    jb, tb = _pair(rng, kb)
    got = getattr(p2, name)(ta, tb)
    _close(got, jax.jit(getattr(jp2, name))(ja, jb))
    assert bool((got < 0).any()) and bool((got > 0).any())


def test_primitives():
    rng = np.random.default_rng(1)
    jr, tr = _pair(rng, "rects")
    jc, tc = _pair(rng, "crects")
    p = rng.uniform(-2.0, 2.0, (32, 2))
    seg = rng.uniform(-1.0, 1.0, (4, 32, 2))
    seg[2:, 0] = seg[:2, 0] + [0.0, 0.5]  # parallel segments
    seg[3, 1] = seg[1, 1]  # a shared endpoint
    T, J = torch.as_tensor, jnp.asarray
    _close(p2.sdf_point_rect(T(p), tr), jp2.sdf_point_rect(J(p), jr))
    _close(p2.closest_on_seg_2d(T(p), *T(seg[:2])),
           jp2.closest_on_seg_2d(J(p), *J(seg[:2])))
    _close(p2.dist_point_seg(T(p), *T(seg[:2])),
           jp2.dist_point_seg(J(p), *J(seg[:2])))
    _close(p2.dist_seg_seg_2d(*T(seg)), jp2.dist_seg_seg_2d(*J(seg)))
    _close(s2.rect_corners(tr), js2.rect_corners(jr))
    for g, w in zip(s2.crect_spine(tc), js2.crect_spine(jc)):
        _close(g, w)
    _close(s2.rot2(tr.angle), js2.rot2(jr.angle))
    _close(s2.rot2_apply(tr.angle, T(p)), js2.rot2_apply(jr.angle, J(p)))


def test_reference_cases_on_the_port():
    """tests/test_geom2d.py's closed cases."""
    f = lambda *a: torch.tensor(a, dtype=torch.float64)
    c = lambda x, y, r: s2.Circle(f(x, y), f(r))
    r = lambda x, y, a, hx, hy: s2.Rectangle(f(x, y), f(a), f(hx, hy))
    a = r(0, 0, 0.0, 1, 1)
    assert np.isclose(float(p2.dist_rect_rect(a, r(3, 3, 0.0, 1, 1))),
                      np.sqrt(2.0))
    assert np.isclose(float(p2.dist_rect_rect(a, r(1.5, 0, 0.0, 1, 1))),
                      -0.5)
    assert np.isclose(float(p2.dist_circle_rect(c(2, 0, 0.3),
                                                r(0, 0, np.pi / 2, 1.0,
                                                  0.5))), 1.2)
    cr = s2.CappedRectangle(f(0, 0), f(0.0), f(1.0), f(0.2))
    crossed = s2.CappedRectangle(f(0, 0), f(np.pi / 2), f(1.0), f(0.3))
    assert np.isclose(float(p2.dist_crect_crect(cr, crossed)), -0.5)


def _shape_set(rng):
    recs = {k: _draw(rng, k, 3, 0.3) for k in ("circles", "rects", "crects",
                                               "segs")}
    body = {"circle_body": [0, 1, 1], "rect_body": [1, 0, 1],
            "crect_body": [0, 0, 1], "seg_body": [1, 1, 0]}
    return js2.ShapeSet2D(**recs, **{k: np.array(v) for k, v in body.items()})


def _jax_set(s):
    return js2.ShapeSet2D(*(None if f is None else (
        type(f)(*(jnp.asarray(x) for x in f)) if isinstance(f, tuple)
        else jnp.asarray(f)) for f in s))


def _compare_sets(got, want, skip=()):
    for field, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None)
        if g is None or field.endswith("_body"):
            continue
        for x, y in zip(g, w):
            keep = [i for i in range(x.shape[0]) if (field, i) not in skip]
            _close(x[keep], np.asarray(y)[keep])


def test_pose_shapes_2d_matches_jax():
    rng = np.random.default_rng(2)
    s = _shape_set(rng)
    pos, ang = rng.uniform(-1, 1, (2, 2)), rng.uniform(-np.pi, np.pi, 2)
    got = s2.pose_shapes_2d(convert.shapes2d_from(s, "cpu", torch.float64),
                            torch.as_tensor(pos), torch.as_tensor(ang))
    _compare_sets(got, js2.pose_shapes_2d(_jax_set(s), jnp.asarray(pos),
                                          jnp.asarray(ang)))


def test_pose_shapes_2d_body_minus_one_is_the_world():
    """F15: a shape on body −1 keeps its local pose; the JAX package takes
    the last body's frame there.  The other shapes match the JAX package."""
    rng = np.random.default_rng(3)
    s = _shape_set(rng)._replace(circle_body=np.array([0, -1, 1]),
                                 rect_body=np.array([-1, 0, 1]))
    pos, ang = rng.uniform(-1, 1, (2, 2)), rng.uniform(-np.pi, np.pi, 2)
    ts = convert.shapes2d_from(s, "cpu", torch.float64)
    got = s2.pose_shapes_2d(ts, torch.as_tensor(pos), torch.as_tensor(ang))
    assert torch.equal(got.circles.center[1], ts.circles.center[1])
    assert torch.equal(got.rects.center[0], ts.rects.center[0])
    assert torch.equal(got.rects.angle[0], ts.rects.angle[0])
    want = js2.pose_shapes_2d(_jax_set(s), jnp.asarray(pos), jnp.asarray(ang))
    _compare_sets(got, want, skip={("circles", 1), ("rects", 0)})
    # the JAX package's −1 selects the last body (index 1)
    _close(np.asarray(want.circles.center)[1],
           pos[1] + np.asarray(js2.rot2_apply(
               jnp.asarray(ang[1]), jnp.asarray(s.circles.center[1]))))


REGISTERED = [("circles", "circles"), ("circles", "rects"),
              ("rects", "circles"), ("circles", "crects"),
              ("crects", "circles"), ("rects", "rects"),
              ("crects", "crects"), ("crects", "rects"), ("rects", "crects")]


@pytest.mark.parametrize("ka,kb", REGISTERED,
                         ids=[f"{a}-{b}" for a, b in REGISTERED])
def test_proxy_query_2d_every_pair_type(ka, kb):
    rng = np.random.default_rng(4)
    m1 = jp2.ProxyModel2D(**{ka: _draw(rng, ka, 3, 1.0)})
    m2 = jp2.ProxyModel2D(**{kb: _draw(rng, kb, 4, 1.0)})
    jm = lambda m: jp2.ProxyModel2D(*(None if f is None else type(f)(
        *(jnp.asarray(x) for x in f)) for f in m))
    got = p2.proxy_query_2d(convert.proxy2d_from(m1, "cpu", torch.float64),
                            convert.proxy2d_from(m2, "cpu", torch.float64))
    _close(got, jax.jit(jp2.proxy_query_2d)(jm(m1), jm(m2)))


def test_proxy_query_2d_all_types_at_once_and_none():
    rng = np.random.default_rng(5)
    m1 = jp2.ProxyModel2D(**{k: _draw(rng, k, 2, 1.0)
                             for k in ("circles", "rects", "crects")})
    m2 = jp2.ProxyModel2D(**{k: _draw(rng, k, 3, 1.5)
                             for k in ("circles", "rects", "crects")})
    jm = lambda m: jp2.ProxyModel2D(*(type(f)(*(jnp.asarray(x) for x in f))
                                      for f in m))
    _close(p2.proxy_query_2d(convert.proxy2d_from(m1, "cpu", torch.float64),
                             convert.proxy2d_from(m2, "cpu", torch.float64)),
           jax.jit(jp2.proxy_query_2d)(jm(m1), jm(m2)))
    assert float(p2.proxy_query_2d(p2.ProxyModel2D(),
                                   p2.ProxyModel2D())) == float("inf")


def _planar_scene():
    """tests/test_geom2d.py:172-197's arm and circle, plus a rectangle
    rotated by 0.4 rad."""
    robot = js2.ShapeSet2D(
        crects=js2.CappedRectangle(np.array([[0.2, 0.0], [0.15, 0.0]]),
                                   np.zeros(2), np.array([0.2, 0.15]),
                                   np.array([0.05, 0.05])),
        crect_body=np.array([0, 1]))
    env = jp2.ProxyModel2D(
        circles=js2.Circle(np.array([[0.55, 0.0]]), np.array([0.1])),
        rects=js2.Rectangle(np.array([[-0.3, 0.45]]), np.array([0.4]),
                            np.array([[0.12, 0.06]])))
    return robot, env


def test_planar_chain_composition_batched():
    robot, env = _planar_scene()
    spec, jspec = models.planar_2link(l1=0.4, l2=0.3), \
        jmodels.planar_2link(l1=0.4, l2=0.3)
    t_robot = convert.shapes2d_from(robot, "cpu", torch.float64)
    t_env = convert.proxy2d_from(env, "cpu", torch.float64)
    j_robot = _jax_set(robot)
    j_env = jp2.ProxyModel2D(*(None if f is None else type(f)(
        *(jnp.asarray(x) for x in f)) for f in env))

    def one(q):
        res = kte.fk(spec, q)
        ang = 2.0 * torch.atan2(res.body_quat[:, 3], res.body_quat[:, 0])
        posed = s2.pose_shapes_2d(t_robot, res.body_pos[:, :2], ang)
        return p2.proxy_query_2d(p2.ProxyModel2D.from_shapes(posed), t_env)

    def jone(q):
        res = jkte.fk(jspec, q)
        ang = 2.0 * jnp.arctan2(res.body_quat[:, 3], res.body_quat[:, 0])
        posed = js2.pose_shapes_2d(j_robot, res.body_pos[:, :2], ang)
        return jp2.proxy_query_2d(jp2.ProxyModel2D.from_shapes(posed), j_env)

    q = np.random.default_rng(6).uniform(-np.pi, np.pi, (64, 2))
    got = torch.func.vmap(one)(torch.as_tensor(q))
    _close(got, jax.jit(jax.vmap(jone))(jnp.asarray(q)))
    assert bool((got < 0).any()) and bool((got > 0).any())
