"""The port's SE(2) and SE(3) spaces (``reak_tpu_torch.spaces.se2``,
``se3``) against the JAX package, f64 on the CPU, on the same numpy points
(seed 15): distance, difference, clamp and interpolation of 64 pairs of
every order and of ``FlatSE2Space`` ≤1e-12 relative to max(1, |reference|),
with headings that avoid odd multiples of π.  The settings are the JAX
tests' (tests/test_tangent_spaces.py:121-215,
tests/test_topomaps_se2plan.py:80-113).  F21 (``wrap_angle`` maps −π and 3π
to −π in the JAX package) is held on its own; ``sample`` takes a
``torch.Generator``, so it is held to its ranges.  Each JAX space's methods
run under one ``jax.jit``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.spaces as jsp
import reak_tpu_torch.spaces as sp
from reak_tpu.spaces import se2 as jse2, se3 as jse3
from reak_tpu_torch.spaces import se2, se3

torch.set_num_threads(1)
TOL = 1e-12
K = 64
FRACS = (0.0, 0.3, 0.7, 1.0)

SE2 = {
    "0": dict(pos_lower=[-1.0, -1.0], pos_upper=[1.0, 1.0]),
    "1": dict(pos_lower=[-5.0, -5.0], pos_upper=[5.0, 5.0], max_speed=2.0,
              max_ang_speed=1.0, max_acc=4.0, max_ang_acc=2.0),
    "2": dict(pos_lower=[0.0, 0.0], pos_upper=[1.0, 1.0], max_speed=1.0,
              max_ang_speed=1.0, max_acc=3.0, max_ang_acc=2.0),
    "flat": dict(pos_lower=[0.0, 0.0], pos_upper=[1.0, 1.0], rot_weight=0.1),
}
SE3 = {
    "0": dict(pos_lower=[-1.0] * 3, pos_upper=[1.0] * 3, rot_weight=0.5),
    "1": dict(pos_lower=[-1.0] * 3, pos_upper=[1.0] * 3, max_speed=2.0,
              max_ang_speed=1.0),
    "2": dict(pos_lower=[0.0] * 3, pos_upper=[1.0] * 3, max_speed=1.0,
              max_ang_speed=1.0, max_acc=3.0, max_ang_acc=2.0),
}


def _spaces(kind, order):
    kw = dict((SE2 if kind == "se2" else SE3)[order])
    lo, hi = kw.pop("pos_lower"), kw.pop("pos_upper")
    if order == "flat":
        return (sp.FlatSE2Space(lo, hi, device="cpu", **kw),
                jsp.FlatSE2Space(jnp.asarray(lo), jnp.asarray(hi), **kw))
    make = se2.make_se2_space if kind == "se2" else se3.make_se3_space
    jmake = jse2.make_se2_space if kind == "se2" else jse3.make_se3_space
    return (make(lo, hi, order=int(order), device="cpu", **kw),
            jmake(jnp.asarray(lo), jnp.asarray(hi), order=int(order), **kw))


def _points(rng, kind, order, cfg):
    """Fields of K points in and around the bounds (clamp has work)."""
    lo, hi = np.asarray(cfg["pos_lower"]), np.asarray(cfg["pos_upper"])
    d = lo.shape[0]
    pos = lo + rng.uniform(-0.2, 1.2, (K, d)) * (hi - lo)
    if kind == "se2":
        theta = rng.uniform(-3.0, 3.0, K) * math.pi
        if order == "flat":
            return [np.concatenate([pos, theta[:, None]], axis=1)]
        f = [pos, theta]
        rate = lambda n: rng.uniform(-1.5, 1.5, (K,) + n)
        if order in ("1", "2"):
            f += [cfg["max_speed"] * rate((2,)), cfg["max_ang_speed"] * rate(())]
        if order == "2":
            f += [cfg["max_acc"] * rate((2,)), cfg["max_ang_acc"] * rate(())]
        return f
    q = rng.standard_normal((K, 4)) * rng.uniform(0.5, 2.0, (K, 1))
    f = [pos, q]
    ball = lambda r: r * rng.uniform(-1.0, 1.0, (K, 3))
    if order in ("1", "2"):
        f += [ball(cfg["max_speed"]), ball(cfg["max_ang_speed"])]
    if order == "2":
        f += [ball(cfg["max_acc"]), ball(cfg["max_ang_acc"])]
    return f


def _records(kind, order, fields):
    if order == "flat":
        return torch.as_tensor(fields[0]), jnp.asarray(fields[0])
    mod, jmod = (se2, jse2) if kind == "se2" else (se3, jse3)
    name = {"se2": "SE2Point", "se3": "SE3Point"}[kind] + \
        {"0": "", "1": "1", "2": "2"}[order]
    return (getattr(mod, name)(*map(torch.as_tensor, fields)),
            getattr(jmod, name)(*map(jnp.asarray, fields)))


def _unit(fields, kind):
    """SE(3) points need unit quaternions (clamp gets the raw ones)."""
    if kind == "se3":
        fields = list(fields)
        fields[1] = fields[1] / np.linalg.norm(fields[1], axis=1,
                                               keepdims=True)
    return fields


def _close(got, want, tol=TOL):
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        scale = max(1.0, float(np.max(np.abs(w), initial=0.0)))
        assert float(np.max(np.abs(g - w), initial=0.0)) <= tol * scale


def _methods(space, a, b, p, t_pair):
    out = {"distance": space.distance(a, b),
           "difference": space.difference(a, b), "clamp": space.clamp(p)}
    for t in FRACS:
        out[f"interpolate@{t}"] = space.interpolate(a, b, t)
    if t_pair is not None:
        out["interpolate@pairs"] = space.interpolate(a, b, t_pair)
    return out


@pytest.mark.parametrize("kind,order", [("se2", "0"), ("se2", "1"),
                                        ("se2", "2"), ("se2", "flat"),
                                        ("se3", "0"), ("se3", "1"),
                                        ("se3", "2")])
def test_orders_match_jax(kind, order):
    """Every method of the order on the same 64 pairs.  Per-pair fractions
    are held for SE(2) only: the JAX package's SE(3) interpolation takes a
    number (its slerp broadcasts per-pair fractions against the quaternion
    axis), and the port's per-pair SE(3) interpolation is held to its own
    calls pair by pair."""
    cfg = (SE2 if kind == "se2" else SE3)[order]
    space, jspace = _spaces(kind, order)
    rng = np.random.default_rng(15)
    fa, fb, fp = (_points(rng, kind, order, cfg) for _ in range(3))
    (a, ja), (b, jb) = (_records(kind, order, _unit(f, kind))
                        for f in (fa, fb))
    p, jp = _records(kind, order, fp)
    t_pair = rng.uniform(0.0, 1.0, K)
    per_pair = kind == "se2"
    got = _methods(space, a, b, p, torch.as_tensor(t_pair) if per_pair
                   else None)
    want = jax.jit(lambda a, b, p, t: _methods(jspace, a, b, p, t))(
        ja, jb, jp, jnp.asarray(t_pair) if per_pair else None)
    assert got.keys() == want.keys()
    for key in got:
        _close(got[key], want[key])
    if not per_pair:
        both = space.interpolate(a, b, torch.as_tensor(t_pair))
        for i in (0, 17, 63):
            one = space.interpolate(type(a)(*(f[i] for f in a)),
                                    type(b)(*(f[i] for f in b)),
                                    float(t_pair[i]))
            _close(tuple(f[i] for f in both), tuple(f.numpy() for f in one))


def test_wrap_angle_f21():
    """F21 fixed in the port: (−π, π] holds at ±π and ±3π, where the JAX
    package's round-half-to-even gives −π at −π and 3π; elsewhere the two
    are bit for bit the same."""
    odd = np.array([-math.pi, math.pi, 3 * math.pi, -3 * math.pi])
    got = se2.wrap_angle(torch.as_tensor(odd)).numpy()
    np.testing.assert_allclose(got, math.pi, rtol=1e-15)
    assert np.all(got > -math.pi)
    jax_got = np.asarray(jse2.wrap_angle(jnp.asarray(odd)))
    assert jax_got[0] == jax_got[2] == -math.pi
    x = np.random.default_rng(21).uniform(-20.0, 20.0, 4096)
    assert np.array_equal(se2.wrap_angle(torch.as_tensor(x)).numpy(),
                          np.asarray(jse2.wrap_angle(jnp.asarray(x))))
    # the heading of a pair π apart interpolates from a, through a's side
    flat = sp.FlatSE2Space([0.0, 0.0], [1.0, 1.0], device="cpu")
    a = torch.tensor([0.5, 0.5, 0.5 * math.pi])
    b = torch.tensor([0.5, 0.5, -0.5 * math.pi])
    assert float(flat.difference(a, b)[2]) == pytest.approx(math.pi)
    assert float(flat.clamp(torch.tensor([0.0, 0.0, -math.pi]))[2]) \
        == pytest.approx(math.pi)


def test_factories_dispatch_and_raise():
    for make, classes in ((sp.make_se2_space, (sp.SE2Space,
                                               sp.SE21stOrderSpace,
                                               sp.SE22ndOrderSpace)),
                          (sp.make_se3_space, (sp.SE3Space,
                                               sp.SE31stOrderSpace,
                                               sp.SE32ndOrderSpace))):
        d = 2 if make is sp.make_se2_space else 3
        lim = [{}, dict(max_speed=1.0, max_ang_speed=1.0),
               dict(max_speed=1.0, max_ang_speed=1.0, max_acc=3.0,
                    max_ang_acc=2.0)]
        for order, cls in enumerate(classes):
            s = make(np.zeros(d), np.ones(d), order=order, device="cpu",
                     **lim[order])
            assert type(s) is cls and s.order == order
        with pytest.raises(ValueError, match="unsupported order 3"):
            make(np.zeros(d), np.ones(d), order=3, device="cpu")


def test_samples_in_ranges():
    """Draws from a generator: shapes, the bounds' dtype (the heading too),
    and every field inside its set."""
    gen = torch.Generator().manual_seed(0)
    s2 = sp.SE22ndOrderSpace(np.zeros(2), np.ones(2), 1.0, 1.0, 3.0, 2.0,
                             device="cpu", dtype=torch.float32)
    a = s2.sample(gen, (256,))
    assert all(f.dtype == torch.float32 for f in a)
    assert a.pos.shape == (256, 2) and a.alpha.shape == (256,)
    assert bool(((a.pos >= 0) & (a.pos <= 1)).all())
    assert bool((a.theta.abs() <= math.pi).all())
    assert bool((a.vel.norm(dim=-1) <= 1.0 + 1e-6).all())
    assert bool((a.acc.norm(dim=-1) <= 3.0 + 1e-6).all())
    assert bool((a.omega.abs() <= 1.0).all() & (a.alpha.abs() <= 2.0).all())
    flat = sp.FlatSE2Space(np.zeros(2), np.ones(2), device="cpu")
    f = flat.sample(gen, (256,))
    assert f.shape == (256, 3) and bool((f[:, 2].abs() <= math.pi).all())
    s3 = sp.SE32ndOrderSpace(np.zeros(3), np.ones(3), 1.0, 1.0, 3.0, 2.0,
                             device="cpu")
    b = s3.sample(gen, (256,))
    np.testing.assert_allclose(b.quat.norm(dim=-1).numpy(), 1.0, rtol=1e-14)
    for field, r in ((b.vel, 1.0), (b.omega, 1.0), (b.acc, 3.0),
                     (b.alpha, 2.0)):
        assert bool((field.norm(dim=-1) <= r + 1e-12).all())
