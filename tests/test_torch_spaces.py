"""The port's spaces (reak_tpu_torch.spaces: base, vector, so3, temporal,
rate_limited, interpolated, tangent) against the JAX package, f64 on the
CPU, on the same numpy points (seed 9): distance, interpolate, clamp,
difference and the mappings ≤1e-12 relative to max(1, |reference|), the
SAP-based 2nd-order bundle ≤1e-10 (72 bisection steps).  ``sample`` takes
a ``torch.Generator`` where JAX takes a key, so it is held to its ranges
and to the same draws from the same seed.  Each JAX reference is computed
once in a module fixture, each space's under one ``jax.jit``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.spaces as jsp
from reak_tpu.spaces import rate_limited as jrl, temporal as jtemp
import reak_tpu_torch.spaces as sp
from reak_tpu_torch.spaces import rate_limited as rl, temporal as temp

torch.set_num_threads(1)
TOL, SAP = 1e-12, 1e-10
B, N = 32, 6
LO, HI = -2.8 * np.ones(N), 2.8 * np.ones(N)
SPEED = np.full(N, 1.5)
ACCEL = 2.0 * SPEED


def _close(got, want, tol=TOL):
    got = jax.tree.leaves(jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, got,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype == bool:
            assert np.array_equal(g, w)
            continue
        fin = np.isfinite(w)
        assert np.array_equal(fin, np.isfinite(g))
        assert np.array_equal(g[~fin], w[~fin])
        scale = max(1.0, float(np.max(np.abs(w[fin]), initial=0.0)))
        assert float(np.max(np.abs(g[fin] - w[fin]), initial=0.0)) <= tol * scale


def _quats(rng, k):
    q = rng.standard_normal((k, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _draws():
    rng = np.random.default_rng(9)
    u = lambda *s: rng.uniform(-1.0, 1.0, s)
    return dict(qa=2.8 * u(B, N), qb=2.8 * u(B, N), qda=1.4 * u(B, N),
                qdb=1.4 * u(B, N), qdda=2.9 * u(B, N), qddb=2.9 * u(B, N),
                far=4.0 * u(B, N), rota=_quats(rng, B), rotb=_quats(rng, B),
                ta=rng.uniform(0.0, 5.0, B), tb=rng.uniform(0.0, 5.0, B),
                frac=rng.uniform(0.0, 1.0, B), ts=np.linspace(0.0, 1.0, 9),
                center=u(3), ball=3.0 * u(B, 3))


def _on_cpu(mod):
    """The keyword that puts a port space built from numbers on the CPU
    (the JAX package's spaces take none)."""
    return {} if mod is jsp else {"device": "cpu"}


def _spaces(mod, rate_mod, t):
    """The same spaces built in the JAX package (``t`` = jnp.asarray) or the
    port (``t`` = torch.as_tensor)."""
    lo, hi = t(LO), t(HI)
    limits = rate_mod.JointLimits(lo, hi, t(SPEED))
    box = mod.HyperboxSpace(lo, hi, weights=t(np.linspace(0.5, 1.5, N)))
    return {
        "box": box,
        "ndof": mod.NdofSpace(lo, hi),
        "line": mod.LineSpace(-1.0, 2.0, **_on_cpu(mod)),
        "ball": mod.HyperballSpace(t(np.array([0.1, -0.2, 0.3])), 1.5),
        "so3": mod.SO3Space(max_angular_speed=2.0),
        "rate": mod.RateLimitedNdofSpace(limits),
        "svp": mod.Ndof1stOrderSpace(lo, hi, t(SPEED)),
        "sap": mod.Ndof2ndOrderSpace(lo, hi, t(SPEED), t(ACCEL)),
        "diff": mod.make_differentiable_ndof(lo, hi, [t(SPEED), t(ACCEL)],
                                             weights=[1.0, 0.5, 0.25]),
        "interp": {p: mod.InterpolatedSpace(mod.NdofSpace(lo, hi), p)
                   for p in ("linear", "cubic", "quintic")},
    }


def _points(d, t, mod, name):
    """(a, b) of one space's points."""
    if name in ("box", "ndof", "rate"):
        return t(d["qa"]), t(d["qb"])
    if name == "line":
        return t(d["qa"][:, :1]), t(d["qb"][:, :1])
    if name == "ball":
        return t(d["ball"]), t(d["ball"][::-1].copy())
    if name == "so3":
        return t(d["rota"]), t(d["rotb"])
    if name == "svp":
        return (mod.NdofPoint1(t(d["qa"]), t(d["qda"])),
                mod.NdofPoint1(t(d["qb"]), t(d["qdb"])))
    if name in ("sap", "diff"):
        a = (t(d["qa"]), t(d["qda"]), t(d["qdda"]))
        b = (t(d["qb"]), t(d["qdb"]), t(d["qddb"]))
        if name == "sap":
            return mod.NdofPoint2(*a), mod.NdofPoint2(*b)
        return a, b
    raise KeyError(name)


SPACES = ["box", "ndof", "line", "ball", "so3", "rate", "svp", "sap", "diff"]


def _ops(space, a, b, far, frac, ts, t, mod, name):
    """{op: output} of one space on (a, b); ``far`` lies outside every
    box (for clamp), ``frac`` a fraction per pair, ``ts`` shared ones."""
    out = {"distance": space.distance(a, b),
           "interpolate": space.interpolate(a, b, frac if name not in (
               "svp", "sap", "so3") else frac[:, None]),
           "interpolate_scalar": space.interpolate(a, b, 0.3),
           "difference": space.difference(a, b)}
    if name in ("box", "ndof", "rate"):
        out["clamp"] = space.clamp(far)
        out["contains"] = space.contains(far)
    elif name == "svp":
        out["clamp"] = space.clamp(mod.NdofPoint1(far, far))
        out["interpolate_grid"] = space.interpolate(
            mod.NdofPoint1(a.q[:4, None], a.qd[:4, None]),
            mod.NdofPoint1(b.q[:4, None], b.qd[:4, None]), ts)
    elif name == "sap":
        out["clamp"] = space.clamp(mod.NdofPoint2(far, far, far))
    elif name == "diff":
        out["clamp"] = space.clamp((far, far, far))
        out["lift"] = space.lift(a, b, 0.05)
        out["flow"] = space.flow(a, 0.05)
        out["lower_order"] = space.lower_order(a)
    else:
        out["clamp"] = space.clamp(a * 1.7)
    if name == "rate":
        out["to_natural"] = space.to_natural(a)
        out["from_natural"] = space.from_natural(a)
    return out


@pytest.fixture(scope="module")
def ref():
    d = _draws()
    t = jnp.asarray
    spaces = _spaces(jsp, jrl, t)
    out = {}
    for name in SPACES:
        a, b = _points(d, t, jsp, name)
        space = spaces[name]
        if name == "sap":
            run = jax.jit(lambda a, b, far, frac, ts: {
                "distance": space.distance(a, b),
                "interpolate": space.interpolate(a, b, frac[:, None]),
                "interpolate_scalar": space.interpolate(a, b, 0.3),
                "difference": space.difference(a, b),
                "clamp": space.clamp(jsp.NdofPoint2(far, far, far))})
        else:
            run = jax.jit(lambda a, b, far, frac, ts: _ops(
                space, a, b, far, frac, ts, t, jsp, name))
        out[name] = run(a, b, t(d["far"]), t(d["frac"]), t(d["ts"]))
    for p, space in spaces["interp"].items():
        a, b = t(d["qa"]), t(d["qb"])
        out[f"interp_{p}"] = {
            "interpolate": space.interpolate(a, b, t(d["frac"])[:, None]),
            "eval": space.eval_with_derivatives(a[0], b[0], t(d["ts"])[:, None],
                                                duration=2.0),
            "distance": space.distance(a, b)}
    return d, jax.tree.map(np.array, out)


@pytest.mark.parametrize("name", SPACES)
def test_space_matches_jax(ref, name):
    d, want = ref
    t = torch.as_tensor
    space = _spaces(sp, rl, t)[name]
    a, b = _points(d, t, sp, name)
    if name == "sap":
        got = {"distance": space.distance(a, b),
               "interpolate": space.interpolate(a, b, t(d["frac"])[:, None]),
               "interpolate_scalar": space.interpolate(a, b, 0.3),
               "difference": space.difference(a, b),
               "clamp": space.clamp(sp.NdofPoint2(*(t(d["far"]),) * 3))}
    else:
        got = _ops(space, a, b, t(d["far"]), t(d["frac"]), t(d["ts"]), t, sp,
                   name)
    assert sorted(got) == sorted(want[name])
    for op in got:
        _close(got[op], want[name][op], SAP if name == "sap" else TOL)


@pytest.mark.parametrize("profile", ["linear", "cubic", "quintic"])
def test_interpolated_space_matches_jax(ref, profile):
    d, want = ref
    t = torch.as_tensor
    space = _spaces(sp, rl, t)["interp"][profile]
    a, b = t(d["qa"]), t(d["qb"])
    w = want[f"interp_{profile}"]
    _close(space.interpolate(a, b, t(d["frac"])[:, None]), w["interpolate"])
    _close(space.eval_with_derivatives(a[0], b[0], t(d["ts"])[:, None],
                                       duration=2.0), w["eval"])
    _close(space.distance(a, b), w["distance"])  # delegated to the base


def test_interpolated_space_rejects_an_unknown_profile():
    with pytest.raises(ValueError, match="profile"):
        sp.InterpolatedSpace(sp.NdofSpace([0.0], [1.0], device="cpu"),
                             "septic")


def test_temporal_and_reachability_match_jax():
    """tests/test_spaces_interp.py's temporal cases and
    tests/test_tangent_spaces.py's reachability norms, on both packages."""
    def build(mod, tmod, rmod, t):
        box = mod.HyperboxSpace(t(np.zeros(2)), t(np.ones(2)))
        tsp = mod.TemporalSpace(box, 10.0, max_speed=0.5)
        base = mod.RateLimitedNdofSpace(rmod.JointLimits(
            t(np.array([-5.0])), t(np.array([5.0])), t(np.array([1.0]))))
        org = tmod.TemporalPoint(t(np.float64(0.0)), t(np.array([0.0])))
        rs = mod.ReachabilitySpace(base, t_max=10.0, origin=org)
        P = lambda s, x: tmod.TemporalPoint(t(np.float64(s)), t(np.asarray(x)))
        a = P(1.0, [0.0, 0.0])
        bs = [P(3.0, [0.5, 0.0]), P(1.2, [1.0, 1.0]), P(0.5, [0.1, 0.0])]
        ra, rbs = P(1.0, [0.0]), [P(3.0, [1.0]), P(2.0, [3.0]), P(4.0, [1.0])]
        out = [tsp.distance(a, b) for b in bs]
        out += [tsp.interpolate(a, bs[0], 0.25), tsp.difference(bs[0], a),
                tsp.clamp(P(12.0, [2.0, -1.0]))]
        for b in rbs:
            out += [rs.distance(ra, b), rs.distance(b, ra),
                    rs.reach_plus_time(ra, b), rs.reach_plus_time(b, ra),
                    rs.forward_reach(b), rs.backward_reach(b)]
        return out

    _close(build(sp, temp, rl, torch.as_tensor), jax.tree.map(
        np.array, jax.jit(lambda: build(jsp, jtemp, jrl, jnp.asarray))()))
    with pytest.raises(ValueError, match="origin"):
        sp.ReachabilitySpace(sp.LineSpace(0.0, 1.0, device="cpu"),
                             1.0).forward_reach(
            temp.TemporalPoint(torch.tensor(0.0), torch.zeros(1)))


def test_product_space_and_mappings_match_jax():
    def build(mod, rmod, t):
        box = mod.HyperboxSpace(t(np.zeros(2)), t(np.ones(2)))
        prod = mod.ProductSpace([box, mod.SO3Space()], weights=[1.0, 0.5])
        rng = np.random.default_rng(3)
        a = (t(rng.uniform(0, 1, (4, 2))), t(_quats(rng, 4)))
        b = (t(rng.uniform(0, 1, (4, 2))), t(_quats(rng, 4)))
        lim = rmod.JointLimits(t(np.array([-1.0, -2.0])),
                               t(np.array([1.0, 2.0])), t(np.array([2.0, 4.0])))
        to_rl, from_rl = mod.joint_limits_mapping(lim)
        q = t(np.array([[0.5, -1.5], [1.0, 2.0]]))
        return [prod.distance(a, b), prod.interpolate(a, b, 0.5),
                prod.difference(a, b), prod.clamp(b), to_rl(q), from_rl(q),
                mod.RateLimitedNdofSpace.for_chain(
                    None, np.array([-1.0, -2.0]), np.array([1.0, 2.0]),
                    np.array([2.0, 4.0]), **_on_cpu(mod)).lower]

    _close(build(sp, rl, torch.as_tensor), jax.tree.map(
        np.array, jax.jit(lambda: build(jsp, jrl, jnp.asarray))()))


def test_make_ndof_space_dispatch():
    lo, hi, v = np.zeros(2), np.ones(2), np.ones(2)
    cpu = dict(device="cpu")
    assert type(sp.make_ndof_space(lo, hi, **cpu)) is sp.NdofSpace
    assert type(sp.make_ndof_space(lo, hi, speed=v, **cpu)) \
        is sp.Ndof1stOrderSpace
    s2 = sp.make_ndof_space(lo, hi, speed=v, accel=2 * v, **cpu)
    assert type(s2) is sp.Ndof2ndOrderSpace
    assert torch.equal(s2.jerk, s2.accel)  # jerk defaults to accel
    with pytest.raises(ValueError, match="order"):
        sp.make_ndof_space(lo, hi, order=3, **cpu)
    assert sp.make_ndof_space(lo, hi, **cpu).dim == 2
    for s in (sp.NdofSpace(lo, hi, **cpu), s2, sp.SO3Space(),
              sp.ProductSpace([sp.LineSpace(0, 1, **cpu)])):
        assert isinstance(s, sp.Space)


def _samplers(t):
    lo, hi = t(LO), t(HI)
    box = sp.HyperboxSpace(lo, hi)
    return {
        "box": box,
        "ball": sp.HyperballSpace(t(np.array([0.1, -0.2, 0.3])), 1.5),
        "so3": sp.SO3Space(),
        "svp": sp.Ndof1stOrderSpace(lo, hi, t(SPEED)),
        "sap": sp.Ndof2ndOrderSpace(lo, hi, t(SPEED), t(ACCEL)),
        "temporal": sp.TemporalSpace(box, 7.0),
        "product": sp.ProductSpace([box, sp.SO3Space()]),
        "diff": sp.make_differentiable_ndof(lo, hi, [t(SPEED)]),
        "poisson": temp.TimePoissonSampler(2.0, 1.0, t_max=3.0),
    }


def _in_ranges(name, p):
    """Whether sample ``p`` of sampler ``name`` lies in its range."""
    lo, hi, v, a = (torch.as_tensor(x) for x in (LO, HI, SPEED, ACCEL))
    inbox = lambda x: bool(((x >= lo) & (x <= hi)).all())
    if name == "box":
        return inbox(p)
    if name == "ball":
        return bool((torch.linalg.vector_norm(
            p - torch.tensor([0.1, -0.2, 0.3], dtype=p.dtype), dim=-1)
            <= 1.5 + 1e-12).all())
    if name == "so3":
        return bool(((p.norm(dim=-1) - 1.0).abs() < 1e-12).all()
                    and (p[..., 0] >= 0).all())
    if name == "svp":
        return inbox(p.q) and bool((p.qd.abs() <= v).all())
    if name == "sap":
        return (inbox(p.q) and bool((p.qd.abs() <= v).all())
                and bool((p.qdd.abs() <= a).all()))
    if name == "temporal":
        return bool(((p.time >= 0) & (p.time <= 7.0)).all()) and inbox(p.point)
    if name == "product":
        return inbox(p[0]) and _in_ranges("so3", p[1])
    if name == "diff":
        return inbox(p[0]) and bool((p[1].abs() <= v).all())
    return bool(((p >= 1.0) & (p <= 3.0)).all())


@pytest.mark.parametrize("name", ["box", "ball", "so3", "svp", "sap",
                                  "temporal", "product", "diff", "poisson"])
def test_sample_ranges_and_seeds(name):
    """Draws lie in the space, have the space's batch shape and dtype, and
    the same generator seed gives the same draws (another seed others)."""
    space = _samplers(torch.as_tensor)[name]
    draw = lambda seed: space.sample(torch.Generator().manual_seed(seed),
                                     (64,))
    p, q, r = draw(4), draw(4), draw(5)
    leaves = lambda x: [x] if isinstance(x, torch.Tensor) else [
        y for z in x for y in leaves(z)]
    for x, y, z in zip(leaves(p), leaves(q), leaves(r)):
        assert x.shape[0] == 64 and x.dtype == torch.float64
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert _in_ranges(name, p)


def test_poisson_arrivals_and_temporal_sampler():
    tp = temp.TimePoissonSampler(2.0, 1.0)
    gen = torch.Generator().manual_seed(0)
    arr = tp.sample_arrivals(gen, 50, (8,))
    assert arr.shape == (8, 50) and bool((arr.diff(dim=-1) >= 0).all())
    assert bool((arr > 1.0).all())
    tsp = sp.TemporalSpace(sp.HyperboxSpace(np.zeros(2), np.ones(2),
                                            device="cpu"), 4.0)
    pt = temp.poisson_temporal_sampler(tsp, 3.0)(gen, (16,))
    assert bool((pt.time <= 4.0).all()) and pt.point.shape == (16, 2)


# each builder of a space from numpy bounds, given its first bound ``lo``;
# it returns a tensor that it made from a numpy bound
_FROM_NUMPY = {
    "box": lambda lo, **on: sp.HyperboxSpace(lo, HI, **on).upper,
    "ndof": lambda lo, **on: sp.NdofSpace.from_chain(None, lo, HI,
                                                      **on).upper,
    "line": lambda lo, **on: sp.LineSpace(-1.0, 2.0, **on).upper,
    "ball": lambda lo, **on: sp.HyperballSpace(lo, 1.5, **on).center,
    "rate": lambda lo, **on: sp.RateLimitedNdofSpace.for_chain(
        None, lo, HI, SPEED, **on).limits.speed,
    "svp": lambda lo, **on: sp.Ndof1stOrderSpace(lo, HI, SPEED, **on).speed,
    "sap": lambda lo, **on: sp.Ndof2ndOrderSpace(lo, HI, SPEED, ACCEL,
                                                 **on).jerk,
    "make_ndof_space": lambda lo, **on: sp.make_ndof_space(
        lo, HI, SPEED, **on).a_ramp,
    "make_differentiable_ndof": lambda lo, **on: sp.make_differentiable_ndof(
        lo, HI, [SPEED], **on).spaces[1].upper,
}


@pytest.mark.parametrize("name", sorted(_FROM_NUMPY))
def test_space_from_numpy_lands_on_the_card(name):
    """Like the JAX spaces, which land on the default accelerator, a space
    built from numpy bounds puts its tensors on the card unless ``device``
    says otherwise, with no fall back to the CPU where there is no card;
    numpy bounds follow the device and dtype of a bound that is a
    tensor."""
    build = _FROM_NUMPY[name]
    if torch.cuda.is_available():
        assert build(LO).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build(LO)
    got = build(LO, device="cpu", dtype=torch.float32)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    if name != "line":  # LineSpace takes its two ends as numbers
        got = build(torch.as_tensor(LO, dtype=torch.float32))
        assert got.device.type == "cpu" and got.dtype == torch.float32


CRS_PAIRS = 2048


@pytest.fixture(scope="module")
def crs():
    """The first CRS_PAIRS state pairs of ``chip_smoke.py``'s phase
    interp_spaces_io (the CRS arm's joint space: ±2.8 rad, 1.5 rad/s,
    3 rad/s²; numpy seed 0) in both bundles.  Per bundle: the port's and
    the JAX package's reach times; the bar masks of each
    (``chip_smoke.isi_bars`` on the port's interpolation and on the JAX
    package's) and its feasibility (``chip_smoke.isi_feasible`` with each
    package's own peak velocities); and the port's feasibility at the JAX
    package's reach times.  The JAX package's reach times and peak
    velocities run op by op (their candidate choice is where rounding
    acts); its closed-form evaluation on the dense grid under ``jax.jit``."""
    import chip_smoke as cs
    from reak_tpu.interp import pulses as jpl

    f64 = torch.float64
    d = cs.isi_draws()
    s1, s2, _ = cs.isi_spaces("cpu", f64)
    pts = cs.isi_points(d, "cpu", f64, CRS_PAIRS)
    port = cs.isi_bar_masks(d, "cpu", f64, CRS_PAIRS)
    out = {}
    for name, space in (("svp", s1), ("sap", s2)):
        a, b = pts[name]
        J = lambda x: jnp.asarray(x.numpy())
        lim = ((J(space.speed), J(space.a_ramp)) if name == "svp" else
               (J(space.speed), J(space.accel), J(space.jerk)))
        ends = (J(a.q), J(b.q), J(a.qd), J(b.qd))
        fr = jnp.asarray(np.linspace(0.0, 1.0, cs.ISI_DENSE[name]))
        with jax.disable_jit():
            if name == "svp":
                T = jnp.max(jpl.svp_min_time(*ends, *lim)[0], axis=-1,
                            keepdims=True)
                vp = jpl.svp_peak_velocity(*ends, lim[0], T, lim[1])
            else:
                T = jnp.max(jpl.sap_min_time(*ends, *lim)[0], axis=-1,
                            keepdims=True)
                vp = jpl.sap_peak_velocity(*ends, *lim[:2], T, lim[2])
        if name == "svp":
            p = jax.jit(lambda vp, T: jpl.svp_eval(
                *ends, vp, lim[0], T, fr[:, None, None] * T, lim[1])[:2])(
                    vp, T)
            p = sp.NdofPoint1(*(torch.as_tensor(np.array(x)) for x in p))
        else:
            p = jax.jit(lambda vp, T: jpl.sap_eval(
                *ends, vp, *lim[:2], T, fr[:, None, None] * T, lim[2])[:3])(
                    vp, T)
            p = sp.NdofPoint2(*(torch.as_tensor(np.array(x)) for x in p))
        T, vp = (torch.as_tensor(np.array(x)) for x in (T, vp))
        ref = cs.isi_bars(name, a, b, p, T[:, 0])
        ref[f"{name}_feasible"] = cs.isi_feasible(name, space, a, b, T, vp)
        out[name] = {
            "port": {k: port[k] for k in ref}, "jax": ref,
            "T": (space.distance(a, b), T[:, 0]),
            "port_at_jax_T": cs.isi_feasible(name, space, a, b, T)}
    return out


@pytest.mark.parametrize("name", ["svp", "sap"])
def test_f18_crs_pairs_miss_the_bars_as_in_jax(crs, name):
    """F18 on the CRS arm's pairs that ``chip_smoke.py`` checks: in both
    packages a pair misses one of the JAX tests' bars only where a joint
    has no single-pulse profile at the synchronized duration, and there
    are such pairs.  The pairs that miss a bar, and the infeasible ones,
    are the same in both packages, except where the two reach times differ
    in the last bits (at most 4 ulp) and the port, given the JAX package's
    reach time, finds the JAX package's profile: the rounding decides
    (1 of the 2048 SVP pairs)."""
    c = crs[name]
    port, ref, feas = c["port"], c["jax"], f"{name}_feasible"
    assert bool((~port[feas]).any()) and bool((~ref[feas]).any())
    for k in ref:
        assert not bool((~port[k] & port[feas]).any()), k
        assert not bool((~ref[k] & ref[feas]).any()), k
    assert torch.equal(c["port_at_jax_T"], ref[feas])
    differ = torch.zeros(CRS_PAIRS, dtype=torch.bool)
    for k in ref:
        differ |= port[k] != ref[k]
    T_port, T_jax = c["T"]
    ulp = torch.as_tensor(np.spacing(T_jax.numpy()))
    assert bool(((T_port - T_jax).abs()[differ] <= 4 * ulp[differ]).all())
    assert int(differ.sum()) <= 2
