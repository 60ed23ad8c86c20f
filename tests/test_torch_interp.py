"""The port's interpolators (reak_tpu_torch.interp: hermite, pulses,
trajectory) against the JAX package, f64 on the CPU, on one batch of 64
pairs × 6 joints drawn with numpy (seed 5) that holds the near-boundary
cases of ``tests/test_pulses.py``: rest-to-rest triangles and trapezoids,
trivial moves (p0 = p1, v0 = v1), boundary velocities at ±0.95 vmax, and
SVP stretches of 1 + 1e-6 … 1.2 of the min time (the regime boundaries of
``svp_peak_velocity``).  The JAX references are computed once (a module
fixture, under one ``jax.jit``) and the cases compare slices of them.  Bars: hermite and SVP ≤1e-12, SAP ≤1e-10 (the
same 72 bisection steps), the trajectory kinds ≤1e-12, each relative to
max(1, |reference|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.interp as jip
from reak_tpu.interp import pulses as jpl
import reak_tpu_torch.interp as ip
from reak_tpu_torch.interp import pulses as pl

torch.set_num_threads(1)
HERMITE, SVP, SAP, TRAJ = 1e-12, 1e-12, 1e-10, 1e-12
B, N = 64, 6
VMAX = np.array([1.5, 1.2, 2.0, 1.0, 1.8, 0.9])
AMAX = 2.0 * VMAX
A_RAMP = 1.3 * VMAX
STRETCH = np.array([1.0 + 1e-6, 1.0001, 1.001, 1.01, 1.2])


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    both_inf = np.isinf(got) & np.isinf(want) & (np.sign(got) == np.sign(want))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = both_inf | np.isnan(want)
    err = np.abs(np.where(ok, 0.0, got - want))
    scale = max(1.0, float(np.max(np.abs(np.where(ok, 0.0, want)),
                                  initial=0.0)))
    assert float(np.max(err, initial=0.0)) <= tol * scale


def _draws():
    rng = np.random.default_rng(5)
    p0 = rng.uniform(-3.0, 3.0, (B, N))
    p1 = rng.uniform(-3.0, 3.0, (B, N))
    v0 = rng.uniform(-0.95, 0.95, (B, N)) * VMAX
    v1 = rng.uniform(-0.95, 0.95, (B, N)) * VMAX
    # rest to rest: short (triangular) and long (trapezoidal) moves
    v0[:4] = v1[:4] = 0.0
    p1[0:2] = p0[0:2] + 0.3
    p1[2:4] = p0[2:4] - 5.0
    # trivial moves, and a pair that only changes velocity
    p1[4], v1[4] = p0[4], v0[4]
    p1[5] = p0[5]
    # boundary velocities at the edge of the limit, same and opposite sign
    v0[6], v1[6] = 0.95 * VMAX, 0.95 * VMAX
    v0[7], v1[7] = -0.95 * VMAX, 0.95 * VMAX
    # small moves with same-sign speeds (no cruise at all)
    p1[8:10] = p0[8:10] + 1e-3
    t = rng.uniform(-0.1, 1.1, (B, N))
    stretch = STRETCH[np.arange(B) % STRETCH.size]
    return dict(p0=p0, p1=p1, v0=v0, v1=v1, t=t, stretch=stretch,
                a0=rng.uniform(-1.0, 1.0, (B, N)),
                a1=rng.uniform(-1.0, 1.0, (B, N)),
                dt=rng.uniform(0.5, 2.0, (B, 1)),
                ts=rng.uniform(-0.2, 1.2, (B, 16)),
                knots=np.cumsum(rng.uniform(0.05, 0.3, 40)),
                wp=rng.standard_normal((40, N)),
                wv=rng.standard_normal((40, N)),
                wa=rng.standard_normal((40, N)),
                tq=rng.uniform(-0.5, 9.0, (8, 32)))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs on the batch, computed once: the SVP
    functions op by op (under ``jax.jit`` XLA's fused arithmetic moves the
    root picked on a regime boundary, fault F18), the rest under one
    ``jax.jit``."""
    d = _draws()
    j = {k: jnp.asarray(v) for k, v in d.items()}
    out = _jax_svp(j)
    out.update(jax.jit(_jax_rest)(j))
    return d, jax.tree.map(np.array, out)


def _jax_svp(j):
    p0, p1, v0, v1, t = j["p0"], j["p1"], j["v0"], j["v1"], j["t"]
    vm, ar = jnp.asarray(VMAX), jnp.asarray(A_RAMP)
    out = {"svp_min_time": jpl.svp_min_time(p0, p1, v0, v1, vm, ar)}
    Ts = out["svp_min_time"][0] * j["stretch"][:, None] + 1e-9
    out["svp_peak_velocity"] = jpl.svp_peak_velocity(p0, p1, v0, v1, vm, Ts,
                                                     ar)
    out["svp_eval"] = jpl.svp_eval(p0, p1, v0, v1, out["svp_peak_velocity"],
                                   vm, Ts, t * Ts, ar)
    out["svp_interpolate"] = jpl.svp_interpolate(p0, v0, p1, v1, vm,
                                                 j["ts"].T[..., None] * 3.0, ar)
    out["svp_reach_time"] = jpl.svp_reach_time(p0, v0, p1, v1, vm, ar)
    return out


def _jax_rest(j):
    p0, p1, v0, v1, t = j["p0"], j["p1"], j["v0"], j["v1"], j["t"]
    vm, am = jnp.asarray(VMAX), jnp.asarray(AMAX)
    out = {"linear_interp": jip.linear_interp(p0, p1, t[:, 0], j["dt"]),
           "cubic_hermite_interp": jip.cubic_hermite_interp(
               p0, v0, p1, v1, t[:, 0], j["dt"]),
           "quintic_hermite_interp": jip.quintic_hermite_interp(
               p0, v0, j["a0"], p1, v1, j["a1"], t[:, 0], j["dt"])}
    T2, vp2 = jpl.sap_min_time(p0, p1, v0, v1, vm, am)
    out["sap_min_time"] = (T2, vp2)
    Ts2 = T2 * j["stretch"][:, None] + 1e-9
    out["sap_peak_velocity"] = jpl.sap_peak_velocity(p0, p1, v0, v1, vm, am,
                                                     Ts2)
    out["sap_eval"] = jpl.sap_eval(p0, p1, v0, v1, out["sap_peak_velocity"],
                                   vm, am, Ts2, t * Ts2)
    out["sap_interpolate"] = jpl.sap_interpolate(
        p0, v0, p1, v1, vm, am, j["ts"].T[..., None] * 3.0)
    out["sap_reach_time"] = jnp.max(T2, axis=-1)
    traj = {"linear": jip.waypoint_trajectory(j["knots"], j["wp"]),
            "cubic": jip.waypoint_trajectory(j["knots"], j["wp"], j["wv"]),
            "quintic": jip.waypoint_trajectory(j["knots"], j["wp"], j["wv"],
                                               j["wa"])}
    for kind, tr in traj.items():
        out[f"traj_{kind}"] = tr.eval_with_derivatives(j["tq"])
    out["constant_trajectory"] = jip.constant_trajectory(
        j["wp"][0], 1.0).eval_with_derivatives(j["tq"])
    out["point_to_point_trajectory"] = jip.point_to_point_trajectory(
        j["wp"][0], j["wp"][1], 0.5, 4.0).eval_with_derivatives(j["tq"])
    out["transformed_trajectory"] = jip.transformed_trajectory(
        traj["cubic"], lambda q: jnp.sin(q) * 2.0).eval(j["tq"])
    return out


def _port_inputs(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _limits():
    return (torch.as_tensor(VMAX), torch.as_tensor(AMAX),
            torch.as_tensor(A_RAMP))


@pytest.mark.parametrize("name", ["linear_interp", "cubic_hermite_interp",
                                  "quintic_hermite_interp"])
def test_hermite(ref, name):
    d, want = ref
    x = _port_inputs(d)
    args = {"linear_interp": (x["p0"], x["p1"]),
            "cubic_hermite_interp": (x["p0"], x["v0"], x["p1"], x["v1"]),
            "quintic_hermite_interp": (x["p0"], x["v0"], x["a0"], x["p1"],
                                       x["v1"], x["a1"])}[name]
    got = getattr(ip, name)(*args, x["t"][:, 0], x["dt"])
    for g, w in zip(got, want[name]):
        _close(g, w, HERMITE)


def test_hermite_takes_a_python_time():
    """A number ``t`` broadcasts as a scalar and keeps float64 (no float32
    tensor made from it)."""
    p0, p1 = torch.zeros(3, dtype=torch.float64), torch.ones(
        3, dtype=torch.float64)
    pos, vel, acc = ip.cubic_hermite_interp(p0, p0, p1, p0, 0.1, 2.0)
    want = jip.cubic_hermite_interp(jnp.zeros(3), jnp.zeros(3), jnp.ones(3),
                                    jnp.zeros(3), 0.1, 2.0)
    for g, w in zip((pos, vel, acc), want):
        assert g.dtype == torch.float64
        _close(g, w, HERMITE)


def _svp(name, x, vm, ar, want):
    p0, p1, v0, v1, t = x["p0"], x["p1"], x["v0"], x["v1"], x["t"]
    if name == "svp_min_time":
        return pl.svp_min_time(p0, p1, v0, v1, vm, ar)
    Ts = torch.as_tensor(want["svp_min_time"][0]) * x["stretch"][:, None] \
        + 1e-9
    if name == "svp_peak_velocity":
        return pl.svp_peak_velocity(p0, p1, v0, v1, vm, Ts, ar)
    if name == "svp_eval":
        vp = torch.as_tensor(want["svp_peak_velocity"])
        return pl.svp_eval(p0, p1, v0, v1, vp, vm, Ts, t * Ts, ar)
    if name == "svp_interpolate":
        return pl.svp_interpolate(p0, v0, p1, v1, vm, x["ts"].T[..., None] * 3.0,
                                  ar)
    return pl.svp_reach_time(p0, v0, p1, v1, vm, ar)


@pytest.mark.parametrize("name", ["svp_min_time", "svp_peak_velocity",
                                  "svp_eval", "svp_interpolate",
                                  "svp_reach_time"])
def test_svp(ref, name):
    d, want = ref
    vm, _, ar = _limits()
    got = _svp(name, _port_inputs(d), vm, ar, want)
    got = got if isinstance(got, tuple) else (got,)
    w = want[name] if isinstance(want[name], tuple) else (want[name],)
    for g, ww in zip(got, w):
        _close(g, ww, SVP)


def _sap(name, x, vm, am, want):
    p0, p1, v0, v1, t = x["p0"], x["p1"], x["v0"], x["v1"], x["t"]
    if name == "sap_min_time":
        return pl.sap_min_time(p0, p1, v0, v1, vm, am)
    Ts = torch.as_tensor(want["sap_min_time"][0]) * x["stretch"][:, None] \
        + 1e-9
    if name == "sap_peak_velocity":
        return pl.sap_peak_velocity(p0, p1, v0, v1, vm, am, Ts)
    if name == "sap_eval":
        vp = torch.as_tensor(want["sap_peak_velocity"])
        return pl.sap_eval(p0, p1, v0, v1, vp, vm, am, Ts, t * Ts)
    if name == "sap_interpolate":
        return pl.sap_interpolate(p0, v0, p1, v1, vm, am,
                                  x["ts"].T[..., None] * 3.0)
    return pl.sap_reach_time(p0, v0, p1, v1, vm, am)


@pytest.mark.parametrize("name", ["sap_min_time", "sap_peak_velocity",
                                  "sap_eval", "sap_interpolate",
                                  "sap_reach_time"])
def test_sap(ref, name):
    d, want = ref
    vm, am, _ = _limits()
    got = _sap(name, _port_inputs(d), vm, am, want)
    got = got if isinstance(got, tuple) else (got,)
    w = want[name] if isinstance(want[name], tuple) else (want[name],)
    for g, ww in zip(got, w):
        _close(g, ww, SAP)


def test_pulses_on_python_numbers():
    """All-number arguments run in float64 on the CPU, as under x64 JAX
    (tests/test_pulses.py's rest-to-rest cases)."""
    T, vp = pl.svp_min_time(0.0, 3.0, 0.0, 0.0, 1.0, a_ramp=1.0)
    assert T.dtype == torch.float64
    assert abs(float(T) - 4.0) <= 1e-12 and abs(float(vp) - 1.0) <= 1e-12
    T2, _ = pl.sap_min_time(0.0, 2.0, 0.0, 0.0, 1.0, 2.0)
    _close(T2, jax.jit(jpl.sap_min_time)(0.0, 2.0, 0.0, 0.0, 1.0, 2.0)[0],
           SAP)


@pytest.mark.parametrize("kind", ["linear", "cubic", "quintic"])
def test_waypoint_trajectory(ref, kind):
    d, want = ref
    x = _port_inputs(d)
    extra = {"linear": (), "cubic": (x["wv"],),
             "quintic": (x["wv"], x["wa"])}[kind]
    tr = ip.waypoint_trajectory(x["knots"], x["wp"], *extra)
    got = tr.eval_with_derivatives(x["tq"])
    for g, w in zip(got, want[f"traj_{kind}"]):
        _close(g, w, TRAJ)
    _close(tr.eval(x["tq"]), want[f"traj_{kind}"][0], TRAJ)
    _close(tr.eval(x["tq"][0, 0]), want[f"traj_{kind}"][0][0, 0], TRAJ)
    assert float(tr.t0) == d["knots"][0] and float(tr.t1) == d["knots"][-1]


def test_constant_and_point_to_point(ref):
    d, want = ref
    x = _port_inputs(d)
    const = ip.constant_trajectory(x["wp"][0], 1.0)
    assert float(const.times[1]) == 1e30  # an unbounded end, as in JAX
    assert float(ip.constant_trajectory(x["wp"][0]).t1) == float(
        jip.constant_trajectory(d["wp"][0]).t1) == 1e30
    for g, w in zip(const.eval_with_derivatives(x["tq"]),
                    want["constant_trajectory"]):
        _close(g, w, TRAJ)
    p2p = ip.point_to_point_trajectory(x["wp"][0], x["wp"][1], 0.5, 4.0)
    for g, w in zip(p2p.eval_with_derivatives(x["tq"]),
                    want["point_to_point_trajectory"]):
        _close(g, w, TRAJ)


def test_transformed_trajectory(ref):
    d, want = ref
    x = _port_inputs(d)
    base = ip.waypoint_trajectory(x["knots"], x["wp"], x["wv"])
    view = ip.transformed_trajectory(base, lambda q: torch.sin(q) * 2.0)
    _close(view.eval(x["tq"]), want["transformed_trajectory"], TRAJ)
    assert float(view.t0) == d["knots"][0] and float(view.t1) == d["knots"][-1]


def test_trajectory_is_a_named_tuple_of_tensors():
    """``Trajectory`` is the JAX package's NamedTuple, with tensors."""
    assert ip.Trajectory._fields == jip.Trajectory._fields
    tr = ip.waypoint_trajectory(torch.arange(3.0, dtype=torch.float64),
                                torch.zeros(3, 2, dtype=torch.float64))
    assert tr.vels is None and tr.accs is None
    assert sorted(ip.__all__) == sorted(jip.__all__)


# each trajectory builder, given waypoints ``x`` (2, N); it returns a
# tensor that it made from a numpy argument
_TRAJ_FROM_NUMPY = {
    "waypoint_trajectory": lambda x, **on: ip.waypoint_trajectory(
        np.arange(2.0), x, **on).times,
    "constant_trajectory": lambda x, **on: ip.constant_trajectory(
        x[0], **on).points,
    "point_to_point_trajectory": lambda x, **on: ip.point_to_point_trajectory(
        x[0], np.ones(N), 0.0, 1.0, **on).points,
}


@pytest.mark.parametrize("name", sorted(_TRAJ_FROM_NUMPY))
def test_trajectory_from_numpy_lands_on_the_card(name):
    """A trajectory built from numpy arrays lies on the card unless
    ``device`` says otherwise (no fall back to the CPU where there is no
    card); numpy arguments follow the device and dtype of a tensor
    argument."""
    build, x = _TRAJ_FROM_NUMPY[name], np.zeros((2, N))
    if torch.cuda.is_available():
        assert build(x).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build(x)
    got = build(x, device="cpu", dtype=torch.float32)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    got = build(torch.as_tensor(x, dtype=torch.float32))
    assert got.device.type == "cpu" and got.dtype == torch.float32


def test_f19_sap_min_time_keeps_its_roots_in_float32():
    """The JAX package accepts a bisected SAP root only where its residual
    is below 1e-6 (1 + |dp|), under float32's rounding of the residual near
    the ramp-shape interest points (a square root of a velocity
    difference): on 1024 pairs of the CRS arm's joint space (±2.8 rad,
    1.5 rad/s, 3 rad/s²; numpy seed 0) its float32 reach times come out
    infinite or late (fault F19).  The port's bar is never below √eps:
    every float32 reach time within 1e-5 relative of float64, and float64
    unchanged (the JAX package's bits, ≤1e-10 as above)."""
    rng = np.random.default_rng(0)
    u = lambda s: s * rng.uniform(-1.0, 1.0, (1024, 6))
    qa, qb, qda, qdb = u(2.8), u(2.8), u(1.5), u(1.5)
    vm, am = np.full(6, 1.5), np.full(6, 3.0)
    reach = jax.jit(jpl.sap_reach_time)
    jargs = [jnp.asarray(x) for x in (qa, qda, qb, qdb, vm, am)]
    want64 = np.asarray(reach(*jargs))
    jax32 = np.asarray(reach(*[x.astype(jnp.float32) for x in jargs]))
    assert np.isinf(jax32).sum() > 0  # the reference's fault
    targs = [torch.as_tensor(x) for x in (qa, qda, qb, qdb, vm, am)]
    got64 = pl.sap_reach_time(*targs)
    _close(got64, want64, SAP)
    got32 = pl.sap_reach_time(*(x.float() for x in targs)).double().numpy()
    assert np.all(np.isfinite(got32))
    assert np.max(np.abs(got32 - want64) / want64) <= 1e-5
