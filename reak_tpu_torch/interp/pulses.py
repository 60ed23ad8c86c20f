"""Sustained velocity / acceleration pulse (SVP / SAP) min-time profiles
(port of ``reak_tpu/interp/pulses.py``).

(ref: ctrl/interpolation/sustained_velocity_pulse.hpp:176,
sustained_velocity_pulse_Ndof_detail.cpp — closed-form min-time trapezoidal
velocity profiles with NONZERO boundary velocities;
sustained_acceleration_pulse.hpp:220, sustained_acceleration_pulse_Ndof_detail.cpp
— jerk-limited S-curve profiles, root-solver assisted)

Branch-free tensor expressions, as in the JAX package:

* **SVP** — closed form.  All candidate peak velocities (saturated cruise,
  triangular up, triangular down; quadratic/linear roots for the timed
  solve) are computed *simultaneously*, validity-masked, and selected with
  ``torch.where`` chains in the JAX package's order, so the same candidate
  wins.  No Python branching on values.
* **SAP** — the position-residual equation has no closed form (ramp shape
  switches between triangular and trapezoidal acceleration), so the peak
  velocity is found by **fixed-iteration bisection** (72 iterations of a
  plain loop, no early exit), vectorized over every joint and over all
  candidate root intervals side by side.

Conventions (natural units):
  SVP ramps change velocity at rate ``a_ramp`` (the rate-limited space uses
  ``a_ramp = vmax``, reproducing the reference's normalized convention where
  a full-range ramp takes |Δv|/vmax seconds).
  SAP ramps are jerk-limited S-curves: jerk ``jmax``, peak accel ``amax``.

All solvers assume |v0|,|v1| ≤ vmax (clamp upstream; the reference throws).
``sap_min_time`` accepts a bisected root at a residual bar that is never
below √eps of the dtype (the JAX package's fixed 1e-6 loses roots in
float32, fault F19); in float64 the bar and every result are the JAX
package's.
Arguments are tensors or Python numbers; the results take the tensors'
promoted dtype and the first tensor's device (float64 on the CPU when no
argument is a tensor).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _common(*xs):
    """(dtype, device) of the tensors among ``xs``."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    if not ts:
        return torch.float64, torch.device("cpu")
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float64
    return dtype, ts[0].device


def _broadcast(*xs):
    """``jnp.broadcast_arrays`` of tensors and numbers, in one dtype."""
    dtype, device = _common(*xs)
    return torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=dtype, device=device) for x in xs))


def _like(x, ref):
    """``x`` (a tensor or number) broadcast to ``ref``'s shape, in its dtype
    and on its device."""
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=ref.dtype, device=ref.device), ref.shape)


def _sign(cond, ref):
    """±1 where ``cond`` is true / false, in ``ref``'s dtype."""
    return torch.where(cond, 1.0, -1.0).to(ref.dtype)


def _pick(cands, idx):
    """``cands[idx[...], ...]`` along the leading (candidate) axis."""
    return torch.gather(cands, 0, idx[None])[0]


# ---------------------------------------------------------------------------
# SVP: trapezoidal velocity, ramp rate a_ramp
# ---------------------------------------------------------------------------


def _svp_ramp(v1, v2, a):
    """Time and distance of a linear velocity ramp v1→v2 at rate a.
    (ref: svp_Ndof_compute_ramp_dist_and_time)"""
    dt = torch.abs(v2 - v1) / a
    dp = 0.5 * (v1 + v2) * dt
    return dp, dt


def svp_min_time(p0, p1, v0, v1, vmax, a_ramp=None):
    """Minimum-time SVP profile p0,v0 → p1,v1 under |v| ≤ vmax.

    Closed form (ref: svp_Ndof_compute_min_delta_time_closedform).  Returns
    ``(T, vp)`` elementwise (synchronize across joints with ``T.max(-1)`` +
    :func:`svp_peak_velocity`).
    """
    p0, p1, v0, v1, vmax = _broadcast(p0, p1, v0, v1, vmax)
    a = vmax if a_ramp is None else _like(a_ramp, p0)
    # mirror so the displacement is non-negative; un-mirror vp at the end
    s = _sign(p1 >= p0, p0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    # candidate 1: saturated cruise at +vmax
    dp1_a, dt1_a = _svp_ramp(w0, vmax, a)
    dp2_a, dt2_a = _svp_ramp(vmax, w1, a)
    cruise_a = dp - dp1_a - dp2_a  # distance left at vp=+vmax
    T_a = cruise_a / vmax + dt1_a + dt2_a
    ok_a = cruise_a > 0.0

    # candidate 2: triangular, vp above both boundary velocities
    vp_b = torch.sqrt(torch.clamp_min(a * dp + 0.5 * (w0 * w0 + w1 * w1), 0.0))
    T_b = (torch.abs(vp_b - w0) + torch.abs(vp_b - w1)) / a
    ok_b = (vp_b >= w0) & (vp_b >= w1)

    # candidate 3: vp below both (possibly opposing the displacement); the
    # guaranteed fallback (ref :270-281)
    vp_c2 = 0.5 * (w0 * w0 + w1 * w1) - a * dp
    vp_c_mag = torch.sqrt(torch.clamp_min(vp_c2, 0.0))
    vp_c = torch.where(
        (vp_c_mag <= w0) & (vp_c_mag <= w1), vp_c_mag, -vp_c_mag
    )
    T_c = (torch.abs(vp_c - w0) + torch.abs(vp_c - w1)) / a

    vp = torch.where(ok_a, vmax, torch.where(ok_b, vp_b, vp_c))
    T = torch.where(ok_a, T_a, torch.where(ok_b, T_b, T_c))
    trivial = (torch.abs(dp) < _EPS) & (torch.abs(w1 - w0) < _EPS)
    return torch.where(trivial, 0.0, T), s * torch.where(trivial, w0, vp)


def svp_peak_velocity(p0, p1, v0, v1, vmax, T, a_ramp=None):
    """Peak velocity of the SVP profile stretched to duration T ≥ min time.

    Closed form (ref: svp_Ndof_compute_peak_velocity_closedform): the three
    regime equations (quadratic up-up, linear mid, quadratic down-down) are
    solved simultaneously and the root of least constraint violation is
    selected.
    """
    p0, p1, v0, v1, vmax, T = _broadcast(p0, p1, v0, v1, vmax, T)
    a = vmax if a_ramp is None else _like(a_ramp, p0)
    s = _sign(p1 >= p0, p0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    def cruise_slack(vp):
        _, dt1 = _svp_ramp(w0, vp, a)
        _, dt2 = _svp_ramp(vp, w1, a)
        return T - dt1 - dt2

    # Root selection by MINIMAL CONSTRAINT VIOLATION: exact roots score
    # ~float-eps; on a regime boundary the coinciding roots tie at 0.
    def violation(vp, lo, hi, ok):
        v = torch.clamp_min(torch.maximum(lo - vp, vp - hi), 0.0)
        v = torch.maximum(v, torch.clamp_min(torch.abs(vp) - vmax, 0.0))
        v = torch.maximum(v, torch.clamp_min(-cruise_slack(vp), 0.0))
        return torch.where(ok & torch.isfinite(vp), v, float("inf"))

    big = float("inf")

    # regime 1: vp above both boundary velocities (ramp-up then ramp-down)
    b1 = w0 + w1 + a * T
    disc1 = b1 * b1 - 4.0 * (a * dp + 0.5 * (w0 * w0 + w1 * w1))
    sq1 = torch.sqrt(torch.clamp_min(disc1, 0.0))
    r1_hi = 0.5 * (b1 + sq1)
    r1_lo = 0.5 * (b1 - sq1)
    lo1 = torch.maximum(w0, w1)

    # regime 2: vp between the boundary velocities (linear equation); the
    # signed form: for w1>w0 (ramp-up/ramp-up) the traversed ramp distance
    # is (w1²−w0²)/2a, mirrored for w1<w0
    denom2 = a * T - torch.abs(w1 - w0)
    r2 = torch.where(
        torch.abs(denom2) > _EPS,
        (a * dp - 0.5 * (w1 * w1 - w0 * w0) * _sign(w1 >= w0, w0)) / denom2,
        float("inf"),
    )

    # regime 3: vp below both (ramp-down then ramp-up, possibly vp < 0)
    b3 = w0 + w1 - a * T
    disc3 = b3 * b3 - 4.0 * (0.5 * (w0 * w0 + w1 * w1) - a * dp)
    sq3 = torch.sqrt(torch.clamp_min(disc3, 0.0))
    r3_hi = 0.5 * (b3 + sq3)
    r3_lo = 0.5 * (b3 - sq3)
    hi3 = torch.minimum(w0, w1)

    inf_t = torch.full_like(dp, big)
    cands = torch.stack([r1_hi, r1_lo, r2, r3_hi, r3_lo])
    viols = torch.stack([
        violation(r1_hi, lo1, inf_t, disc1 >= 0),
        violation(r1_lo, lo1, inf_t, disc1 >= 0),
        violation(r2, torch.minimum(w0, w1), torch.maximum(w0, w1),
                  torch.isfinite(r2)),
        violation(r3_hi, -inf_t, hi3, disc3 >= 0),
        # r3_lo is the always-finite fallback root: cap its score so argmin
        # lands here when every candidate is out-of-regime
        torch.clamp_max(violation(r3_lo, -inf_t, hi3, disc3 >= 0), 1e30),
    ])
    vp = _pick(cands, torch.argmin(viols, dim=0))
    trivial = (torch.abs(dp) < _EPS) & (torch.abs(w1 - w0) < _EPS)
    return s * torch.where(trivial, w0, vp)


def svp_eval(p0, p1, v0, v1, vp, vmax, T, t, a_ramp=None):
    """Evaluate the SVP profile with peak velocity vp at time(s) t ∈ [0, T].

    Branch-free piecewise evaluation
    (ref: svp_Ndof_compute_interpolated_values_balanced).
    Returns ``(pos, vel, acc)``; query times broadcast against joints when
    ``t`` carries extra leading axes.
    """
    p0, p1, v0, v1, vp, vmax, T = _broadcast(p0, p1, v0, v1, vp, vmax, T)
    a = vmax if a_ramp is None else _like(a_ramp, p0)
    t = torch.as_tensor(t, dtype=p0.dtype, device=p0.device)

    s1 = _sign(vp >= v0, p0)
    s2 = _sign(v1 >= vp, p0)
    dt1 = torch.abs(vp - v0) / a
    dt2 = torch.abs(v1 - vp) / a
    tc = torch.clamp_min(T - dt1 - dt2, 0.0)

    pis = p0 + 0.5 * (v0 + vp) * dt1  # cruise start position
    pie = p1 - 0.5 * (vp + v1) * dt2  # cruise end position

    tcl = torch.minimum(torch.clamp_min(t, 0.0), T)
    # segment 1: ramp v0 → vp
    tau1 = torch.minimum(tcl, dt1)
    pos1 = p0 + (v0 + 0.5 * s1 * a * tau1) * tau1
    vel1 = v0 + s1 * a * tau1
    # segment 2: cruise (robust lerp between analytic endpoints, ref :90)
    frac = torch.clamp((tcl - dt1) / torch.clamp_min(tc, _EPS), 0.0, 1.0)
    pos2 = pis + (pie - pis) * frac
    # segment 3: ramp vp → v1, measured back from the end
    mdt = torch.minimum(torch.clamp_min(T - tcl, 0.0), dt2)
    pos3 = p1 - (v1 - 0.5 * s2 * a * mdt) * mdt
    vel3 = v1 - s2 * a * mdt

    in1 = tcl < dt1
    in3 = tcl > dt1 + tc
    pos = torch.where(in1, pos1, torch.where(in3, pos3, pos2))
    vel = torch.where(in1, vel1, torch.where(in3, vel3, vp))
    acc = torch.where(in1, s1 * a, torch.where(in3, s2 * a, 0.0))
    outside = (t < 0.0) | (t > T)
    pos = torch.where(t < 0.0, p0, torch.where(t > T, p1, pos))
    vel = torch.where(t < 0.0, v0, torch.where(t > T, v1, vel))
    acc = torch.where(outside, 0.0, acc)
    return pos, vel, acc


def _maximum(x, lo):
    return torch.maximum(x, lo) if isinstance(lo, torch.Tensor) else \
        torch.clamp_min(x, lo)


def svp_interpolate(p0, v0, p1, v1, vmax, t, a_ramp=None, min_T=None):
    """Synchronized N-DoF SVP interpolation: per-joint min times, shared
    duration T = max, per-joint peak velocities re-solved for that T
    (ref: svp_compute_Ndof_interpolation_data_impl).  Returns (pos, vel, T).
    """
    T_j, _ = svp_min_time(p0, p1, v0, v1, vmax, a_ramp)
    T = torch.amax(T_j, dim=-1)
    if min_T is not None:
        T = _maximum(T, min_T)
    Tb = T[..., None]
    vp = svp_peak_velocity(p0, p1, v0, v1, vmax, Tb, a_ramp)
    pos, vel, _ = svp_eval(p0, p1, v0, v1, vp, vmax, Tb, t, a_ramp)
    return pos, vel, T


# ---------------------------------------------------------------------------
# SAP: jerk-limited S-curve ramps (trapezoidal/triangular acceleration)
# ---------------------------------------------------------------------------


def _sap_ramp(v1, v2, amax, jmax):
    """Time and distance of a jerk-limited ramp v1→v2.
    (ref: sap_Ndof_compute_ramp_dist_and_time — accel trapezoid when
    |Δv| ≥ amax²/jmax, else accel triangle with peak √(|Δv|·jmax))"""
    dv = torch.abs(v2 - v1)
    dt_trap = dv / amax + amax / jmax
    dt_tri = 2.0 * torch.sqrt(dv / jmax)
    dt = torch.where(dv >= amax * amax / jmax, dt_trap, dt_tri)
    dp = 0.5 * (v1 + v2) * dt  # odd-symmetric accel ⇒ mean velocity = midpoint
    return dp, dt


def _bisect(f, lo, hi, iters=72):
    """Branch-free fixed-iteration bisection over batched intervals: a plain
    loop of ``iters`` steps with no early exit (the JAX package's
    ``lax.fori_loop``)."""
    flo = f(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        left = flo * fm <= 0.0
        lo, hi, flo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                       torch.where(left, flo, fm))
    return 0.5 * (lo + hi)


def sap_min_time(p0, p1, v0, v1, vmax, amax, jmax=None):
    """Minimum-time SAP (S-curve) profile p0,v0 → p1,v1 under |v| ≤ vmax,
    |a| ≤ amax, |jerk| ≤ jmax (default jmax = amax, the reference's
    rate-limited normalization).  Returns ``(T, vp)`` elementwise.

    (ref: sap_Ndof_compute_min_delta_time_numsolve — reference uses Brent;
    here a fixed-72-iteration branch-free bisection, batched over joints.)
    """
    p0, p1, v0, v1, vmax, amax = _broadcast(p0, p1, v0, v1, vmax, amax)
    j = amax if jmax is None else _like(jmax, p0)
    s = _sign(p1 >= p0, p0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    def resid(vp):
        dp1, _ = _sap_ramp(w0, vp, amax, j)
        dp2, _ = _sap_ramp(vp, w1, amax, j)
        return dp - dp1 - dp2

    def ramps_T(vp):
        _, dt1 = _sap_ramp(w0, vp, amax, j)
        _, dt2 = _sap_ramp(vp, w1, amax, j)
        return dt1 + dt2

    # The min-time profile either cruises at ±vmax or has zero cruise (a
    # root of the position residual).  The residual is only piecewise
    # monotone — its derivative kinks at the boundary velocities, the ramp
    # shape knees, and vp = 0 — so bisect every sub-interval between
    # interest points side by side and take the fastest feasible candidate.
    knee = amax * amax / j
    pts = torch.stack([-vmax, w0 - knee, w0, w0 + knee, w1 - knee, w1,
                       w1 + knee, torch.zeros_like(dp), vmax])
    pts = torch.sort(torch.minimum(torch.maximum(pts, -vmax), vmax),
                     dim=0).values
    lo, hi = pts[:-1], pts[1:]  # (8, ...)
    roots = _bisect(resid, lo, hi)
    # a root is accepted where its residual is below 1e-6 (1 + |dp|), or
    # below √eps (1 + |dp|) where that is larger: near the interest points
    # the ramp time is a square root of a velocity difference, so the
    # residual at the bisected root carries an error of order √eps.  In
    # float64 the bar stays the JAX package's 1e-6; in float32 (√eps ≈
    # 3.5e-4) the JAX package's bar loses the root of ~1.6 % of pairs (fault
    # F19: their reach time comes out late or infinite)
    tol = max(1e-6, math.sqrt(torch.finfo(dp.dtype).eps))
    root_ok = (resid(lo) * resid(hi) <= 0.0) & (
        torch.abs(resid(roots)) < tol * (1.0 + torch.abs(dp))
    )
    T_roots = torch.where(root_ok, ramps_T(roots), float("inf"))
    # saturated-cruise candidates at ±vmax
    sat = torch.stack([vmax, -vmax])
    tc_sat = resid(sat) / sat
    T_sat = torch.where(tc_sat >= 0.0, ramps_T(sat) + tc_sat, float("inf"))
    cand_vp = torch.cat([roots, sat], dim=0)
    cand_T = torch.cat([T_roots, T_sat], dim=0)
    best = torch.argmin(cand_T, dim=0)
    T = _pick(cand_T, best)
    vp = _pick(cand_vp, best)
    trivial = (torch.abs(dp) < _EPS) & (torch.abs(w1 - w0) < _EPS)
    return torch.where(trivial, 0.0, T), s * torch.where(trivial, w0, vp)


def sap_peak_velocity(p0, p1, v0, v1, vmax, amax, T, jmax=None):
    """Peak velocity of the SAP profile stretched to duration T ≥ min time.

    (ref: sap_Ndof_compute_peak_velocity_numsolve — the reference walks 7
    intervals between "interest points" sequentially with Brent; here all 7
    intervals are bisected side by side (a stacked leading axis) and the
    first valid root is selected.)
    """
    p0, p1, v0, v1, vmax, amax, T = _broadcast(p0, p1, v0, v1, vmax, amax, T)
    j = amax if jmax is None else _like(jmax, p0)
    s = _sign(p1 >= p0, p0)
    dp, w0, w1 = s * (p1 - p0), s * v0, s * v1

    def pd(vp):
        dp1, dt1 = _sap_ramp(w0, vp, amax, j)
        dp2, dt2 = _sap_ramp(vp, w1, amax, j)
        return dp - dp1 - dp2 - vp * (T - dt1 - dt2)

    def slack(vp):
        _, dt1 = _sap_ramp(w0, vp, amax, j)
        _, dt2 = _sap_ramp(vp, w1, amax, j)
        return T - dt1 - dt2

    dv_knee = amax * amax / j  # Δv where ramp shape switches
    pts = torch.stack([vmax, w0 + dv_knee, w0, w0 - dv_knee, w1 + dv_knee,
                       w1, w1 - dv_knee, -vmax])  # (8, ...)
    pts = torch.minimum(torch.maximum(pts, -vmax), vmax)
    pts = -torch.sort(-pts, dim=0).values  # descending: search from +vmax down
    lo, hi = pts[1:], pts[:-1]  # (7, ...) intervals
    roots = _bisect(pd, lo, hi)
    tol = 1e-3 * vmax
    ok = (
        (torch.abs(pd(roots)) < tol)
        & (slack(roots) >= -tol)
        & (pd(lo) * pd(hi) <= 0.0)
    )
    # also accept interval endpoints that are exact solutions (ref :450-457)
    ok_hi_pt = (torch.abs(pd(hi)) < tol) & (slack(hi) >= -tol)
    roots = torch.where(ok, roots, torch.where(ok_hi_pt, hi, float("nan")))
    ok = ok | ok_hi_pt
    # first valid candidate in descending-vp order
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    vp = _pick(roots, first)
    any_ok = torch.any(ok, dim=0)
    vp = torch.where(any_ok, vp, torch.sign(dp) * vmax)
    trivial = (torch.abs(dp) < _EPS) & (torch.abs(w1 - w0) < _EPS)
    return s * torch.where(trivial, w0, vp)


def sap_eval(p0, p1, v0, v1, vp, vmax, amax, T, t, jmax=None):
    """Evaluate the SAP (S-curve) profile at time(s) t ∈ [0, T].

    Branch-free 7-segment evaluation (jerk-up / const-accel / jerk-down per
    ramp + cruise; ref: sap_Ndof_compute_interpolated_values_balanced).
    Returns ``(pos, vel, acc, jerk)``.
    """
    p0, p1, v0, v1, vp, vmax, amax, T = _broadcast(p0, p1, v0, v1, vp, vmax,
                                                   amax, T)
    j = amax if jmax is None else _like(jmax, p0)
    t = torch.as_tensor(t, dtype=p0.dtype, device=p0.device)

    def ramp_phases(va, vb):
        """Phase durations of the jerk-limited ramp va→vb: (dt_a, dt_v, a_pk)."""
        dv = torch.abs(vb - va)
        tri = dv < amax * amax / j
        a_pk = torch.where(tri, torch.sqrt(torch.clamp_min(dv * j, 0.0)), amax)
        dt_a = a_pk / j
        dt_v = torch.where(tri, 0.0, dv / torch.clamp_min(amax, _EPS) - amax / j)
        return dt_a, dt_v, a_pk

    def ramp_eval(va, vb, p_start, p_end, tau, dt_a, dt_v, a_pk):
        """(pos, vel, acc, jerk) inside a ramp, tau ∈ [0, 2·dt_a+dt_v]."""
        sg = _sign(vb >= va, va)
        dtr = 2.0 * dt_a + dt_v
        # phase A: jerk up, tau ∈ [0, dt_a]
        tA = torch.minimum(torch.clamp_min(tau, 0.0), dt_a)
        velA = va + 0.5 * sg * j * tA * tA
        posA = p_start + va * tA + sg * j * tA ** 3 / 6.0
        # phase B: const accel, tau-dt_a ∈ [0, dt_v]
        tB = torch.minimum(torch.clamp_min(tau - dt_a, 0.0), dt_v)
        vA_end = va + 0.5 * sg * j * dt_a * dt_a
        pA_end = p_start + va * dt_a + sg * j * dt_a ** 3 / 6.0
        velB = vA_end + sg * a_pk * tB
        posB = pA_end + vA_end * tB + 0.5 * sg * a_pk * tB * tB
        # phase C: jerk down, measured back from ramp end
        mdt = torch.minimum(torch.clamp_min(dtr - tau, 0.0), dt_a)
        velC = vb - 0.5 * sg * j * mdt * mdt
        posC = p_end - vb * mdt + sg * j * mdt ** 3 / 6.0
        inA = tau < dt_a
        inC = tau > dt_a + dt_v
        pos = torch.where(inA, posA, torch.where(inC, posC, posB))
        vel = torch.where(inA, velA, torch.where(inC, velC, velB))
        acc = torch.where(
            inA, sg * j * tA, torch.where(inC, sg * j * mdt, sg * a_pk)
        )
        jerk = torch.where(inA, sg * j, torch.where(inC, -sg * j, 0.0))
        return pos, vel, acc, jerk

    dt_a1, dt_v1, apk1 = ramp_phases(v0, vp)
    dt_a2, dt_v2, apk2 = ramp_phases(vp, v1)
    dtr1 = 2.0 * dt_a1 + dt_v1
    dtr2 = 2.0 * dt_a2 + dt_v2
    dp1 = 0.5 * (v0 + vp) * dtr1
    dp2 = 0.5 * (vp + v1) * dtr2
    tc = torch.clamp_min(T - dtr1 - dtr2, 0.0)
    pis = p0 + dp1
    pie = p1 - dp2

    tcl = torch.minimum(torch.clamp_min(t, 0.0), T)
    pos1, vel1, acc1, jrk1 = ramp_eval(v0, vp, p0, pis, tcl, dt_a1, dt_v1, apk1)
    frac = torch.clamp((tcl - dtr1) / torch.clamp_min(tc, _EPS), 0.0, 1.0)
    pos2 = pis + (pie - pis) * frac
    pos3, vel3, acc3, jrk3 = ramp_eval(
        vp, v1, pie, p1, tcl - dtr1 - tc, dt_a2, dt_v2, apk2
    )
    in1 = tcl < dtr1
    in3 = tcl > dtr1 + tc
    pos = torch.where(in1, pos1, torch.where(in3, pos3, pos2))
    vel = torch.where(in1, vel1, torch.where(in3, vel3, vp))
    acc = torch.where(in1, acc1, torch.where(in3, acc3, 0.0))
    jerk = torch.where(in1, jrk1, torch.where(in3, jrk3, 0.0))
    outside = (t < 0.0) | (t > T)
    pos = torch.where(t < 0.0, p0, torch.where(t > T, p1, pos))
    vel = torch.where(t < 0.0, v0, torch.where(t > T, v1, vel))
    acc = torch.where(outside, 0.0, acc)
    jerk = torch.where(outside, 0.0, jerk)
    return pos, vel, acc, jerk


def sap_interpolate(p0, v0, p1, v1, vmax, amax, t, jmax=None, min_T=None):
    """Synchronized N-DoF SAP interpolation (shared duration = max over
    joints of per-joint min times).  Returns (pos, vel, acc, T)."""
    T_j, _ = sap_min_time(p0, p1, v0, v1, vmax, amax, jmax)
    T = torch.amax(T_j, dim=-1)
    if min_T is not None:
        T = _maximum(T, min_T)
    Tb = T[..., None]
    vp = sap_peak_velocity(p0, p1, v0, v1, vmax, amax, Tb, jmax)
    pos, vel, acc, _ = sap_eval(p0, p1, v0, v1, vp, vmax, amax, Tb, t, jmax)
    return pos, vel, acc, T


# ---------------------------------------------------------------------------
# Reach-time metrics (ref: svp_Ndof_metrics.hpp, sap_Ndof_metrics.hpp)
# ---------------------------------------------------------------------------


def svp_reach_time(p0, v0, p1, v1, vmax, a_ramp=None):
    """Synchronized min travel time between two 1st-order Ndof points — the
    SVP distance metric (ref: svp_Ndof_metrics.hpp svp_Ndof_reach_time_metric)."""
    T_j, _ = svp_min_time(p0, p1, v0, v1, vmax, a_ramp)
    return torch.amax(T_j, dim=-1)


def sap_reach_time(p0, v0, p1, v1, vmax, amax, jmax=None):
    """Synchronized min travel time between two 2nd-order Ndof points — the
    SAP distance metric (ref: sap_Ndof_metrics.hpp)."""
    T_j, _ = sap_min_time(p0, p1, v0, v1, vmax, amax, jmax)
    return torch.amax(T_j, dim=-1)
