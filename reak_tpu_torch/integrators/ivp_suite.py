"""The classic stiff initial-value test suite as torch rate functions (the
port's own copy of ``reak_tpu/integrators/ivp_suite.py``).

The published CWI/Hairer–Wanner test-set problems the reference encodes as
fixtures (ref: core/integrators/unit_test_integrators_problems.hpp:53 HIRES,
:109 Pollution, :255 RingModulator, :348 AkzoNobel, plus VdP/OREGO/ROBER)
as pure functions f(t, y) → ẏ of one state (``torch.func.jacfwd`` takes
them) with the published initial states and reference endpoint values
(Lioen & de Swart, "Test Set for IVP Solvers", CWI; Hairer & Wanner,
Solving ODEs II).  ``t`` is a 0-dim tensor, as the port's integrators pass
it; the constants a function needs past Python floats are made once per
(type, device), so a function can be captured into a CUDA graph.

``ALL_PROBLEMS`` holds eight problems: HIRES, POLLU, RINGMOD, MEDAKZO, VDP,
VDP_MOD, OREGO and ROBER.  The reference's docstring also names E5, which
its ``ALL_PROBLEMS`` does not hold; neither does this module.

Each entry is an ``IVProblem`` for integrators/adaptive.py (mildly stiff
members) and integrators/implicit.py (the genuinely stiff ones).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import math

import numpy as np
import torch


class IVProblem(NamedTuple):
    name: str
    f: Callable               # f(t, y) -> dy/dt
    t0: float
    y0: np.ndarray
    tf: float
    y_ref: np.ndarray         # reference solution at tf (None entries = NaN)
    stiff: bool               # requires an L-stable solver


# ---------------------------------------------------------------------------
# HIRES — plant-physiology kinetics, 8 states (mildly stiff)
# ---------------------------------------------------------------------------


_CONSTS = {}


def _consts(key, like, make):
    """The arrays ``make()`` as tensors of ``like``'s type and device, made
    once for each (``key``, type, device)."""
    k = (key, like.dtype, like.device)
    if k not in _CONSTS:
        _CONSTS[k] = tuple(torch.as_tensor(a, dtype=like.dtype,
                                           device=like.device)
                           for a in make())
    return _CONSTS[k]


def _hires_linear():
    """HIRES's linear part L, its constant source and the direction of its
    one bilinear rate r = 280·y6·y8: ẏ = L y + s + e r."""
    L = np.zeros((8, 8))
    for i, j, v in ((0, 0, -1.71), (0, 1, 0.43), (0, 2, 8.32),
                    (1, 0, 1.71), (1, 1, -8.75),
                    (2, 2, -10.03), (2, 3, 0.43), (2, 4, 0.035),
                    (3, 1, 8.32), (3, 2, 1.71), (3, 3, -1.12),
                    (4, 4, -1.745), (4, 5, 0.43), (4, 6, 0.43),
                    (5, 3, 0.69), (5, 4, 1.71), (5, 5, -0.43), (5, 6, 0.69),
                    (6, 6, -1.81), (7, 6, 1.81)):
        L[i, j] = v
    s = np.zeros(8)
    s[0] = 0.0007
    return L, s, np.array([0.0, 0, 0, 0, 0, -1.0, 1.0, -1.0])


def _hires_f(t, y):
    """As one matrix product, six operations (a CUDA graph of a step
    replays each as a launch): the reference's sums in another order."""
    L, s, e = _consts("hires", y, _hires_linear)
    return L @ y + s + e * (280.0 * y[5] * y[7])


HIRES = IVProblem(
    name="HIRES", f=_hires_f, t0=0.0,
    y0=np.array([1.0, 0, 0, 0, 0, 0, 0, 0.0057]),
    tf=321.8122,
    y_ref=np.array([
        0.7371312573325668e-3, 0.1442485726316185e-3, 0.5888729740967575e-4,
        0.1175651343283149e-2, 0.2386356198831331e-2, 0.6238968252742796e-2,
        0.2849998395185769e-2, 0.2850001604814231e-2]),
    stiff=True,
)


# ---------------------------------------------------------------------------
# POLLU — atmospheric pollution kinetics, 20 states / 25 reactions (stiff)
# ---------------------------------------------------------------------------

_POLLU_K = np.array([
    0.35, 0.266e2, 0.123e5, 0.86e-3, 0.82e-3, 0.15e5, 0.13e-3, 0.24e5,
    0.165e5, 0.9e4, 0.22e-1, 0.12e5, 0.188e1, 0.163e5, 0.48e7, 0.35e-3,
    0.175e-1, 0.1e9, 0.444e12, 0.124e4, 0.21e1, 0.578e1, 0.474e-1,
    0.178e4, 0.312e1])


_POLLU_KF = [float(v) for v in _POLLU_K]


def _pollu_f(t, y):
    k = _POLLU_KF
    r = torch.stack([
        k[0] * y[0], k[1] * y[1] * y[3], k[2] * y[4] * y[1], k[3] * y[6],
        k[4] * y[6], k[5] * y[6] * y[5], k[6] * y[8], k[7] * y[8] * y[5],
        k[8] * y[10] * y[1], k[9] * y[10] * y[0], k[10] * y[12],
        k[11] * y[9] * y[1], k[12] * y[13], k[13] * y[0] * y[5],
        k[14] * y[2], k[15] * y[3], k[16] * y[3], k[17] * y[15],
        k[18] * y[15], k[19] * y[16] * y[5], k[20] * y[18], k[21] * y[18],
        k[22] * y[0] * y[3], k[23] * y[18] * y[0], k[24] * y[19]])
    return torch.stack([
        -r[0] - r[9] - r[13] - r[22] - r[23]
        + r[1] + r[2] + r[8] + r[10] + r[11] + r[21] + r[24],
        -r[1] - r[2] - r[8] - r[11] + r[0] + r[20],
        -r[14] + r[0] + r[16] + r[18] + r[21],
        -r[1] - r[15] - r[16] - r[22] + r[14],
        -r[2] + 2.0 * r[3] + r[5] + r[6] + r[12] + r[19],
        -r[5] - r[7] - r[13] - r[19] + r[2] + 2.0 * r[17],
        -r[3] - r[4] - r[5] + r[12],
        r[3] + r[4] + r[5] + r[6],
        -r[6] - r[7],
        -r[11] + r[6] + r[8],
        -r[8] - r[9] + r[7] + r[10],
        r[8],
        -r[10] + r[9],
        -r[12] + r[11],
        r[13],
        -r[17] - r[18] + r[15],
        -r[19],
        r[19],
        -r[20] - r[21] - r[23] + r[22] + r[24],
        -r[24] + r[23],
    ])


POLLU = IVProblem(
    name="POLLU", f=_pollu_f, t0=0.0,
    y0=np.array([0, 0.2, 0, 0.04, 0, 0, 0.1, 0.3, 0.01, 0, 0, 0, 0, 0, 0,
                 0, 0.007, 0, 0, 0.0]),
    tf=60.0,
    y_ref=np.array([
        0.5646255480022769e-1, 0.1342484130422339, 0.4139734331099427e-8,
        0.5523140207484359e-2, 0.2018977262302196e-6, 0.1464541863493966e-6,
        0.7784249118997964e-1, 0.3245075353396018, 0.7494013383880406e-2,
        0.1622293157301561e-7, 0.1135863833257075e-7, 0.2230505975721359e-2,
        0.2087162882798630e-3, 0.1396921016840158e-4, 0.8964884856898295e-2,
        0.4352846369330103e-17, 0.6899219696263405e-2, 0.1007803037365946e-3,
        0.1772146513969984e-5, 0.5682943292316392e-4]),
    stiff=True,
)


# ---------------------------------------------------------------------------
# RINGMOD — ring modulator circuit (C_s = 2e-12 variant), 15 states (stiff)
# ---------------------------------------------------------------------------


def _ringmod_f(t, y):
    c, cs, cp = 1.6e-8, 2.0e-12, 1.0e-8
    r, rp = 25.0e3, 50.0
    lh, ls1, ls2, ls3 = 4.45, 2.0e-3, 5.0e-4, 5.0e-4
    rg1, rg2, rg3 = 36.3, 17.3, 17.3
    ri, rc = 50.0, 600.0
    gamma, delta = 40.67286402e-9, 17.7493332
    pi = math.pi
    uin1 = 0.5 * torch.sin(2.0e3 * pi * t)
    uin2 = 2.0 * torch.sin(2.0e4 * pi * t)
    ud1 = y[2] - y[4] - y[6] - uin2
    ud2 = -y[3] + y[5] - y[6] - uin2
    ud3 = y[3] + y[4] + y[6] + uin2
    ud4 = -y[2] - y[5] + y[6] + uin2
    g = lambda u: gamma * (torch.exp(delta * u) - 1.0)
    q1, q2, q3, q4 = g(ud1), g(ud2), g(ud3), g(ud4)
    return torch.stack([
        (y[7] - 0.5 * y[9] + 0.5 * y[10] + y[13] - y[0] / r) / c,
        (y[8] - 0.5 * y[11] + 0.5 * y[12] + y[14] - y[1] / r) / c,
        (y[9] - q1 + q4) / cs,
        (-y[10] + q2 - q3) / cs,
        (y[11] + q1 - q3) / cs,
        (-y[12] - q2 + q4) / cs,
        (-y[6] / rp + q1 + q2 - q3 - q4) / cp,
        -y[0] / lh,
        -y[1] / lh,
        (0.5 * y[0] - y[2] - rg2 * y[9]) / ls2,
        (-0.5 * y[0] + y[3] - rg3 * y[10]) / ls3,
        (0.5 * y[1] - y[4] - rg2 * y[11]) / ls2,
        (-0.5 * y[1] + y[5] - rg3 * y[12]) / ls3,
        (-y[0] + uin1 - (ri + rg1) * y[13]) / ls1,
        (-y[1] - (rc + rg1) * y[14]) / ls1,
    ])


RINGMOD = IVProblem(
    name="RINGMOD", f=_ringmod_f, t0=0.0, y0=np.zeros(15), tf=1.0e-3,
    y_ref=np.array([
        -0.2339057358486745e-1, -0.7367485485540825e-2, 0.2582956709291169,
        -0.4064465721283450, -0.4039455665149794, 0.2607966765422943,
        0.1106761861269975, 0.2939904342435596e-6, -0.2840029933642329e-7,
        0.7267198267264553e-3, 0.7929487196960840e-3, -0.7255283495698965e-3,
        -0.7941401968526521e-3, 0.7088495416976114e-4, 0.2390059075236570e-4]),
    stiff=True,
)


# ---------------------------------------------------------------------------
# MEDAKZO — medical Akzo Nobel 1-D reaction-diffusion, N=200 cells → 400
# states (stiff, large).  Spatial scheme: ζ_j = jΔζ (j = 1..N), Dirichlet
# u(0) = φ(t) on the left, homogeneous Neumann ghost on the right — this is
# the discretization the published endpoint values correspond to (verified
# by tolerance-refinement: endpoint matches to 2.5e-5; the reference's own
# C++ fixture deviates from the scheme behind the values it quotes — its
# first cell reuses ζ = Δζ twice and its last cell drops diffusion —
# producing a ~1% endpoint offset, which its assertion-free test never
# notices.  ref: unit_test_integrators_problems.hpp:348).
# ---------------------------------------------------------------------------

_MEDAKZO_N = 200


def _medakzo_consts():
    """alpha and beta of the spatial scheme."""
    zeta = (np.arange(_MEDAKZO_N) + 1) * (1.0 / _MEDAKZO_N)
    dum = (zeta - 1.0) ** 2 / 4.0
    return 2.0 * (zeta - 1.0) * dum / 4.0, dum * dum


def _medakzo_f(t, y):
    N = _MEDAKZO_N
    k = 100.0
    dz = 1.0 / N
    u = y[0::2]
    v = y[1::2]
    alpha, beta = _consts("medakzo", y, _medakzo_consts)
    phi = 2.0 * (t < 5.0).to(y.dtype)
    u_prev = torch.cat([phi.reshape(1), u[:-1]])
    u_next = torch.cat([u[1:], u[-1:]])   # du/dζ = 0 right ghost
    react = k * u * v
    du = ((u_prev - 2.0 * u + u_next) * beta / (dz * dz)
          + alpha * (u_next - u_prev) / (2.0 * dz) - react)
    dv = -react
    return torch.stack([du, dv], dim=-1).reshape(-1)


def _medakzo_y0():
    y = np.zeros(2 * _MEDAKZO_N)
    y[1::2] = 1.0
    return y


# first 15 cells' u-values + the last 5 cells (u ≈ 0, v = 1) from the
# reference fixture; unchecked components are NaN
_MEDAKZO_REF = np.full(2 * _MEDAKZO_N, np.nan)
_MEDAKZO_REF[0:30:2] = [
    0.5113983840919909e-5, 0.1027858770570419e-4, 0.1549349862635799e-4,
    0.2075835344757462e-4, 0.2607273610116854e-4, 0.3143617475695002e-4,
    0.3684813884509626e-4, 0.4230803594492533e-4, 0.4781520853483223e-4,
    0.5336893059800053e-4, 0.5896840407836044e-4, 0.6461275518112516e-4,
    0.7030103051210320e-4, 0.7603219304985662e-4, 0.8180511794465543e-4]
_MEDAKZO_REF[390:400:2] = 0.0
_MEDAKZO_REF[391:400:2] = 1.0

MEDAKZO = IVProblem(
    name="MEDAKZO", f=_medakzo_f, t0=0.0, y0=_medakzo_y0(), tf=20.0,
    y_ref=_MEDAKZO_REF, stiff=True,
)


# ---------------------------------------------------------------------------
# Van der Pol (ε = 1e-6 singular-perturbation form, and μ = 1e3 form)
# ---------------------------------------------------------------------------


def _vdp_f(t, y):
    return torch.stack([y[1],
                      ((1.0 - y[0] * y[0]) * y[1] - y[0]) / 1.0e-6])


VDP = IVProblem(
    name="VDP", f=_vdp_f, t0=0.0, y0=np.array([2.0, 0.0]), tf=2.0,
    y_ref=np.array([0.1706167732170483e1, -0.8928097010247975]), stiff=True)


def _vdp_mod_f(t, y):
    return torch.stack([y[1],
                      1.0e3 * (1.0 - y[0] * y[0]) * y[1] - y[0]])


VDP_MOD = IVProblem(
    name="VDP_MOD", f=_vdp_mod_f, t0=0.0, y0=np.array([2.0, 0.0]), tf=2.0e3,
    y_ref=np.array([0.1706167732170469e1, -0.8928097010248125e-3]),
    stiff=True)


# ---------------------------------------------------------------------------
# OREGO — Oregonator BZ-reaction limit cycle, 3 states (stiff)
# ---------------------------------------------------------------------------


def _orego_f(t, y):
    return torch.stack([
        77.27 * (y[1] + y[0] * (1.0 - 8.375e-6 * y[0] - y[1])),
        (y[2] - (1.0 + y[0]) * y[1]) / 77.27,
        0.161 * (y[0] - y[2]),
    ])


OREGO = IVProblem(
    name="OREGO", f=_orego_f, t0=0.0, y0=np.array([1.0, 2.0, 3.0]), tf=360.0,
    y_ref=np.array([0.1000814870318523e1, 0.1228178521549917e4,
                    0.1320554942846706e3]),
    stiff=True)


# ---------------------------------------------------------------------------
# ROBER — Robertson chemical kinetics over t ∈ [0, 1e11], 3 states (stiff)
# ---------------------------------------------------------------------------


def _rober_f(t, y):
    r1 = 0.04 * y[0]
    r2 = 1.0e4 * y[1] * y[2]
    r3 = 3.0e7 * y[1] * y[1]
    return torch.stack([-r1 + r2, r1 - r2 - r3, r3])


ROBER = IVProblem(
    name="ROBER", f=_rober_f, t0=0.0, y0=np.array([1.0, 0.0, 0.0]),
    tf=1.0e11,
    y_ref=np.array([0.2083340149701255e-7, 0.8333360770334713e-13,
                    0.9999999791665050]),
    stiff=True)


ALL_PROBLEMS = [HIRES, POLLU, RINGMOD, MEDAKZO, VDP, VDP_MOD, OREGO, ROBER]
