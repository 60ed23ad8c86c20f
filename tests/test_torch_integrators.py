"""The port's integrators (reak_tpu_torch.integrators) and its copy of the
stiff suite against the JAX package, f64 on the CPU: every fixed-step and
multistep method over 20 steps ≤1e-12; the suite's rate functions; the
adaptive Dormand–Prince and Fehlberg loops and the Rosenbrock 2(3) loop on
HIRES and ROBER with the same attempts, end time and flag, y ≤1e-10
relative; the budget failure, a tree state, and the k-attempt host check
against a check every attempt.  The JAX loops run under ``jax.jit``.

The adaptive runs stop early in the problems (HIRES at t = 5 or 0.05 of
321.8, ROBER at t = 0.2 or 0.1 of 1e11): on a CPU the port's eager loop
costs ~2 ms an attempt (dopri45) to ~11 ms (Rosenbrock's jacfwd on HIRES),
and the full runs take 10⁴ attempts each (the card runs them whole).
Explicit dopri45 on ROBER past t ≈ 0.2 runs at its stability bound, where
the two packages' last-bit differences grow (7e-9 relative at t = 1)."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.integrators as jig
from reak_tpu.integrators import (adaptive as jad, implicit as jim,
                                  ivp_suite as jivs, multistep as jms)
import reak_tpu_torch.integrators as ig
from reak_tpu_torch.integrators import adaptive as ad, implicit as im, \
    ivp_suite as ivs, multistep as ms

torch.set_num_threads(1)


def _osc(t, y):
    return torch.stack([y[1], -y[0] + 0.1 * torch.sin(t)])


def _josc(t, y):
    return jnp.stack([y[1], -y[0] + 0.1 * jnp.sin(t)])


Y0 = np.array([1.0, 0.2])


def _close(got, want, tol):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1.0)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4", "rk5"])
def test_fixed_steppers_and_rollout(method):
    _close(ig.integrate(_osc, torch.as_tensor(Y0), 0.3, 0.05, 20,
                        method=method, unroll=4),
           jig.integrate(_josc, jnp.asarray(Y0), 0.3, 0.05, 20,
                         method=method), 1e-12)
    _close(ig.rollout(_osc, torch.as_tensor(Y0), 0.3, 0.05, 20,
                      method=method),
           jig.rollout(_josc, jnp.asarray(Y0), 0.3, 0.05, 20, method=method),
           1e-12)


@pytest.mark.parametrize("name", ["adams_bm3", "adams_bm5", "hamming_mod",
                                  "hamming_iter_mod"])
def test_multistep_methods(name):
    for n in (20, 3):  # 3: fewer steps than the bootstrap window
        _close(getattr(ms, name)(_osc, torch.as_tensor(Y0), 0.3, 0.05, n),
               getattr(jms, name)(_josc, jnp.asarray(Y0), 0.3, 0.05, n),
               1e-12)


def test_attempt_steps():
    for name in ("rkf45_step", "dopri45_step"):
        got = getattr(ad, name)(_osc, torch.tensor(0.2, dtype=torch.float64),
                                torch.as_tensor(Y0),
                                torch.tensor(0.1, dtype=torch.float64))
        want = getattr(jad, name)(_josc, 0.2, jnp.asarray(Y0), 0.1)
        for g, w in zip(got, want):
            _close(g, w, 1e-12)
    f = lambda t, y: ivs.HIRES.f(t, y)
    jac = lambda t, y: torch.func.jacfwd(lambda yy: f(t, yy))(y)
    y = torch.as_tensor(ivs.HIRES.y0) + 0.01
    got = im.rosenbrock23_step(f, jac, torch.tensor(0.0, dtype=torch.float64),
                               y, torch.tensor(1e-3, dtype=torch.float64))
    want = jax.jit(lambda yy: jim.rosenbrock23_step(
        jivs.HIRES.f, lambda t, z: jax.jacfwd(
            lambda w: jivs.HIRES.f(t, w))(z), 0.0, yy, 1e-3))(
                jnp.asarray(y.numpy()))
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


@pytest.mark.parametrize("name", ["HIRES", "POLLU", "RINGMOD", "MEDAKZO",
                                  "VDP", "VDP_MOD", "OREGO", "ROBER"])
def test_suite_rate_functions(name):
    p, jp = getattr(ivs, name), getattr(jivs, name)
    assert (p.t0, p.tf, p.stiff) == (jp.t0, jp.tf, jp.stiff)
    np.testing.assert_array_equal(p.y0, jp.y0)
    np.testing.assert_array_equal(p.y_ref, jp.y_ref)
    y = p.y0 + 0.01 * np.random.default_rng(0).standard_normal(p.y0.shape)
    for t in (1e-4, 7.0):
        _close(p.f(torch.tensor(t, dtype=torch.float64), torch.as_tensor(y)),
               jp.f(jnp.asarray(t), jnp.asarray(y)), 1e-12)
    assert [q.name for q in ivs.ALL_PROBLEMS] == [q.name for q in
                                                  jivs.ALL_PROBLEMS]


def _same_run(got, want, rtol=1e-10):
    assert int(got.n_steps) == int(want.n_steps)
    assert bool(got.ok) == bool(want.ok)
    assert float(got.t) == float(want.t)
    y, wy = got.y.numpy(), np.asarray(want.y)
    assert np.max(np.abs(y - wy) / np.maximum(np.abs(wy), 1e-300)) <= rtol


@pytest.mark.parametrize("name,tf,method", [("HIRES", 5.0, "dopri45"),
                                            ("ROBER", 0.2, "dopri45"),
                                            ("HIRES", 2.0, "rkf45")])
def test_adaptive_against_jax(name, tf, method):
    p, jp = getattr(ivs, name), getattr(jivs, name)
    kw = dict(dt0=1e-4, tol=1e-10, dt_min=1e-12, max_steps=20_000,
              method=method)
    want = jax.jit(lambda y0: jad.integrate_adaptive(
        jp.f, y0, jp.t0, tf, **kw))(jnp.asarray(jp.y0))
    got = ad.integrate_adaptive(p.f, torch.as_tensor(p.y0), p.t0, tf, **kw)
    assert bool(got.ok)
    _same_run(got, want)


@pytest.mark.parametrize("name,tf,atol", [("HIRES", 0.05, 1e-12),
                                          ("ROBER", 0.1, 1e-14)])
def test_rosenbrock_against_jax(name, tf, atol):
    p, jp = getattr(ivs, name), getattr(jivs, name)
    kw = dict(dt0=1e-6, rtol=1e-7, atol=atol, max_steps=20_000)
    want = jax.jit(lambda y0: jim.integrate_rosenbrock(
        jp.f, y0, jp.t0, tf, **kw))(jnp.asarray(jp.y0))
    got = im.integrate_rosenbrock(p.f, torch.as_tensor(p.y0), p.t0, tf, **kw)
    assert bool(got.ok)
    _same_run(got, want)


def test_budget_failure_and_host_check_every_k():
    """``tests/test_integrators.py:62``: the budget runs out before t_end,
    in JAX and in the port.  At tol = 1e-12 the error estimate of this
    oscillator is rounding noise, so the two packages' states part at
    ~1e-7 after a few attempts; the flag and the attempts agree.  The
    condition read every k attempts (k = 7, the default 32) gives the state
    of a read every attempt bit for bit, with one read per k attempts and
    one at the end."""
    osc = lambda t, y: torch.stack([y[1], -y[0]])
    kw = dict(tol=1e-12, max_steps=10)
    want = jig.integrate_adaptive(lambda t, y: jnp.stack([y[1], -y[0]]),
                                  jnp.array([1.0, 0.0]), 0.0, 1000.0, 0.1,
                                  **kw)
    assert not bool(want.ok) and int(want.n_steps) == 10
    runs = {}
    for k in (1, 7, 32):
        before = ad.host_reads
        runs[k] = ad.integrate_adaptive(
            osc, torch.tensor([1.0, 0.0], dtype=torch.float64), 0.0, 1000.0,
            0.1, check_every=k, **kw)
        assert ad.host_reads - before == -(-10 // k) + 1
        assert not bool(runs[k].ok) and int(runs[k].n_steps) == 10
    for k in (7, 32):
        for a, b in zip(runs[k], runs[1]):
            assert torch.equal(a, b)
    # and on a run that ends at t_end: the same attempts for k = 1 and 32
    p = ivs.ROBER
    a = im.integrate_rosenbrock(p.f, torch.as_tensor(p.y0), 0.0, 1e-4, 1e-6,
                                rtol=1e-7, atol=1e-14, check_every=1)
    b = im.integrate_rosenbrock(p.f, torch.as_tensor(p.y0), 0.0, 1e-4, 1e-6,
                                rtol=1e-7, atol=1e-14, check_every=32)
    assert bool(a.ok) and int(a.n_steps) == int(b.n_steps)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


class _State(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor


def test_tree_state():
    """``tests/test_integrators.py:102``: a dict state, and here a
    NamedTuple in a list, through the steppers, the rollout, the multistep
    and the adaptive loop."""
    y0 = {"a": torch.tensor([1.0], dtype=torch.float64),
          "b": torch.tensor([0.0, 1.0], dtype=torch.float64)}

    def f(t, y):
        return {"a": -y["a"], "b": torch.stack([y["b"][1], -y["b"][0]])}

    y = ig.integrate(f, y0, 0.0, 0.01, 100, method="rk4")
    np.testing.assert_allclose(float(y["a"][0]), np.exp(-1.0), atol=1e-9)
    np.testing.assert_allclose(float(y["b"][0]), np.sin(1.0), atol=1e-9)
    s0 = [_State(torch.tensor([1.0], dtype=torch.float64),
                 torch.tensor([0.0], dtype=torch.float64))]
    g = lambda t, s: [_State(s[0].vel, -s[0].pos)]
    ys = ig.rollout(g, s0, 0.0, 0.1, 5)
    assert isinstance(ys[0], _State) and ys[0].pos.shape == (5, 1)
    y5 = ms.adams_bm5(g, s0, 0.0, 0.01, 100)
    np.testing.assert_allclose(float(y5[0].pos[0]), np.cos(1.0), atol=1e-8)
    res = ad.integrate_adaptive(g, s0, 0.0, 1.0, 0.1, tol=1e-10)
    assert bool(res.ok) and isinstance(res.y[0], _State)
    np.testing.assert_allclose(float(res.y[0].pos[0]), np.cos(1.0),
                               atol=1e-7)


def test_graph_chunks_give_the_eager_values(monkeypatch):
    """The chunked loops that CUDA graphs replay on the card (``graph_steps``
    of ``integrate``, ``rollout`` and the multistep methods), run here with
    the capture taken out: the same values as the plain loop, bit for bit,
    with whole chunks and a remainder."""
    from reak_tpu_torch.integrators import fixed

    y0 = torch.as_tensor(Y0)
    plain = (ig.integrate(_osc, y0, 0.3, 0.05, 23),
             ig.rollout(_osc, y0, 0.3, 0.05, 23),
             ms.adams_bm5(_osc, y0, 0.3, 0.05, 23),
             ms.hamming_iter_mod(_osc, y0, 0.3, 0.05, 23))
    chunks = []
    monkeypatch.setattr(fixed, "_on_card", lambda leaf: True)
    monkeypatch.setattr(fixed.graphs, "graphed",
                        lambda fn: chunks.append(fn) or fn)
    chunked = (ig.integrate(_osc, y0, 0.3, 0.05, 23, graph_steps=5),
               ig.rollout(_osc, y0, 0.3, 0.05, 23, graph_steps=5),
               ms.adams_bm5(_osc, y0, 0.3, 0.05, 23, graph_steps=5),
               ms.hamming_iter_mod(_osc, y0, 0.3, 0.05, 23, graph_steps=5))
    assert len(chunks) == 4
    for a, b in zip(plain, chunked):
        assert torch.equal(a, b)
