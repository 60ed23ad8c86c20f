"""The port's register-form KTE dynamics (reak_tpu_torch.kte.soa) and the
batch-first lanes rollout (kte/lanes.make_rollout_ltv_batchfirst) against
the JAX package on the same seeded numpy inputs, f64 on the CPU, ≤1e-10
relative, on ``planar_2link`` and on the mixed chain
``kte/models.mixed_chain`` (FIXED and PRISMATIC joints, offset quaternions,
springs, dampers, full inertia tensors):

- the terms (M, f) and q̈ on both chains against JAX's, op by op
  (``jax.disable_jit``);
- the register and batch-first rollouts with their LTV models at H = 2
  and 3 on ``planar_2link`` against JAX's register rollout (one JAX run
  at H = 3; H = 2 is its first two steps);
- on the mixed chain, the register rollout against the port's lanes
  rollout and the batch-first one against the register one, H = 1.  JAX's
  register rollout of this chain takes ~48 s a step op by op on a CPU (its
  ``jax.linearize``) and minutes to compile under ``jax.jit``; the port's
  lanes terms and step are held to JAX's on this chain in
  ``tests/test_torch_kte_step_shapes.py``, and the register terms above."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.kte import models as jmodels, soa as jsoa
from reak_tpu.kte import spec as jspec
from reak_tpu_torch import convert
from reak_tpu_torch.kte import lanes, models, soa

torch.set_num_threads(1)

B = 3


def _chain(name):
    """(JAX spec, the port's spec) of one chain."""
    if name == "planar_2link":
        j = jmodels.planar_2link()
    else:
        j = jspec.ChainSpec.build(**models.mixed_chain_fields())
    return j, convert.spec_from(j)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _states(rng, nv):
    return np.concatenate([rng.uniform(-0.5, 0.5, (nv, B)),
                           rng.uniform(-0.3, 0.3, (nv, B))])


def _grid(entries):
    """A nested tuple of (array | float) entries → one array (…, B)."""
    return np.stack([np.stack([np.broadcast_to(np.asarray(e), (B,))
                               for e in row]) for row in entries])


CHAINS = ["planar_2link", "mixed_chain"]


@pytest.mark.parametrize("name", CHAINS)
def test_terms_and_forward_dynamics_match_jax(name):
    js, ts = _chain(name)
    rng = np.random.default_rng(4)
    x = _states(rng, ts.nv)
    tau = rng.uniform(-3.0, 3.0, (ts.nv, B))
    nv = ts.nv
    jq = tuple(jnp.asarray(x[i]) for i in range(nv))
    jqd = tuple(jnp.asarray(x[nv + i]) for i in range(nv))
    tq = tuple(torch.as_tensor(x[i]) for i in range(nv))
    tqd = tuple(torch.as_tensor(x[nv + i]) for i in range(nv))
    with jax.disable_jit():
        Mj, fj = jsoa.make_terms_soa(js)(jq, jqd)
        # the terms just taken, not evaluated again
        qddj = jsoa.forward_dynamics_soa(js, lambda q, qd: (Mj, fj), jq, jqd,
                                         tuple(jnp.asarray(t) for t in tau))
    Mt, ft = soa.make_terms_soa(ts)(tq, tqd)
    assert all(torch.is_tensor(e) and e.shape == (B,) for row in Mt
               for e in row)
    assert _rel(_grid(Mt), _grid(Mj)) <= 1e-10
    assert _rel(_grid([ft]), _grid([fj])) <= 1e-10
    qddt = soa.forward_dynamics_soa(ts, soa.make_terms_soa(ts), tq, tqd,
                                    tuple(torch.as_tensor(t) for t in tau))
    assert _rel(_grid([qddt]), _grid([qddj])) <= 1e-10
    # the lanes terms compute the same (M, f)
    Ml, fl = lanes.make_terms_lanes(ts)(torch.as_tensor(x[:nv]),
                                        torch.as_tensor(x[nv:]))
    assert _rel(Ml.numpy(), _grid(Mj)) <= 1e-10


@pytest.fixture(scope="module")
def planar_case():
    """planar_2link at H = 3: the inputs and JAX's register rollout (JAX's
    batch-first lanes rollout is the same function: its own tests hold the
    two to each other, ``tests/test_lanes_rollout.py``)."""
    js, ts = _chain("planar_2link")
    rng = np.random.default_rng(5)
    x0 = _states(rng, ts.nv).T
    us = rng.uniform(-2.0, 2.0, (B, 3, ts.nv))
    return ts, x0, us, jsoa.make_rollout_ltv_soa(js, 0.01, 3)(
        jnp.asarray(x0), jnp.asarray(us))


@pytest.mark.parametrize("horizon", [2, 3])
@pytest.mark.parametrize("kind", ["register", "batchfirst"])
def test_rollouts_match_jax(planar_case, kind, horizon):
    """``make_rollout_ltv_soa`` and ``make_rollout_ltv_batchfirst``: (A, B,
    c, xs) batch first, against JAX's register rollout on
    ``planar_2link``."""
    ts, x0, us, want = planar_case
    make = (soa.make_rollout_ltv_soa if kind == "register"
            else lanes.make_rollout_ltv_batchfirst)
    got = make(ts, 0.01, horizon)(torch.as_tensor(x0),
                                  torch.as_tensor(us[:, :horizon]))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)[:, :horizon]) <= 1e-10


def test_mixed_chain_rollouts_agree():
    """On the mixed chain: the register rollout against the lanes rollout
    (moved batch first), and the batch-first one against the register
    one, H = 1."""
    _, ts = _chain("mixed_chain")
    rng = np.random.default_rng(9)
    x0 = torch.as_tensor(_states(rng, ts.nv).T)
    us = torch.as_tensor(rng.uniform(-2.0, 2.0, (B, 1, ts.nv)))
    reg = soa.make_rollout_ltv_soa(ts, 0.01, 1)(x0, us)
    lan = lanes.make_rollout_ltv_lanes(ts, 0.01, 1)(x0, us)
    bf = lanes.make_rollout_ltv_batchfirst(ts, 0.01, 1)(x0, us)
    for r, l, b in zip(reg, lan, bf):
        assert _rel(r.numpy(), torch.movedim(l, -1, 0).numpy()) <= 1e-10
        assert _rel(b.numpy(), r.numpy()) <= 1e-10


def test_register_rollout_refuses_a_free_base():
    with pytest.raises(ValueError, match="fixed-base"):
        soa.make_rollout_ltv_soa(models.floating_arm(), 0.01, 2)


def test_register_step_makes_no_host_tensor_on_a_second_call(monkeypatch):
    """The step's unit tangents, identity right-hand sides and identity are
    made once per (dtype, device), so the step could be captured into a
    CUDA graph: a second call makes no tensor from host memory."""
    ts = models.planar_2link()
    roll = soa.make_rollout_ltv_soa(ts, 0.01, 1)
    x0 = torch.zeros(2, 4, dtype=torch.float64)
    us = torch.zeros(2, 1, 2, dtype=torch.float64)
    roll(x0, us)
    made = []
    for fn in ("as_tensor", "tensor", "from_numpy"):
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, lambda *a, _r=real, **k: (
            made.append(fn), _r(*a, **k))[1])
    roll(x0, us)
    assert made == []
