"""The port's rollout core (reak_tpu_torch.kte.lanes.make_core_ltv_lanes, the
plain version of the core kernel in ops/kte_core.py) against the JAX package
on the same numpy inputs, f64 on the CPU, and the core kernel's wrapper on
CPU tensors.  (The rollout over the core, ``make_rollout_ltv_fused``, is
held to the JAX package in tests/test_torch_kte.py.)

The JAX side of the core is ``kte_core_pallas.make_core_lanes_xla``, the
plain reference that tests/test_ops_pallas.py holds the core kernel to (the
kernel itself takes minutes to compile in interpret mode).  It runs op by op:
under ``jax.jit`` its XLA compile on a CPU takes minutes.  Bar: ≤1e-10
relative to the largest entry of each output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.kte import models as jmodels
from reak_tpu.ops import kte_core_pallas as kcp
from reak_tpu_torch import convert
from reak_tpu_torch.kte import lanes, models
from reak_tpu_torch.ops import kte_core

torch.set_num_threads(1)

REL = 1e-10


def _assert_rel(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.max(np.abs(want)), 1e-300)
    err = np.max(np.abs(got - want)) / scale
    assert err <= rel, f"relative error {err:.3e} > {rel:.0e}"


def _states(rng, B):
    return np.concatenate([rng.uniform(-0.5, 0.5, (B, 6)),
                           rng.uniform(-0.2, 0.2, (B, 6))], axis=1)


def test_core_matches_jax_plain_reference(rng):
    B = 5
    x = _states(rng, B).T.copy()
    u = rng.uniform(-5.0, 5.0, (6, B))
    want = kcp.make_core_lanes_xla(jmodels.manip_3r3r())(jnp.asarray(x),
                                                         jnp.asarray(u))
    got = lanes.make_core_ltv_lanes(models.manip_3r3r())(
        torch.as_tensor(x), torch.as_tensor(u))
    # (qdd, dqdd, minv); the reference's minv rows are broadcast, so the
    # comparison is of values
    for g, w in zip(got, want):
        _assert_rel(g, w)


def test_core_wrapper_takes_plain_version_on_cpu(rng):
    """On CPU tensors the kernel's wrapper is its plain version, and no
    launch is counted."""
    spec = models.manip_3r3r()
    x = torch.as_tensor(_states(rng, 3).T.copy())
    u = torch.as_tensor(rng.uniform(-2.0, 2.0, (6, 3)))
    before = kte_core.launches
    got = kte_core.make_core_lanes(spec)(x, u)
    want = kte_core.make_core_plain(spec)(x, u)
    assert [tuple(g.shape) for g in got] == [(6, 3), (6, 12, 3), (6, 6, 3)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kte_core.launches == before


def test_core_kernel_refuses_free_base_chains():
    """The core kernel is the fixed-base step kernel's first half: it
    refuses a free-base chain at its first call on a device tensor (a meta
    tensor stands in for a CUDA one)."""
    free = convert.spec_from(jmodels.manip_3r3r()).__class__.build(
        joint_types=[3], masses=[1.0])
    core = kte_core.make_core_lanes(free)
    with pytest.raises(NotImplementedError, match="free base"):
        core(torch.empty(12, 2, dtype=torch.float64, device="meta"),
             torch.empty(6, 2, dtype=torch.float64, device="meta"))
