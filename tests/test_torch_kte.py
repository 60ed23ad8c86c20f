"""The port's lanes KTE terms and rollout (reak_tpu_torch.kte) against the JAX
package on the same numpy inputs, f64 on the CPU, and the rollout over the
core kernel (``make_rollout_ltv_fused``) against the same JAX reference.

The JAX side of the rollout is ``make_rollout_ltv_lanes``, the plain
reference that ``tests/test_ops_pallas.py`` holds the step kernel equal to
(the kernel itself takes minutes to compile in interpret mode).  Bar:
≤1e-10 relative to the largest entry of each output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import mpc as jmpc
from reak_tpu.kte import lanes as jlanes, models as jmodels
from reak_tpu_torch import convert
from reak_tpu_torch.kte import lanes, models
from reak_tpu_torch.ops import kte_core, kte_step

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


def test_terms_lanes_match_jax(rng):
    q = rng.uniform(-0.5, 0.5, (6, 4))
    qd = rng.uniform(-0.5, 0.5, (6, 4))
    M_j, f_j = jax.jit(jlanes.make_terms_lanes(jmodels.manip_3r3r()))(
        jnp.asarray(q), jnp.asarray(qd))
    M_t, f_t = lanes.make_terms_lanes(models.manip_3r3r())(
        torch.as_tensor(q), torch.as_tensor(qd))
    _assert_rel(M_t, M_j)
    _assert_rel(f_t, f_j)


@pytest.fixture(scope="module")
def rollout_case():
    """B=4, H=2 inputs (numpy seed 42) and the JAX package's
    ``make_rollout_ltv_lanes`` of them, computed once for the tests that
    share it."""
    rng = np.random.default_rng(42)
    B, H = 4, 2
    x0 = _states(rng, B)
    us = rng.uniform(-2.0, 2.0, (B, H, 6))
    roll_j = jlanes.make_rollout_ltv_lanes(jmodels.manip_3r3r(), 0.01, H)
    out_j = roll_j(jnp.asarray(x0), jnp.asarray(us))
    return x0, us, [np.asarray(o) for o in out_j]


def test_rollout_ltv_lanes_matches_jax(rollout_case):
    x0, us, out_j = rollout_case
    out_t = lanes.make_rollout_ltv_lanes(models.manip_3r3r(), 0.01,
                                         us.shape[1])(
        torch.as_tensor(x0), torch.as_tensor(us))
    for got, want in zip(out_t, out_j):
        _assert_rel(got, want)


def test_rollout_ltv_fused_matches_jax(rollout_case):
    """The rollout over the core kernel (``make_rollout_ltv_fused``; on CPU
    tensors its wrapper takes the plain core) against the JAX
    ``make_rollout_ltv_lanes``, the function the JAX ``make_rollout_ltv_fused``
    computes (≤1e-10), and against the port's plain rollout, whose step is
    the same core and series (≤1e-12); no launch is counted."""
    x0, us, out_j = rollout_case
    spec, H = models.manip_3r3r(), us.shape[1]
    before = kte_core.launches
    out_t = lanes.make_rollout_ltv_fused(spec, 0.01, H)(
        torch.as_tensor(x0), torch.as_tensor(us))
    assert kte_core.launches == before
    out_p = lanes.make_rollout_ltv_lanes(spec, 0.01, H)(
        torch.as_tensor(x0), torch.as_tensor(us))
    for got, want, plain in zip(out_t, out_j, out_p):
        _assert_rel(got, want)
        assert float((got - plain).abs().max()) <= 1e-12


def test_step_wrapper_takes_plain_version_on_cpu(rng):
    """On CPU tensors the kernel's wrapper is its plain version, and no
    launch is counted."""
    spec = models.manip_3r3r()
    x = torch.as_tensor(_states(rng, 3).T.copy())
    u = torch.as_tensor(rng.uniform(-2.0, 2.0, (6, 3)))
    before = kte_step.launches
    got = kte_step.make_step_lanes(spec, 0.01)(x, u)
    want = kte_step.make_step_plain(spec, 0.01)(x, u)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kte_step.launches == before


def test_chain_table_layout():
    spec = models.manip_3r3r()
    table = kte_step.chain_table(spec, "cpu", torch.float64).numpy()
    assert table.shape == (27 * 6 + 3,)
    np.testing.assert_array_equal(table[-3:], spec.gravity)
    for i in range(6):
        row = table[27 * i:27 * (i + 1)]
        assert row[0] == spec.joint_types[i]
        np.testing.assert_array_equal(row[1:4], spec.axes[i])
        assert row[14] == spec.masses[i]
        np.testing.assert_array_equal(row[15:24], spec.inertias[i])


def test_convert_round_trip():
    """JAX ChainSpec/MPCProblem → port → the same numbers; the port's own
    manip_3r3r equals the converted one, and converting twice is a no-op."""
    spec_j = jmodels.manip_3r3r()
    spec_t = convert.spec_from(spec_j)
    assert spec_t == models.manip_3r3r()
    assert convert.spec_from(spec_t) == spec_t
    for field in ("joint_types", "axes", "offsets_pos", "offsets_quat",
                  "com_pos", "masses", "inertias", "gravity"):
        np.testing.assert_array_equal(np.asarray(getattr(spec_t, field)),
                                      np.asarray(getattr(spec_j, field)))
    prob_j = jmpc.MPCProblem(Q=jnp.eye(12) * 3.0, R=jnp.eye(6) * 0.05,
                             QN=jnp.eye(12) * 7.0, u_min=jnp.full(6, -4.0),
                             u_max=jnp.full(6, 4.0), horizon=5)
    prob_t = convert.problem_from(prob_j, "cpu", torch.float64)
    assert prob_t.horizon == 5
    for a, b in zip(prob_t[:5], prob_j[:5]):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    prob_t2 = convert.problem_from(prob_t, "cpu", torch.float64)
    for a, b in zip(prob_t2[:5], prob_t[:5]):
        assert torch.equal(a, b)


def test_free_base_chain_is_not_ported():
    """The rollout-step kernel is the fixed-base flagship's, as in the JAX
    package: it refuses a free-base chain, whose terms take the generic
    lanes assembly instead (tests/test_torch_kte_free.py)."""
    spec = convert.spec_from(jmodels.manip_3r3r())
    free = spec.__class__.build(joint_types=[3], masses=[1.0])
    M, f = lanes.make_terms_lanes(free)(
        torch.tensor([[0.0], [0.0], [0.0], [1.0], [0.0], [0.0], [0.0]],
                     dtype=torch.float64), torch.zeros(6, 1,
                                                       dtype=torch.float64))
    assert M.shape == (6, 6, 1) and f.shape == (6, 1)
    step = kte_step.make_step_lanes(free, 0.01)  # the kernel is chosen later
    with pytest.raises(NotImplementedError, match="free base"):
        # at its first call on a device tensor (a meta tensor stands in)
        step(torch.empty(12, 2, dtype=torch.float64, device="meta"),
             torch.empty(6, 2, dtype=torch.float64, device="meta"))
    assert spec.nv == 6
