"""The widths that the reference's zoo and tests build and that the port's
kernels once refused: the flexible beams of ``reak_tpu/kte/models.py``
(one joint a segment; ``tests/test_kte_elements.py`` builds 16) carried
into the port, and the port's ``make_kte_mpc`` on a 9-segment beam on CPU
tensors, against the JAX package on the same numpy inputs at f64.

JAX's own ``make_kte_mpc`` compiles the 9-joint rollout inside its
``lax.scan`` for over a minute on a CPU (and runs as long op by op), so the
JAX side of the solve is held in its two parts on the port's inputs: each
stage's LTV from JAX's ``make_terms_lanes`` and its jvp along every state
direction, with the solves and the exponential series of
``make_rollout_ltv_lanes`` in numpy, then JAX's PDIP on that LTV.  Bars:
controls and states ≤1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import mpc as jmpc
from reak_tpu.ctrl.riccati_soa import solve_box_mpc_riccati_soa_fused
from reak_tpu.kte import lanes as jlanes
from reak_tpu.kte import models as jmodels
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import mpc
from reak_tpu_torch.kte import models
from reak_tpu_torch.ops import kte_step, pdip_whole
from test_torch_kte_step_shapes import _core_and_step_of

torch.set_num_threads(1)

FIELDS = ("axes", "offsets_pos", "offsets_quat", "com_pos", "masses",
          "inertias", "stiffness", "rest_q", "damping", "gravity")
# dt of the 9-segment beam: its fastest mode is overdamped at
# |λ| ≈ 5.1e4 /s, and the order-4 series (and RK4) is stable for
# |λ| dt ≤ 2.78 on the negative real axis
BEAM9_DT = 2e-5


@pytest.mark.parametrize("name,kw", [
    ("flexible_beam", {}), ("flexible_beam", {"n_segments": 9}),
    ("flexible_beam", {"n_segments": 16, "tip_mass": 0.2,
                       "axis": (0.0, 0.0, 1.0)}),
    ("floating_flexible_beam", {}),
    ("floating_flexible_beam", {"n_segments": 11, "base_mass": 4.0})])
def test_beam_models_match_jax(name, kw):
    """The port's beams are the JAX package's, field by field
    (``convert.spec_from`` of the JAX spec)."""
    want = convert.spec_from(getattr(jmodels, name)(**kw))
    got = getattr(models, name)(**kw)
    assert got.joint_types == want.joint_types
    assert got.name == want.name
    for field in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    joints = kw.get("n_segments", 8 if name == "flexible_beam" else 4)
    assert got.nv == joints + (6 if name == "floating_flexible_beam" else 0)


def _jax_rollout_ltv(jspec, x0, us, dt):
    """(A (H,n,n,B), Bm (H,n,m,B), c (H,n,B)) of ``make_rollout_ltv_lanes``
    along x0 (B, n) and us (B, H, m): per stage, JAX's terms and their jvp
    along the n state directions (one ``jax.jvp`` over the scenarios
    repeated n times, op by op), the solves and the series in numpy."""
    nv = jspec.nv
    n, B = 2 * nv, x0.shape[0]
    terms = jlanes.make_terms_lanes(jspec)
    tangent = np.repeat(np.eye(n), B, axis=1)  # column d·B + b: direction d
    x = x0.T.copy()
    seqs = []
    for t in range(us.shape[1]):
        (M, f), (dM, df) = jax.jvp(lambda xx: terms(xx[:nv], xx[nv:]),
                                   (jnp.asarray(np.tile(x, (1, n))),),
                                   (jnp.asarray(tangent),))
        M, f = np.asarray(M)[..., :B], np.asarray(f)[..., :B]
        dM = np.moveaxis(np.asarray(dM).reshape(nv, nv, n, B), 2, 0)
        df = np.moveaxis(np.asarray(df).reshape(nv, n, B), 1, 0)
        _, (Ad, Bd, cd, x) = _core_and_step_of(x, us[:, t].T, M, f, dM, df,
                                               dt)
        seqs.append((Ad, Bd, cd))
    return tuple(np.stack(s, axis=0) for s in zip(*seqs))


def test_make_kte_mpc_on_a_9_segment_beam_matches_jax(rng):
    """F7: the port's ``make_kte_mpc`` once raised for a chain of more
    than 8 joints when it was built, on any device; on CPU tensors it now
    builds and solves a 9-segment beam (H=3, B=4, one SQP pass, 8
    iterations, f64) and agrees with the JAX package (see the module), with
    bounds active in some scenarios, and launches no kernel."""
    H, B = 3, 4
    jspec = jmodels.flexible_beam(9)
    nv = jspec.nv
    w = np.concatenate([np.full(nv, 10.0), np.full(nv, 1.0)])
    prob_j = jmpc.MPCProblem(Q=jnp.diag(jnp.asarray(w)), R=jnp.eye(nv) * 0.05,
                             QN=jnp.diag(jnp.asarray(5.0 * w)),
                             u_min=jnp.full(nv, -8.0),
                             u_max=jnp.full(nv, 8.0), horizon=H)
    x0 = np.concatenate([rng.uniform(-0.05, 0.05, (B, nv)),
                         rng.uniform(-0.5, 0.5, (B, nv))], axis=1)
    u0 = rng.uniform(-1.0, 1.0, (B, H, nv))
    spec = convert.spec_from(jspec)
    prob = convert.problem_from(prob_j, "cpu", torch.float64)
    launches = (kte_step.launches, pdip_whole.launches)
    solve = mpc.make_kte_mpc(spec, prob, BEAM9_DT, qp_iters=8, sqp_iters=1)
    us_t, xs_t = solve(torch.as_tensor(x0), torch.as_tensor(u0))
    assert (kte_step.launches, pdip_whole.launches) == launches
    assert us_t.shape == (B, H, nv) and xs_t.shape == (B, H, 2 * nv)

    A, Bm, c = _jax_rollout_ltv(jspec, x0, u0, BEAM9_DT)
    ul, xl = solve_box_mpc_riccati_soa_fused(
        jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(c), prob_j.Q, prob_j.QN,
        prob_j.R, jnp.asarray(x0.T), prob_j.u_min, prob_j.u_max, iters=8)
    us_j = np.moveaxis(np.asarray(ul), -1, 0)
    xs_j = np.moveaxis(np.asarray(xl), -1, 0)
    assert np.max(np.abs(us_t.numpy() - us_j)) <= 1e-9
    assert np.max(np.abs(xs_t.numpy() - xs_j)) <= 1e-9
    active = np.abs(us_j) > 8.0 - 1e-6
    assert 0 < active.sum() < active.size
