"""The second branch of the port's make_kte_mpc (``qp_layout="vmap"``,
``rollout="register"``) against the JAX solver with the same options, on
``planar_2link``, H = 8, B = 4, 6 Mehrotra iterations, f64 on the CPU, at
the JAX package's own bars for these layouts (``tests/test_riccati_soa.py::
test_make_kte_mpc_layouts_agree``: atol 1e-8, rtol 1e-6).

The routes: ``qp_layout="vmap"`` (the register rollout, then the
batch-first PDIP of ``ctrl/riccati.py``), ``qp_layout="vmap",
rollout="lanes"`` (the batch-first lanes rollout), ``rollout="register"``
(the register rollout, then the unfused lanes PDIP), and both options.  In
the JAX package ``qp_layout="vmap"`` takes the register rollout unless
``rollout="lanes"``, so "vmap" alone and "vmap" with "register" are one
solver there.  The second branch returns the QP model's xs and does no
line search; one case shows that with two SQP passes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ctrl import mpc as jmpc
from reak_tpu.kte import models as jmodels
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import mpc
from reak_tpu_torch.ops import chol_lanes, kte_step, pdip_whole

torch.set_num_threads(1)

H, B, DT, ITERS = 8, 4, 0.02, 6
# option sets of the port, and of the JAX solver they are held to
ROUTES = {"vmap": dict(qp_layout="vmap"),
          "vmap_lanes": dict(qp_layout="vmap", rollout="lanes"),
          "register": dict(rollout="register"),
          "vmap_register": dict(qp_layout="vmap", rollout="register")}
JAX_OF = {"vmap": "vmap", "vmap_lanes": "vmap_lanes",
          "register": "register", "vmap_register": "vmap"}


def _jax_problem():
    return jmpc.MPCProblem(
        Q=jnp.diag(jnp.array([10.0, 10.0, 1.0, 1.0])), R=jnp.eye(2) * 0.05,
        QN=jnp.diag(jnp.array([50.0, 50.0, 5.0, 5.0])),
        u_min=jnp.full(2, -3.0), u_max=jnp.full(2, 3.0), horizon=H)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, (B, 4))
    u0 = rng.uniform(-0.5, 0.5, (B, H, 2))
    prob_j = _jax_problem()
    keys = sorted(set(JAX_OF.values()))
    solvers = [jmpc.make_kte_mpc(jmodels.planar_2link(), prob_j, DT,
                                 qp_iters=ITERS, **ROUTES[key])
               for key in keys]
    # one program for the three JAX solvers: XLA compiles their shared
    # rollout once
    outs = jax.jit(lambda x, u: [s(x, u) for s in solvers])(
        jnp.asarray(x0), jnp.asarray(u0))
    want = {key: [np.asarray(a) for a in out] for key, out in zip(keys, outs)}
    return (convert.spec_from(jmodels.planar_2link()),
            convert.problem_from(prob_j, "cpu", torch.float64), x0, u0, want)


@pytest.mark.parametrize("route", ROUTES)
def test_second_branch_matches_jax(case, route):
    """Each route builds and solves on CPU tensors, launches nothing, and
    gives the JAX solver's controls and predicted states."""
    spec, prob, x0, u0, want = case
    before = (kte_step.launches, pdip_whole.launches,
              dict(chol_lanes.launches))
    us, xs = mpc.make_kte_mpc(spec, prob, DT, qp_iters=ITERS,
                              **ROUTES[route])(torch.as_tensor(x0),
                                               torch.as_tensor(u0))
    assert (kte_step.launches, pdip_whole.launches,
            dict(chol_lanes.launches)) == before
    assert us.shape == (B, H, 2) and xs.shape == (B, H, 4)
    us_j, xs_j = want[JAX_OF[route]]
    np.testing.assert_allclose(us.numpy(), us_j, atol=1e-8, rtol=1e-6)
    np.testing.assert_allclose(xs.numpy(), xs_j, atol=1e-8, rtol=1e-6)


def test_second_branch_takes_full_steps_and_no_references(case):
    """With two SQP passes the second branch takes the full QP step each
    pass (no line search, whatever ``sqp_linesearch`` says): two passes are
    one pass from the first pass's controls (H = 3).  Its solver takes no
    references, as the JAX package's."""
    spec, prob, x0, u0, _ = case
    prob = prob._replace(horizon=3)
    x0t, u0t = torch.as_tensor(x0), torch.as_tensor(u0[:, :3])
    make = lambda n: mpc.make_kte_mpc(spec, prob, DT, qp_iters=ITERS,
                                      sqp_iters=n, qp_layout="vmap",
                                      rollout="lanes")
    us1, _ = make(1)(x0t, u0t)
    us2, xs2 = make(2)(x0t, u0t)
    again, xs_again = make(1)(x0t, us1)
    assert torch.equal(us2, again) and torch.equal(xs2, xs_again)
    with pytest.raises(TypeError):
        make(1)(x0t, u0t, x_ref=torch.zeros(4))


@pytest.mark.parametrize("kw", [dict(qp_layout="dense"),
                                dict(rollout="scan")])
def test_unknown_options_raise(kw):
    spec = convert.spec_from(jmodels.planar_2link())
    prob = convert.problem_from(_jax_problem(), "cpu", torch.float64)
    with pytest.raises(ValueError):
        mpc.make_kte_mpc(spec, prob, DT, **kw)
