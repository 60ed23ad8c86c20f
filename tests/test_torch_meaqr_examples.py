"""The planners over a MEAQR space (``reak_tpu_torch.ctrl.aqr_space.
meaqr_rrt_star_plan``, ``meaqr_sbastar_plan``) and the two examples
(``reak_tpu_torch.examples.x8_planner``, ``crs_dynexec``) against the JAX
package, f64 on the CPU.

- The planners on the JAX test's double-integrator MEAQR space
  (tests/test_aqr_space.py:11-21), from the JAX planners' own draws
  (``ReplayDraws``): success, counts and iterations equal, path and cost
  ≤1e-10.
- ``x8_planner.hover_lti`` ≤1e-12 of JAX's; ``main`` at the settings of
  tests/test_examples.py:78.
- ``crs_dynexec``: the truth, the measurements (JAX's noise draws given to
  the port), the online IEKF over the loopback TCP rows, the prediction and
  the IK table ≤1e-9 of the JAX package's functions at the JAX test's
  settings (tests/test_examples.py:51-68), and ``main`` there, on a port
  the test picks: its three printed claims and the recorded plan.  The
  JAX examples are not run end to end (both are ``slow`` in
  tests/test_examples.py).
"""
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _planning_jax import assert_result_equal, tree_draws
from reak_tpu.ctrl import aqr_space as jaqr, ss_systems as jss
from reak_tpu.ctrl import predictor as jpred
from reak_tpu.ctrl.belief import GaussianBelief as JBelief
from reak_tpu.ctrl.invariant import iekf_step as j_iekf_step
from reak_tpu.kte import ik as jik, models as jmodels
from reak_tpu.math import rotations as jrot
from reak_tpu.planning.queries import PlanningQuery
from reak_tpu_torch.ctrl import aqr_space as aqr
from reak_tpu_torch.examples import crs_dynexec as dyn, x8_planner as x8
from reak_tpu_torch.kte import models
from reak_tpu_torch.planning.draws import ReplayDraws

torch.set_num_threads(1)
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
A = [[0.0, 1.0], [0.0, 0.0]]   # double integrator
B = [[0.0], [1.0]]
LO, HI = [-5.0, -3.0], [5.0, 3.0]
KW = dict(t_max=3.0, n_grid=32, time_weight=0.1)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def meaqr():
    return (aqr.MEAQRSpace(A, B, LO, HI, device="cpu", **KW),
            jaqr.MEAQRSpace(jnp.asarray(A), jnp.asarray(B), jnp.asarray(LO),
                            jnp.asarray(HI), **KW))


def test_meaqr_rrt_star_matches_jax(meaqr):
    """The JAX wrapper test's run (tests/test_aqr_space.py:84-92)."""
    sp, jsp = meaqr
    q = PlanningQuery(np.array([0.0, 0.0]), np.array([0.8, 0.0]),
                      goal_tolerance=0.6)
    kw = dict(max_iters=15, step_size=1.0, capacity=256)
    jr = jaqr.meaqr_rrt_star_plan(jsp, lambda p: jnp.ones(p.shape[0], bool),
                                  q, seed=1, **kw)
    tr = aqr.meaqr_rrt_star_plan(
        sp, lambda p: torch.ones(p.shape[0], dtype=torch.bool), q,
        seed=ReplayDraws(tree_draws(jsp, 1, 15, 32)), **kw)
    assert jr.n_vertices > 1
    assert_result_equal(tr, jr, rtol=1e-10)


def test_meaqr_sbastar_matches_jax(meaqr):
    """The RRT* test's query (the JAX SBA*, host-driven, compiles its
    steps for each new tree size, so the run is one front expansion)."""
    sp, jsp = meaqr
    q = PlanningQuery(np.array([0.0, 0.0]), np.array([0.8, 0.0]),
                      goal_tolerance=0.6)
    kw = dict(max_iters=8, step_size=1.0, capacity=256)
    jr = jaqr.meaqr_sbastar_plan(jsp, lambda p: jnp.ones(p.shape[0], bool),
                                 q, seed=3, **kw)
    key, subs = jax.random.PRNGKey(3), []
    for _ in range(8):
        key, sub = jax.random.split(key)
        subs.append(sub)
    normal = jax.jit(jax.random.normal, static_argnums=1)
    draws = [lambda shape, k=k: np.asarray(normal(k, shape)) for k in subs]
    tr = aqr.meaqr_sbastar_plan(
        sp, lambda p: torch.ones(p.shape[0], dtype=torch.bool), q,
        seed=ReplayDraws(draws), **kw)
    assert jr.success
    assert_result_equal(tr, jr, rtol=1e-10)


def test_hover_lti_matches_jax():
    sys.path.insert(0, os.path.abspath(EXAMPLES))
    from examples import x8_planner as jx8

    A_, B_ = x8.hover_lti(x8.ss.quadrotor(), "cpu")
    jA, jB = jax.jit(jx8.hover_lti)(jss.quadrotor())
    np.testing.assert_allclose(A_.numpy(), np.asarray(jA), rtol=0,
                               atol=1e-12 * max(1.0, np.abs(jA).max()))
    np.testing.assert_allclose(B_.numpy(), np.asarray(jB), rtol=0,
                               atol=1e-12 * max(1.0, np.abs(jB).max()))
    assert A_.shape == (12, 12) and B_.shape == (12, 4)


def test_x8_main_on_the_cpu(capsys):
    import json

    rc = x8.main(["--planner=rrt_star", "--max-iters=10", "--seed=1",
                  "--n-grid=24", "--capacity=768", "--device=cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["success"]
    assert out["cost"] < 10.0


CFG = dict(dyn.DEFAULTS, steps=15, horizon=15, max_iters=60, device="cpu")


def _jax_stages(cfg, port):
    """The JAX example's stages 0-4 (examples/crs_dynexec.py:70-153) with
    the JAX package's functions: the truth's step, the IEKF step and the
    prediction each under one ``jax.jit``."""
    sys.path.insert(0, os.path.abspath(EXAMPLES))
    import crs_dynexec as jdyn

    # jdyn.target_truth with its step under jax.jit
    F = jss.satellite3D_imdt(jss.satellite3D(mass=120.0,
                                             inertia=jnp.eye(3) * 8.0),
                             cfg["dt"])
    step_F = jax.jit(lambda x: F(x, jnp.zeros(6)))
    x = jss.default_state()
    x = x.at[0:3].set(jnp.array([0.62, -0.28, 0.40]))
    x = x.at[7:10].set(jnp.array([-0.035, 0.06, 0.01]))
    x = x.at[10:13].set(jnp.array([0.02, -0.01, 0.03]))
    xs = [x]
    for _ in range(cfg["steps"] + cfg["horizon"]):
        xs.append(step_F(xs[-1]))
    xs = jnp.stack(xs)
    zs = jax.vmap(jss.h_pose_gyro)(xs[1: cfg["steps"] + 1])
    k1, _ = jax.random.split(jax.random.PRNGKey(cfg["seed"]))
    noise = jax.random.normal(k1, (cfg["steps"], 3))
    zs = zs.at[:, 0:3].add(cfg["meas_noise"] * noise)
    ret = jss.sat3D_retraction()
    Qd = jnp.eye(12) * cfg["proc_noise"]
    R = jnp.eye(9) * cfg["meas_noise"] ** 2 * 10 + jnp.eye(9) * 1e-8
    step = jax.jit(lambda b, z: j_iekf_step(
        F, jss.h_pose_gyro, ret, b, jnp.zeros(6), z, Qd, R,
        diff=jss.pose_innovation))
    b = JBelief(jss.default_state().at[0:3].set(jnp.array([0.6, -0.3, 0.4])),
                jnp.eye(12) * 0.25)
    rows = list(jdyn.stream_measurements(dict(cfg, port=port), zs))
    for z in rows:
        b = step(b, z)
    H = cfg["horizon"]
    traj = jax.jit(lambda b: jpred.predict_belief_trajectory(
        F, ret, b, jnp.zeros((H, 6)), Qd, cfg["dt"],
        t0=cfg["steps"] * cfg["dt"]))(b)
    spec = jmodels.manip_3r3r()
    q_tab = jax.vmap(lambda mm: jik.ik_3r3r(
        spec, mm[0:3], jrot.qnormalize(mm[3:7]), wrist=-1.0))(
        traj.means[: H + 1])
    return dict(xs=xs, zs=zs, rows=len(rows), mean=b.mean, cov=b.cov,
                means=traj.means, covs=traj.covs, q_tab=q_tab), noise


def test_dynexec_stages_match_jax():
    want, noise = _jax_stages(CFG, _free_port())
    cfg = dict(CFG, port=_free_port())
    F, xs = dyn.target_truth(cfg)
    zs = dyn.measurements(cfg, xs, np.asarray(noise))
    b, n_rows = dyn.estimate_online(cfg, F, zs)
    traj = dyn.predict(cfg, F, b)
    q_tab = dyn.joint_table(models.manip_3r3r(),
                            traj.means[: cfg["horizon"] + 1])
    got = dict(xs=xs, zs=zs, rows=n_rows, mean=b.mean, cov=b.cov,
               means=traj.means, covs=traj.covs, q_tab=q_tab)
    assert got["rows"] == want["rows"] == cfg["steps"]
    for key in ("xs", "zs", "mean", "cov", "means", "covs", "q_tab"):
        w = np.asarray(want[key])
        err = np.max(np.abs(got[key].numpy() - w))
        assert err <= 1e-9 * max(1.0, np.abs(w).max()), (key, err)


def test_dynexec_main_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "plan.csv")
    rc = dyn.main(["--steps=15", "--horizon=15", "--max-iters=60",
                   f"--port={_free_port()}", f"--output={out}",
                   "--device=cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "rows streamed" in text and "intercept planned" in text
    assert "all clear of the moving target body: True" in text
    with open(out) as f:
        rows = f.read().strip().splitlines()
    assert len(rows) >= 3  # header + at least two waypoints
