"""The port's per-point rotations (reak_tpu_torch.math.rotations) and
status flags (reak_tpu_torch.errors) against the JAX package on the same
numpy inputs, f64 on the CPU: every rotation function at batch shapes (),
(5,) and (3, 4), ≤1e-12 relative; the flags and ``raise_on_error``
exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu import errors as jerr
from reak_tpu.math import rotations as jrot
from reak_tpu_torch import errors
from reak_tpu_torch.math import rotations as rot

SHAPES = [(), (5,), (3, 4)]


def _close(got, want, rtol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    assert np.max(np.abs(got - want), initial=0.0) <= rtol * scale


def _unit_quats(rng, shape):
    q = rng.standard_normal(shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pair(a):
    return torch.as_tensor(a), jnp.asarray(a)


@pytest.mark.parametrize("shape", SHAPES)
def test_quaternion_algebra(shape):
    rng = np.random.default_rng(1)
    q1, q2 = _unit_quats(rng, shape), _unit_quats(rng, shape)
    v = rng.standard_normal(shape + (3,))
    (t1, j1), (t2, j2), (tv, jv) = _pair(q1), _pair(q2), _pair(v)
    _close(rot.qmul(t1, t2), jrot.qmul(j1, j2))
    _close(rot.qconj(t1), jrot.qconj(j1))
    _close(rot.qnormalize(3.0 * t1), jrot.qnormalize(3.0 * j1))
    _close(rot.qnormalize(3.0 * t1, eps=1e-6), jrot.qnormalize(3.0 * j1,
                                                                 eps=1e-6))
    _close(rot.qrot(t1, tv), jrot.qrot(j1, jv))
    _close(rot.qrot_inv(t1, tv), jrot.qrot_inv(j1, jv))
    _close(rot.q_to_matrix(t1), jrot.q_to_matrix(j1))
    _close(rot.q_from_matrix(rot.q_to_matrix(t1)),
           jrot.q_from_matrix(jrot.q_to_matrix(j1)))
    _close(rot.qdot_from_omega(t1, tv), jrot.qdot_from_omega(j1, jv))
    _close(rot.omega_from_qdot(t1, t2), jrot.omega_from_qdot(j1, j2))
    _close(rot.qslerp(t1, t2, 0.3), jrot.qslerp(j1, j2, 0.3))
    _close(rot.hat(tv), jrot.hat(jv))
    _close(rot.vee(rot.hat(tv)), jrot.vee(jrot.hat(jv)))
    _close(rot.qidentity(torch.float64, shape, device="cpu"),
           jrot.qidentity(jnp.float64, shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_maps_axis_angle_and_euler(shape):
    rng = np.random.default_rng(2)
    v = rng.standard_normal(shape + (3,))
    v_small = 1e-9 * v  # the series branch of q_exp / q_log
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    angle = rng.uniform(-3.0, 3.0, shape)
    q = _unit_quats(rng, shape)
    ypr = [rng.uniform(-1.2, 1.2, shape) for _ in range(3)]
    for vv in (v, v_small):
        tv, jv = _pair(vv)
        _close(rot.q_exp(tv), jrot.q_exp(jv))
        _close(rot.q_log(rot.q_exp(tv)), jrot.q_log(jrot.q_exp(jv)))
    (ta, ja), (tg, jg), (tq, jq) = _pair(axis), _pair(angle), _pair(q)
    _close(rot.q_from_axis_angle(ta, tg), jrot.q_from_axis_angle(ja, jg))
    for got, want in zip(rot.q_to_axis_angle(tq), jrot.q_to_axis_angle(jq)):
        _close(got, want)
    ident = np.zeros(shape + (4,))
    ident[..., 0] = 1.0
    for got, want in zip(rot.q_to_axis_angle(torch.as_tensor(ident)),
                         jrot.q_to_axis_angle(jnp.asarray(ident))):
        _close(got, want)
    tq_e = rot.q_from_euler_tb(*(torch.as_tensor(a) for a in ypr))
    jq_e = jrot.q_from_euler_tb(*(jnp.asarray(a) for a in ypr))
    _close(tq_e, jq_e)
    for got, want in zip(rot.q_to_euler_tb(tq_e), jrot.q_to_euler_tb(jq_e)):
        _close(got, want)
    th = rng.uniform(-3.0, 3.0, shape)
    p2 = rng.standard_normal(shape + (2,))
    _close(rot.rot2d(torch.as_tensor(th)), jrot.rot2d(jnp.asarray(th)))
    _close(rot.rot2d_apply(torch.as_tensor(th), torch.as_tensor(p2)),
           jrot.rot2d_apply(jnp.asarray(th), jnp.asarray(p2)))


def test_q_from_matrix_every_pivot_branch():
    """Rotations by π about x, y and z and the identity pick each of the
    four Shepperd candidates."""
    qs = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0],
                   [0, 0, 0, 1.0], [-0.5, 0.5, -0.5, 0.5]])
    R = np.array(jrot.q_to_matrix(jnp.asarray(qs)))
    _close(rot.q_from_matrix(torch.as_tensor(R)),
           jrot.q_from_matrix(jnp.asarray(R)))


def test_status_flags_match():
    good = np.eye(3) * 2.0
    sing = np.diag([1.0, 1.0, 1e-20])
    notpd = np.diag([1.0, -1.0, 1.0])
    for A in (good, sing, notpd):
        assert int(errors.chol_singular_flag(torch.as_tensor(A))) == int(
            jerr.chol_singular_flag(jnp.asarray(A)))
    batch = np.stack([good, sing])
    np.testing.assert_array_equal(
        errors.chol_singular_flag(torch.as_tensor(batch)).numpy(),
        np.asarray(jerr.chol_singular_flag(jnp.asarray(batch))))
    nan = np.array([1.0, np.nan])
    for trees in (((np.ones(2),), {"a": np.ones(3)}),
                  ((np.ones(2), nan),), ((np.ones(2), [np.inf]),)):
        t_trees = [torch.utils._pytree.tree_map(torch.as_tensor, t)
                   for t in trees]
        assert int(errors.finite_flag(*t_trees)) == int(
            jerr.finite_flag(*trees))
    res = np.array([1e-9, 1e-3])
    np.testing.assert_array_equal(
        errors.convergence_flag(torch.as_tensor(res), 1e-6).numpy(),
        np.asarray(jerr.convergence_flag(jnp.asarray(res), 1e-6)))
    for s in range(16):
        assert errors.describe(torch.tensor(s)) == jerr.describe(s)


@pytest.mark.parametrize("status,exc", [
    (errors.OK, None), (errors.SINGULAR_MATRIX, errors.SingularityError),
    (errors.NONFINITE, errors.NonFiniteError),
    (errors.NOT_CONVERGED, errors.NotConvergedError),
    (errors.SINGULAR_MATRIX | errors.NONFINITE, errors.SingularityError),
    (errors.OUT_OF_BOUNDS, RuntimeError)])
def test_raise_on_error(status, exc):
    """The same exception class (by name) as the JAX package, on one status
    and on a batch in which one scenario failed."""
    for st in (torch.tensor(status), torch.tensor([0, status, 0])):
        if exc is None:
            errors.raise_on_error(st)
            jerr.raise_on_error(jnp.asarray(st.numpy()))
            continue
        with pytest.raises(exc):
            errors.raise_on_error(st)
        with pytest.raises(Exception) as jexc:
            jerr.raise_on_error(jnp.asarray(st.numpy()))
        assert type(jexc.value).__name__ == exc.__name__


def test_slice_modules_import_without_jax():
    """This slice's modules import with neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys

    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    code = (
        "import sys\n"
        "import reak_tpu_torch.errors, reak_tpu_torch.math.rotations,"
        " reak_tpu_torch.math.frames, reak_tpu_torch.ctrl.belief,"
        " reak_tpu_torch.ctrl.invariant, reak_tpu_torch.ctrl.ss_systems,"
        " reak_tpu_torch.ctrl.qp, reak_tpu_torch.kte.dynamics,"
        " reak_tpu_torch.ctrl.systems, reak_tpu_torch.ctrl.mpc,"
        " reak_tpu_torch.ctrl.mpc_manifold, reak_tpu_torch.convert,"
        " reak_tpu_torch.kte\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'reak_tpu' or m.startswith('reak_tpu.')"
        " for m in sys.modules), 'reak_tpu was imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
