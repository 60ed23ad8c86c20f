"""The port's lanes-layout rotations (reak_tpu_torch.math.rot_lanes) against
the JAX package's ``reak_tpu/math/rot_lanes.py`` on the same numpy inputs,
f64 on the CPU, with a leading axis to show the broadcasting.  Bar: ≤1e-13
absolute (every output is O(1)); forward-mode derivatives of ``q_exp_l`` and
``q_log_l`` at the identity are finite and equal to JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.math import rot_lanes as jrl
from reak_tpu_torch.math import rot_lanes as rl

torch.set_num_threads(1)

TOL = 1e-13
LEAD, B = 2, 7


def _quat(rng):
    q = rng.standard_normal((LEAD, 4, B))
    return q / np.linalg.norm(q, axis=-2, keepdims=True)


def _vec(rng, scale=1.0):
    return scale * rng.standard_normal((LEAD, 3, B))


def _inputs(name, rng):
    """Arguments of each function, numpy, components on axis -2."""
    return {
        "cross_l": lambda: (_vec(rng), _vec(rng)),
        "qmul_l": lambda: (_quat(rng), _quat(rng)),
        "qconj_l": lambda: (_quat(rng),),
        "qnormalize_l": lambda: (2.0 * _quat(rng),),
        "qrot_l": lambda: (_quat(rng), _vec(rng)),
        "qrot_inv_l": lambda: (_quat(rng), _vec(rng)),
        # rotation vectors of both branches: ordinary and below the guard
        "q_exp_l": lambda: (np.concatenate(
            [_vec(rng), _vec(rng, 1e-9)], axis=-1),),
        "q_log_l": lambda: (np.concatenate(
            [_quat(rng) * np.sign(_quat(rng)[..., :1, :]),
             np.asarray(jrl.q_exp_l(jnp.asarray(_vec(rng, 1e-9))))],
            axis=-1),),
        "q_to_matrix_l": lambda: (_quat(rng),),
        "skew_l": lambda: (_vec(rng),),
        "qdot_from_omega_l": lambda: (_quat(rng), _vec(rng)),
    }[name]()


NAMES = ["cross_l", "qmul_l", "qconj_l", "qnormalize_l", "qrot_l",
         "qrot_inv_l", "q_exp_l", "q_log_l", "q_to_matrix_l", "skew_l",
         "qdot_from_omega_l"]


@pytest.mark.parametrize("name", NAMES)
def test_function_matches_jax(rng, name):
    args = _inputs(name, rng)
    want = np.asarray(getattr(jrl, name)(*map(jnp.asarray, args)))
    got = getattr(rl, name)(*map(torch.as_tensor, args)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL


def test_every_function_is_ported():
    public = {n for n in dir(jrl) if n.endswith("_l") and callable(
        getattr(jrl, n))}
    assert public == set(NAMES)
    assert all(callable(getattr(rl, n)) for n in NAMES)


@pytest.mark.parametrize("name", ["q_exp_l", "q_log_l"])
def test_jvp_at_identity_is_finite_and_matches_jax(rng, name):
    """The double-where guards: the derivative at e = 0 (the identity
    quaternion) takes the series branch and stays finite."""
    if name == "q_exp_l":
        x = np.zeros((3, B))
    else:
        x = np.zeros((4, B))
        x[0] = 1.0
    t = rng.standard_normal(x.shape)
    _, want = jax.jvp(getattr(jrl, name), (jnp.asarray(x),),
                      (jnp.asarray(t),))
    _, got = torch.func.jvp(getattr(rl, name), (torch.as_tensor(x),),
                            (torch.as_tensor(t),))
    assert bool(torch.isfinite(got).all())
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= TOL
