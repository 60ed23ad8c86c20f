"""A JAX free-base chain whose step and LTV each run as one jitted JAX
function, reached from a jitted solver through host callbacks: the solver
then compiles in seconds instead of minutes, and every number still comes
from the JAX package's code."""
import jax
import numpy as np

from reak_tpu.kte import lanes as jlanes

_make_kte_manifold_lanes = jlanes.make_kte_manifold_lanes


def host_manifold_lanes(spec, dt, actuated=None):
    """``jlanes.make_kte_manifold_lanes(spec, dt, actuated)`` with its step
    and LTV behind host callbacks."""
    step, ltv = _make_kte_manifold_lanes(spec, dt, actuated=actuated)
    step_c, ltv_c = jax.jit(step), jax.jit(ltv)
    d = 2 * spec.nv
    nu = spec.nv if actuated is None else np.shape(actuated)[1]

    def host(fn):
        return lambda *a: jax.tree.map(np.asarray, fn(*a))

    def step_cb(x, u):
        return jax.pure_callback(host(step_c),
                                 jax.ShapeDtypeStruct(x.shape, x.dtype), x, u)

    def ltv_cb(x, u):
        B = x.shape[1:]
        shapes = tuple(jax.ShapeDtypeStruct(s + B, x.dtype)
                       for s in ((d, d), (d, nu), (d,)))
        return jax.pure_callback(host(ltv_c), shapes, x, u)

    return step_cb, ltv_cb
