"""Failure detection: status flags computed beside the result, and
host-side raising wrappers (port of ``reak_tpu/errors.py``).

The hot paths return a STATUS tensor, an integer bitmask computed on the
device of their inputs, and the host decides what to do:

    qdd, status = forward_dynamics_checked(spec, q, qd, tau)

Under ``torch.func.vmap`` over a scenario batch the status is one flag per
scenario, so it localizes which scenario went bad without a sync inside the
loop.  :func:`raise_on_error` syncs once and raises the matching exception
(ref: ctrl/mbd_kte/manipulator_model.cpp:351-354 ``singularity_error``;
core/integrators/integration_exceptions.hpp:38,82,136;
core/optimization/optim_exceptions.hpp).
"""
from __future__ import annotations

import torch

# status bitmask values (combine with |)
OK = 0
SINGULAR_MATRIX = 1  # ≙ singularity_error (manipulator_model.cpp:351)
NONFINITE = 2  # ≙ invalid_state_derivative
NOT_CONVERGED = 4  # ≙ optim exceptions / untolerable_integration
OUT_OF_BOUNDS = 8  # ≙ recorder out_of_bounds / domain violations


class SingularityError(RuntimeError):
    """Host-side analog of the reference's ReaK::singularity_error."""


class NonFiniteError(FloatingPointError):
    """Host-side analog of invalid_state_derivative."""


class NotConvergedError(RuntimeError):
    """Host-side analog of untolerable_integration / optim failures."""


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield torch.as_tensor(tree)


def _flag(bad, value):
    """``value`` where ``bad``, OK elsewhere, as an int32 tensor on bad's
    device."""
    return torch.where(bad, torch.full_like(bad, value, dtype=torch.int32),
                       torch.zeros_like(bad, dtype=torch.int32))


def finite_flag(*trees):
    """0 where every tensor of every (nested tuple / list / dict) tree is
    finite, NONFINITE otherwise; one int32 scalar (per scenario under
    vmap)."""
    bad = None
    for tree in trees:
        for leaf in _leaves(tree):
            b = ~torch.all(torch.isfinite(leaf))
            bad = b if bad is None else bad | b
    if bad is None:
        return torch.tensor(OK, dtype=torch.int32)
    return _flag(bad, NONFINITE)


def chol_singular_flag(A, rcond: float = 1e-12):
    """SINGULAR_MATRIX flag for an SPD solve: the Cholesky factor has a
    non-finite or relatively tiny pivot (the device analog of the
    reference's throw at manipulator_model.cpp:351).  A factorization that
    fails outright counts as singular, as JAX's NaN factor does."""
    L, info = torch.linalg.cholesky_ex(A)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    bad = (~torch.all(torch.isfinite(d), dim=-1)
           | (torch.amin(d, dim=-1)
              <= rcond * torch.amax(torch.abs(d), dim=-1))
           | (info != 0))
    return _flag(bad, SINGULAR_MATRIX)


def convergence_flag(residual, tol):
    """NOT_CONVERGED where a solver residual (e.g. PDIP complementarity
    gap, CLIK task error, adaptive-integrator error estimate) exceeds
    tol."""
    return _flag(torch.as_tensor(residual) > tol, NOT_CONVERGED)


def describe(status) -> str:
    s = int(status)
    if s == OK:
        return "ok"
    parts = []
    if s & SINGULAR_MATRIX:
        parts.append("singular-matrix")
    if s & NONFINITE:
        parts.append("non-finite")
    if s & NOT_CONVERGED:
        parts.append("not-converged")
    if s & OUT_OF_BOUNDS:
        parts.append("out-of-bounds")
    return "+".join(parts)


def raise_on_error(status):
    """Sync ``status`` to the host and raise the matching exception (the
    reference's throwing behavior).  A batched status raises if ANY element
    failed; several flags of one element raise the first of singular,
    non-finite, not converged."""
    s = int(torch.as_tensor(status).max())
    if s == OK:
        return
    if s & SINGULAR_MATRIX:
        raise SingularityError(
            "singular matrix in dynamics solve (ref: singularity_error, "
            "manipulator_model.cpp:351)")
    if s & NONFINITE:
        raise NonFiniteError("non-finite values on the compute path")
    if s & NOT_CONVERGED:
        raise NotConvergedError("solver failed to converge to tolerance")
    raise RuntimeError(describe(s))
