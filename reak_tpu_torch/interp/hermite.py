"""Linear / cubic / quintic Hermite interpolation (port of
``reak_tpu/interp/hermite.py``).

(ref: ctrl/interpolation/linear_interp.hpp:179, cubic_hermite_interp.hpp:217,
quintic_hermite_interp.hpp:346 — the detail:: *_interpolate functions)

Each interpolator maps endpoint data + normalized time t ∈ [0, 1] (broadcasts)
to (position, velocity[, acceleration]) — time-scaled by the segment duration.
``t`` is a Python number or a tensor; a tensor with axes gains a trailing
axis that broadcasts against the points' coordinates.  The results follow
the points' dtype and device.
"""
from __future__ import annotations

import numpy as np
import torch


def _lift(t):
    """``t[..., None]`` for a tensor with axes, else ``t`` unchanged (a
    Python number stays one, so it never rounds to float32; other
    array-likes become float64 tensors)."""
    if isinstance(t, (int, float)):
        return t
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t, np.float64))
    return t[..., None] if t.ndim else t


def _as_tensors(*xs, device="cuda", dtype=torch.float64):
    """``xs`` as tensors: a tensor unchanged, None kept, anything else (a
    number, list or numpy array) a tensor in the dtype and on the device
    of the first tensor among ``xs``, else of ``dtype`` on ``device``."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if like is not None:
        device, dtype = like.device, like.dtype
    return tuple(
        x if x is None or isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x, np.float64), dtype=dtype, device=device)
        for x in xs)


def linear_interp(p0, p1, t, dt=1.0):
    """Position + constant velocity (ref: linear_interp.hpp detail::linear_interpolate)."""
    tt = _lift(t)
    pos = p0 + (p1 - p0) * tt
    vel = (p1 - p0) / dt
    return pos, torch.broadcast_to(vel, pos.shape)


def cubic_hermite_interp(p0, v0, p1, v1, t, dt=1.0):
    """Cubic Hermite on (pos, vel) endpoints
    (ref: cubic_hermite_interp.hpp:217 detail::cubic_hermite_interpolate).
    Velocities are physical (per unit time); returns (pos, vel, acc)."""
    tt = _lift(t)
    h00 = 2 * tt**3 - 3 * tt**2 + 1
    h10 = tt**3 - 2 * tt**2 + tt
    h01 = -2 * tt**3 + 3 * tt**2
    h11 = tt**3 - tt**2
    pos = h00 * p0 + h10 * dt * v0 + h01 * p1 + h11 * dt * v1
    dh00 = 6 * tt**2 - 6 * tt
    dh10 = 3 * tt**2 - 4 * tt + 1
    dh01 = -6 * tt**2 + 6 * tt
    dh11 = 3 * tt**2 - 2 * tt
    vel = (dh00 * p0 + dh10 * dt * v0 + dh01 * p1 + dh11 * dt * v1) / dt
    d2h00 = 12 * tt - 6
    d2h10 = 6 * tt - 4
    d2h01 = -12 * tt + 6
    d2h11 = 6 * tt - 2
    acc = (d2h00 * p0 + d2h10 * dt * v0 + d2h01 * p1 + d2h11 * dt * v1) / (dt * dt)
    return pos, vel, acc


def quintic_hermite_interp(p0, v0, a0, p1, v1, a1, t, dt=1.0):
    """Quintic Hermite on (pos, vel, acc) endpoints
    (ref: quintic_hermite_interp.hpp:346 detail::quintic_hermite_interpolate)."""
    s = _lift(t)
    s2, s3, s4, s5 = s * s, s**3, s**4, s**5
    # basis for p0, v0, a0, p1, v1, a1 (normalized time)
    h0 = 1 - 10 * s3 + 15 * s4 - 6 * s5
    h1 = s - 6 * s3 + 8 * s4 - 3 * s5
    h2 = 0.5 * s2 - 1.5 * s3 + 1.5 * s4 - 0.5 * s5
    h3 = 10 * s3 - 15 * s4 + 6 * s5
    h4 = -4 * s3 + 7 * s4 - 3 * s5
    h5 = 0.5 * s3 - s4 + 0.5 * s5
    pos = (
        h0 * p0 + h1 * dt * v0 + h2 * dt * dt * a0
        + h3 * p1 + h4 * dt * v1 + h5 * dt * dt * a1
    )
    dh0 = -30 * s2 + 60 * s3 - 30 * s4
    dh1 = 1 - 18 * s2 + 32 * s3 - 15 * s4
    dh2 = s - 4.5 * s2 + 6 * s3 - 2.5 * s4
    dh3 = 30 * s2 - 60 * s3 + 30 * s4
    dh4 = -12 * s2 + 28 * s3 - 15 * s4
    dh5 = 1.5 * s2 - 4 * s3 + 2.5 * s4
    vel = (
        dh0 * p0 + dh1 * dt * v0 + dh2 * dt * dt * a0
        + dh3 * p1 + dh4 * dt * v1 + dh5 * dt * dt * a1
    ) / dt
    d2h0 = -60 * s + 180 * s2 - 120 * s3
    d2h1 = -36 * s + 96 * s2 - 60 * s3
    d2h2 = 1 - 9 * s + 18 * s2 - 10 * s3
    d2h3 = 60 * s - 180 * s2 + 120 * s3
    d2h4 = -24 * s + 84 * s2 - 60 * s3
    d2h5 = 3 * s - 12 * s2 + 10 * s3
    acc = (
        d2h0 * p0 + d2h1 * dt * v0 + d2h2 * dt * dt * a0
        + d2h3 * p1 + d2h4 * dt * v1 + d2h5 * dt * dt * a1
    ) / (dt * dt)
    return pos, vel, acc
