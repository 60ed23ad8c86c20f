"""AQR control topologies: IHAQR and MEAQR metric spaces for kinodynamic
planning (port of ``reak_tpu/ctrl/aqr_space.py``; ref:
examples/misc/IHAQR_topology.hpp:183 IHAQR_topology,
misc/MEAQR_topology.hpp:316,895 MEAQR_topology).

Both spaces wrap an affine LTI system  ẋ = A·x + B·u + c  and expose the
Space protocol (sample/distance/interpolate/clamp); steering follows
system trajectories, not straight lines:

* :class:`IHAQRSpace` — distance is the infinite-horizon LQR cost-to-go
  quadratic form (CARE solution P); interpolation flows the closed-loop
  dynamics ẋ = (A−BK)(x−b) toward the target.
* :class:`MEAQRSpace` — distance is the minimum-energy cost
  min_T [ρ·T + eᵀG(T)⁻¹e], e = b − Φ(T)a − d(T), with G the weighted
  controllability Gramian; interpolation follows the exact minimum-energy
  trajectory x(s) = Φ(s)a + d(s) + G(s)Φ(T−s)ᵀG(T)⁻¹e.

The Gramians and transition matrices are tabulated on a fixed time grid at
construction, so distance and interpolation are table lookups and small
batched products, on the device of the matrices given: the device of ``A``
where it is a tensor, else ``device`` (the card unless the caller asks for
the CPU, as the JAX classes land on the default accelerator).  The
planners over a MEAQR space (``meaqr_rrt_star_plan``,
``meaqr_sbastar_plan``; ref: misc/MEAQR_rrtstar_planner.hpp:78,
misc/MEAQR_sbastar_planner.hpp:85) are the port's ``planning`` planners on
an ``AQRWorkspace``.
"""
from __future__ import annotations

import numpy as np
import torch

from reak_tpu_torch.math.are import solve_care
from reak_tpu_torch.math.linalg import _inv, _lu_factor, _lu_solve, _solve


def _matrix(A, device):
    """A tensor as it is; anything else as a float64 tensor on
    ``device``."""
    return A if torch.is_tensor(A) else torch.as_tensor(
        np.asarray(A, np.float64), device=device)


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _tabulate(A, B, c, Rinv, t_max: float, n_grid: int):
    """RK4 of the matrix ODEs  Φ̇ = AΦ,  ḋ = A d + c,  Ġ = Φ B R⁻¹ Bᵀ Φᵀ
    on the grid; returns the times and stacked (Φ, d, G) at s_k = k·Δ."""
    n = A.shape[0]
    dt = t_max / n_grid
    BRB = B @ Rinv @ B.T

    def deriv(state):
        Phi, d, G = state
        return (A @ Phi, A @ d + c, Phi @ BRB @ Phi.T)

    state = (torch.eye(n, dtype=A.dtype, device=A.device),
             torch.zeros(n, dtype=A.dtype, device=A.device),
             torch.zeros((n, n), dtype=A.dtype, device=A.device))
    out = [state]
    for _ in range(n_grid):
        k1 = deriv(state)
        k2 = deriv(tuple(x + 0.5 * dt * k for x, k in zip(state, k1)))
        k3 = deriv(tuple(x + 0.5 * dt * k for x, k in zip(state, k2)))
        k4 = deriv(tuple(x + dt * k for x, k in zip(state, k3)))
        state = tuple(x + (dt / 6.0) * (a + 2 * b_ + 2 * c_ + d_)
                      for x, a, b_, c_, d_ in zip(state, k1, k2, k3, k4))
        out.append(state)
    Phis, ds, Gs = (torch.stack(s) for s in zip(*out))
    times = dt * torch.arange(n_grid + 1, dtype=A.dtype, device=A.device)
    return times, Phis, ds, Gs


class _BoxSpace:
    """The sampling box shared by both spaces."""

    @property
    def dim(self):
        return self.lower.shape[-1]

    def sample(self, generator: torch.Generator, batch=()):
        """Uniform points of the box, drawn from ``generator`` (on the
        space's device; the JAX package takes a key)."""
        u = torch.rand(tuple(batch) + (self.dim,), generator=generator,
                       dtype=self.lower.dtype, device=self.lower.device)
        return self.lower + u * (self.upper - self.lower)

    def clamp(self, p):
        return torch.clamp(p, self.lower, self.upper)

    def contains(self, p):
        return torch.all((p >= self.lower) & (p <= self.upper), dim=-1)

    def difference(self, a, b):
        return a - b


class MEAQRSpace(_BoxSpace):
    """Minimum-Energy AQR topology (ref: MEAQR_topology.hpp:316).  ``A`` and
    ``B`` are float64 unless given as tensors of another type; every
    tensor of the space is on A's device, ``device`` where A is not a
    tensor."""

    def __init__(self, A, B, lower, upper, c=None, R=None,
                 t_max: float = 2.0, n_grid: int = 64,
                 time_weight: float = 1.0, device="cuda"):
        A = _matrix(A, device)
        B = _as(B, A)
        n, m = B.shape
        self.A, self.B = A, B
        self.c = torch.zeros_like(A[0]) if c is None else _as(c, A)
        R = (torch.eye(m, dtype=A.dtype, device=A.device) if R is None
             else _as(R, A))
        Rinv = _inv(R)
        self.lower = _as(lower, A)
        self.upper = _as(upper, A)
        self.time_weight = time_weight
        self.times, self.Phis, self.ds, self.Gs = _tabulate(
            A, B, self.c, Rinv, t_max, n_grid)
        # regularize the Gramian at tiny T (G(0) = 0 is singular)
        self.Gs_reg = self.Gs + 1e-9 * torch.eye(n, dtype=A.dtype,
                                                 device=A.device)
        self._G_lu = _lu_factor(self.Gs_reg)

    # -- MEAQR cost --------------------------------------------------------
    def _costs_over_grid(self, a, b):
        """Cost (n_grid+1, ...) of every horizon T on the grid (index 0 =
        ∞).  The pairs are the columns of one (n, pairs) matrix, so each
        grid point is one product and one solve with the pairs as its
        right-hand sides, on the Gramian's factor made at construction."""
        lead = a.shape[:-1]
        n = a.shape[-1]
        e = (b.reshape(-1, n).T - self.Phis @ a.reshape(-1, n).T
             - self.ds[..., None])                          # (T, n, pairs)
        energy = torch.sum(e * _lu_solve(*self._G_lu, e), dim=1)
        cost = energy + self.time_weight * self.times[:, None]
        cost = torch.cat([torch.full_like(cost[:1], float("inf")), cost[1:]])
        return cost.reshape((cost.shape[0],) + lead)

    def distance(self, a, b):
        """Minimum-energy quasi-metric, broadcast over leading axes of a and
        b."""
        a, b = torch.broadcast_tensors(_as(a, self.A), _as(b, self.A))
        return torch.sqrt(torch.amin(self._costs_over_grid(a, b), dim=0))

    def interpolate(self, a, b, t):
        """Point a fraction ``t`` along the optimal min-energy trajectory
        a → b (ref: MEAQR steering, MEAQR_topology.hpp
        move_position_toward)."""
        a, b = torch.broadcast_tensors(_as(a, self.A), _as(b, self.A))
        single = a.ndim == 1
        if single:
            a, b = a[None], b[None]
        t = _as(t, a).expand(a.shape[:1])
        last = self.times.shape[0] - 1

        costs = self._costs_over_grid(a, b)              # (T, K)
        jT = torch.argmin(costs, dim=0)     # optimal horizon index per pair
        js = torch.clamp((t * jT).to(torch.int32), 0, last).long()
        jr = torch.clamp(jT - js, 0, last)               # T − s index
        e = b - (self.Phis[jT] @ a[..., None])[..., 0] - self.ds[jT]
        lam = _solve(self.Gs_reg[jT], e[..., None])
        out = ((self.Phis[js] @ a[..., None])[..., 0] + self.ds[js]
               + (self.Gs[js] @ (self.Phis[jr].mT @ lam))[..., 0])
        out = self.clamp(out)
        return out[0] if single else out


class IHAQRSpace(_BoxSpace):
    """Infinite-horizon AQR topology (ref: IHAQR_topology.hpp:183): the
    metric is the LQR cost-to-go quadratic form; steering flows the
    closed-loop dynamics toward the target point.  Its tensors are on A's
    device, ``device`` where A is not a tensor."""

    def __init__(self, A, B, lower, upper, Q=None, R=None,
                 t_horizon: float = 2.0, n_grid: int = 64, device="cuda"):
        A = _matrix(A, device)
        B = _as(B, A)
        n, m = B.shape
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        Q = eye if Q is None else _as(Q, A)
        R = (torch.eye(m, dtype=A.dtype, device=A.device) if R is None
             else _as(R, A))
        self.P = solve_care(A, B, Q, R)
        self.K = _solve(R, B.T @ self.P)
        Acl = A - B @ self.K
        self.lower = _as(lower, A)
        self.upper = _as(upper, A)
        # tabulate the closed-loop flow e^{Acl s} on the grid
        E = torch.linalg.matrix_exp(Acl * (t_horizon / n_grid))
        flows = [eye]
        for _ in range(n_grid):
            flows.append(E @ flows[-1])
        self.flows = torch.stack(flows)                  # (n_grid+1, n, n)

    def distance(self, a, b):
        d = _as(b, self.P) - _as(a, self.P)
        return torch.sqrt(torch.einsum("...i,ij,...j->...", d, self.P, d))

    def interpolate(self, a, b, t):
        """Flow the closed-loop system from a toward b for fraction t of
        the tabulated horizon: x = b + e^{Acl·t·T}(a − b)."""
        a, b, t = _as(a, self.P), _as(b, self.P), _as(t, self.P)
        last = self.flows.shape[0] - 1
        j = torch.clamp((t * last).to(torch.int32), 0, last).long()
        M = self.flows[j]                                # (..., n, n)
        return self.clamp(b + torch.einsum("...ij,...j->...i", M, a - b))


class AQRWorkspace:
    """Workspace whose edges follow the space's system trajectories rather
    than straight lines (needed by AQR spaces)."""

    def __init__(self, space, is_free_fn, n_checks: int = 16):
        self.space = space
        self._is_free = is_free_fn
        self.n_checks = n_checks

    def is_free_batch(self, pts):
        return self._is_free(pts)

    def edge_free_batch(self, a, b):
        """Each edge free at ``n_checks`` points of its system trajectory,
        at numpy's ``linspace`` fractions (``jnp.linspace``'s bits: the
        interpolation floors ``t`` times a grid index)."""
        from reak_tpu_torch.planning.workspace import fractions

        ts = fractions(self.n_checks, a)
        pts = torch.stack([self.space.interpolate(a, b, t.expand(a.shape[0]))
                           for t in ts], dim=1)          # (K, C, n)
        free = self._is_free(pts.reshape(-1, pts.shape[-1]))
        return torch.all(free.reshape(a.shape[0], self.n_checks), dim=-1)


def meaqr_rrt_star_plan(space: MEAQRSpace, is_free_fn, query, **kw):
    """RRT* over a MEAQR topology (ref: MEAQR_rrtstar_planner.hpp:78);
    ``kw`` goes to ``planning.rrt_star.rrt_star_plan`` (``seed``, a draw
    object or an int, ``max_iters``, ``capacity``, ...)."""
    from reak_tpu_torch.planning.rrt_star import rrt_star_plan

    return rrt_star_plan(AQRWorkspace(space, is_free_fn), query, **kw)


def meaqr_sbastar_plan(space: MEAQRSpace, is_free_fn, query, **kw):
    """SBA* over a MEAQR topology (ref: MEAQR_sbastar_planner.hpp:85);
    ``kw`` goes to ``planning.sbastar.sbastar_plan``."""
    from reak_tpu_torch.planning.sbastar import sbastar_plan

    return sbastar_plan(AQRWorkspace(space, is_free_fn), query, **kw)
