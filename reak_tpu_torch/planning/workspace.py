"""Collision-checked workspaces: the planner's view of C-free (port of
``reak_tpu/planning/workspace.py``).

(ref: ctrl/topologies/manip_free_workspace.hpp:113 manip_quasi_static_env —
rate-limited joint space + DK map + proxy-query models;
no_obstacle_space.hpp — the null-collision fake)

A workspace bundles a Space with batched validity and edge-checking functions;
planners only ever call the batched forms.  The chain workspaces compose
``kte.fk`` → ``pose_shapes`` → ``proxy_query`` for one configuration and map
it over the batch with ``torch.func.vmap`` (``jax.jit(jax.vmap(...))`` in the
JAX package), closing over the shapes.  The edge checks interpolate at
numpy's ``linspace`` fractions, which are ``jnp.linspace``'s bits
(``torch.linspace`` differs in the last bit).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from reak_tpu_torch.geom.proximity import ProxyModel, proxy_query
from reak_tpu_torch.geom.shapes import ShapeSet, pose_shapes


@functools.lru_cache(maxsize=None)
def _fractions_np(n: int):
    return np.linspace(0.0, 1.0, n)


def fractions(n: int, like):
    """``n`` fractions 0 … 1 (numpy's ``linspace``) in ``like``'s dtype on
    its device."""
    return torch.as_tensor(_fractions_np(n), dtype=like.dtype,
                           device=like.device)


class Workspace:
    """Space + batched validity predicate.

    ``is_free_batch(points (K, n)) → (K,) bool``
    ``edge_free_batch(a (K, n), b (K, n)) → (K,) bool`` — checks ``n_checks``
    interpolated points per edge in one device batch (the reference's
    move_position_toward + is_free loop, manip_free_workspace.hpp:154).
    """

    def __init__(self, space, is_free_fn: Callable, n_checks: int = 16):
        self.space = space
        self._is_free = is_free_fn
        self.n_checks = n_checks

    def is_free_batch(self, pts):
        return self._is_free(pts)

    def edge_free_batch(self, a, b):
        ts = fractions(self.n_checks, a)
        # (K, C, n) interpolated configurations
        pts = a[:, None, :] + ts[None, :, None] * (b - a)[:, None, :]
        flat = pts.reshape(-1, pts.shape[-1])
        free = self._is_free(flat).reshape(pts.shape[0], self.n_checks)
        return torch.all(free, dim=-1)


class NoObstacleWorkspace(Workspace):
    """Everything free (ref: topologies/no_obstacle_space.hpp) — isolates
    planner logic in tests."""

    def __init__(self, space):
        super().__init__(
            space, lambda pts: torch.ones(pts.shape[0], dtype=torch.bool,
                                          device=pts.device), n_checks=2)


def bitmap_workspace(space, grid, lower, upper,
                     n_checks: int = 16) -> Workspace:
    """2D occupancy-grid world — the analog of the reference's OpenCV
    bitmap test world (ref: topologies/ptrobot2D_test_world.hpp:65).

    ``grid``: (H, W) bool array, True = free; points map linearly from
    [lower, upper] to pixel coordinates.  Points may carry extra trailing
    coordinates beyond the grid's two (e.g. the heading of a FlatSE2Space
    pose — the reference's ptrobot world likewise checks only the position).
    The grid and bounds go to the space's device.
    """
    from reak_tpu_torch.planning.draws import space_like

    dev, dtype = space_like(space)
    grid = torch.as_tensor(np.array(grid, bool), device=dev)
    as_t = lambda x: torch.atleast_1d(torch.as_tensor(
        np.array(x, np.float64), dtype=dtype, device=dev))
    lower, upper = as_t(lower), as_t(upper)
    hw = torch.as_tensor(grid.shape, dtype=torch.float32, device=dev)
    top = torch.as_tensor(grid.shape, device=dev) - 1

    def is_free(pts):
        uv = (pts[..., : lower.shape[-1]] - lower) / (upper - lower)
        ij = torch.minimum(torch.clamp_min((uv * hw).to(torch.int32), 0), top)
        inside = torch.all((uv >= 0) & (uv <= 1), dim=-1)
        return inside & grid[ij[:, 0], ij[:, 1]]

    return Workspace(space, is_free, n_checks)


def _robot_model(posed: ShapeSet) -> ProxyModel:
    return ProxyModel(spheres=posed.spheres, capsules=posed.capsules,
                      boxes=posed.boxes, cylinders=posed.cylinders)


class ChainWorkspace(Workspace):
    """Quasi-static manipulator workspace: joint-space points are valid when
    the chain geometry clears the environment by ``margin``
    (ref: manip_quasi_static_env, manip_free_workspace.hpp:113,79-95 —
    DK map + proxy-query pairs).  ``robot_shapes`` and ``env`` hold tensors
    on the planner's device (``convert.shapes_from``, ``proxy_from``).
    """

    def __init__(
        self,
        space,
        spec,
        robot_shapes: ShapeSet,
        env: ProxyModel,
        margin: float = 0.0,
        n_checks: int = 16,
    ):
        from reak_tpu_torch import kte

        self.spec = spec
        self.robot_shapes = robot_shapes
        self.env = env
        self.margin = margin

        def min_dist_one(q):
            res = kte.fk(spec, q)
            posed = pose_shapes(robot_shapes, res.body_pos, res.body_quat)
            return proxy_query(_robot_model(posed), env)

        self._min_dist = vmap(min_dist_one)
        super().__init__(space, lambda qs: self._min_dist(qs) > margin,
                         n_checks)

    def min_distance_batch(self, qs):
        """Batched clearance query (for SBA* density/clearance heuristics)."""
        return self._min_dist(qs)


class TemporalChainWorkspace(ChainWorkspace):
    """Time-dependent manipulator workspace: moving obstacles are posed at
    the QUERY TIME before collision checking, so validity is a predicate on
    (t, q) — the reference's dynamic planning environment
    (ref: manip_dynamic_env, manip_free_dynamic_workspace.hpp:60,111, with
    the per-query-time proxy-model posing of proxy_traj_applicator.hpp).

    ``moving``: list of ``(shapes_local, traj)`` where ``shapes_local`` is a
    single-frame ShapeSet (all ``*_body`` indices 0) and ``traj`` is a
    batched rigid trajectory ``t (K,) → (pos (K, 3), quat (K, 4))`` — e.g.
    :func:`rigid_traj_tabulated` (the JAX package's takes one time and is
    mapped by ``jax.vmap``; here the trajectory is evaluated over the batch
    first and the poses are mapped with the configurations).

    The static (t-independent) checks inherited from ChainWorkspace evaluate
    only against ``env``; planners that know about time call the
    ``*_txq_batch`` forms.  ``is_free_batch`` retains the static-env-only
    semantics so a temporal workspace can be dropped into a static planner
    (which then ignores the moving bodies).
    """

    def __init__(self, space, spec, robot_shapes: ShapeSet, env: ProxyModel,
                 moving=(), margin: float = 0.0, n_checks: int = 16):
        super().__init__(space, spec, robot_shapes, env, margin, n_checks)
        self.moving = tuple(moving)

        from reak_tpu_torch import kte

        def min_dist_one(q, poses):
            res = kte.fk(spec, q)
            robot = _robot_model(
                pose_shapes(robot_shapes, res.body_pos, res.body_quat))
            d = proxy_query(robot, env)
            for (shapes_local, _), (pos, quat) in zip(self.moving, poses):
                posed_obs = pose_shapes(shapes_local, pos[None], quat[None])
                d = torch.minimum(d, proxy_query(robot,
                                                 _robot_model(posed_obs)))
            return d

        self._min_dist_one_txq = vmap(min_dist_one)

    def min_distance_txq_batch(self, ts, qs):
        """Clearance of configurations ``qs (K, n)`` at times ``ts (K,)``
        against static env + moving obstacles posed at each t."""
        poses = tuple(traj(ts) for _, traj in self.moving)
        return self._min_dist_one_txq(qs, poses)

    def is_free_txq_batch(self, ts, qs):
        return self.min_distance_txq_batch(ts, qs) > self.margin

    def edge_free_txq_batch(self, t0s, q0s, t1s, q1s):
        """Time-parameterized straight edges: ``n_checks`` samples of
        (t(s), q(s)) per edge, all in one device batch."""
        ss = fractions(self.n_checks, q0s)
        qs = q0s[:, None, :] + ss[None, :, None] * (q1s - q0s)[:, None, :]
        ts = t0s[:, None] + ss[None, :] * (t1s - t0s)[:, None]
        free = self.is_free_txq_batch(ts.reshape(-1),
                                      qs.reshape(-1, qs.shape[-1]))
        return torch.all(free.reshape(qs.shape[0], self.n_checks), dim=-1)


def rigid_traj_tabulated(ts, poss, quats, device="cuda",
                         dtype=torch.float64):
    """A batched rigid trajectory ``t (...) → (pos (..., 3), quat (..., 4))``
    from tabulated samples (linear position / nlerp quaternion
    interpolation) — the device-side analog of the reference's
    predicted-trajectory applicator input (proxy_traj_applicator.hpp;
    belief trajectories arrive tabulated from ctrl/predictor.py).  Numpy or
    number tables go on ``device`` in ``dtype``; tensors keep theirs."""
    from reak_tpu_torch.interp.hermite import _as_tensors

    ts, poss, quats = _as_tensors(ts, poss, quats, device=device, dtype=dtype)

    def traj(t):
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        # jnp.searchsorted's default side is "left"
        i = torch.clamp(torch.searchsorted(ts, t.reshape(-1).contiguous())
                        .reshape(t.shape) - 1, 0, ts.shape[0] - 2)
        w = torch.clamp((t - ts[i]) / torch.clamp_min(ts[i + 1] - ts[i],
                                                      1e-12), 0.0, 1.0)
        pos = poss[i] + w[..., None] * (poss[i + 1] - poss[i])
        q0, q1 = quats[i], quats[i + 1]
        q1 = torch.where((torch.sum(q0 * q1, dim=-1) < 0)[..., None], -q1, q1)
        q = q0 + w[..., None] * (q1 - q0)
        q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                         keepdim=True), 1e-12)
        return pos, q

    return traj


class PlanarChainWorkspace(Workspace):
    """Quasi-static PLANAR manipulator workspace: the 2D analog of
    :class:`ChainWorkspace` for chains whose motion lies in the z=0 plane
    (ref: kte_chain_geometry_2D, geometry/shapes/kte_chain_geometry.hpp:52;
    manip_quasi_static_env over 2D proxy models, proxy_query_model.hpp:51).

    ``robot_shapes`` is a :class:`reak_tpu_torch.geom.shapes2d.ShapeSet2D`
    anchored to body indices; FK frames are projected onto the plane (xy
    position + rotation angle about z — exact for planar chains, whose body
    quaternions are pure z rotations).
    """

    def __init__(self, space, spec, robot_shapes, env, margin: float = 0.0,
                 n_checks: int = 16):
        from reak_tpu_torch import kte
        from reak_tpu_torch.geom.proximity2d import (ProxyModel2D,
                                                     proxy_query_2d)
        from reak_tpu_torch.geom.shapes2d import pose_shapes_2d

        self.spec = spec
        self.robot_shapes = robot_shapes
        self.env = env
        self.margin = margin

        def min_dist_one(q):
            res = kte.fk(spec, q)
            pos2 = res.body_pos[:, :2]
            # planar angle of a pure z-rotation quaternion [w, x, y, z]
            ang = 2.0 * torch.atan2(res.body_quat[:, 3], res.body_quat[:, 0])
            posed = pose_shapes_2d(robot_shapes, pos2, ang)
            return proxy_query_2d(ProxyModel2D.from_shapes(posed), env)

        self._min_dist = vmap(min_dist_one)
        super().__init__(space, lambda qs: self._min_dist(qs) > margin,
                         n_checks)

    def min_distance_batch(self, qs):
        return self._min_dist(qs)
