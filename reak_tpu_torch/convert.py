"""Carry parameters across from the JAX package to the port.

Each function duck-types its argument: anything with the fields of
``ChainSpec``, ``MPCProblem``, ``GaussianBelief``, ``SatelliteParams``,
``AirshipParams``, ``QuadrotorParams``, ``TSOSBelief``,
``PredictedBeliefTrajectory``, the shape sets ``ShapeSet`` and
``ShapeSet2D``, the proximity models ``ProxyModel`` and ``ProxyModel2D``,
the interpolators' ``Trajectory``, the scenario bundles
``NavigationScenario`` and ``ChaserTargetScenario``, the box spaces or the
planning workspaces as numbers, tuples,
numpy arrays or arrays that ``numpy.asarray`` reads: a JAX object, or one
that ``io.serialization.load_scene`` returned.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from reak_tpu_torch.ctrl.aug_kalman import TSOSBelief
from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.ctrl.mpc import MPCProblem
from reak_tpu_torch.ctrl.predictor import PredictedBeliefTrajectory
from reak_tpu_torch.ctrl.ss_systems import (AirshipParams, QuadrotorParams,
                                            SatelliteParams, airship3D,
                                            quadrotor, satellite3D)
from reak_tpu_torch.geom.proximity import ProxyModel
from reak_tpu_torch.geom.proximity2d import ProxyModel2D
from reak_tpu_torch.geom.shapes import (Box, Capsule, Cylinder, Plane,
                                        ShapeSet, Sphere)
from reak_tpu_torch.geom.shapes2d import (CappedRectangle, Circle,
                                          Rectangle, Seg2D, ShapeSet2D)
from reak_tpu_torch.interp.trajectory import Trajectory
from reak_tpu_torch.kte.scenarios import (ChaserTargetScenario,
                                          NavigationScenario)
from reak_tpu_torch.kte.spec import ChainSpec


def spec_from(obj) -> ChainSpec:
    """The port's ``ChainSpec`` with the fields of ``obj``."""
    return ChainSpec.build(
        joint_types=tuple(int(t) for t in obj.joint_types),
        axes=np.asarray(obj.axes, np.float64),
        offsets_pos=np.asarray(obj.offsets_pos, np.float64),
        offsets_quat=np.asarray(obj.offsets_quat, np.float64),
        com_pos=np.asarray(obj.com_pos, np.float64),
        masses=np.asarray(obj.masses, np.float64),
        inertias=np.asarray(obj.inertias, np.float64).reshape(-1, 3, 3),
        stiffness=np.asarray(obj.stiffness, np.float64),
        rest_q=np.asarray(obj.rest_q, np.float64),
        damping=np.asarray(obj.damping, np.float64),
        stiction_vel=np.asarray(obj.stiction_vel, np.float64),
        slip_vel=np.asarray(obj.slip_vel, np.float64),
        stiction_coef=np.asarray(obj.stiction_coef, np.float64),
        slip_coef=np.asarray(obj.slip_coef, np.float64),
        gravity=np.asarray(obj.gravity, np.float64),
        backlash=np.asarray(obj.backlash, np.float64),
        name=str(obj.name),
    )


def problem_from(obj, device, dtype) -> MPCProblem:
    """The port's ``MPCProblem`` with the weights and bounds of ``obj``, as
    tensors of ``dtype`` on ``device``."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return MPCProblem(Q=t(obj.Q), R=t(obj.R), QN=t(obj.QN),
                      u_min=t(obj.u_min), u_max=t(obj.u_max),
                      horizon=int(obj.horizon))


def satellite_from(obj) -> SatelliteParams:
    """The port's ``SatelliteParams`` (float64 CPU tensors) with the mass
    and inertia of ``obj``."""
    return satellite3D(mass=float(np.asarray(obj.mass)),
                       inertia=np.array(obj.inertia, np.float64))


def belief_from(obj, device, dtype) -> GaussianBelief:
    """The port's ``GaussianBelief`` with the mean and covariance of
    ``obj``, as tensors of ``dtype`` on ``device``."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return GaussianBelief(mean=t(obj.mean), cov=t(obj.cov))


def tsos_from(obj, device, dtype) -> TSOSBelief:
    """The port's ``TSOSBelief`` with the five factors of ``obj``, as
    tensors of ``dtype`` on ``device``."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return TSOSBelief(*(t(getattr(obj, f)) for f in TSOSBelief._fields))


def trajectory_from(obj, device, dtype) -> PredictedBeliefTrajectory:
    """The port's ``PredictedBeliefTrajectory`` with the times, means and
    covariances of ``obj``, as tensors of ``dtype`` on ``device``."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return PredictedBeliefTrajectory(t(obj.times), t(obj.means), t(obj.covs))


def airship_from(obj) -> AirshipParams:
    """The port's ``AirshipParams`` (float64 CPU tensors) with the fields of
    ``obj``."""
    f = lambda a: np.array(a, np.float64)
    return airship3D(mass=f(obj.mass), inertia=f(obj.inertia),
                     buoyancy=f(obj.buoyancy), r_cm=f(obj.r_cm),
                     drag_lin=f(obj.drag_lin), drag_rot=f(obj.drag_rot),
                     gravity=f(obj.gravity))


def quadrotor_from(obj) -> QuadrotorParams:
    """The port's ``QuadrotorParams`` (float64 CPU tensors) with the fields
    of ``obj``."""
    f = lambda a: np.array(a, np.float64)
    return quadrotor(mass=f(obj.mass), inertia=f(obj.inertia), arm=f(obj.arm),
                     k_torque=f(obj.k_torque), gravity=f(obj.gravity))


def _shape_records(cls, kinds, obj, device, dtype):
    """``cls`` with the fields of ``obj``: each shape record (``kinds``:
    field → record type) as tensors of ``dtype`` on ``device``, each other
    field (the body indices) as int64 on ``device``; absent fields stay
    None."""
    out = {}
    for field in cls._fields:
        value = getattr(obj, field, None)
        if value is None:
            continue
        if field in kinds:
            rec = kinds[field]
            out[field] = rec(*(torch.as_tensor(np.array(getattr(value, f)),
                                               dtype=dtype, device=device)
                               for f in rec._fields))
        else:
            out[field] = torch.as_tensor(np.array(value), dtype=torch.int64,
                                         device=device)
    return cls(**out)


_SHAPES_3D = {"spheres": Sphere, "capsules": Capsule, "boxes": Box,
              "cylinders": Cylinder, "planes": Plane}
_SHAPES_2D = {"circles": Circle, "rects": Rectangle,
              "crects": CappedRectangle, "segs": Seg2D}


def shapes_from(obj, device, dtype) -> ShapeSet:
    """The port's ``ShapeSet`` with the shapes and body indices of
    ``obj``."""
    return _shape_records(ShapeSet, _SHAPES_3D, obj, device, dtype)


def proxy_from(obj, device, dtype) -> ProxyModel:
    """The port's ``ProxyModel`` with the shapes of ``obj``."""
    return _shape_records(ProxyModel, _SHAPES_3D, obj, device, dtype)


def shapes2d_from(obj, device, dtype) -> ShapeSet2D:
    """The port's ``ShapeSet2D`` with the shapes and body indices of
    ``obj``."""
    return _shape_records(ShapeSet2D, _SHAPES_2D, obj, device, dtype)


def proxy2d_from(obj, device, dtype) -> ProxyModel2D:
    """The port's ``ProxyModel2D`` with the shapes of ``obj``."""
    return _shape_records(ProxyModel2D, _SHAPES_2D, obj, device, dtype)


def interp_trajectory_from(obj, device, dtype) -> Trajectory:
    """The port's interpolator ``Trajectory`` with the times, points and
    (where present) velocities and accelerations of ``obj``, as tensors of
    ``dtype`` on ``device``."""
    t = lambda a: None if a is None else torch.as_tensor(
        np.array(a), dtype=dtype, device=device)
    return Trajectory(t(obj.times), t(obj.points), t(getattr(obj, "vels", None)),
                      t(getattr(obj, "accs", None)))


def navigation_scenario_from(obj, device, dtype) -> NavigationScenario:
    """The port's ``NavigationScenario`` with the fields of ``obj``: the
    robot through ``spec_from``, its shapes and the environment on
    ``device`` in ``dtype``, the bounds, start and goal as tensors of
    ``dtype`` on ``device``."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return NavigationScenario(
        name=str(obj.name), robot=spec_from(obj.robot),
        robot_shapes=shapes_from(obj.robot_shapes, device, dtype),
        env=proxy_from(obj.env, device, dtype),
        bounds_lower=t(obj.bounds_lower), bounds_upper=t(obj.bounds_upper),
        start=t(obj.start), goal=t(obj.goal))


def chaser_target_scenario_from(obj, device, dtype) -> ChaserTargetScenario:
    """The port's ``ChaserTargetScenario`` with the fields of ``obj``, as
    ``navigation_scenario_from`` carries them."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return ChaserTargetScenario(
        name=str(obj.name), chaser=spec_from(obj.chaser),
        chaser_shapes=shapes_from(obj.chaser_shapes, device, dtype),
        target=spec_from(obj.target),
        target_shapes=shapes_from(obj.target_shapes, device, dtype),
        env=proxy_from(obj.env, device, dtype), start=t(obj.start),
        target_state=t(obj.target_state))


def box_space_from(obj, device, dtype):
    """The port's ``NdofSpace`` (``HyperboxSpace`` when ``obj`` is not an
    ``NdofSpace``) with the bounds and weights of ``obj``."""
    from reak_tpu_torch.spaces.vector import HyperboxSpace, NdofSpace

    cls = NdofSpace if type(obj).__name__ == "NdofSpace" else HyperboxSpace
    w = getattr(obj, "weights", None)
    t = lambda a: None if a is None else torch.as_tensor(
        np.array(a), dtype=dtype, device=device)
    return cls(t(obj.lower), t(obj.upper), t(w))


def workspace_from(obj, device, dtype):
    """The port's workspace of ``obj``: a ``NoObstacleWorkspace``, a
    ``ChainWorkspace`` or ``PlanarChainWorkspace`` (chain through
    ``spec_from``, shapes and environment through ``shapes_from`` /
    ``proxy_from`` or their 2-D forms, margin and edge checks kept), a
    ``TemporalChainWorkspace`` whose moving bodies carry
    ``rigid_traj_tabulated`` trajectories (their tables are read from the
    trajectory's closure), or the ``Workspace`` that ``bitmap_workspace``
    returns (its grid and bounds, likewise).  The space goes through
    ``box_space_from``."""
    import inspect

    from reak_tpu_torch.planning import workspace as ws

    space = box_space_from(obj.space, device, dtype)
    kind = type(obj).__name__
    if kind == "NoObstacleWorkspace":
        return ws.NoObstacleWorkspace(space)
    if kind in ("ChainWorkspace", "TemporalChainWorkspace"):
        args = (space, spec_from(obj.spec),
                shapes_from(obj.robot_shapes, device, dtype),
                proxy_from(obj.env, device, dtype))
        kw = dict(margin=float(obj.margin), n_checks=int(obj.n_checks))
        if kind == "ChainWorkspace":
            return ws.ChainWorkspace(*args, **kw)
        moving = []
        for shapes, traj in obj.moving:
            tab = inspect.getclosurevars(traj).nonlocals
            moving.append((shapes_from(shapes, device, dtype),
                           ws.rigid_traj_tabulated(
                               np.asarray(tab["ts"]), np.asarray(tab["poss"]),
                               np.asarray(tab["quats"]), device=device,
                               dtype=dtype)))
        return ws.TemporalChainWorkspace(*args, moving=moving, **kw)
    if kind == "PlanarChainWorkspace":
        return ws.PlanarChainWorkspace(
            space, spec_from(obj.spec),
            shapes2d_from(obj.robot_shapes, device, dtype),
            proxy2d_from(obj.env, device, dtype), margin=float(obj.margin),
            n_checks=int(obj.n_checks))
    tab = inspect.getclosurevars(obj._is_free).nonlocals
    return ws.bitmap_workspace(space, np.asarray(tab["grid"]),
                               np.asarray(tab["lower"]),
                               np.asarray(tab["upper"]),
                               n_checks=int(obj.n_checks))
