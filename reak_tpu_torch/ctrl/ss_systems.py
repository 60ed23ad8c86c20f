"""Concrete vehicle state-space systems: satellite, airship, quadrotor
(port of ``reak_tpu/ctrl/ss_systems.py``; ref: ss_systems/
satellite_basic_models.hpp:70, satellite_invar_models.hpp:296,406,514,
near_buoyant_airship_models.hpp:72,342,617,739, quadrotor_system.hpp:51,
airship_sonar_mixins.hpp:157).

Each vehicle is a named tuple of parameters plus pure functions
``f(x, u, t) → ẋ`` (continuous) and ``F(x, u, t) → x'`` (discrete time),
usable by the IEKF (``ctrl/invariant.py``) and the MPC layer
(``ctrl/mpc.py``, ``ctrl/mpc_manifold.py``).  Every function indexes the
last axis, so it takes a single state or leading batch axes, and
``torch.func`` transforms go through it.

State layout (frame_3D.hpp:40-45 — linear quantities in global coords,
angular ones in body coords):

    x = [p (3, global) | q (4, unit quaternion body→global)
         | v (3, global) | w (3, body)]            (13,)

followed by any augmented parameter states (airships).  Inputs are
body-frame force + torque ``u = [f_body (3) | tau_body (3)]`` unless noted.

The parameters' device: ``SatelliteParams``, ``AirshipParams`` and
``QuadrotorParams`` are configurations, float64 CPU tensors whatever the
states' device (``satellite3D``, ``airship3D``, ``quadrotor`` and
``convert`` make them so).  A model function made from them computes on the
device and in the type of the state it is given: its inertia, inverse
inertia and vectors are moved there once for each (device, dtype) at their
first use, its scalars are read once when the function is made.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from reak_tpu_torch.ctrl.invariant import Retraction, quat_state_retraction
from reak_tpu_torch.kte.lanes import _Consts
from reak_tpu_torch.math import rotations as rot

_UP = np.array([0.0, 0.0, 1.0])


def _f64(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64)


def _rigid_consts(params, **arrays) -> _Consts:
    """J, J⁻¹ (inverted in float64) and ``arrays``, per (dtype, device)."""
    J = np.asarray(params.inertia, np.float64)
    return _Consts(J=J, Jinv=np.linalg.inv(J), **arrays)


def _wdot(c, w, tau):
    """Euler's equations: J⁻¹(τ − ω × Jω)."""
    return (tau - rot.cross(w, w @ c["J"].T)) @ c["Jinv"].T


# ---------------------------------------------------------------------------
# shared rigid-body core
# ---------------------------------------------------------------------------


def split_state(x):
    """x → (p, q, v, w, aug)."""
    return x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13], x[..., 13:]


def join_state(p, q, v, w, aug=None):
    parts = [p, q, v, w]
    if aug is not None and aug.shape[-1]:
        parts.append(aug)
    return torch.cat(parts, dim=-1)


def _rigid_rate(q, v, w, acc_global, ang_acc_body, aug_rate=None):
    """Pack ẋ from the global linear and the body angular acceleration."""
    parts = [v, rot.qdot_from_omega(q, w), acc_global, ang_acc_body]
    if aug_rate is not None and aug_rate.shape[-1]:
        parts.append(aug_rate)
    return torch.cat(parts, dim=-1)


def sat3D_retraction(n_aug: int = 0) -> Retraction:
    """Invariant-error retraction for the 13(+n_aug)-state rigid body:
    tangent = [δp, δθ (3), δv, δw, δaug] (ref:
    satellite_invar_models.hpp:296)."""
    return quat_state_retraction(3, 13 + n_aug, 12 + n_aug)


def default_state(n_aug: int = 0, dtype=torch.float64, device="cuda"):
    """[p (3), q (4), v (3), ω (3), aug (n_aug)] at rest: origin, identity
    attitude.  On the card unless ``device`` says otherwise (the JAX
    function lands on the default accelerator); with no card it raises,
    and a CPU caller passes ``device="cpu"``."""
    x = torch.zeros(13 + n_aug, dtype=dtype, device=device)
    x[3] = 1.0
    return x


# ---------------------------------------------------------------------------
# satellite (ref: satellite_basic_models.hpp:70, satellite_invar_models.hpp)
# ---------------------------------------------------------------------------


class SatelliteParams(NamedTuple):
    mass: torch.Tensor         # scalar
    inertia: torch.Tensor      # (3, 3) body-frame inertia tensor


def satellite3D(mass=1.0, inertia=None) -> SatelliteParams:
    """Satellite parameters as float64 CPU tensors (identity inertia when
    None)."""
    return SatelliteParams(_f64(mass), _f64(np.eye(3) if inertia is None
                                            else inertia))


def satellite3D_cont(params: SatelliteParams) -> Callable:
    """Continuous dynamics of a free rigid body with body-frame thrusters:
    v̇ = R(q)·f/m,  J·ẇ = τ − w × Jw  (Euler's equations)."""
    consts = _rigid_consts(params)
    mass = float(params.mass)

    def f(x, u, t=0.0):
        c = consts(x)
        _, q, v, w, _ = split_state(x)
        fb, tb = u[..., 0:3], u[..., 3:6]
        acc = rot.qrot(q, fb) / mass
        return _rigid_rate(q, v, w, acc, _wdot(c, w, tb))

    return f


def satellite3D_imdt(params: SatelliteParams, dt: float) -> Callable:
    """Discrete-time invariant mid-point step on SE(3) (ref:
    satellite_invar_models.hpp:296 satellite3D_imdt_sys): the attitude
    advances along the Lie-group exponential of the mid-point body rate, so
    the quaternion stays unit and torque-free rotation keeps |Jw|."""
    consts = _rigid_consts(params)
    mass = float(params.mass)

    def F(x, u, t=0.0):
        c = consts(x)
        p, q, v, w, _ = split_state(x)
        fb, tb = u[..., 0:3], u[..., 3:6]
        # mid-point body rate (one fixed-point sweep of the implicit rule)
        w_half = w + 0.5 * dt * _wdot(c, w, tb)
        w_half = w + 0.5 * dt * _wdot(c, w_half, tb)
        q_next = rot.qnormalize(rot.qmul(q, rot.q_exp(dt * w_half)))
        w_next = w + dt * _wdot(c, w_half, tb)
        # translation: trapezoidal with the mid-point attitude
        q_half = rot.qmul(q, rot.q_exp(0.5 * dt * w_half))
        acc = rot.qrot(q_half, fb) / mass
        v_next = v + dt * acc
        p_next = p + dt * v + 0.5 * dt * dt * acc
        return join_state(p_next, q_next, v_next, w_next)

    return F


def h_pose(x, t=0.0):
    """Position + attitude measurement y = [p, q] (ref:
    satellite_basic_models.hpp:70)."""
    p, q, _, _, _ = split_state(x)
    return torch.cat([p, q], dim=-1)


def h_pose_gyro(x, t=0.0):
    """Pose + body-rate gyro (ref: satellite_invar_models.hpp:406)."""
    p, q, _, w, _ = split_state(x)
    return torch.cat([p, q, w], dim=-1)


def make_h_pose_imu(params: SatelliteParams, f_of_xu: Callable | None = None):
    """Pose + gyro + body-frame accelerometer (specific force) (ref:
    satellite3D_IMU_imdt_sys, satellite_invar_models.hpp:514)."""
    mass = float(params.mass)

    def h(x, u=None, t=0.0):
        p, q, _, w, _ = split_state(x)
        fb = torch.zeros_like(p) if u is None else u[..., 0:3]
        accel = fb / mass  # specific force sensed in the body frame
        return torch.cat([p, q, w, accel], dim=-1)

    return h


def make_h_sonars_in_room(room_lower, room_upper, sonar_pos, sonar_dir):
    """Sonar-grounded output model: N body-mounted sonar rays return their
    distance to the axis-aligned room box [room_lower, room_upper] (ref:
    airship_sonar_mixins.hpp:157 sonars_in_room_output_model, :171
    get_sonar_distance_to_room).

    One masked minimum over the 6 slab intersections of every sonar.  A
    sonar reports 0, the reference's impossible-distance guard, where its
    ray has no positive hit or where its world origin lies outside the
    room.  The JAX package (``reak_tpu/ctrl/ss_systems.py:190``) returns a
    slab crossing for an origin outside the room (fault F2); the port
    follows the reference.

    Returns ``h(x, t=0.0) → (..., N)`` distances given the rigid-body state
    x."""
    consts = _Consts(lo=np.asarray(room_lower, np.float64),
                     hi=np.asarray(room_upper, np.float64),
                     spos=np.asarray(sonar_pos, np.float64),   # (N, 3) body
                     sdir=np.asarray(sonar_dir, np.float64))   # (N, 3) body

    def h(x, t=0.0):
        c = consts(x)
        p, q, _, _, _ = split_state(x)
        qn = q[..., None, :]                                  # (..., 1, 4)
        pos_g = p[..., None, :] + rot.qrot(qn, c["spos"])     # (..., N, 3)
        dir_g = rot.qrot(qn, c["sdir"].expand(c["spos"].shape))
        valid = torch.abs(dir_g) > 1e-4
        safe = torch.where(valid, dir_g, torch.ones_like(dir_g))
        t_lo = (c["lo"] - pos_g) / safe
        t_hi = (c["hi"] - pos_g) / safe
        cand = torch.cat([t_lo, t_hi], dim=-1)                # (..., N, 6)
        ok = torch.cat([valid, valid], dim=-1) & (cand > 0.0)
        dist = torch.amin(torch.where(ok, cand, torch.full_like(cand,
                                                                np.inf)),
                          dim=-1)
        inside = torch.all((pos_g >= c["lo"]) & (pos_g <= c["hi"]), dim=-1)
        return torch.where(inside & torch.isfinite(dist), dist,
                           torch.zeros_like(dist))

    return h


def pose_innovation(z, y):
    """Measurement difference for [p, q, ...] outputs: the quaternion part
    maps to a 3-vector rotation error via the log map (the reference's
    invariant output error)."""
    dp = z[..., 0:3] - y[..., 0:3]
    dq = rot.qmul(rot.qconj(y[..., 3:7]), z[..., 3:7])
    dth = rot.q_log(rot.qnormalize(dq))
    return torch.cat([dp, dth, z[..., 7:] - y[..., 7:]], dim=-1)


# ---------------------------------------------------------------------------
# airship (ref: near_buoyant_airship_models.hpp:72,342,617,739 + mixins)
# ---------------------------------------------------------------------------


class AirshipParams(NamedTuple):
    mass: torch.Tensor        # scalar, body dry mass
    inertia: torch.Tensor     # (3, 3)
    buoyancy: torch.Tensor    # scalar net buoyant force (N, +up)
    r_cm: torch.Tensor        # (3,) CM offset from the body origin
    drag_lin: torch.Tensor    # scalar linear-velocity drag coefficient
    drag_rot: torch.Tensor    # scalar angular-velocity drag coefficient
    gravity: torch.Tensor     # scalar, +9.81


def airship3D(mass=1.0, inertia=None, buoyancy=None, r_cm=(0.0, 0.0, 0.0),
              drag_lin=0.1, drag_rot=0.1, gravity=9.81) -> AirshipParams:
    """Airship parameters as float64 CPU tensors (neutral buoyancy when
    ``buoyancy`` is None)."""
    buoy = mass * gravity if buoyancy is None else buoyancy
    return AirshipParams(_f64(mass), _f64(np.eye(3) if inertia is None
                                          else inertia), _f64(buoy),
                         _f64(r_cm), _f64(drag_lin), _f64(drag_rot),
                         _f64(gravity))


def airship3D_cont(params: AirshipParams) -> Callable:
    """Near-buoyant airship: gravity − buoyancy imbalance, CM-eccentricity
    torque, linear/rotational drag (ref: near_buoyant_airship_models.hpp:72
    state-rate)."""
    consts = _rigid_consts(params, r_cm=np.asarray(params.r_cm), up=_UP)
    mass, g = float(params.mass), float(params.gravity)
    buoy = float(params.buoyancy)
    d_lin, d_rot = float(params.drag_lin), float(params.drag_rot)

    def f(x, u, t=0.0):
        c = consts(x)
        _, q, v, w, _ = split_state(x)
        fb, tb = u[..., 0:3], u[..., 3:6]
        up = c["up"]
        # global forces: thrust (body), net buoyancy − weight, linear drag
        f_glob = rot.qrot(q, fb) + (buoy - mass * g) * up - d_lin * v
        acc = f_glob / mass
        # body torques: thrusters, gravity at the CM offset, rotational drag
        g_body = rot.qrot_inv(q, -g * up) * mass
        tau = tb + rot.cross(c["r_cm"], g_body) - d_rot * w
        return _rigid_rate(q, v, w, acc, _wdot(c, w, tau))

    return f


N_AUG_AIRSHIP = 5  # [δm (1), r_ecc (3), log-drag (1)]


def airship3D_aug_cont(params: AirshipParams) -> Callable:
    """Airship with augmented quasi-constant parameter states
    ``aug = [δm, r_ecc (3), κ_drag]`` appended to x (ref:
    near_buoyant_airship_models.hpp:342,617,739).  auġ = 0."""
    consts = _rigid_consts(params, r_cm=np.asarray(params.r_cm), up=_UP)
    mass, g = float(params.mass), float(params.gravity)
    buoy = float(params.buoyancy)
    d_lin, d_rot = float(params.drag_lin), float(params.drag_rot)

    def f(x, u, t=0.0):
        c = consts(x)
        _, q, v, w, aug = split_state(x)
        dm, r_ecc, kd = aug[..., 0:1], aug[..., 1:4], aug[..., 4:5]
        m = mass + dm
        fb, tb = u[..., 0:3], u[..., 3:6]
        up = c["up"]
        drag = d_lin * torch.exp(kd)
        f_glob = rot.qrot(q, fb) + (buoy - m * g) * up - drag * v
        acc = f_glob / m
        g_body = rot.qrot_inv(q, -g * up) * m
        tau = tb + rot.cross(c["r_cm"] + r_ecc, g_body) - d_rot * w
        return _rigid_rate(q, v, w, acc, _wdot(c, w, tau),
                           torch.zeros_like(aug))

    return f


# ---------------------------------------------------------------------------
# quadrotor (ref: quadrotor_system.hpp:51)
# ---------------------------------------------------------------------------


class QuadrotorParams(NamedTuple):
    mass: torch.Tensor
    inertia: torch.Tensor     # (3, 3)
    arm: torch.Tensor         # rotor arm length
    k_torque: torch.Tensor    # rotor drag-torque / thrust ratio
    gravity: torch.Tensor


def quadrotor(mass=1.0, inertia=None, arm=0.2, k_torque=0.02,
              gravity=9.81) -> QuadrotorParams:
    """Quadrotor parameters as float64 CPU tensors (inertia
    diag(0.01, 0.01, 0.02) when None)."""
    inertia = np.diag([0.01, 0.01, 0.02]) if inertia is None else inertia
    return QuadrotorParams(_f64(mass), _f64(inertia), _f64(arm),
                           _f64(k_torque), _f64(gravity))


def quadrotor_cont(params: QuadrotorParams) -> Callable:
    """X-configuration quadrotor; input u = 4 rotor thrusts (N, ≥0).
    Thrust along body +z; rotor torques from the arm geometry and the drag
    torque (ref: quadrotor_system.hpp:51 get_state_derivative)."""
    consts = _rigid_consts(params, up=_UP)
    mass, g = float(params.mass), float(params.gravity)
    a = float(params.arm) / float(np.sqrt(2.0))
    k = float(params.k_torque)

    def f(x, u, t=0.0):
        c = consts(x)
        _, q, v, w, _ = split_state(x)
        up = c["up"]
        thrust = torch.sum(u, dim=-1)
        acc = rot.qrot(q, thrust[..., None] * up) / mass - g * up
        # rotors (+x+y, +x−y, −x−y, −x+y), alternating spin for yaw balance
        tau_x = a * (u[..., 0] - u[..., 1] - u[..., 2] + u[..., 3])
        tau_y = a * (-u[..., 0] - u[..., 1] + u[..., 2] + u[..., 3])
        tau_z = k * (u[..., 0] - u[..., 1] + u[..., 2] - u[..., 3])
        tb = torch.stack([tau_x, tau_y, tau_z], dim=-1)
        return _rigid_rate(q, v, w, acc, _wdot(c, w, tb))

    return f


def hover_thrust(params: QuadrotorParams):
    """Per-rotor thrust that exactly cancels gravity."""
    return params.mass * params.gravity / 4.0


# ---------------------------------------------------------------------------
# discretization helper shared by all vehicles
# ---------------------------------------------------------------------------


def rk4_quat_discrete(f: Callable, dt: float, n_aug: int = 0) -> Callable:
    """RK4 step + quaternion renormalization (ref: num_int_dtnl_system.hpp:55
    wrapping)."""
    def F(x, u, t=0.0):
        k1 = f(x, u, t)
        k2 = f(x + 0.5 * dt * k1, u, t + 0.5 * dt)
        k3 = f(x + 0.5 * dt * k2, u, t + 0.5 * dt)
        k4 = f(x + dt * k3, u, t + dt)
        xn = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return torch.cat([xn[..., 0:3], rot.qnormalize(xn[..., 3:7]),
                          xn[..., 7:]], dim=-1)

    return F
