"""Ideal steer plant with jerk/accel/steer-rate limiting + pure-pursuit
steering (the port of `dftpav_tpu/urban/steer.py`; simulator::IdealSteerModel
and control::PurePursuitControl in the reference).

Pure functions on a flat agent-state tensor [..., 6] that broadcast over any
batch; one RK4 step replaces odeint::integrate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dftpav_tpu_torch.urban.lane import normalize_angle

# Agent kinematic state layout (columns of a [..., 6] tensor):
#   0:x  1:y  2:theta  3:v  4:steer  5:acc(long)
X, Y, TH, V, ST, ACC = 0, 1, 2, 3, 4, 5
STATE_DIM = 6


class SteerLimits(NamedTuple):
    """OnLaneForwardSimulation::Param limits."""

    max_lon_acc: float = 2.0
    max_lon_dec: float = 5.0
    max_lon_acc_jerk: float = 5.0
    max_lon_dec_jerk: float = 5.0
    max_lat_acc: float = 1.5
    max_lat_jerk: float = 3.0
    max_steer_angle: float = 45.0 / 180.0 * math.pi
    max_steer_rate: float = 0.39
    max_curvature: float = 0.33


def pure_pursuit_steer(wheel_base, angle_diff, look_ahead_dist):
    """steer = atan2(2 L sin(angle_diff), lookahead)."""
    return torch.atan2(2.0 * wheel_base * torch.sin(angle_diff),
                       look_ahead_dist)


def _clip(x, lo, hi):
    return torch.clamp(x, min=lo, max=hi)


def truncate_control(state, ctrl_steer, ctrl_vel, wheel_base,
                     lim: SteerLimits, dt):
    """IdealSteerModel::TruncateControl: longitudinal jerk -> acc ->
    velocity clamp chain, then lateral jerk -> lat acc -> steer ->
    steer-rate chain."""
    v, steer0, acc0 = state[..., V], state[..., ST], state[..., ACC]
    curvature0 = torch.tan(steer0) / wheel_base

    ctrl_vel = torch.clamp(ctrl_vel, min=0.0)
    ctrl_steer = _clip(ctrl_steer, -lim.max_steer_angle, lim.max_steer_angle)

    lon_acc = (ctrl_vel - v) / dt
    lon_jerk = _clip((lon_acc - acc0) / dt,
                     -lim.max_lon_dec_jerk, lim.max_lon_acc_jerk)
    lon_acc = _clip(lon_jerk * dt + acc0, -lim.max_lon_dec, lim.max_lon_acc)
    vel = torch.clamp(v + lon_acc * dt, min=0.0)

    lat_acc = vel * vel * torch.tan(ctrl_steer) / wheel_base
    lat_acc0 = v * v * curvature0
    lat_jerk = _clip((lat_acc - lat_acc0) / dt,
                     -lim.max_lat_jerk, lim.max_lat_jerk)
    lat_acc = _clip(lat_jerk * dt + lat_acc0,
                    -lim.max_lat_acc, lim.max_lat_acc)
    steer = torch.atan(lat_acc * wheel_base
                       / torch.clamp(vel * vel, min=0.1 * 1e-8))
    steer_rate = _clip(normalize_angle(steer - steer0) / dt,
                       -lim.max_steer_rate, lim.max_steer_rate)
    steer = normalize_angle(steer0 + steer_rate * dt)
    return steer, vel, lon_acc, steer_rate


def ideal_steer_step(state, ctrl_steer, ctrl_vel, wheel_base,
                     lim: SteerLimits, dt):
    """One limited closed-loop plant step (IdealSteerModel::Step): the
    control is truncated, then the bicycle ODE is integrated with one RK4
    step."""
    _, _, lon_acc, steer_rate = truncate_control(
        state, ctrl_steer, ctrl_vel, wheel_base, lim, dt)

    def deriv(y):
        return torch.stack([
            torch.cos(y[..., TH]) * y[..., V],
            torch.sin(y[..., TH]) * y[..., V],
            torch.tan(y[..., ST]) * y[..., V] / wheel_base,
            lon_acc,
            steer_rate * torch.ones_like(y[..., ST]),
            torch.zeros_like(y[..., ACC]),
        ], dim=-1)

    k1 = deriv(state)
    k2 = deriv(state + 0.5 * dt * k1)
    k3 = deriv(state + 0.5 * dt * k2)
    k4 = deriv(state + dt * k3)
    nxt = state + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return torch.stack([nxt[..., X], nxt[..., Y],
                        normalize_angle(nxt[..., TH]), nxt[..., V],
                        normalize_angle(nxt[..., ST]),
                        lon_acc.expand(nxt.shape[:-1])], dim=-1)
