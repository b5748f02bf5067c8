"""Kinematic bicycle plant with RK4 integration.

Equivalent of simulator::VehicleModel (vehicle_model.cc:25-51), which
integrates

    x' = v cos(theta),  y' = v sin(theta),  theta' = v tan(delta) / L,
    delta' = u_steer_rate,  v' = u_acc

with Boost.odeint RK4 and clamps steering to +-max_steering_angle. The step
is a function of state tensors [..., 5], so the physics of B vehicles is one
batched call on the model's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class VehicleState(NamedTuple):
    """State vector [x, y, theta, delta(steer), v]."""

    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor
    steer: torch.Tensor
    v: torch.Tensor

    def as_array(self):
        return torch.stack([self.x, self.y, self.theta, self.steer, self.v],
                           dim=-1)

    @classmethod
    def from_array(cls, a):
        return cls(a[..., 0], a[..., 1], a[..., 2], a[..., 3], a[..., 4])


class BicycleModel:
    """The plant; states and controls live on `device` (the card unless
    the caller names another)."""

    def __init__(self, wheel_base: float = 2.85,
                 max_steer: float = 0.7,
                 max_steer_rate: float = 5.0,
                 max_acc: float = 8.0,
                 device="cuda"):
        self.wheel_base = wheel_base
        self.max_steer = max_steer
        self.max_steer_rate = max_steer_rate
        self.max_acc = max_acc
        self.device = torch.device(device)

    def deriv(self, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """s: [..., 5] state, u: [..., 2] (steer_rate, acc)."""
        th, de, v = s[..., 2], s[..., 3], s[..., 4]
        sr = torch.clamp(u[..., 0], -self.max_steer_rate, self.max_steer_rate)
        ac = torch.clamp(u[..., 1], -self.max_acc, self.max_acc)
        return torch.stack([
            v * torch.cos(th),
            v * torch.sin(th),
            v * torch.tan(de) / self.wheel_base,
            sr.expand_as(v),
            ac.expand_as(v),
        ], dim=-1)

    def step(self, s: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
        """One RK4 step; steering clamped after integration
        (vehicle_model.cc:25-33)."""
        k1 = self.deriv(s, u)
        k2 = self.deriv(s + 0.5 * dt * k1, u)
        k3 = self.deriv(s + 0.5 * dt * k2, u)
        k4 = self.deriv(s + dt * k3, u)
        s1 = s + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        steer = torch.clamp(s1[..., 3:4], -self.max_steer, self.max_steer)
        return torch.cat([s1[..., :3], steer, s1[..., 4:]], dim=-1)

    def make_stepper(self, dt: float, substeps: int = 1):
        """(states [..., 5], controls [..., 2]) -> states after dt, in
        `substeps` RK4 steps, on the model's device (inputs are moved there,
        keeping their dtype)."""
        def stepper(s, u):
            s = torch.as_tensor(s, device=self.device)
            u = torch.as_tensor(u, dtype=s.dtype, device=self.device)
            for _ in range(substeps):
                s = self.step(s, u, dt / substeps)
            return s
        return stepper


def tracking_control(state, desired, wheel_base, k_steer=8.0, k_v=4.0,
                     k_pos=1.0, k_theta=2.5):
    """State-feedback controller mapping the executing trajectory's desired
    state to (steer_rate, acc), in numpy on the host.

    The reference's simulator consumes full desired states ("state-feedback
    control signals", phy_simulator.cc:75 + vehicle_msgs ControlSignal); the
    closed-loop variant here: steer rate servos the steering angle toward the
    desired (plus a heading-error term), acc = desired acc + velocity error
    feedback + longitudinal position error.
    """
    ex = desired["pos"][0] - state[0]
    ey = desired["pos"][1] - state[1]
    c, s = np.cos(state[2]), np.sin(state[2])
    e_lon = c * ex + s * ey
    e_lat = -s * ex + c * ey
    e_th = np.arctan2(np.sin(desired["theta"] - state[2]),
                      np.cos(desired["theta"] - state[2]))
    # theta' = v tan(delta)/L: the steering-to-heading gain flips sign with
    # the drive direction, so BOTH heading and lateral feedback must be
    # multiplied by sign(v) or reverse tracking is unstable.
    sgn = 1.0 if desired["vel"] >= 0 else -1.0
    steer_des = desired["steer"] + sgn * (k_theta * e_th + k_pos * e_lat)
    steer_rate = k_steer * (steer_des - state[3])
    acc = desired["acc"] + k_v * (desired["vel"] - state[4]) \
        + k_pos * e_lon
    return np.array([steer_rate, acc])
