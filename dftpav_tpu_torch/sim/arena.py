"""Multi-vehicle physics arena: the phy_simulator equivalent (the port of
`dftpav_tpu/sim/arena.py`).

Every vehicle's kinematic bicycle model steps at 500 Hz from its latest
control (phy_simulator_planning_node.cc:117-135, vehicle_model.cc RK4); an
open-loop agent is teleported to its commanded state. All vehicles step in
one batched RK4 call; a burst of substeps between two planner ticks is a
Python loop over a fixed count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dftpav_tpu_torch.urban.lane import normalize_angle

# arena state layout per vehicle: x, y, theta, steer, v  — the ODE state of
# simulator::VehicleModel (vehicle_model.cc:38-51)
AX, AY, ATH, AST, AV = 0, 1, 2, 3, 4
ARENA_STATE_DIM = 5


class ArenaControl(NamedTuple):
    """Per-agent control ([A] tensors): closed loop u = (steer_rate,
    lon_acc); open loop a target state to teleport to."""

    steer_rate: torch.Tensor
    lon_acc: torch.Tensor
    openloop: torch.Tensor          # [A] bool
    target_state: torch.Tensor      # [A, 5]


def bicycle_deriv(s, u, wheel_base):
    """[x', y', th', steer', v'] = [v cos th, v sin th, v tan(steer)/L, u0,
    u1] (vehicle_model.cc:38-51)."""
    return torch.stack([
        torch.cos(s[..., ATH]) * s[..., AV],
        torch.sin(s[..., ATH]) * s[..., AV],
        torch.tan(s[..., AST]) * s[..., AV] / wheel_base,
        u[..., 0],
        u[..., 1],
    ], dim=-1)


def step_all(states, ctrl: ArenaControl, wheel_base, dt,
             max_steer: float = 0.75):
    """One RK4 physics step for all agents ([..., A, 5] -> [..., A, 5])."""
    u = torch.stack([ctrl.steer_rate, ctrl.lon_acc], dim=-1)

    def deriv(s):
        return bicycle_deriv(s, u, wheel_base)

    k1 = deriv(states)
    k2 = deriv(states + 0.5 * dt * k1)
    k3 = deriv(states + 0.5 * dt * k2)
    k4 = deriv(states + dt * k3)
    nxt = states + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    nxt = torch.stack([nxt[..., AX], nxt[..., AY],
                       normalize_angle(nxt[..., ATH]),
                       torch.clamp(nxt[..., AST], -max_steer, max_steer),
                       torch.clamp(nxt[..., AV], min=0.0)], dim=-1)
    return torch.where(ctrl.openloop[..., None], ctrl.target_state, nxt)


def run_burst(states, ctrl: ArenaControl, wheel_base, dt: float,
              n_substeps: int):
    """n_substeps physics steps (the 500 Hz burst between planner ticks)."""
    for _ in range(n_substeps):
        states = step_all(states, ctrl, wheel_base, dt)
    return states


def from_agent_states(states6):
    """steer-plant layout [..., 6] (x,y,th,v,steer,acc) -> arena [..., 5]."""
    return torch.stack([states6[..., 0], states6[..., 1], states6[..., 2],
                        states6[..., 4], states6[..., 3]], dim=-1)


def to_agent_states(states5, lon_acc=None):
    """arena [..., 5] -> steer-plant layout [..., 6]."""
    acc = torch.zeros_like(states5[..., 0]) if lon_acc is None else lon_acc
    return torch.stack([states5[..., AX], states5[..., AY], states5[..., ATH],
                        states5[..., AV], states5[..., AST], acc], dim=-1)
