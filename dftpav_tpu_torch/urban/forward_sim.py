"""On-lane closed-loop forward simulation: IDM longitudinal + pure-pursuit
lateral (the port of `dftpav_tpu/urban/forward_sim.py`;
planning::OnLaneForwardSimulation and BehaviorPlanner::MultiAgentSimForward
in the reference).

Batch-first: all A agents of every scene step in one call (leading-vehicle
resolution is an [A, A] Frenet-projection matrix), and the horizon is a
Python loop over a fixed number of steps. Where JAX vmaps over agents, the
agent axis is the last batch axis here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dftpav_tpu_torch.urban import lane as lane_mod
from dftpav_tpu_torch.urban import steer as steer_mod
from dftpav_tpu_torch.urban.idm import IDMParam, idm_velocity
from dftpav_tpu_torch.urban.lane import Lane, normalize_angle
from dftpav_tpu_torch.urban.steer import ST, STATE_DIM, SteerLimits, TH, V

LAT_RANGE = 2.2  # lateral gate for "on this lane" (behavior_planner.cc:473)


class SimParam(NamedTuple):
    """OnLaneForwardSimulation::Param."""

    idm: IDMParam = IDMParam()
    limits: SteerLimits = SteerLimits()
    steer_control_gain: float = 1.5
    steer_lookahead_max: float = 50.0
    steer_lookahead_min: float = 3.0


class AgentGeom(NamedTuple):
    """Per-agent footprint geometry [A] (shared by every scene of a batch)."""

    length: torch.Tensor
    width: torch.Tensor
    d_cr: torch.Tensor
    wheel_base: torch.Tensor


def _take(x, j):
    """x [..., A] at index j [...] (both broadcast) -> [...]."""
    lead = torch.broadcast_shapes(x.shape[:-1], j.shape)
    return torch.gather(x.expand(lead + x.shape[-1:]), -1,
                        j.expand(lead)[..., None]).squeeze(-1)


def propagate_once(lane: Lane, state, lead_s, lead_v, has_lead, eqv_len,
                   p: SimParam, dt, wheel_base=2.85, lat_track_offset=0.0):
    """One agent step on its reference lane (PropagateOnce).

    lead_s/lead_v: Frenet arc length and velocity of the leading vehicle on
    this lane; eqv_len: the equivalent IDM vehicle length. Without a leader
    (``has_lead`` False) a virtual one 100 + 100 v ahead gives free-flow
    IDM. Every argument broadcasts with the state's batch.
    """
    def t(x):
        return torch.as_tensor(x, dtype=state.dtype, device=state.device)

    pos = state[..., 0:2]
    fs = lane_mod.frenet_of_state(lane, pos, state[..., TH], state[..., V])

    # --- Step I: pure-pursuit steering toward a lookahead point on the lane
    lookahead = torch.clamp(state[..., V] * p.steer_control_gain,
                            min=p.steer_lookahead_min,
                            max=p.steer_lookahead_max)
    dest, _ = lane_mod.state_of_frenet(
        lane, fs.s + lookahead, torch.full_like(fs.s, lat_track_offset))
    rel = dest - pos
    dist = lane_mod._norm(rel)
    angle_diff = normalize_angle(torch.atan2(rel[..., 1], rel[..., 0])
                                 - state[..., TH])
    steer = steer_mod.pure_pursuit_steer(wheel_base, angle_diff, dist)
    # reverse gear or degenerate projection -> keep current steer, brake
    lat_ok = fs.s_dot >= -1e-6
    steer = torch.where(lat_ok, steer, state[..., ST])
    idm_p = p.idm._replace(
        desired_velocity=torch.where(lat_ok, t(p.idm.desired_velocity), 0.0),
        vehicle_length=t(eqv_len))

    # --- Step II: IDM longitudinal velocity
    virt_s = fs.s + 100.0 + 100.0 * state[..., V]
    has_lead = torch.as_tensor(has_lead, device=state.device)
    s_front = torch.where(has_lead, t(lead_s), virt_s)
    v_front = torch.where(has_lead, torch.clamp(t(lead_v), min=0.0),
                          state[..., V])
    vel = idm_velocity(idm_p, fs.s, s_front, state[..., V], v_front, dt)

    # --- Step III: limited plant step
    return steer_mod.ideal_steer_step(state, steer, vel, wheel_base,
                                      p.limits, dt)


def leading_on_lane(lane: Lane, ego_s, states, geom: AgentGeom, self_idx):
    """Leading agent of an ego at arc length ego_s on ``lane``.

    lane batch [*L]; ego_s and self_idx (an int or a tensor) broadcast with
    it; states [*S, A, 6] with *S broadcasting with *L. Returns (lead_s,
    lead_v, has_lead, eqv_len) [broadcast]: the nearest agent ahead within
    LAT_RANGE laterally, not the ego itself (GetLeadingVehicleOnLane), and
    the IDM equivalent length.
    """
    dev = states.device
    s_all, d_all = lane_mod.frenet_of_point(lane_mod.lane_unsqueeze(lane, 1),
                                            states[..., 0:2])
    A = states.shape[-2]
    self_idx = torch.as_tensor(self_idx, device=dev)
    not_self = torch.arange(A, device=dev) != self_idx[..., None]
    ahead = ((s_all > ego_s[..., None] + 1e-6) & (d_all.abs() < LAT_RANGE)
             & not_self)
    s_masked = torch.where(ahead, s_all, torch.inf)
    j = torch.argmin(s_masked, dim=-1)
    has_lead = torch.isfinite(_take(s_masked, j))
    lead_s = torch.where(has_lead, _take(s_all, j), 0.0)
    lead_v = torch.where(has_lead, _take(states[..., V], j), 0.0)
    # equivalent length: ego rear-axle->front bumper + leader rear
    # bumper->axle
    ego_half = geom.length[self_idx] / 2.0 + geom.d_cr[self_idx]
    lead_rb2r = geom.length[j] / 2.0 - geom.d_cr[j]
    return lead_s, lead_v, has_lead, ego_half + lead_rb2r


def multi_agent_step(lanes: Lane, states, geom: AgentGeom,
                     desired_vel, p: SimParam, dt):
    """Advance all A agents one closed-loop step.

    lanes: each agent's reference lane, batch [*, A]; states [*, A, 6];
    desired_vel broadcasts with [*, A]. Every agent runs IDM + pure pursuit
    on its own lane, reacting to the nearest leader on that lane at the
    current step (MultiAgentSimForward's inner loop). The plant uses the
    default wheel base, as JAX's does.
    """
    A = states.shape[-2]
    ego_s, _ = lane_mod.frenet_of_point(lanes, states[..., 0:2])
    lead_s, lead_v, has_lead, eqv_len = leading_on_lane(
        lanes, ego_s, states.unsqueeze(-3), geom,
        torch.arange(A, device=states.device))
    pi = p._replace(idm=p.idm._replace(desired_velocity=desired_vel))
    return propagate_once(lanes, states, lead_s, lead_v, has_lead, eqv_len,
                          pi, dt)


def rollout(lanes: Lane, states0, geom: AgentGeom, desired_vel,
            p: SimParam, dt, n_steps: int):
    """Closed-loop rollout -> trajs [*, T+1, A, STATE_DIM] (includes t=0)."""
    out = [states0]
    for _ in range(n_steps):
        out.append(multi_agent_step(lanes, out[-1], geom, desired_vel, p,
                                    dt))
    return torch.stack(out, dim=-3)


__all__ = [
    "SimParam", "AgentGeom", "propagate_once", "leading_on_lane",
    "multi_agent_step", "rollout", "STATE_DIM",
]
