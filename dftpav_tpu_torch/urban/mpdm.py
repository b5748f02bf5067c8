"""MPDM behaviour planning: simulate candidate lateral behaviours, pick the
best (the port of `dftpav_tpu/urban/mpdm.py`; planning::BehaviorPlanner's
MultiBehaviorJudge in the reference).

Batch-first: the three behaviours are an axis after the scene batch, so one
call runs every behaviour's closed-loop and open-loop simulation of every
scene; invalid behaviours (no neighbour lane, or both simulations collide)
are masked, not branched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dftpav_tpu_torch.urban import forward_sim as fsim
from dftpav_tpu_torch.urban import geometry, lane as lane_mod
from dftpav_tpu_torch.urban.forward_sim import _take
from dftpav_tpu_torch.urban.lane import Lane, LaneSet

# Lateral behaviours (common::LateralBehavior)
LK, LCL, LCR = 0, 1, 2
BEHAVIORS = (LK, LCL, LCR)


class MPDMConfig(NamedTuple):
    sim_resolution: float = 0.4
    sim_horizon: float = 4.0
    desired_velocity: float = 6.0
    max_vel_cmd_gap: float = 5.0

    @property
    def n_steps(self) -> int:
        return int(self.sim_horizon / self.sim_resolution)


class MPDMResult(NamedTuple):
    behavior: torch.Tensor     # [*] int64 winning behaviour id
    desired_vel: torch.Tensor  # [*] clamped desired velocity command
    scores: torch.Tensor       # [*, 3] per-behaviour cost (inf if invalid)
    valid: torch.Tensor        # [*, 3] bool
    trajs: torch.Tensor        # [*, 3, T+1, A, 6] forward trajectories
    ref_lane_id: torch.Tensor  # [*] lane id of the winning behaviour


def behavior_lane_ids(lane_set: LaneSet, cur_lane_id):
    """Target lane per behaviour: [..., 3] = (LK, LCL, LCR) lane ids, -1
    where there is no such neighbour."""
    cur = torch.as_tensor(cur_lane_id, device=lane_set.left_id.device).long()
    return torch.stack([cur, lane_set.left_id[cur],
                        lane_set.right_id[cur]], dim=-1)


def _gather_lane(lane_set: LaneSet, lane_id) -> Lane:
    safe = torch.clamp(lane_id, min=0)
    return Lane(*(f[safe] for f in lane_set.lanes))


def _rollout_openloop(lanes, states0, geom_, desired_vel, p, dt, n_steps):
    """OpenloopSimForward: every agent free-flows on its own lane (no
    leading vehicle) at its desired velocity, with its own wheel base."""
    pi = p._replace(idm=p.idm._replace(desired_velocity=desired_vel))
    out = [states0]
    for _ in range(n_steps):
        out.append(fsim.propagate_once(
            lanes, out[-1], 0.0, 0.0, False, 5.0, pi, dt,
            wheel_base=geom_.wheel_base))
    return torch.stack(out, dim=-3)


def _ego_collisions(trajs, ego_idx, geom_: fsim.AgentGeom, inflate=0.0):
    """[..., T, A] bool: the ego overlaps agent a at step t (ego column
    False)."""
    ego = trajs[..., ego_idx, :]
    pa = (geom_.length[ego_idx], geom_.width[ego_idx], geom_.d_cr[ego_idx])
    pb = (geom_.length, geom_.width, geom_.d_cr)
    hit = geometry.vehicles_collide(ego[..., None, :], trajs, pa, pb,
                                    inflate=inflate)
    not_ego = torch.arange(trajs.shape[-2], device=trajs.device) != ego_idx
    return hit & not_ego


def _score_policy(traj, ego_idx, geom_, behavior_id, eval_lane: Lane,
                  cfg: MPDMConfig):
    """EvaluateSinglePolicyTraj: action + safety + efficiency cost of
    trajectories traj [*, T+1, A, 6] (see the JAX module for the terms)."""
    dev = traj.device
    ego_T = traj[..., -1, ego_idx, :]
    last = traj[..., -1, :, :]
    cost_eff_ego = (ego_T[..., fsim.V] - cfg.desired_velocity).abs() / 10.0

    # terminal leading vehicle on the evaluation lane
    ego_s, _ = lane_mod.frenet_of_point(eval_lane, ego_T[..., 0:2])
    lead_s, lead_v, has_lead, _ = fsim.leading_on_lane(
        eval_lane, ego_s, last, geom_, ego_idx)
    ds = lead_s - ego_s
    # euclidean distance to the leader's terminal position
    A = traj.shape[-2]
    s_all, d_all = lane_mod.frenet_of_point(
        lane_mod.lane_unsqueeze(eval_lane, 1), last[..., 0:2])
    dists = lane_mod._norm(last[..., 0:2] - ego_T[..., None, 0:2])
    j = torch.argmin(torch.where(
        (s_all > ego_s[..., None] + 1e-6) & (d_all.abs() < fsim.LAT_RANGE)
        & (torch.arange(A, device=dev) != ego_idx), s_all, torch.inf),
        dim=-1)
    dist_lead = _take(dists, j)
    ratio = torch.clamp((120.0 - ds) / 120.0, min=0.0)
    v_T = ego_T[..., fsim.V]
    lead_applies = (has_lead & (ds < 120.0)
                    & (v_T < cfg.desired_velocity)
                    & (lead_v < cfg.desired_velocity)
                    & (dist_lead < 100.0))
    cost_eff_lead = torch.where(
        lead_applies,
        1.5 * ratio * (v_T - cfg.desired_velocity).abs()
        / torch.clamp(dist_lead, min=2.0), 0.0)
    cost_eff = 0.5 * (cost_eff_ego + cost_eff_lead)

    hits = _ego_collisions(traj, ego_idx, geom_, inflate=0.5)
    dv = (traj[..., :, ego_idx, fsim.V][..., None] - traj[..., fsim.V]).abs()
    cost_safety = torch.where(hits, 0.01 * dv * 0.5, 0.0).sum((-2, -1))

    cost_action = torch.where(behavior_id == LK, 0.0, 0.5).to(traj.dtype)
    return cost_action + cost_safety + cost_eff


def _desired_vel_of_traj(traj, ego_idx, geom_, fallback):
    """GetDesiredVelocityOfTrajectory: the ego's velocity at the last state
    whose normal acceleration |kappa| v^2 is positive; `fallback` when the
    path is straight. traj [*, T+1, A, 6]."""
    v = traj[..., ego_idx, fsim.V]
    steer = traj[..., ego_idx, fsim.ST]
    kappa = torch.tan(steer).abs() / geom_.wheel_base[ego_idx]
    has = kappa * v * v > 1e-6
    found = has.any(-1)
    last = traj.shape[-3] - 1 - torch.argmax(has.flip(-1).long(), dim=-1)
    idx = torch.where(found, last, 0)
    return torch.where(found, _take(v, idx), fallback)


def mpdm_plan(lane_set: LaneSet, states, lane_ids, geom_: fsim.AgentGeom,
              ego_idx: int, p: fsim.SimParam, cfg: MPDMConfig) -> MPDMResult:
    """One MPDM decision per scene (MultiBehaviorJudge).

    states [*, A, 6] (steer.STATE_DIM layout); lane_ids [*, A] each agent's
    current lane (agents keep their lane, predicted behaviour LK); geom_
    [A], shared by the scenes.
    """
    dt, n_steps = cfg.sim_resolution, cfg.n_steps
    dev = states.device
    A = states.shape[-2]
    desired_vel = states[..., fsim.V].clone()
    desired_vel[..., ego_idx] = cfg.desired_velocity

    ego_lanes = behavior_lane_ids(lane_set, lane_ids[..., ego_idx])  # [*, 3]
    batch = states.shape[:-2]
    ids = lane_ids[..., None, :].expand(batch + (3, A)).clone()
    ids[..., ego_idx] = torch.clamp(ego_lanes, min=0)
    lanes = _gather_lane(lane_set, ids)                          # [*, 3, A]
    st = states[..., None, :, :].expand(batch + (3, A, states.shape[-1]))
    dv = desired_vel[..., None, :]
    cl = fsim.rollout(lanes, st, geom_, dv, p, dt, n_steps)
    ol = _rollout_openloop(lanes, st, geom_, dv, p, dt, n_steps)
    cl_hit = _ego_collisions(cl, ego_idx, geom_).flatten(-2).any(-1)
    ol_hit = _ego_collisions(ol, ego_idx, geom_).flatten(-2).any(-1)
    trajs = torch.where(cl_hit[..., None, None, None], ol, cl)
    valid = (ego_lanes >= 0) & ~(cl_hit & ol_hit)
    # terminal lane-keep evaluation lane = the behaviour's target lane
    eval_lane = _gather_lane(lane_set, ego_lanes)
    score = _score_policy(trajs, ego_idx, geom_,
                          torch.arange(3, device=dev), eval_lane, cfg)
    scores = torch.where(valid, score, torch.inf)

    best = torch.argmin(scores, dim=-1)
    t_best = torch.gather(
        trajs, len(batch),
        best.reshape(batch + (1, 1, 1, 1)).expand(
            batch + (1,) + trajs.shape[len(batch) + 1:])).squeeze(len(batch))
    des_vel = _desired_vel_of_traj(t_best, ego_idx, geom_,
                                   cfg.desired_velocity)
    # clamp command gap (behavior_planner.cc:239-247)
    v0 = states[..., ego_idx, fsim.V]
    des_vel = torch.minimum(torch.maximum(des_vel, v0 - cfg.max_vel_cmd_gap),
                            v0 + cfg.max_vel_cmd_gap)
    return MPDMResult(behavior=best, desired_vel=des_vel, scores=scores,
                      valid=valid, trajs=trajs,
                      ref_lane_id=_take(ego_lanes, best))
