"""MOBIL lane-change model + lateral behaviour prediction (the port of
`dftpav_tpu/urban/mobil.py`; common::MobilLaneChangingModel and
MobilBehaviorPrediction in the reference). One call evaluates MOBIL for
every agent of every scene: the per-lane leading / following lookups are
Frenet projections of all agents, gains and probabilities elementwise."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dftpav_tpu_torch.urban import forward_sim as fsim
from dftpav_tpu_torch.urban import lane as lane_mod
from dftpav_tpu_torch.urban.forward_sim import _take
from dftpav_tpu_torch.urban.idm import IDMParam, acc_acc
from dftpav_tpu_torch.urban.lane import Lane, LaneSet
from dftpav_tpu_torch.urban.mpdm import _gather_lane, behavior_lane_ids
from dftpav_tpu_torch.urban.rss import RssConfig, rss_safe


class MobilResult(NamedTuple):
    prob: torch.Tensor      # [..., 3] probabilities over (LK, LCL, LCR)
    gain_left: torch.Tensor
    gain_right: torch.Tensor
    lcl_safe: torch.Tensor  # bool
    lcr_safe: torch.Tensor


def _idm_acc_pair(rear_s, rear_v, front_s, front_v, has_front, v_des):
    """GetDesiredAccelerationUsingIdm: ACC acceleration of the rear vehicle;
    without a front vehicle a virtual one sits 100 + 10 v ahead."""
    p = IDMParam(desired_velocity=torch.clamp(v_des, min=1e-3))
    s_front = torch.where(has_front, front_s, rear_s + 100.0 + rear_v * 10.0)
    v_front = torch.where(has_front, front_v, rear_v)
    return acc_acc(p, rear_s, rear_v, s_front, v_front)


def _normalize_with_bound(v, lo=-1.0, hi=6.0):
    """normalize_with_bound(v, -1, 6, 0, 1)."""
    return torch.clamp((v - lo) / (hi - lo), min=0.0, max=1.0)


def _neighbors_on_lane(lane: Lane, states, idx):
    """(leading, following) Frenet info of agent `idx` on `lane`:
    (s_lead, v_lead, has_lead, s_follow, v_follow, has_follow, ego_s, ego_d).
    lane batch [*L]; states [*S, A, 6]; idx broadcasts with both."""
    s_all, d_all = lane_mod.frenet_of_point(lane_mod.lane_unsqueeze(lane, 1),
                                            states[..., 0:2])
    A = states.shape[-2]
    ego_s = _take(s_all, idx)
    near = ((d_all.abs() < fsim.LAT_RANGE)
            & (torch.arange(A, device=states.device) != idx[..., None]))
    ahead = near & (s_all > ego_s[..., None] + 1e-6)
    behind = near & (s_all < ego_s[..., None] - 1e-6)
    j_lead = torch.argmin(torch.where(ahead, s_all, torch.inf), dim=-1)
    j_fol = torch.argmax(torch.where(behind, s_all, -torch.inf), dim=-1)
    v = states[..., fsim.V]
    return (_take(s_all, j_lead), _take(v, j_lead), ahead.any(-1),
            _take(s_all, j_fol), _take(v, j_fol), behind.any(-1),
            ego_s, _take(d_all, idx))


def mobil_predict(lane_set: LaneSet, states, lane_ids, geom, agent_idx,
                  politeness: float = 0.0,
                  rss_cfg: RssConfig = RssConfig()) -> MobilResult:
    """Lateral behaviour probability of agent(s) `agent_idx` (an int or a
    tensor that broadcasts with the scenes' batch): MOBIL gains on the
    left/right neighbour lanes gated by RSS front/rear safety on the target
    lane, remapped to a (LK, LCL, LCR) probability vector
    (MobilBehaviorPrediction::LateralBehaviorPrediction). states [*, A, 6],
    lane_ids [*, A]; geom is unused, as in JAX."""
    del geom
    dev = states.device
    idx = torch.as_tensor(agent_idx, device=dev)
    v_ego = _take(states[..., fsim.V], idx)
    lanes3 = behavior_lane_ids(lane_set, _take(lane_ids.long(), idx))

    cur_lane = _gather_lane(lane_set, lanes3[..., 0])
    (ls, lv, hl, fs_, fv, hf, ego_s, _d) = _neighbors_on_lane(
        cur_lane, states, idx)
    # current lane: old follower's acc before/after ego leaves + ego's acc
    acc_o = _idm_acc_pair(fs_, fv, ego_s, v_ego, hf, fv)
    acc_o_tilda = _idm_acc_pair(fs_, fv, ls, lv, hf & hl, fv)
    acc_c = _idm_acc_pair(ego_s, v_ego, ls, lv, hl, v_ego)
    no_follow = ~hf | (fv.abs() < 1e-3)
    acc_o = torch.where(no_follow, 0.0, acc_o)
    acc_o_tilda = torch.where(no_follow, 0.0, acc_o_tilda)
    zero = torch.zeros_like(v_ego)

    def target_gain(lane_id, valid):
        lane_t = _gather_lane(lane_set, torch.clamp(lane_id, min=0))
        (ls_t, lv_t, hl_t, fs_t, fv_t, hf_t, s_t, d_t) = _neighbors_on_lane(
            lane_t, states, idx)
        # RSS safety vs new leader and follower (mobil_model.cc:77-88)
        front_safe = ~hl_t | rss_safe(s_t, d_t, v_ego, zero, ls_t, d_t,
                                      lv_t, zero, rss_cfg)
        rear_safe = ~hf_t | rss_safe(s_t, d_t, v_ego, zero, fs_t, d_t,
                                     fv_t, zero, rss_cfg)
        safe = valid & front_safe & rear_safe
        acc_n = _idm_acc_pair(fs_t, fv_t, ls_t, lv_t, hf_t & hl_t, fv_t)
        acc_n_tilda = _idm_acc_pair(fs_t, fv_t, s_t, v_ego, hf_t, fv_t)
        acc_c_tilda = _idm_acc_pair(s_t, v_ego, ls_t, lv_t, hl_t, v_ego)
        nf = ~hf_t | (fv_t.abs() < 1e-3)
        acc_n = torch.where(nf, 0.0, acc_n)
        acc_n_tilda = torch.where(nf, 0.0, acc_n_tilda)
        gain = (acc_c_tilda - acc_c) + politeness * (
            (acc_n_tilda - acc_n) + (acc_o_tilda - acc_o))
        return torch.where(safe, gain, -torch.inf), safe

    gain_l, lcl_safe = target_gain(lanes3[..., 1], lanes3[..., 1] >= 0)
    gain_r, lcr_safe = target_gain(lanes3[..., 2], lanes3[..., 2] >= 0)

    # RemapGainsToProb (mobil_behavior_prediction.cc:5-52)
    gl = _normalize_with_bound(gain_l)
    gr = _normalize_with_bound(gain_r)
    gk = _normalize_with_bound(torch.ones_like(gl))
    tot = gk + gl + gr
    p_both = torch.stack([gk / tot, gl / tot, gr / tot], dim=-1)
    p_left = torch.stack([1.0 - gl, gl, torch.zeros_like(gl)], dim=-1)
    p_right = torch.stack([1.0 - gr, torch.zeros_like(gr), gr], dim=-1)
    p_none = torch.tensor([1.0, 0.0, 0.0], dtype=states.dtype, device=dev)
    both = (lcl_safe & lcr_safe)[..., None]
    prob = torch.where(both, p_both,
                       torch.where(lcl_safe[..., None], p_left,
                                   torch.where(lcr_safe[..., None], p_right,
                                               p_none)))
    # near-stop -> lane keeping (mobil_behavior_prediction.cc:78-86)
    stopped = v_ego.abs() < 1e-3
    prob = torch.where(stopped[..., None], p_none, prob)
    return MobilResult(prob=prob, gain_left=gain_l, gain_right=gain_r,
                       lcl_safe=lcl_safe & ~stopped,
                       lcr_safe=lcr_safe & ~stopped)


def predict_all(lane_set: LaneSet, states, lane_ids, geom,
                politeness: float = 0.0) -> torch.Tensor:
    """[*, A, 3] behaviour probabilities for every agent."""
    A = states.shape[-2]
    return mobil_predict(lane_set, states.unsqueeze(-3),
                         lane_ids.unsqueeze(-2), geom,
                         torch.arange(A, device=states.device),
                         politeness).prob
