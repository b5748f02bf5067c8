"""EUDM behaviour planning: DCP-tree branching over semantic action
sequences, CFB belief branching over surrounding-vehicle intentions, batched
forward simulation and layered costs with the typed RSS safety ladder (the
port of `dftpav_tpu/urban/eudm.py`; planning::EudmPlanner + DcpTree in the
reference, whose sources and config lines the JAX module cites).

Batch-first: states [*, A, 6] and lane_ids [*, A] carry any leading scene
batch; the policies of the DCP tree are an axis P after it (and, for CFB,
the belief combinations an axis C before P), so one call simulates every
leaf of every scene. JAX's `lax.scan` over layers and steps is a Python
loop over H layers x steps_per_layer steps of
`forward_sim.multi_agent_step`, with each agent's lane gathered per (scene,
belief, policy, agent), as MPDM's [*, 3, A] gather does. Invalid policies
are masked (score inf), not branched.

Mid-horizon lateral re-planning is modelled as in JAX: when the simulated
ego reaches its lane-change target at a layer boundary, the remaining
lateral actions re-base through `_LAT_XFORM` and the reference lane
advances. The cross-tick manager context lives in
`urban/behavior_server.py`.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from dftpav_tpu_torch.urban import forward_sim as fsim
from dftpav_tpu_torch.urban import lane as lane_mod
from dftpav_tpu_torch.urban import rss as rss_mod
from dftpav_tpu_torch.urban import semantic_map as smap
from dftpav_tpu_torch.urban.forward_sim import _take
from dftpav_tpu_torch.urban.lane import LaneSet
from dftpav_tpu_torch.urban.mpdm import (_ego_collisions, _gather_lane,
                                         behavior_lane_ids)

# lateral actions are mpdm.{LK, LCL, LCR}; longitudinal ones:
MAINTAIN, ACCEL, DECEL = 0, 1, 2


class EUDMConfig(NamedTuple):
    tree_height: int = 5
    layer_time: float = 1.0
    step: float = 0.2
    desired_velocity: float = 6.0
    acc_cmd_vel_gap: float = 10.0
    dec_cmd_vel_gap: float = 10.0
    lon_aggressive_ratio: float = 0.25
    # cost weights
    ego_lack_speed_unit_cost: float = 0.3
    leading_unit_cost: float = 1.0
    lane_change_unit_cost: float = 0.3
    discount_factor: float = 0.7  # per layer
    # RSS safety ladder
    rss: rss_mod.RssConfig = rss_mod.RssConfig()
    rss_cost_enable: bool = True
    rss_over_speed_power_coeff: float = 0.25
    rss_over_speed_linear_coeff: float = 0.5
    rss_lack_speed_power_coeff: float = 0.35
    rss_lack_speed_linear_coeff: float = 0.6
    # CFB focus threshold: beliefs below this probability leave the
    # validity gate (they still carry their weight in the expectation)
    belief_prune_prob: float = 0.05

    @property
    def steps_per_layer(self) -> int:
        return int(round(self.layer_time / self.step))


def dcp_action_script(H: int, ongoing_lat: int = 0) -> np.ndarray:
    """All DCP-tree leaves as [n_policies, H, 2] (lon, lat) int arrays
    (host, numpy; DcpTree::GenerateActionScript): for each longitudinal
    action, one branch away from the ongoing lateral action at each depth
    1..H-1 to each other lateral action, then the no-change sequence."""
    out = []
    for lon in range(3):
        for h in range(1, H):
            for lat in range(3):
                if lat == ongoing_lat:
                    continue
                seq = [(lon, ongoing_lat)] * h + [(lon, lat)] * (H - h)
                out.append(seq[:H])
        out.append([(lon, ongoing_lat)] * H)
    return np.asarray(out, dtype=np.int32)  # [P, H, 2]


class EUDMResult(NamedTuple):
    best_policy: torch.Tensor    # [*] int64 index into the action script
    action_script: torch.Tensor  # [P, H, 2] int64
    scores: torch.Tensor         # [*, P] (inf where invalid)
    valid: torch.Tensor          # [*, P] bool
    trajs: torch.Tensor          # [*, P, T+1, A, 6] (CFB: most likely belief)
    behavior: torch.Tensor       # [*] int64 first differing lat action (or LK)
    desired_vel: torch.Tensor    # [*] velocity command
    risky: torch.Tensor          # [*, P] bool RSS-unsafe (CFB: any focused)


def _lon_desired_vel(lon_action, v_now, cfg: EUDMConfig):
    """Longitudinal action -> IDM desired velocity (lon_action broadcasts
    with v_now)."""
    v_base = torch.floor(v_now)
    v_des = cfg.desired_velocity
    acc = torch.clamp(v_base + cfg.acc_cmd_vel_gap, max=v_des)
    dec = torch.clamp(torch.clamp(v_base - cfg.dec_cmd_vel_gap, min=0.0),
                      max=v_des)
    mai = torch.clamp(v_base, max=v_des)
    return torch.where(lon_action == ACCEL, acc,
                       torch.where(lon_action == DECEL, dec, mai))


def _frenet_time_states(eval_lane, traj):
    """Frenet (s, vs, d, vd) of every agent state in traj [..., A, 6]; the
    lane's batch dims broadcast against the states' leading dims."""
    fs = lane_mod.frenet_of_state(eval_lane, traj[..., 0:2],
                                  traj[..., fsim.TH], traj[..., fsim.V])
    return fs.s, fs.s_dot, fs.d, fs.s_dot * fs.d_prime


def _rss_ladder(traj, ego_idx, eval_lane, geom_: fsim.AgentGeom,
                cfg: EUDMConfig, H: int, spl: int):
    """Per-layer RSS safety cost and riskiness of traj [*, T+1, A, 6] with
    T = H * spl: every step of every surrounding agent is typed against the
    ego on eval_lane (batch [*]); the ladder's cost accumulates per layer
    over steps and agents. Returns (rss_cost [*, H], risky [*] bool).

    One layer at a time: the Frenet projection of a layer's states onto
    the lane's samples is the peak of the planner's memory."""
    A = traj.shape[-2]
    lane = lane_mod.lane_unsqueeze(eval_lane, 2)
    not_self = torch.arange(A, device=traj.device) != ego_idx
    costs, risky = [], None
    for h in range(H):
        layer = traj[..., 1 + h * spl:1 + (h + 1) * spl, :, :]
        s, vs, d, vd = _frenet_time_states(lane, layer)     # [*, spl, A]
        es, evs, ed, evd = (x[..., ego_idx, None] for x in (s, vs, d, vd))
        safe, typ, v_low, v_up = rss_mod.rss_check_typed(
            es, ed, evs, evd, s, d, vs, vd,
            geom_.length[ego_idx], geom_.width[ego_idx], geom_.d_cr[ego_idx],
            geom_.length, geom_.width, geom_.d_cr, cfg.rss)
        unsafe = ~safe & not_self
        cost_fast = (cfg.rss_over_speed_linear_coeff * evs
                     * 10.0 ** (cfg.rss_over_speed_power_coeff
                                * (evs - v_up).abs()))
        cost_slow = (cfg.rss_lack_speed_linear_coeff * evs
                     * 10.0 ** (cfg.rss_lack_speed_power_coeff
                                * (evs - v_low).abs()))
        # the powers overflow to inf in float32 where they are not chosen:
        # selected away, never multiplied by a mask
        step_cost = torch.where(
            unsafe & (typ == rss_mod.TOO_FAST), cost_fast,
            torch.where(unsafe & (typ == rss_mod.TOO_SLOW), cost_slow, 0.0))
        if not cfg.rss_cost_enable:
            step_cost = torch.zeros_like(step_cost)
        costs.append(step_cost.sum((-2, -1)))
        r = unsafe.flatten(-2).any(-1)
        risky = r if risky is None else risky | r
    return torch.stack(costs, dim=-1), risky


_LAT_INVALID = 3
# lateral-finish transforms (UpdateLateralActionSequence): after completing
# a lane change the remaining sequence re-bases: same direction -> LK, LK ->
# the opposite direction, opposite -> invalid. Indexed [dir - 1][action]
# with dir in {LCL (1), LCR (2)}, INVALID absorbing.
_LAT_XFORM = np.array([
    [2, 0, _LAT_INVALID, _LAT_INVALID],   # completed LCL: LK->LCR, LCL->LK
    [1, _LAT_INVALID, 0, _LAT_INVALID],   # completed LCR: LK->LCL, LCR->LK
], dtype=np.int32)


def _sim_policies(script, agent_lane_ids, lane_set: LaneSet, states,
                  geom_: fsim.AgentGeom, ego_idx: int, p: fsim.SimParam,
                  cfg: EUDMConfig, ego_lanes):
    """Simulate every DCP leaf of script [P, H, 2] for each batch entry:
    agent_lane_ids [*, A] the belief's lane of each agent (the ego's entry
    is overridden per layer by its lateral action), states [*, A, 6],
    ego_lanes [*, 3] the ego's (LK, LCL, LCR) lanes. Returns (trajs
    [*, P, H*spl+1, A, 6], scores [*, P], valid [*, P], risky [*, P]).

    When the simulated ego reaches its lane-change target lane at a layer
    boundary, the reference lane for later actions becomes that lane and
    the remaining lateral actions re-base through _LAT_XFORM (an invalid
    re-base kills the policy)."""
    dev = states.device
    P, H = script.shape[0], script.shape[1]
    spl = cfg.steps_per_layer
    A = states.shape[-2]
    batch = states.shape[:-2]
    lat_seq = script[:, :, 1]                                    # [P, H]
    xform = torch.as_tensor(_LAT_XFORM, device=dev).long()
    ego = ego_idx                                   # the ego's agent index

    s = states[..., None, :, :].expand(batch + (P, A, states.shape[-1]))
    ids0 = agent_lane_ids[..., None, :].expand(batch + (P, A))
    vel0 = states[..., None, :, fsim.V].expand(batch + (P, A))
    ref_lane = torch.clamp(ego_lanes[..., 0], min=0)[..., None].expand(
        batch + (P,))
    lat_map = torch.arange(4, device=dev).expand(batch + (P, 4))
    ok = (ego_lanes[..., 0] >= 0)[..., None].expand(batch + (P,))
    layers = [s]
    for h in range(H):
        eff_lat = torch.gather(
            lat_map, -1, lat_seq[:, h].expand(batch + (P,))[..., None]
        ).squeeze(-1)                                            # [*, P]
        cand = behavior_lane_ids(lane_set, ref_lane)             # [*, P, 3]
        tgt = _take(cand, torch.clamp(eff_lat, max=2))
        ok = ok & (eff_lat != _LAT_INVALID) & (tgt >= 0)
        lane_id_h = torch.where(ok, torch.clamp(tgt, min=0), ref_lane)
        ids = ids0.clone()
        ids[..., ego] = lane_id_h
        lanes = _gather_lane(lane_set, ids)                      # [*, P, A]
        desired = vel0.clone()
        desired[..., ego] = _lon_desired_vel(script[:, h, 0], s[..., ego,
                                                                fsim.V], cfg)
        for _ in range(spl):
            s = fsim.multi_agent_step(lanes, s, geom_, desired, p, cfg.step)
            layers.append(s)

        # lateral-finish check at the layer boundary: the ego's nearest
        # lane is the lane-change target
        near = smap.nearest_lane(lane_set, s[..., ego, 0:2],
                                 s[..., ego, fsim.TH])
        finished = ((eff_lat == 1) | (eff_lat == 2)) & (near == lane_id_h)
        rows = xform[torch.clamp(eff_lat - 1, 0, 1)]            # [*, P, 4]
        lat_map = torch.where(finished[..., None],
                              torch.gather(rows, -1, lat_map), lat_map)
        ref_lane = torch.where(finished, lane_id_h, ref_lane)
    traj = torch.stack(layers, dim=-3)                     # [*, P, T+1, A, 6]

    # --- costs, per layer, discounted ---
    vT = traj[..., spl::spl, ego, fsim.V]                        # [*, P, H]
    lack = torch.where(vT < cfg.desired_velocity,
                       cfg.ego_lack_speed_unit_cost
                       * (vT - cfg.desired_velocity).abs(), 0.0)
    disc = cfg.discount_factor ** torch.arange(H, dtype=traj.dtype,
                                               device=dev)

    # RSS ladder on the ego's current (evaluation) lane
    eval_lane = lane_mod.lane_unsqueeze(
        _gather_lane(lane_set, torch.clamp(ego_lanes[..., 0], min=0)), 1)
    rss_cost, risky = _rss_ladder(traj, ego, eval_lane, geom_, cfg, H, spl)
    cost_safety_rss = (disc * 0.5 * rss_cost * cfg.layer_time).sum(-1)

    cost_eff = (disc * lack * cfg.layer_time).sum(-1)

    hits = _ego_collisions(traj, ego, geom_)                     # [*,P,T+1,A]
    dv = (traj[..., :, ego, fsim.V][..., None] - traj[..., fsim.V]).abs()
    cost_safety = torch.where(hits, 0.1 * (1.0 + dv), 0.0).sum((-2, -1))

    n_changes = (lat_seq[:, 1:] != lat_seq[:, :-1]).sum(-1)       # [P]
    v0 = states[..., ego, fsim.V][..., None]
    cost_nav = cfg.lane_change_unit_cost * (
        n_changes.to(traj.dtype) * torch.clamp(v0, min=1.0)
        / max(cfg.desired_velocity, 1.0))

    collided = hits.flatten(-2).any(-1)
    valid = ok & ~collided
    score = cost_eff + cost_safety + cost_safety_rss + cost_nav
    return traj, torch.where(valid, score, torch.inf), valid, risky


def _finalize(script, trajs, scores, valid, risky, ego_idx,
              cfg: EUDMConfig) -> EUDMResult:
    best = torch.argmin(scores, dim=-1)          # all inf: the first index
    # the executed behaviour = the first lateral action that differs from
    # the root
    lat_best = script[best, :, 1]                                # [*, H]
    differs = lat_best != lat_best[..., :1]
    first = torch.argmax(differs.to(torch.int32), dim=-1)
    behavior = torch.where(differs.any(-1), _take(lat_best, first),
                           lat_best[..., 0])
    v_end = _take(trajs[..., cfg.steps_per_layer, ego_idx, fsim.V], best)
    return EUDMResult(best_policy=best, action_script=script, scores=scores,
                      valid=valid, trajs=trajs, behavior=behavior,
                      desired_vel=v_end, risky=risky)


def _script_of(script, cfg: EUDMConfig, ongoing_lat: int, device):
    """The [P, H, 2] action table as an int64 tensor on `device`: the DCP
    tree rooted at ongoing_lat unless a table (array or tensor) is
    given."""
    if script is None:
        script = dcp_action_script(cfg.tree_height, ongoing_lat)
    if not torch.is_tensor(script):
        script = torch.from_numpy(np.asarray(script))
    return script.to(device=device, dtype=torch.int64)


def eudm_plan(lane_set: LaneSet, states, lane_ids, geom_: fsim.AgentGeom,
              ego_idx: int, p: fsim.SimParam, cfg: EUDMConfig,
              script=None, ongoing_lat: int = 0) -> EUDMResult:
    """One EUDM decision per scene under the observed (default) belief:
    simulate every DCP-tree leaf, pick the best.

    states [*, A, 6]; lane_ids [*, A] current lanes; geom_ [A], shared by
    the scenes. trajs are [*, P, H*steps_per_layer + 1, A, 6].
    `ongoing_lat` roots the DCP tree at the manager's ongoing lateral
    action; `script` may pass the [P, H, 2] action table directly, so one
    planner serves any root."""
    script = _script_of(script, cfg, ongoing_lat, states.device)
    ego_lanes = behavior_lane_ids(lane_set, lane_ids[..., ego_idx])  # [*, 3]
    trajs, scores, valid, risky = _sim_policies(
        script, lane_ids, lane_set, states, geom_, ego_idx, p, cfg,
        ego_lanes)
    return _finalize(script, trajs, scores, valid, risky, ego_idx, cfg)


def _combo_table(U: int) -> np.ndarray:
    """[3^U, U] int32: every combination of {LK, LCL, LCR} over U agents,
    the last agent varying fastest (the order CFB's weights follow)."""
    return np.asarray(list(itertools.product(range(3), repeat=U)),
                      dtype=np.int32).reshape(3 ** U, U)


def cfb_belief_combos(sur_lat_probs, uncertain_idx: Sequence[int]):
    """Host-side CFB combo table: ([C, U] lat actions, [C] raw
    probabilities) for one scene's sur_lat_probs [A, 3] (numpy).

    C = 3^U combinations of {LK, LCL, LCR} over the focused agents; each
    combo's probability is the product of the agents' belief entries."""
    combos = _combo_table(len(uncertain_idx))
    probs = np.ones(combos.shape[0])
    for j, u in enumerate(uncertain_idx):
        probs *= np.asarray(sur_lat_probs)[u, combos[:, j]]
    return combos, probs


def eudm_plan_cfb(lane_set: LaneSet, states, lane_ids,
                  geom_: fsim.AgentGeom, ego_idx: int, p: fsim.SimParam,
                  cfg: EUDMConfig, sur_lat_probs,
                  uncertain_idx: Sequence[int], script=None,
                  ongoing_lat: int = 0) -> EUDMResult:
    """EUDM with CFB belief branching over surrounding-vehicle intentions.

    sur_lat_probs [*, A, 3]: per agent the probability of {LK, LCL, LCR}
    (rows of agents not focused are ignored); uncertain_idx: a static tuple
    of the agents to branch. Per policy: score = the expectation over the
    beliefs whose score is finite, valid = no focused belief (weight >
    belief_prune_prob after renormalisation) is unsafe, risky = any
    focused belief is. trajs come from the most likely belief (the first
    on a tie). `script` / `ongoing_lat` as in eudm_plan."""
    dev = states.device
    script = _script_of(script, cfg, ongoing_lat, dev)
    ego_lanes = behavior_lane_ids(lane_set, lane_ids[..., ego_idx])  # [*, 3]
    combos = torch.as_tensor(_combo_table(len(uncertain_idx)),
                             dtype=torch.int64, device=dev)
    C = combos.shape[0]
    batch = states.shape[:-2]
    A = states.shape[-2]
    probs_in = torch.as_tensor(sur_lat_probs, device=dev).to(torch.float64)

    # per combo: its probability (the product over the agents, in float64
    # as the host table is) and each agent's lane; a combo whose behaviour
    # has no target lane (e.g. LCL without a left neighbour) gets weight 0
    probs = torch.ones(batch + (C,), dtype=torch.float64, device=dev)
    ids = lane_ids[..., None, :].expand(batch + (C, A)).clone()
    combo_ok = torch.ones(batch + (C,), dtype=torch.bool, device=dev)
    for j, u in enumerate(uncertain_idx):
        probs = probs * probs_in[..., u, :][..., combos[:, j]]
        cand = behavior_lane_ids(lane_set, lane_ids[..., u])     # [*, 3]
        tgt = cand[..., combos[:, j]]                            # [*, C]
        combo_ok = combo_ok & (tgt >= 0)
        ids[..., u] = torch.clamp(tgt, min=0)
    w = torch.where(combo_ok, probs.to(states.dtype), 0.0)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    focused = w > cfg.belief_prune_prob

    st_c = states[..., None, :, :].expand(batch + (C,) + states.shape[-2:])
    trajs_c, scores_c, valid_c, risky_c = _sim_policies(
        script, ids, lane_set, st_c, geom_, ego_idx, p, cfg,
        ego_lanes[..., None, :].expand(batch + (C, 3)))
    # trajs_c [*, C, P, T+1, A, 6]; scores_c / valid_c / risky_c [*, C, P]

    # the expectation over beliefs, renormalised over the finite combos of
    # each policy (dropping a non-finite combo's share without it would
    # favour policies infeasible under unlikely beliefs)
    finite = torch.isfinite(scores_c)
    w_c = w[..., None]
    w_fin = (w_c * finite).sum(-2)                               # [*, P]
    scores = (w_c * torch.where(finite, scores_c, 0.0)).sum(-2) \
        / torch.clamp(w_fin, min=1e-9)
    foc = focused[..., None]
    valid = torch.where(foc, valid_c, True).all(-2)
    risky = torch.where(foc, risky_c, False).any(-2)
    scores = torch.where(valid, scores, torch.inf)

    c_star = torch.argmax(w, dim=-1)                             # [*]
    sel = c_star.reshape(batch + (1,) * (trajs_c.dim() - len(batch)))
    trajs = torch.gather(trajs_c, len(batch), sel.expand(
        batch + (1,) + trajs_c.shape[len(batch) + 1:])).squeeze(len(batch))
    return _finalize(script, trajs, scores, valid, risky, ego_idx, cfg)
