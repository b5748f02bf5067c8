"""Behaviour planner server: the decision loop around MPDM / EUDM (the port
of `dftpav_tpu/urban/behavior_server.py`; planning::BehaviorPlannerServer in
the reference).

A host object, as in JAX: each tick associates lanes, runs the behaviour
planner (autonomous level >= 3 enables it), applies the HMI lock, and
returns the lateral behaviour, reference lane and forward trajectory. The
EUDM branch carries the manager's cross-tick context (the ongoing action
roots the next tick's DCP tree; a completed lane change collapses the root
to LK). States may live on the card; the host reads back only the values
JAX's server reads back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dftpav_tpu_torch.urban import eudm as eudm_mod
from dftpav_tpu_torch.urban import forward_sim as fsim
from dftpav_tpu_torch.urban import mpdm as mpdm_mod
from dftpav_tpu_torch.urban import semantic_map
from dftpav_tpu_torch.urban.lane import LaneSet


@dataclasses.dataclass
class BehaviorDecision:
    behavior: int           # mpdm.{LK, LCL, LCR}
    ref_lane_id: int
    desired_vel: float
    forward_traj: np.ndarray   # [T+1, A, 6] winning policy rollout
    valid: bool
    ongoing_lat: int = 0    # the DCP root this decision was planned from


@dataclasses.dataclass
class EudmSnapshot:
    """The EUDM manager's cross-tick context: the last winning action
    sequence and its stamp locate the ongoing action by elapsed time; a
    committed lane change is carried until the ego reaches its target lane,
    then the root collapses to LK."""

    action_seq: np.ndarray      # [H, 2] winner (lon, lat) sequence
    stamp: float                # decision time (the sequence's start)
    valid: bool = True
    risky: bool = False
    # committed lane change
    lc_lat: int = 0             # 0 = none committed
    lc_target: int = -1         # target lane id of the committed change


class BehaviorServer:
    """Behaviour decisions with HMI lock and level gating.

    autonomous_level < 3 -> always lane keep (no planner); >= 3 -> the
    planner decides. `lock_to_hmi(behavior)` pins the output to an
    operator-requested behaviour while it stays among the valid
    candidates (MPDM).
    """

    def __init__(self, lane_set: LaneSet, geom: fsim.AgentGeom, ego_idx: int,
                 planner: str = "mpdm", autonomous_level: int = 3,
                 sim_param: fsim.SimParam | None = None,
                 cfg=None):
        self.lane_set = lane_set
        self.geom = geom
        self.ego_idx = ego_idx
        self.level = autonomous_level
        self.p = sim_param or fsim.SimParam()
        self.planner = planner
        self.hmi_behavior: int | None = None
        if planner == "mpdm":
            self.cfg = cfg or mpdm_mod.MPDMConfig()
        elif planner == "eudm":
            self.cfg = cfg or eudm_mod.EUDMConfig()
            self._snapshot: EudmSnapshot | None = None
            self._auto_stamp = 0.0
        else:
            raise ValueError(planner)

    def lock_to_hmi(self, behavior: int | None):
        """Pin the lateral behaviour (None releases the lock)."""
        self.hmi_behavior = behavior

    def _states(self, states):
        xy = self.lane_set.lanes.xy
        return torch.as_tensor(states, device=xy.device).to(xy.dtype)

    def ongoing_lat_action(self, states, stamp: float) -> int:
        """The manager's ongoing lateral action at `stamp`: the last winning
        sequence indexed by elapsed time; a committed lane change whose
        target lane the ego has reached completes and collapses the root
        to LK."""
        snap = getattr(self, "_snapshot", None)
        if snap is None or not snap.valid:
            return mpdm_mod.LK
        if snap.lc_lat != mpdm_mod.LK and snap.lc_target >= 0:
            st = self._states(states)
            near = int(semantic_map.nearest_lane(
                self.lane_set, st[self.ego_idx, 0:2],
                st[self.ego_idx, fsim.TH]))
            if near == snap.lc_target:
                # lane change completed -> clear the lc context
                self._snapshot = dataclasses.replace(
                    snap, lc_lat=mpdm_mod.LK, lc_target=-1)
                return mpdm_mod.LK
        H = snap.action_seq.shape[0]
        elapsed = stamp - snap.stamp
        if elapsed < 0.0:
            return mpdm_mod.LK
        idx = min(int(elapsed / self.cfg.layer_time), H - 1)
        return int(snap.action_seq[idx, 1])

    def tick(self, states, stamp: float | None = None) -> BehaviorDecision:
        """One decision cycle on the current agent states [A, 6] (a tensor
        or an array; put on the lane net's device and dtype).

        `stamp` (seconds) drives the EUDM manager context: the previous
        tick's committed action, located by elapsed time in the last
        winning sequence, roots this tick's DCP tree. Without a stamp the
        clock advances 0.05 s per tick."""
        states = self._states(states)
        lane_ids = torch.clamp(
            semantic_map.associate_lanes(self.lane_set, states), min=0)
        ego_lane = int(lane_ids[self.ego_idx])

        if self.level < 3:
            # no autonomous behaviour planning: lane keep at current speed
            traj = fsim.rollout(
                mpdm_mod._gather_lane(self.lane_set, lane_ids), states,
                self.geom, states[:, fsim.V], self.p, 0.4, 10)
            return BehaviorDecision(
                behavior=mpdm_mod.LK, ref_lane_id=ego_lane,
                desired_vel=float(states[self.ego_idx, fsim.V]),
                forward_traj=traj.cpu().numpy(), valid=True)

        lanes3 = mpdm_mod.behavior_lane_ids(
            self.lane_set, ego_lane).cpu().numpy()
        if self.planner == "mpdm":
            res = mpdm_mod.mpdm_plan(self.lane_set, states, lane_ids,
                                     self.geom, self.ego_idx, self.p,
                                     self.cfg)
            behavior = int(res.behavior)
            valid = res.valid.cpu().numpy()
            if (self.hmi_behavior is not None
                    and valid[self.hmi_behavior]):
                behavior = self.hmi_behavior
            return BehaviorDecision(
                behavior=behavior,
                ref_lane_id=int(lanes3[behavior]),
                desired_vel=float(res.desired_vel),
                forward_traj=res.trajs[behavior].cpu().numpy(),
                valid=bool(valid[behavior]))

        if stamp is None:
            stamp = self._auto_stamp
            self._auto_stamp = stamp + 0.05
        ongoing = self.ongoing_lat_action(states, stamp)
        script = eudm_mod.dcp_action_script(self.cfg.tree_height, ongoing)
        res = eudm_mod.eudm_plan(self.lane_set, states, lane_ids, self.geom,
                                 self.ego_idx, self.p, self.cfg,
                                 script=script)
        # EUDM: the behaviour is the best leaf's first lateral switch
        # (relative to the ongoing root); the snapshot carries the winning
        # sequence into the next tick's context
        behavior = int(res.behavior)
        best = int(res.best_policy)
        winner_seq = res.action_script[best].cpu().numpy().astype(np.int32)
        valid_best = bool(res.valid[best])
        snap = EudmSnapshot(action_seq=winner_seq, stamp=float(stamp),
                            valid=valid_best, risky=bool(res.risky[best]))
        # commit a lane change the winner prescribes anywhere in its
        # sequence: the decided change is the lc context until completed
        lat_seq = winner_seq[:, 1]
        change = lat_seq[lat_seq != mpdm_mod.LK]
        if change.size and snap.valid:
            snap.lc_lat = int(change[0])
            snap.lc_target = int(lanes3[snap.lc_lat])
        self._snapshot = snap
        return BehaviorDecision(
            behavior=behavior,
            ref_lane_id=int(lanes3[behavior]),
            desired_vel=float(res.desired_vel),
            forward_traj=res.trajs[best].cpu().numpy(),
            valid=valid_best,
            ongoing_lat=ongoing)
