"""Urban closed-loop demo on the port: MPDM or EUDM behaviour -> SSC back
end -> multi-agent plant (the counterpart of examples/urban_demo.py).

A three-lane 600 m highway, IDM + pure-pursuit traffic agents on their own
lanes, and an ego driven by MPDM behaviour selection (or EUDM's DCP tree,
`--behavior eudm`) with the SSC planner as trajectory back end; one tick
per MPDM step (0.4 s). The same highway and agents as JAX's demo from the
same --seed. Runs on the card unless --device names another.

Run:  python examples/urban_demo_torch.py [--steps 80] [--agents 5]
          [--behavior mpdm|eudm] [--seed 0] [--device cuda] [--plot out.png]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dftpav_tpu_torch.ssc import bezier_eval, ssc_plan  # noqa: E402
from dftpav_tpu_torch.ssc.planner import SSCConfig, SSCResult  # noqa: E402
from dftpav_tpu_torch.urban import forward_sim as fsim  # noqa: E402
from dftpav_tpu_torch.urban import geometry  # noqa: E402
from dftpav_tpu_torch.urban import lane as lane_mod  # noqa: E402
from dftpav_tpu_torch.urban import eudm, mpdm, semantic_map  # noqa: E402


def build_highway(n_lanes=3, length=600.0, lane_width=3.5, device="cuda",
                  dtype=torch.float32):
    lanes = []
    for i in range(n_lanes):
        wps = np.stack([np.linspace(0, length, 31),
                        i * lane_width * np.ones(31)], 1)
        lanes.append(lane_mod.build_lane(wps, ds=1.0, P=1024, dtype=dtype,
                                         device=device))
    left = [i + 1 if i + 1 < n_lanes else -1 for i in range(n_lanes)]
    right = [i - 1 if i - 1 >= 0 else -1 for i in range(n_lanes)]
    return lane_mod.build_lane_set(lanes, left, right)


def spawn_agents(rng, n_agents, n_lanes, lane_width=3.5):
    """Ego at the origin of lane 0 plus slower traffic ahead ([A, 6])."""
    states = [np.array([0.0, 0.0, 0.0, 8.0, 0.0, 0.0])]
    # a slow car on the ego lane forces an interactive overtake
    states.append(np.array([30.0, 0.0, 0.0, 2.0, 0.0, 0.0]))
    for i in range(n_agents - 1):
        lane = int(rng.integers(0, n_lanes))
        s = 50.0 + 60.0 * i / max(n_agents - 2, 1) + rng.uniform(-8, 8)
        v = rng.uniform(2.0, 5.0)
        states.append(np.array([s, lane * lane_width, 0.0, v, 0.0, 0.0]))
    return np.stack(states)


class World(NamedTuple):
    lane_set: lane_mod.LaneSet
    states: torch.Tensor          # [A, 6] initial states
    geom: fsim.AgentGeom
    p: fsim.SimParam
    cfg_mpdm: mpdm.MPDMConfig
    cfg_eudm: eudm.EUDMConfig | None  # None: MPDM decides
    cfg_ssc: SSCConfig
    times: np.ndarray             # [T+1] forward-sim stamps
    dt_plan: float


def setup(seed=0, agents=5, device="cuda", dtype=torch.float32,
          behavior="mpdm") -> World:
    rng = np.random.default_rng(seed)
    states = torch.as_tensor(spawn_agents(rng, agents, n_lanes=3),
                             device=device).to(dtype)
    ones = torch.ones(states.shape[0], dtype=dtype, device=device)
    geom = fsim.AgentGeom(length=4.88 * ones, width=1.9 * ones,
                          d_cr=1.015 * ones, wheel_base=2.85 * ones)
    cfg_mpdm = mpdm.MPDMConfig(desired_velocity=8.0)
    # EUDM's tree on the same 0.4 s steps (5 layers of 0.8 s: 10 steps, the
    # MPDM horizon), as JAX's demo configures it
    cfg_eudm = eudm.EUDMConfig(desired_velocity=8.0, step=0.4,
                               tree_height=5, layer_time=0.8) \
        if behavior == "eudm" else None
    # the tick matches the MPDM sim resolution so the SSC-infeasible
    # fallback (one forward-sim state) advances exactly one tick
    return World(lane_set=build_highway(device=device, dtype=dtype),
                 states=states, geom=geom, p=fsim.SimParam(),
                 cfg_mpdm=cfg_mpdm, cfg_eudm=cfg_eudm,
                 cfg_ssc=SSCConfig(M=5),
                 times=np.linspace(0.0, cfg_mpdm.sim_horizon,
                                   cfg_mpdm.n_steps + 1),
                 dt_plan=cfg_mpdm.sim_resolution)


def _mark(device):
    """A time mark: a CUDA event on the card, the host clock elsewhere."""
    if torch.device(device).type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
        else (b - a) * 1e3


class Tick(NamedTuple):
    states: torch.Tensor          # [A, 6] after the tick
    dec: mpdm.MPDMResult
    ssc: SSCResult
    marks: tuple                  # start, after the planner, after SSC, end


def _eudm_decision(w: World, states, lane_ids) -> mpdm.MPDMResult:
    """EUDM's decision in MPDM's form, as JAX's demo builds it: the first
    three scores and flags, the best policy's trajectory three times, the
    reference lane of EUDM's behaviour, and behaviour 0 (the trajectory
    row to follow), so that the logged behaviour never changes."""
    eres = eudm.eudm_plan(w.lane_set, states, lane_ids, w.geom, 0, w.p,
                          w.cfg_eudm)
    lanes3 = mpdm.behavior_lane_ids(w.lane_set, lane_ids[0])
    best = eres.trajs[eres.best_policy]
    return mpdm.MPDMResult(
        behavior=torch.zeros_like(eres.behavior),
        desired_vel=eres.desired_vel, scores=eres.scores[:3],
        valid=eres.valid[:3], trajs=best[None].expand((3,) + best.shape),
        ref_lane_id=lanes3[eres.behavior])


def tick(w: World, states) -> Tick:
    """One planning tick: lane association and the behaviour planner (MPDM,
    or EUDM where the world has its config), the SSC plan of the chosen
    behaviour, the ego set to the SSC spline's state one tick ahead (the
    planner's forward state where the corridor is infeasible), and the
    traffic agents one IDM + pure-pursuit step on their own lanes."""
    dev = states.device
    m0 = _mark(dev)
    lane_ids = torch.clamp(semantic_map.associate_lanes(w.lane_set, states),
                           min=0)
    if w.cfg_eudm is not None:
        dec = _eudm_decision(w, states, lane_ids)
    else:
        dec = mpdm.mpdm_plan(w.lane_set, states, lane_ids, w.geom, 0, w.p,
                             w.cfg_mpdm)
    m1 = _mark(dev)
    ego_traj = dec.trajs[dec.behavior]                   # [T+1, A, 6]
    ref_lane = mpdm._gather_lane(w.lane_set, dec.ref_lane_id)
    A = states.shape[0]
    res = ssc_plan(ref_lane, states[0], ego_traj[:, 0], w.times,
                   ego_traj[:, 1:].transpose(0, 1),
                   torch.ones(A - 1, dtype=torch.bool, device=dev),
                   w.geom.length[1:] / 2, w.geom.width[1:] / 2, w.cfg_ssc)
    m2 = _mark(dev)

    # ego control from the SSC spline: desired state a tick ahead
    t_next = torch.tensor([min(w.dt_plan, w.times[-1])], dtype=states.dtype,
                          device=dev)
    pos_sd, vel_sd, _ = bezier_eval(res.spline, t_next)
    pos_w, heading_w = lane_mod.state_of_frenet(ref_lane, pos_sd[0, 0:1],
                                                pos_sd[0, 1:2])
    v_des = lane_mod._norm(vel_sd[0])
    ego_next = torch.where(
        res.feasible,
        torch.cat([pos_w[0], heading_w[0:1], v_des[None], states[0, 4:6]]),
        ego_traj[1, 0])

    # traffic agents: IDM + pure pursuit on their own lanes
    lanes = mpdm._gather_lane(w.lane_set, lane_ids)
    desired = torch.clamp(states[:, fsim.V], 2.0, 8.0)
    agents = fsim.multi_agent_step(lanes, states, w.geom, desired, w.p,
                                   w.dt_plan)
    nxt = torch.cat([ego_next[None], agents[1:]])
    return Tick(states=nxt, dec=dec, ssc=res, marks=(m0, m1, m2, _mark(dev)))


def run(steps=80, seed=0, agents=5, device="cuda", dtype=torch.float32,
        behavior="mpdm"):
    """The closed loop for `steps` ticks -> a summary dict: collisions,
    v_ego mean / max, lane changes (changes of the chosen behaviour, as JAX's
    demo counts them; always 0 with EUDM, whose logged behaviour is the
    trajectory row 0), SSC feasible share, wall seconds, per-tick ms of the
    behaviour planner, SSC and the whole tick (CUDA events on the card), and
    the logs."""
    w = setup(seed, agents, device, dtype, behavior)
    states = w.states
    pa = (w.geom.length[0], w.geom.width[0], w.geom.d_cr[0])
    log_states, rows, marks = [], [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        out = tick(w, states)
        states = out.states
        hits = geometry.vehicles_collide(states[0], states[1:], pa, pa)
        rows.append(torch.stack([hits.sum().to(states.dtype),
                                 out.dec.behavior.to(states.dtype),
                                 states[0, fsim.V],
                                 out.ssc.feasible.to(states.dtype)]))
        log_states.append(states)
        marks.append(out.marks)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = torch.stack(rows).cpu().double().numpy()
    beh = rows[:, 1].astype(int)
    ms = np.array([[_ms(m[0], m[1]), _ms(m[1], m[2]), _ms(m[0], m[3])]
                   for m in marks])
    return dict(steps=steps, collisions=int(rows[:, 0].sum()),
                v_mean=float(rows[:, 2].mean()),
                v_max=float(rows[:, 2].max()),
                lane_changes=int((np.diff(beh) != 0).sum()),
                ssc_feasible=float(rows[:, 3].mean()), wall_s=wall,
                ms_behavior=ms[:, 0], ms_ssc=ms[:, 1], ms_tick=ms[:, 2],
                behavior=beh,
                states=torch.stack(log_states).cpu().double().numpy())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--behavior", choices=["mpdm", "eudm"], default="mpdm")
    ap.add_argument("--agents", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plot", type=str, default="")
    args = ap.parse_args(argv)

    r = run(args.steps, args.seed, args.agents, args.device,
            behavior=args.behavior)
    print(f"steps={args.steps} wall={r['wall_s']:.1f}s "
          f"collisions={r['collisions']} v_ego mean={r['v_mean']:.2f} "
          f"max={r['v_max']:.2f} lane_changes={r['lane_changes']} "
          f"ssc_feasible={r['ssc_feasible']:.2f} "
          f"ms/tick p50 {args.behavior}={np.median(r['ms_behavior']):.1f} "
          f"ssc={np.median(r['ms_ssc']):.1f} "
          f"tick={np.median(r['ms_tick']):.1f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(14, 4))
        traj = r["states"]                          # [T, A, 6]
        for a in range(traj.shape[1]):
            ax.plot(traj[:, a, 0], traj[:, a, 1],
                    color="tab:red" if a == 0 else "tab:gray",
                    lw=2 if a == 0 else 1)
        for y in (-1.75, 1.75, 5.25, 8.75):
            ax.axhline(y, color="k", lw=0.5, ls="--")
        ax.set_aspect("equal")
        fig.savefig(args.plot, dpi=110, bbox_inches="tight")
        print("saved", args.plot)

    return r["collisions"], r["v_mean"]


if __name__ == "__main__":
    main(sys.argv[1:])
