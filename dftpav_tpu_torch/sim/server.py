"""Closed-loop planner server and simulation loop.

Equivalent of plan_utils::TrajPlannerServer (traj_server_ros.cpp) plus the
phy_simulator main loop: a 20 Hz replan cycle with latency-hiding seeding
(plan for the state budget seconds ahead, traj_server_ros.cpp:406-501), a
100 Hz control stream sampled from the executing trajectory, and a 500 Hz
bicycle plant, all on sim time, in one process, without ROS. The front end
and the executing trajectory live on the host (numpy); each replan is one
solve at B = 1 through solver.make_solver on the server's device, and the
plant steps on the loop's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dftpav_tpu_torch import solver
from dftpav_tpu_torch.config import PlannerConfig
from dftpav_tpu_torch.container import TrajContainer
from dftpav_tpu_torch.pipeline import ParkingPlanner
from dftpav_tpu_torch.sim.obstacles import fit_surround_trajs
from dftpav_tpu_torch.sim.vehicle import BicycleModel, tracking_control
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config


class PlannerServer:
    """Replan orchestration with the reference's CheckReplan and seeding
    rules. Solves run on `device` (the card unless the caller names
    another) through make_solver's default engine, "fused" (kernels A and
    B on the card); `replans` records each replan's class, outcome, solver
    calls and host seconds of the front end and of the solve (up to its
    result on the host).

    Beyond the JAX package's server: a failed solve is re-solved with its
    initial durations scaled by 1.6, then 0.7 (solver.solve_with_retry).
    JAX's server solves with its bminor engine, which reaches the
    reverse_park playground's first plan from the front end's durations;
    the fused engine's objective (and JAX's own round loop) stalls there
    in float32 and succeeds from 1.6x those durations, so without the
    ladder the same failing plan would repeat at every replan."""

    def __init__(self, pipeline: ParkingPlanner, goal, budget: float = 0.5,
                 max_iterations: int = 300, movers=None, device="cuda"):
        self.pp = pipeline
        self.cfg: PlannerConfig = pipeline.cfg
        self.dims: Dims = pipeline.dims
        self.goal = np.asarray(goal, float)  # (x, y, yaw, v)
        self.budget = budget
        self.container = TrajContainer()
        self.movers = movers or []
        self.device = torch.device(device)
        self._dtype = torch.from_numpy(np.zeros(0, pipeline.dtype)).dtype
        self._w = weights_from_config(self.cfg.opt, self._dtype,
                                      device=self.device)
        self._max_iterations = max_iterations
        self._solvers: dict = {}
        self._state_hist: list = []
        self.n_replans = 0
        self.n_failures = 0
        self.replans: list = []

    # -- CheckReplan (traj_server_ros.cpp:359-402) --
    def check_replan(self, t_now: float, ego_state=None) -> bool:
        c = self.container
        if not c.segments:
            return True
        # ego-aware recovery (beyond the reference, which assumes perfect
        # tracking): executing trajectory exhausted but the plant is still
        # far from the goal -> replan from the ego state
        if ego_state is not None and t_now > c.end_time:
            err = np.hypot(ego_state[0] - self.goal[0],
                           ego_state[1] - self.goal[1])
            dth = abs(np.arctan2(np.sin(ego_state[2] - self.goal[2]),
                                 np.cos(ego_state[2] - self.goal[2])))
            if err > 0.15 or dth > 0.1:
                return True
        total = sum(s.duration for s in c.segments)
        cur = c.locate(t_now)
        is_close_turn = False
        if cur is not c.segments[-1] and (cur.end_time - t_now) < 2.5:
            is_close_turn = True
        is_near = (c.end_time - t_now) < 2.0 * total / 3.0
        end_pos = c.segments[-1].state(c.end_time, 1.0)["pos"]
        target_moved = np.linalg.norm(end_pos - self.goal[:2]) > 0.1
        if is_near and not is_close_turn and target_moved:
            return True
        # collision sweep at 0.05 s
        vp = self.cfg.vehicle
        for seg in c.segments:
            ts = np.arange(max(seg.start_time, t_now), seg.end_time, 0.05)
            if len(ts) == 0:
                continue
            st = seg.state(ts, vp.wheel_base)
            for (x, y), th in zip(st["pos"], st["theta"]):
                if self.pp.grid.obb_collides(x, y, float(th), vp.length,
                                             vp.width, vp.d_cr):
                    return True
        return False

    def _filter_singularity(self, state: dict, t: float) -> dict:
        """Near-zero speed keeps the previous heading
        (FilterSingularityState, traj_server_ros.cpp:335-356)."""
        if not self._state_hist:
            return state
        t_prev, th_prev = self._state_hist[-1]
        duration = max(t - t_prev, 1e-6)
        singular_velocity = 1e-1
        max_rate = np.tan(np.pi / 4) / self.cfg.vehicle.wheel_base \
            * singular_velocity
        dth = np.arctan2(np.sin(state["theta"] - th_prev),
                         np.cos(state["theta"] - th_prev))
        if abs(state["vel"]) < singular_velocity and \
                abs(dth) > max_rate * duration:
            state = dict(state)
            state["theta"] = th_prev
        return state

    def replan(self, t_now: float, ego_state) -> bool:
        """One replan attempt; swaps the executing trajectory on success.

        ego_state: [x, y, theta, steer, v] plant state (used only when no
        trajectory is executing; otherwise seeds from the executing traj at
        t_now + budget, hiding solve latency like the reference).
        """
        self.n_replans += 1
        vp = self.cfg.vehicle
        t_seed = t_now + self.budget
        c = self.container
        if not c.segments or t_seed >= c.end_time:
            # no trajectory (or it ends before the seed time): seed from the
            # plant state instead of the executing trajectory
            self.container.clear()
        if not self.container.segments:
            start = (float(ego_state[0]), float(ego_state[1]),
                     float(ego_state[2]), float(ego_state[4]))
        else:
            st = self.container.state(t_seed, vp.wheel_base)
            st = self._filter_singularity(
                {k: (float(v) if np.ndim(v) == 0 else v)
                 for k, v in st.items() if k != "singul"} | {
                     "theta": float(st["theta"])}, t_seed)
            self._state_hist.append((t_seed, st["theta"]))
            if len(self._state_hist) > 100:
                self._state_hist.pop(0)
            start = (float(st["pos"][0]), float(st["pos"][1]),
                     float(st["theta"]), float(st["vel"]))

        t0 = time.perf_counter()
        scen, meta = self.pp.plan_scenario(start, tuple(self.goal))
        frontend_s = time.perf_counter() - t0
        if scen is None:
            self.n_failures += 1
            self.last_failure = ("frontend", start)
            self.replans.append(dict(dims=None, ok=False, solves=0,
                                     frontend_s=frontend_s, solve_s=None))
            return False
        dims = meta.dims or self.dims
        if self.movers:
            obs = fit_surround_trajs(self.movers, t_seed, dims,
                                     dtype=self.pp.dtype)
            scen = scen._replace(**obs)

        if dims not in self._solvers:
            self._solvers[dims] = solver.make_solver(
                self.cfg, dims, max_iterations=self._max_iterations)
        t0 = time.perf_counter()
        batch = from_numpy([np.asarray(a)[None] for a in scen], Scenario,
                           device=self.device, dtype=self._dtype)
        solves = []

        def solve(b, w):
            solves.append(1)
            return self._solvers[dims](b, w)

        res = solver.solve_with_retry(solve, batch, self._w, pad_to=1)
        res0 = [a[0].cpu().numpy() for a in res]
        solve_s = time.perf_counter() - t0
        coeffs, dT, cost, _n_iters, status, success = res0
        self.replans.append(dict(dims=dims, ok=bool(success),
                                 solves=len(solves), cost=float(cost),
                                 frontend_s=frontend_s, solve_s=solve_s))
        if not success:
            self.n_failures += 1
            self.last_failure = ("solver", start, int(status), float(cost))
            return False
        self.container.set_from_solve(
            type(res)(*res0), np.asarray(scen.singul),
            np.asarray(scen.seg_mask), t_seed)
        return True

    def desired_state(self, t_now: float):
        vp = self.cfg.vehicle
        if not self.container.segments or t_now < self.container.start_time:
            return None
        st = self.container.state(t_now, vp.wheel_base)
        return {k: (np.asarray(v) if k != "singul" else v)
                for k, v in st.items()}


@dataclass
class SimLog:
    t: list = field(default_factory=list)
    ego: list = field(default_factory=list)
    desired: list = field(default_factory=list)
    replans: int = 0


class SimLoop:
    """Closed-loop driver: plant at phys_dt, control at ctrl_dt, replans at
    replan_dt (rates per BASELINE.md: 500 / 100 / 20 Hz). The plant's state
    is float32 on `device` (the card unless the caller names another)."""

    def __init__(self, server: PlannerServer, ego0,
                 phys_dt=0.002, ctrl_dt=0.01, replan_dt=0.05, device="cuda"):
        self.server = server
        vpcfg = server.cfg.vehicle
        self.model = BicycleModel(wheel_base=vpcfg.wheel_base,
                                  max_steer=vpcfg.max_steering_angle,
                                  device=device)
        self.phys_dt = phys_dt
        self.ctrl_dt = ctrl_dt
        self.replan_dt = replan_dt
        self.stepper = self.model.make_stepper(
            ctrl_dt, substeps=max(1, int(round(ctrl_dt / phys_dt))))
        self.ego = torch.tensor(np.asarray(ego0, np.float32),
                                device=self.model.device)
        self.t = 0.0

    def run(self, duration: float, goal_tol=0.15) -> SimLog:
        log = SimLog()
        u = np.zeros(2, np.float32)
        next_replan = 0.0
        goal = self.server.goal
        while self.t < duration:
            ego_np = self.ego.cpu().numpy()
            if self.t >= next_replan:
                if self.server.check_replan(self.t, ego_np):
                    self.server.replan(self.t, ego_np)
                    log.replans += 1
                next_replan = self.t + self.replan_dt
            des = self.server.desired_state(self.t)
            if des is not None:
                u = tracking_control(ego_np, des,
                                     self.server.cfg.vehicle.wheel_base)
            else:
                u = np.array([0.0, -4.0 * ego_np[4]])  # hold still
            self.ego = self.stepper(self.ego, np.asarray(u, np.float32))
            self.t += self.ctrl_dt
            log.t.append(self.t)
            log.ego.append(ego_np)
            log.desired.append(None if des is None else des["pos"])
            err = np.hypot(ego_np[0] - goal[0], ego_np[1] - goal[1])
            dth = abs(np.arctan2(np.sin(ego_np[2] - goal[2]),
                                 np.cos(ego_np[2] - goal[2])))
            if err < goal_tol and dth < 0.1 and abs(ego_np[4]) < 0.05:
                break
        return log
