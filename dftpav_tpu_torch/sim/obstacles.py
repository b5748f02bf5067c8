"""Moving obstacles and surround-trajectory fitting.

The parking scene's moving cars (constant-speed circular motion publishing
30 s predicted trajectories, parking_moving_obstacles.cc:42-100,
cfg/dynamicObs.yaml: 4 cars, v=4.5, r=12) and
TrajPlanner::ConverSurroundTrajFromPoints (traj_manager.cpp:743-789), which
MINCO-fits the predicted states into the piecewise quintics the
dynamic-obstacle penalty reads. Pure numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dftpav_tpu_torch import minco
from dftpav_tpu_torch.types import Dims


@dataclass
class CircularMover:
    """Constant-speed circular motion (parking_moving_obstacles.cc:42-57)."""

    center: tuple
    radius: float = 12.0
    speed: float = 4.5
    phase: float = 0.0
    ccw: bool = True

    def state(self, t: float):
        """(x, y, yaw, v) at time t."""
        w = (1.0 if self.ccw else -1.0) * self.speed / self.radius
        a = self.phase + w * t
        x = self.center[0] + self.radius * np.cos(a)
        y = self.center[1] + self.radius * np.sin(a)
        yaw = a + (np.pi / 2 if self.ccw else -np.pi / 2)
        return np.array([x, y, yaw, self.speed])

    def predict(self, t0: float, horizon: float = 30.0, dt: float = 1.0):
        """Predicted states [(x, y, yaw, v, t_abs)] every dt over the
        horizon, like the obstacle node's marker trajectories."""
        ts = np.arange(0.0, horizon + 1e-9, dt)
        return np.array([np.concatenate([self.state(t0 + t), [t0 + t]])
                         for t in ts])


def fit_surround_traj(states: np.ndarray, n_pieces: int):
    """MINCO fit of one obstacle's predicted states [M, 5] (x, y, yaw, v,
    t_abs), t increasing: resampled to n_pieces + 1 waypoints at uniform
    times (linear between states), solved as a minimum-jerk spline of
    uniform piece duration (traj_manager.cpp:772-775). Returns
    (coef [n_pieces, 6, 2], dt, start_time)."""
    t = states[:, 4]
    total = t[-1] - t[0]
    dt = total / n_pieces
    tw = t[0] + dt * np.arange(n_pieces + 1)
    xs = np.interp(tw, t, states[:, 0])
    ys = np.interp(tw, t, states[:, 1])
    inner = np.stack([xs[1:-1], ys[1:-1]], axis=-1)

    def flat(i):
        yaw, v = states[i, 2], states[i, 3]
        return np.stack([
            states[i, 0:2],
            v * np.array([np.cos(yaw), np.sin(yaw)]),
            np.zeros(2)], axis=1)

    head, tail = flat(0), flat(-1)
    Mh, Mi, Mt = minco.minco_maps(n_pieces)
    scale = np.array([1.0, dt, dt * dt])
    b = (Mh @ (head.T * scale[:, None]) + Mi @ inner
         + Mt @ (tail.T * scale[:, None]))
    return b.reshape(n_pieces, 6, 2), dt, t[0]


def fit_surround_trajs(movers, t_now: float, dims: Dims, horizon=None,
                       pred_dt=1.0, dtype=np.float32):
    """A Scenario's obstacle block from movers (anything with .predict).
    The horizon defaults to Po * pred_dt, so each quintic piece spans one
    prediction sample (the reference's pieceNum = len(points) - 1,
    traj_manager.cpp:757); past it the cost extrapolates with constant
    acceleration."""
    O, Po = dims.O, dims.Po
    if horizon is None:
        horizon = Po * pred_dt
    obs_coef = np.zeros((O, Po, 6, 2), dtype)
    obs_dt = np.ones((O,), dtype)
    obs_rel_t0 = np.zeros((O,), dtype)
    obs_mask = np.zeros((O,), bool)
    for i, mv in enumerate(movers[:O]):
        pred = mv.predict(t_now, horizon, pred_dt)
        coef, dt, t0 = fit_surround_traj(pred, Po)
        obs_coef[i] = coef
        obs_dt[i] = dt
        obs_rel_t0[i] = t_now - t0
        obs_mask[i] = True
    return dict(obs_coef=obs_coef, obs_dt=obs_dt, obs_rel_t0=obs_rel_t0,
                obs_mask=obs_mask)
