"""World-time-stamped executing trajectories.

Equivalent of plan_utils::TrajContainer/LocalTrajData/SingulTrajData
(traj_container.hpp:36-81): the optimizer returns per-segment normalized
coefficients; this wraps them with wall-clock start/end times so the control
loop can sample the executing trajectory at 100 Hz and the replanner can seed
from state at (now + budget). Numpy on the host: the control loop samples it
every 10 ms, and a device round trip per sample would cost more than the
evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _eval_states_np(coeffs, dT, singul, wheel_base, t):
    """Flatness-map evaluation in numpy (the host control loop). Mirrors
    minco.eval_segment_states / Trajectory::GetState
    (poly_traj_utils.hpp:378-406)."""
    coeffs = np.asarray(coeffs)
    N = coeffs.shape[0]
    total = dT * N
    tc = np.clip(t, 0.0, total)
    idx = np.clip((tc / dT).astype(int), 0, N - 1)
    tau = tc / dT - idx
    b = coeffs[idx]                       # [..., 6, 2]
    k = np.arange(6)
    powers = tau[..., None] ** k
    d1 = np.where(k >= 1, k * tau[..., None] ** np.maximum(k - 1, 0), 0.0)
    d2c = k * np.maximum(k - 1, 0)
    d2 = np.where(k >= 2, d2c * tau[..., None] ** np.maximum(k - 2, 0), 0.0)
    pos = np.einsum("...k,...kd->...d", powers, b)
    dsig = np.einsum("...k,...kd->...d", d1, b) / dT
    ddsig = np.einsum("...k,...kd->...d", d2, b) / (dT * dT)
    sg = float(singul)
    vn = np.linalg.norm(dsig, axis=-1)
    theta = np.arctan2(sg * dsig[..., 1], sg * dsig[..., 0])
    v = sg * vn
    safe = vn >= 1e-6
    vn_s = np.where(safe, vn, 1.0)
    cross = dsig[..., 0] * ddsig[..., 1] - dsig[..., 1] * ddsig[..., 0]
    dot = np.sum(dsig * ddsig, axis=-1)
    kappa = np.where(safe, sg * cross / vn_s**3, 0.0)
    a_lon = np.where(safe, sg * dot / vn_s, 0.0)
    steer = np.arctan(wheel_base * kappa)
    return dict(pos=pos, dsigma=dsig, ddsigma=ddsig, theta=theta, vel=v,
                acc=a_lon, curv=kappa, steer=steer)


@dataclass
class LocalTraj:
    """One single-gear polynomial trajectory with world-time stamps."""

    coeffs: np.ndarray    # [N, 6, 2] normalized-time coefficients
    dT: float             # per-piece duration
    singul: int
    start_time: float
    end_time: float

    @property
    def duration(self) -> float:
        return self.coeffs.shape[0] * self.dT

    def state(self, world_t: float, wheel_base: float) -> dict:
        t = np.clip(world_t - self.start_time, 0.0, self.duration)
        return _eval_states_np(self.coeffs, self.dT, self.singul, wheel_base,
                               np.asarray(t))


@dataclass
class TrajContainer:
    """The executing multi-gear trajectory (reference: addSingulTraj,
    traj_container.hpp:59-81)."""

    segments: list = field(default_factory=list)

    def clear(self):
        self.segments = []

    def add(self, coeffs, dT, singul, start_time):
        dur = coeffs.shape[0] * float(dT)
        self.segments.append(LocalTraj(
            coeffs=np.asarray(coeffs), dT=float(dT), singul=int(singul),
            start_time=start_time, end_time=start_time + dur))

    def set_from_solve(self, res, singuls, seg_mask, start_time):
        """Replace contents from one lane of a SolveResult (host arrays)."""
        self.clear()
        t = start_time
        for i in range(len(seg_mask)):
            if not seg_mask[i]:
                continue
            self.add(np.asarray(res.coeffs[i]), float(res.dT[i]),
                     int(singuls[i]), t)
            t = self.segments[-1].end_time

    @property
    def start_time(self):
        return self.segments[0].start_time if self.segments else None

    @property
    def end_time(self):
        return self.segments[-1].end_time if self.segments else None

    def locate(self, world_t: float) -> LocalTraj | None:
        """Active segment at world_t (traj_server_ros.cpp:248-254)."""
        if not self.segments:
            return None
        for seg in self.segments:
            if world_t < seg.end_time:
                return seg
        return self.segments[-1]

    def state(self, world_t: float, wheel_base: float) -> dict | None:
        seg = self.locate(world_t)
        if seg is None:
            return None
        out = seg.state(world_t, wheel_base)
        out["singul"] = seg.singul
        return out
