"""Lanes and Frenet-frame transforms (the port of `dftpav_tpu/urban/lane.py`).

A lane IS its uniform arc-length sampling: tensors ``xy [P, 2]``, unit
``tangent [P, 2]``, ``curvature [P]`` with spacing ``ds`` and a validity
count ``n_valid`` (the reference's common::Lane spline, sampled; see the JAX
module for the sources). Every query is a gather plus linear interpolation.

Batch-first: every field of a ``Lane`` may carry leading batch dims, and the
queries broadcast the lane's batch dims against the points' batch dims
(numpy rules, right-aligned). To project K points per lane, append a unit
batch dim to the lane with ``lane_unsqueeze``.

The host construction (`build_lane`, a centripetal Catmull-Rom fit resampled
in arc length) is the JAX module's numpy code, copied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Lane(NamedTuple):
    """Uniform arc-length sampled lane (fields may carry batch dims).

    Positions beyond ``n_valid`` points repeat the last valid sample. A
    closed (ring) lane wraps arc-length queries modulo its length.
    """

    xy: torch.Tensor         # [..., P, 2]
    tangent: torch.Tensor    # [..., P, 2] unit tangents
    curvature: torch.Tensor  # [..., P]
    ds: torch.Tensor         # [...] sample spacing (m)
    n_valid: torch.Tensor    # [...] int64, number of real samples (<= P)
    closed: torch.Tensor     # [...] bool

    @property
    def length(self) -> torch.Tensor:
        return (self.n_valid.to(self.xy.dtype) - 1.0) * self.ds


# trailing (per-lane) dims of each Lane field
_FEATURE_DIMS = (2, 2, 1, 0, 0, 0)


class LaneSet(NamedTuple):
    """A lane net: L stacked lanes + left/right adjacency (-1 = none)."""

    lanes: Lane              # Lane with leading [L] axis on every field
    left_id: torch.Tensor    # [L] int64 index of left neighbor, -1 if none
    right_id: torch.Tensor   # [L] int64

    @property
    def n_lanes(self) -> int:
        return self.lanes.xy.shape[0]

    def lane(self, i) -> Lane:
        return Lane(*(f[i] for f in self.lanes))


def lane_unsqueeze(lane: Lane, n: int = 1) -> Lane:
    """The lane with n unit batch dims appended, so that it broadcasts over
    n trailing point dims."""
    def one(f, k):
        cut = f.dim() - k
        return f.reshape(f.shape[:cut] + (1,) * n + f.shape[cut:])
    return Lane(*(one(f, k) for f, k in zip(lane, _FEATURE_DIMS)))


# ---------------------------------------------------------------------------
# Host-side construction (numpy, as in the JAX module)
# ---------------------------------------------------------------------------

def _catmull_rom(points: np.ndarray, samples_per_seg: int = 32) -> np.ndarray:
    """Centripetal Catmull-Rom densification of a waypoint polyline."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) < 2:
        raise ValueError("need at least 2 waypoints")
    if len(pts) == 2:
        t = np.linspace(0.0, 1.0, samples_per_seg)[:, None]
        return pts[0] * (1 - t) + pts[1] * t
    # pad endpoints by reflection
    ext = np.vstack([2 * pts[0] - pts[1], pts, 2 * pts[-1] - pts[-2]])
    out = []
    for i in range(len(pts) - 1):
        p0, p1, p2, p3 = ext[i], ext[i + 1], ext[i + 2], ext[i + 3]

        def tj(ti, pa, pb):
            return ti + max(np.sqrt(np.linalg.norm(pb - pa)), 1e-9)

        t0 = 0.0
        t1 = tj(t0, p0, p1)
        t2 = tj(t1, p1, p2)
        t3 = tj(t2, p2, p3)
        t = np.linspace(t1, t2, samples_per_seg, endpoint=False)[:, None]
        a1 = (t1 - t) / (t1 - t0) * p0 + (t - t0) / (t1 - t0) * p1
        a2 = (t2 - t) / (t2 - t1) * p1 + (t - t1) / (t2 - t1) * p2
        a3 = (t3 - t) / (t3 - t2) * p2 + (t - t2) / (t3 - t2) * p3
        b1 = (t2 - t) / (t2 - t0) * a1 + (t - t0) / (t2 - t0) * a2
        b2 = (t3 - t) / (t3 - t1) * a2 + (t - t1) / (t3 - t1) * a3
        c = (t2 - t) / (t2 - t1) * b1 + (t - t1) / (t2 - t1) * b2
        out.append(c)
    out.append(pts[-1:])
    return np.vstack(out)


def build_lane(waypoints, ds: float = 0.5, P: int = 512,
               dtype=torch.float32, closed: bool = False,
               device="cuda") -> Lane:
    """Fit + uniformly resample a lane from sparse waypoints (host, numpy),
    then put it on `device` (the card unless the caller names another;
    without a card the default raises). `closed=True` marks a ring lane."""
    wp = np.asarray(waypoints, dtype=np.float64)
    dense = _catmull_rom(wp)
    seg = np.linalg.norm(np.diff(dense, axis=0), axis=1)
    keep = np.concatenate([[True], seg > 1e-12])
    dense = dense[keep]
    seg = np.linalg.norm(np.diff(dense, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(s[-1])
    n = min(P, max(2, int(np.floor(total / ds)) + 1))
    su = np.arange(n) * ds
    x = np.interp(su, s, dense[:, 0])
    y = np.interp(su, s, dense[:, 1])
    xy = np.stack([x, y], axis=1)

    grad = np.gradient(xy, ds, axis=0)
    speed = np.maximum(np.linalg.norm(grad, axis=1), 1e-9)
    tan = grad / speed[:, None]
    # curvature = d(theta)/ds from unit tangents
    theta = np.unwrap(np.arctan2(tan[:, 1], tan[:, 0]))
    kappa = np.gradient(theta, ds)

    pad = P - n
    if pad > 0:
        xy = np.vstack([xy, np.repeat(xy[-1:], pad, axis=0)])
        tan = np.vstack([tan, np.repeat(tan[-1:], pad, axis=0)])
        kappa = np.concatenate([kappa, np.repeat(kappa[-1:], pad)])
    return _lane_from_numpy(xy, tan, kappa, ds, n, bool(closed), device,
                            dtype)


def _lane_from_numpy(xy, tangent, curvature, ds, n_valid, closed, device,
                     dtype) -> Lane:
    def f(a):
        return torch.as_tensor(np.array(a, np.float64), device=device).to(
            dtype)
    return Lane(xy=f(xy), tangent=f(tangent), curvature=f(curvature),
                ds=f(ds),
                n_valid=torch.as_tensor(np.array(n_valid, np.int64),
                                        device=device),
                closed=torch.as_tensor(np.array(closed, bool),
                                       device=device))


def build_lane_set(lanes: list[Lane], left_ids, right_ids) -> LaneSet:
    stacked = Lane(*(torch.stack([getattr(ln, f) for ln in lanes])
                     for f in Lane._fields))
    dev = stacked.xy.device
    return LaneSet(lanes=stacked,
                   left_id=torch.as_tensor(left_ids, dtype=torch.int64,
                                           device=dev),
                   right_id=torch.as_tensor(right_ids, dtype=torch.int64,
                                            device=dev))


def lane_set_from_numpy(lanes, left_id, right_id, device="cuda",
                        dtype=torch.float32) -> LaneSet:
    """The port's LaneSet from a JAX LaneSet's fields as numpy arrays:
    `lanes` the six Lane fields in order ([L, ...] each), `left_id` and
    `right_id` [L]. On the card unless `device` says otherwise."""
    return LaneSet(
        lanes=_lane_from_numpy(*lanes, device=device, dtype=dtype),
        left_id=torch.as_tensor(np.array(left_id, np.int64),
                                device=device),
        right_id=torch.as_tensor(np.array(right_id, np.int64),
                                 device=device))


# ---------------------------------------------------------------------------
# Device queries (clamped; linear interpolation between samples)
# ---------------------------------------------------------------------------

def _at(f, i, nf: int):
    """f [*L, P, *F] (nf feature dims F) at sample index i [*I]
    -> [*broadcast(L, I), *F]."""
    cut = f.dim() - 1 - nf
    lead = torch.broadcast_shapes(f.shape[:cut], i.shape)
    feat = f.shape[cut + 1:]
    f = f.expand(lead + f.shape[cut:])
    idx = i.expand(lead).reshape(lead + (1,) * (1 + nf)).expand(
        lead + (1,) + feat)
    return torch.gather(f, len(lead), idx).squeeze(len(lead))


def _norm(v, keepdim=False):
    """Euclidean norm over the last axis, as sqrt(sum(v * v))."""
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def _interp_idx(lane: Lane, s):
    smax = lane.length
    # closed lanes wrap (s mod length); open lanes clamp at the ends
    s_wrap = s - torch.floor(s / torch.clamp(smax, min=1e-6)) * smax
    s = torch.where(lane.closed, s_wrap,
                    torch.minimum(torch.clamp(s, min=0.0), smax))
    f = s / lane.ds
    i0 = torch.minimum(torch.clamp(torch.floor(f).long(), min=0),
                       lane.n_valid - 2)
    w = f - i0.to(f.dtype)
    return i0, w


def lane_point(lane: Lane, s):
    """(xy, unit tangent, curvature) at arc length s (clamped to the lane)."""
    i0, w = _interp_idx(lane, s)
    w1 = w[..., None]
    xy = _at(lane.xy, i0, 1) * (1 - w1) + _at(lane.xy, i0 + 1, 1) * w1
    tan = (_at(lane.tangent, i0, 1) * (1 - w1)
           + _at(lane.tangent, i0 + 1, 1) * w1)
    tan = tan / torch.clamp(_norm(tan, keepdim=True), min=1e-9)
    kappa = (_at(lane.curvature, i0, 0) * (1 - w)
             + _at(lane.curvature, i0 + 1, 0) * w)
    return xy, tan, kappa


def frenet_of_point(lane: Lane, p):
    """Project point(s) p [..., 2] onto the lane -> (s, d), d > 0 left.

    The nearest valid sample wins (the first one on a tie), as in JAX.
    """
    P = lane.xy.shape[-2]
    valid = (torch.arange(P, device=p.device)
             < lane.n_valid[..., None])                      # [*L, P]
    d2 = ((p[..., None, :] - lane.xy) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.inf)
    i = torch.minimum(torch.clamp(torch.argmin(d2, dim=-1), min=0),
                      lane.n_valid - 2)
    rel = p - _at(lane.xy, i, 1)
    tan = _at(lane.tangent, i, 1)
    along = (rel * tan).sum(-1)
    # clamp the along-track correction to one sample to stay on the polyline
    along = torch.minimum(torch.maximum(along, -lane.ds), lane.ds)
    s = i.to(p.dtype) * lane.ds + along
    d = tan[..., 0] * rel[..., 1] - tan[..., 1] * rel[..., 0]
    return s, d


class FrenetState(NamedTuple):
    """Longitudinal/lateral state (common::FrenetState)."""

    s: torch.Tensor        # arc length
    s_dot: torch.Tensor    # ds/dt
    d: torch.Tensor        # signed lateral offset (left +)
    d_prime: torch.Tensor  # dd/ds


def frenet_of_state(lane: Lane, pos, angle, velocity) -> FrenetState:
    """s_dot = v cos(dtheta) / (1 - kappa d); d' = tan(dtheta) (1 - kappa d).
    """
    s, d = frenet_of_point(lane, pos)
    _, tan, kappa = lane_point(lane, s)
    lane_theta = torch.atan2(tan[..., 1], tan[..., 0])
    dtheta = normalize_angle(angle - lane_theta)
    one_kd = torch.clamp(1.0 - kappa * d, min=0.1)
    s_dot = velocity * torch.cos(dtheta) / one_kd
    d_prime = torch.tan(dtheta) * one_kd
    return FrenetState(s=s, s_dot=s_dot, d=d, d_prime=d_prime)


def state_of_frenet(lane: Lane, s, d):
    """(position, heading) of the point at (s, d) with d' = 0."""
    xy, tan, _ = lane_point(lane, s)
    normal = torch.stack([-tan[..., 1], tan[..., 0]], dim=-1)
    pos = xy + d[..., None] * normal
    heading = torch.atan2(tan[..., 1], tan[..., 0])
    return pos, heading


def normalize_angle(a):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))
