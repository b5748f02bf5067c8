"""Semantic map: occupancy rasterization, lane association, predictions (the
port of `dftpav_tpu/urban/semantic_map.py`; the reference's
semantic_map_manager). The grid is an [H, W] tensor from vectorized
point-in-shape tests; neighbour queries are the Frenet projections of
forward_sim / mobil; predictions reuse the batched forward simulator."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dftpav_tpu_torch.urban import forward_sim as fsim
from dftpav_tpu_torch.urban import lane as lane_mod
from dftpav_tpu_torch.urban import mobil
from dftpav_tpu_torch.urban.lane import Lane, LaneSet
from dftpav_tpu_torch.urban.mpdm import _gather_lane, _rollout_openloop


class GridSpec(NamedTuple):
    """Ego-centric occupancy grid geometry (GridMapND in the reference)."""

    origin: torch.Tensor      # [2] world position of cell (0, 0)
    resolution: float = 0.2
    height: int = 512
    width: int = 512


def _cell_centers(spec: GridSpec):
    o = spec.origin
    ys = torch.arange(spec.height, device=o.device, dtype=o.dtype) \
        * spec.resolution
    xs = torch.arange(spec.width, device=o.device, dtype=o.dtype) \
        * spec.resolution
    return o[0] + xs[None, :], o[1] + ys[:, None]  # [1, W], [H, 1]


def rasterize_circles(spec: GridSpec, centers, radii, mask):
    """Occupancy [H, W] from circle obstacles: centers [O, 2], radii [O],
    mask [O]."""
    gx, gy = _cell_centers(spec)
    d2 = (gx[None] - centers[:, 0, None, None]) ** 2 \
        + (gy[None] - centers[:, 1, None, None]) ** 2
    hit = (d2 <= (radii ** 2)[:, None, None]) & mask[:, None, None]
    return hit.any(0)


def rasterize_obbs(spec: GridSpec, states, lengths, widths, d_crs, mask):
    """Occupancy [H, W] from vehicle footprints: states [O, 6] in the
    steer-plant layout; a point-in-OBB test per cell."""
    gx, gy = _cell_centers(spec)
    c, s = torch.cos(states[:, 2]), torch.sin(states[:, 2])
    cx = states[:, 0] + d_crs * c
    cy = states[:, 1] + d_crs * s
    relx = gx[None] - cx[:, None, None]
    rely = gy[None] - cy[:, None, None]
    lon = relx * c[:, None, None] + rely * s[:, None, None]
    lat = -relx * s[:, None, None] + rely * c[:, None, None]
    hit = (lon.abs() <= (lengths / 2)[:, None, None]) \
        & (lat.abs() <= (widths / 2)[:, None, None]) \
        & mask[:, None, None]
    return hit.any(0)


def occupied_at(spec: GridSpec, grid, pos):
    """Grid lookup at world positions pos [..., 2]; out of bounds is free."""
    ij = (pos - spec.origin) / spec.resolution
    i = torch.clamp(ij[..., 1].to(torch.int32), 0, spec.height - 1).long()
    j = torch.clamp(ij[..., 0].to(torch.int32), 0, spec.width - 1).long()
    inb = (ij[..., 0] >= 0) & (ij[..., 0] < spec.width) \
        & (ij[..., 1] >= 0) & (ij[..., 1] < spec.height)
    return torch.where(inb, grid[i, j], False)


# ---------------------------------------------------------------------------
# Occlusion-aware sensing (the "fake mapper")
# ---------------------------------------------------------------------------

def visibility_mask(spec: GridSpec, grid, ego_pos, n_samples: int = 128):
    """[H, W] bool: the cell is in line of sight of the ego position.

    Every cell is a ray end point: n_samples points along each ego->cell
    segment are looked up in one batched gather, and a cell is visible iff
    no strictly earlier sample is occupied (DataRenderer's ray casting; the
    samples start one cell out of the ego's own cell and stop one cell
    short of the target).
    """
    gx, gy = _cell_centers(spec)
    cx = gx.expand(spec.height, spec.width)
    cy = gy.expand(spec.height, spec.width)
    dx = cx - ego_pos[0]
    dy = cy - ego_pos[1]
    dist = torch.sqrt(dx * dx + dy * dy)
    t_hi = torch.clamp(1.0 - spec.resolution / torch.clamp(dist, min=1e-6),
                       min=0.0)
    t_lo = torch.minimum(spec.resolution / torch.clamp(dist, min=1e-6), t_hi)
    ts = (torch.arange(n_samples, device=dist.device, dtype=dist.dtype)
          + 0.5) / n_samples
    frac = t_lo[..., None] + ts * (t_hi - t_lo)[..., None]   # [H, W, S]
    px = ego_pos[0] + dx[..., None] * frac
    py = ego_pos[1] + dy[..., None] * frac
    blocked = occupied_at(spec, grid, torch.stack([px, py], dim=-1))
    return ~blocked.any(-1)


def fake_mapper(spec: GridSpec, grid, ego_pos, seen_prev=None,
                dist_thres=None, n_samples: int = 128):
    """Sensed occupancy (DataRenderer::FakeMapper): ray-cast-visible obstacle
    cells, unioned with previously seen cells still within `dist_thres`
    (Chebyshev) of the ego."""
    vis = visibility_mask(spec, grid, ego_pos, n_samples)
    seen = grid & vis
    if seen_prev is not None:
        if dist_thres is None:
            dist_thres = spec.height * spec.resolution / 2.0 * 0.8
        gx, gy = _cell_centers(spec)
        near = ((gx - ego_pos[0]).abs() < dist_thres) \
            & ((gy - ego_pos[1]).abs() < dist_thres)
        seen = seen | (seen_prev & near)
    return seen


def nearest_lane(lane_set: LaneSet, pos, heading, max_dist: float = 10.0,
                 heading_gate: float = 1.3):
    """Nearest lane id for poses pos [..., 2], heading [...]
    (GetNearestLaneIdUsingState): the smallest |d| among lanes whose local
    heading is within the gate, the first on a tie; -1 when none
    qualifies."""
    nb = heading.dim()
    lanes = Lane(*(f.reshape(f.shape[:1] + (1,) * nb + f.shape[1:])
                   for f in lane_set.lanes))                 # batch [L, 1..]
    s, d = lane_mod.frenet_of_point(lanes, pos)
    _, tan, _ = lane_mod.lane_point(lanes, s)
    dth = lane_mod.normalize_angle(
        heading - torch.atan2(tan[..., 1], tan[..., 0]))
    ok = (d.abs() < max_dist) & (dth.abs() < heading_gate)
    dists = torch.where(ok, d.abs(), torch.inf)              # [L, ...]
    best = torch.argmin(dists, dim=0)
    found = torch.isfinite(dists.amin(0))
    return torch.where(found, best, -1)


def associate_lanes(lane_set: LaneSet, states):
    """[*, A] lane ids for all agents."""
    return nearest_lane(lane_set, states[..., 0:2], states[..., 2])


def openloop_prediction(lane_set: LaneSet, states, lane_ids, geom,
                        p: fsim.SimParam, dt: float, n_steps: int):
    """Open-loop (non-interactive) forward prediction of all agents on their
    lanes at their current velocities -> [*, T+1, A, 6]."""
    lanes = _gather_lane(lane_set, torch.clamp(lane_ids, min=0))
    return _rollout_openloop(lanes, states, geom, states[..., fsim.V], p, dt,
                             n_steps)


def predict_behaviors(lane_set: LaneSet, states, lane_ids, geom):
    """Most likely lateral behaviour per agent from MOBIL probabilities
    (GetPredictedBehavior): (ids [*, A], probs [*, A, 3])."""
    probs = mobil.predict_all(lane_set, states, lane_ids, geom)
    return torch.argmax(probs, dim=-1), probs
