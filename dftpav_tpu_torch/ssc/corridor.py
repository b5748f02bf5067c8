"""(s, d, t) corridor generation around a behavioural forward trajectory by
interval inflation (the port of `dftpav_tpu/ssc/corridor.py`; the
reference's SscMap, re-designed without a voxel grid in JAX: time is
chunked into M uniform cubes, obstacle predictions are axis-aligned Frenet
boxes per step, and each cube's bounds are closed-form interval arithmetic
per (cube, obstacle)). Every argument may carry leading plan dims."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Corridor(NamedTuple):
    """M cubes in the Frenet plane; time bounds are uniform chunks."""

    s_lb: torch.Tensor   # [..., M]
    s_ub: torch.Tensor   # [..., M]
    d_lb: torch.Tensor   # [..., M]
    d_ub: torch.Tensor   # [..., M]
    t_lb: torch.Tensor   # [..., M]
    t_ub: torch.Tensor   # [..., M]
    seed_free: torch.Tensor  # [...] bool: no obstacle overlaps the seed


class CorridorConfig(NamedTuple):
    s_back: float = 2.0       # inflation behind the seed interval
    s_forward: float = 10.0   # inflation ahead
    d_half_width: float = 5.25  # lateral corridor half width (1.5 lanes)
    margin_s: float = 2.5     # obstacle clearance (about half a car length)
    margin_d: float = 1.1     # lateral clearance (about half a car width)


def _chunks(M: int, k: int, device):
    """[M, k+1] sample indices: cube n covers samples [n k, (n+1) k]."""
    return (torch.arange(M, device=device)[:, None] * k
            + torch.arange(k + 1, device=device)[None])


def build_corridor(times, seed_s, seed_d, obs_s, obs_d, obs_half_l,
                   obs_half_w, obs_mask, M: int,
                   cfg: CorridorConfig = CorridorConfig()) -> Corridor:
    """Corridor of M cubes around the seed.

    times [T+1] uniform stamps (shared); seed_s/d [..., T+1] the ego
    forward trajectory in Frenet; obs_s/d [..., A, T+1] obstacle centers;
    obs_half_l/w and obs_mask [..., A]. T must be divisible by M.
    """
    T = seed_s.shape[-1] - 1
    assert T % M == 0, "steps must divide evenly into cubes"
    k = T // M
    idx = _chunks(M, k, seed_s.device)
    batch = seed_s.shape[:-1]

    ss = seed_s[..., idx]                                    # [..., M, k+1]
    sd = seed_d[..., idx]
    t_lb = times[torch.arange(M, device=times.device) * k].expand(batch + (M,))
    t_ub = times[(torch.arange(M, device=times.device) + 1) * k].expand(
        batch + (M,))
    seed_s_lo, seed_s_hi = ss.amin(-1), ss.amax(-1)          # [..., M]
    seed_d_lo, seed_d_hi = sd.amin(-1), sd.amax(-1)

    # obstacle boxes per cube: each obstacle reduced over the cube's samples
    os_ = obs_s[..., idx]                                    # [..., A, M, k+1]
    od = obs_d[..., idx]
    hl, hw = obs_half_l[..., None], obs_half_w[..., None]
    obs_s_lo = os_.amin(-1) - hl - cfg.margin_s              # [..., A, M]
    obs_s_hi = os_.amax(-1) + hl + cfg.margin_s
    obs_d_lo = od.amin(-1) - hw - cfg.margin_d
    obs_d_hi = od.amax(-1) + hw + cfg.margin_d
    live = obs_mask[..., None]                               # [..., A, 1]

    def over_a(x):  # [..., M] -> [..., 1, M]
        return x.unsqueeze(-2)

    # --- lateral bounds: obstacles overlapping the seed s-interval clip d ---
    d_lo0 = seed_d_lo - cfg.d_half_width
    d_hi0 = seed_d_hi + cfg.d_half_width
    s_overlap = live & (obs_s_hi > over_a(seed_s_lo) - cfg.s_back) \
        & (obs_s_lo < over_a(seed_s_hi) + cfg.s_forward)
    left_of = obs_d_lo > over_a(seed_d_hi)     # obstacle fully left of seed
    right_of = obs_d_hi < over_a(seed_d_lo)
    d_hi = torch.where(s_overlap & left_of, obs_d_lo, torch.inf).amin(-2)
    d_lo = torch.where(s_overlap & right_of, obs_d_hi, -torch.inf).amax(-2)
    d_ub = torch.maximum(torch.minimum(d_hi, d_hi0), seed_d_hi)
    d_lb = torch.minimum(torch.maximum(d_lo, d_lo0), seed_d_lo)

    # --- longitudinal bounds: obstacles inside the final d-interval clip s ---
    d_overlap = live & (obs_d_hi > over_a(d_lb)) & (obs_d_lo < over_a(d_ub))
    ahead = obs_s_lo > over_a(seed_s_hi)
    behind = obs_s_hi < over_a(seed_s_lo)
    s_hi = torch.where(d_overlap & ahead, obs_s_lo, torch.inf).amin(-2)
    s_lo = torch.where(d_overlap & behind, obs_s_hi, -torch.inf).amax(-2)
    s_ub = torch.maximum(torch.minimum(s_hi, seed_s_hi + cfg.s_forward),
                         seed_s_hi)
    s_lb = torch.minimum(torch.maximum(s_lo, seed_s_lo - cfg.s_back),
                         seed_s_lo)

    # seed validity: an obstacle overlapping a cube's seed region in BOTH
    # dims means the forward trajectory itself collides
    overlap_both = live & (obs_s_hi > over_a(seed_s_lo)) \
        & (obs_s_lo < over_a(seed_s_hi)) & (obs_d_hi > over_a(seed_d_lo)) \
        & (obs_d_lo < over_a(seed_d_hi))
    seed_free = ~overlap_both.flatten(-2).any(-1)
    return Corridor(s_lb=s_lb, s_ub=s_ub, d_lb=d_lb, d_ub=d_ub,
                    t_lb=t_lb, t_ub=t_ub, seed_free=seed_free)
