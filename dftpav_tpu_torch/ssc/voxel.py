"""(s, d, t) voxel-grid cube inflation, the reference SscMap's corridor
construction (the port of `dftpav_tpu/ssc/voxel.py`).

Obstacle predictions, dilated by the ego footprint, are rasterized into a
dense [T+1, Ns, Nd] bool grid by broadcast interval tests; each seed cube
grows face by face (s+, s-, d+, d-, up to inflate_steps cells each per
round) until a blocked plane or the grid edge (InflateCubeIn3dGrid). Every
cube of every plan grows in one batched loop: a finished cube's round is a
no-op (its faces stay finished and its bounds stay), so the batched loop
gives each cube what `jax.vmap` of the one-cube `while_loop` gives it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dftpav_tpu_torch.ssc.corridor import Corridor, _chunks


class VoxelConfig(NamedTuple):
    """Grid + inflation parameters (ssc_map.h:37-52 defaults, sized for the
    forward-sim horizon)."""

    s_res: float = 0.25       # map_resolution[0]
    d_res: float = 0.2        # map_resolution[1]
    n_s: int = 256            # grid cells along s (covers s0 + ~64 m)
    n_d: int = 64             # grid cells along d (~12.8 m)
    s_back: float = 10.0      # grid start offset behind the initial s
    d_origin: float = -6.4    # grid start in d
    inflate_s_pos: int = 20   # inflate_steps[0]
    inflate_s_neg: int = 5    # inflate_steps[1]
    inflate_d_pos: int = 10   # inflate_steps[2]
    inflate_d_neg: int = 10   # inflate_steps[3]
    margin_s: float = 0.0     # extra clearance on top of footprint inflation
    margin_d: float = 0.0


def rasterize(times, obs_s, obs_d, obs_half_l, obs_half_w, obs_mask,
              ego_len, ego_d_cr, ego_width, s0,
              cfg: VoxelConfig = VoxelConfig()):
    """(occupancy [..., T+1, Ns, Nd], s_cells [..., Ns], d_cells [Nd]) from
    per-step obstacle Frenet boxes obs_s/d [..., A, T+1] dilated by the ego
    footprint (InflateObstacleGrid: s+ by len/2 - d_cr, s- by the rest, d by
    (width - 0.5)/2); s0 [...] is the plan's initial s."""
    del times
    dtype, dev = obs_s.dtype, obs_s.device
    s_p_inf = ego_len / 2.0 - ego_d_cr
    s_n_inf = ego_len - s_p_inf
    d_inf = (ego_width - 0.5) / 2.0

    s_cells = (s0[..., None] - cfg.s_back) + (
        torch.arange(cfg.n_s, dtype=dtype, device=dev) + 0.5) * cfg.s_res
    d_cells = cfg.d_origin + (
        torch.arange(cfg.n_d, dtype=dtype, device=dev) + 0.5) * cfg.d_res

    hl, hw = obs_half_l[..., None], obs_half_w[..., None]
    lo_s = obs_s - hl - s_n_inf - cfg.margin_s               # [..., A, T+1]
    hi_s = obs_s + hl + s_p_inf + cfg.margin_s
    lo_d = obs_d - hw - d_inf - cfg.margin_d
    hi_d = obs_d + hw + d_inf + cfg.margin_d

    sc = s_cells[..., None, None, :]
    # [..., A, T+1, Ns] and [..., A, T+1, Nd]
    in_s = (sc >= lo_s[..., None]) & (sc <= hi_s[..., None])
    in_d = (d_cells >= lo_d[..., None]) & (d_cells <= hi_d[..., None])
    occ = (in_s[..., :, None] & in_d[..., None, :]
           & obs_mask[..., None, None, None]).any(-4)  # [.., T+1, Ns, Nd]
    return occ, s_cells, d_cells


def _in_range(n: int, lo, hi):
    """[..., n] bool: lo <= index <= hi."""
    i = torch.arange(n, device=lo.device)
    return (i >= lo[..., None]) & (i <= hi[..., None])


def _plane_free_s(occ, s_idx, d_lb, d_ub):
    """occ [..., K, Ns, Nd] (the cube's time slab): is the plane s == s_idx
    free over d in [d_lb, d_ub]? (CheckIfPlaneIsFreeOnXAxis)"""
    K, Nd = occ.shape[-3], occ.shape[-1]
    col = torch.gather(occ, -2, s_idx.reshape(s_idx.shape + (1, 1, 1)).expand(
        s_idx.shape + (K, 1, Nd))).squeeze(-2)               # [..., K, Nd]
    return ~(col & _in_range(Nd, d_lb, d_ub)[..., None, :]).flatten(-2).any(-1)


def _plane_free_d(occ, d_idx, s_lb, s_ub):
    K, Ns = occ.shape[-3], occ.shape[-2]
    row = torch.gather(occ, -1, d_idx.reshape(d_idx.shape + (1, 1, 1)).expand(
        d_idx.shape + (K, Ns, 1))).squeeze(-1)               # [..., K, Ns]
    return ~(row & _in_range(Ns, s_lb, s_ub)[..., None, :]).flatten(-2).any(-1)


def inflate_cube(occ_slab, s_lb0, s_ub0, d_lb0, d_ub0,
                 cfg: VoxelConfig = VoxelConfig()):
    """Grow seed cubes [...] in their time slabs occ_slab [..., K, Ns, Nd]
    (InflateCubeIn3dGrid's s/d phase): each round takes up to inflate_steps
    cells per face in the order s+, s-, d+, d-, re-checking the blocking
    plane against the current other-axis bounds; a face stops at the first
    blocked plane or the grid edge. Returns index bounds. (JAX's optional
    reachability caps, which no caller sets, are left out.)"""
    Ns, Nd = occ_slab.shape[-2], occ_slab.shape[-1]

    def face_steps(bounds, fin, n_step, grow):
        for _ in range(n_step):
            nb, blocked = grow(bounds)
            fin = fin | blocked
            bounds = tuple(torch.where(fin, a, b) for a, b in zip(bounds, nb))
        return bounds, fin

    def grow_sp(b):
        s_lb, s_ub, d_lb, d_ub = b
        nxt = s_ub + 1
        ok = (nxt < Ns) & _plane_free_s(occ_slab, torch.clamp(nxt, max=Ns - 1),
                                        d_lb, d_ub)
        return (s_lb, torch.where(ok, nxt, s_ub), d_lb, d_ub), ~ok

    def grow_sn(b):
        s_lb, s_ub, d_lb, d_ub = b
        nxt = s_lb - 1
        ok = (nxt >= 0) & _plane_free_s(occ_slab, torch.clamp(nxt, min=0),
                                        d_lb, d_ub)
        return (torch.where(ok, nxt, s_lb), s_ub, d_lb, d_ub), ~ok

    def grow_dp(b):
        s_lb, s_ub, d_lb, d_ub = b
        nxt = d_ub + 1
        ok = (nxt < Nd) & _plane_free_d(occ_slab, torch.clamp(nxt, max=Nd - 1),
                                        s_lb, s_ub)
        return (s_lb, s_ub, d_lb, torch.where(ok, nxt, d_ub)), ~ok

    def grow_dn(b):
        s_lb, s_ub, d_lb, d_ub = b
        nxt = d_lb - 1
        ok = (nxt >= 0) & _plane_free_d(occ_slab, torch.clamp(nxt, min=0),
                                        s_lb, s_ub)
        return (s_lb, s_ub, torch.where(ok, nxt, d_lb), d_ub), ~ok

    bounds = torch.broadcast_tensors(*(torch.as_tensor(
        v, device=occ_slab.device).long() for v in (s_lb0, s_ub0, d_lb0,
                                                    d_ub0)))
    fins = [torch.zeros(bounds[0].shape, dtype=torch.bool,
                        device=occ_slab.device) for _ in range(4)]
    while not bool((fins[0] & fins[1] & fins[2] & fins[3]).all()):
        bounds, fins[0] = face_steps(bounds, fins[0], cfg.inflate_s_pos,
                                     grow_sp)
        bounds, fins[1] = face_steps(bounds, fins[1], cfg.inflate_s_neg,
                                     grow_sn)
        bounds, fins[2] = face_steps(bounds, fins[2], cfg.inflate_d_pos,
                                     grow_dp)
        bounds, fins[3] = face_steps(bounds, fins[3], cfg.inflate_d_neg,
                                     grow_dn)
    return bounds


def build_corridor_voxel(times, seed_s, seed_d, obs_s, obs_d, obs_half_l,
                         obs_half_w, obs_mask, M: int,
                         ego_len=4.88, ego_width=1.9, ego_d_cr=1.015,
                         cfg: VoxelConfig = VoxelConfig()) -> Corridor:
    """Voxel-exact drop-in for corridor.build_corridor (same arguments,
    metric bounds): times [T+1]; seed_s/d [..., T+1]; obs_s/d
    [..., A, T+1]; obs_half_l/w, obs_mask [..., A]. The seed cube of chunk m
    covers the voxels its trajectory samples touch in the chunk's time slab
    (GetInitialCubeUsingSeed)."""
    T = seed_s.shape[-1] - 1
    assert T % M == 0, "steps must divide evenly into cubes"
    k = T // M
    batch = seed_s.shape[:-1]
    s0 = seed_s[..., 0]
    occ, s_cells, d_cells = rasterize(
        times, obs_s, obs_d, obs_half_l, obs_half_w, obs_mask,
        ego_len, ego_d_cr, ego_width, s0, cfg)

    def to_s_idx(v):
        return torch.clamp(torch.floor((v - (s0 - cfg.s_back)[..., None])
                                       / cfg.s_res), 0, cfg.n_s - 1).long()

    def to_d_idx(v):
        return torch.clamp(torch.floor((v - cfg.d_origin) / cfg.d_res),
                           0, cfg.n_d - 1).long()

    idx = _chunks(M, k, seed_s.device)
    ss = seed_s[..., idx]                                    # [..., M, k+1]
    sd = seed_d[..., idx]
    s_lb0, s_ub0 = to_s_idx(ss.amin(-1)), to_s_idx(ss.amax(-1))
    d_lb0, d_ub0 = to_d_idx(sd.amin(-1)), to_d_idx(sd.amax(-1))

    occ_slabs = occ[..., idx, :, :]                  # [..., M, k+1, Ns, Nd]

    # seed validity (ConstructCorridor: CheckIfCubeIsFree on the seed cube)
    seed_box = (_in_range(cfg.n_s, s_lb0, s_ub0)[..., None, :, None]
                & _in_range(cfg.n_d, d_lb0, d_ub0)[..., None, None, :])
    occupied = (occ_slabs & seed_box).flatten(-3).any(-1)    # [..., M]
    seed_free = ~occupied.any(-1)

    s_lb, s_ub, d_lb, d_ub = inflate_cube(occ_slabs, s_lb0, s_ub0, d_lb0,
                                          d_ub0, cfg)

    half_s, half_d = 0.5 * cfg.s_res, 0.5 * cfg.d_res
    ar = torch.arange(M, device=times.device)
    return Corridor(
        s_lb=torch.gather(s_cells, -1, s_lb) - half_s,
        s_ub=torch.gather(s_cells, -1, s_ub) + half_s,
        d_lb=d_cells[d_lb] - half_d, d_ub=d_cells[d_ub] + half_d,
        t_lb=times[ar * k].expand(batch + (M,)),
        t_ub=times[(ar + 1) * k].expand(batch + (M,)),
        seed_free=seed_free)
