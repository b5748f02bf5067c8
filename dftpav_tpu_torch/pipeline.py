"""Parking pipeline: grid map -> kinodynamic A* -> corridors -> solver
scenarios (TrajPlanner::RunOnceParking / RunMINCOParking,
traj_manager.cpp:160-238, 509-641).

The front end (search, time profile, corridor growth) runs in native C++
on the host (frontend.native); scenario assembly pads every plan to a
static problem class (S segments of N pieces) so plans batch into one
solve. The reference picks each segment's piece count from its duration
(max(round(dur / 1 s), 2), traj_manager.cpp:543); here a class either
re-pieces every segment to N, or with `Dims.Ns` gives each segment slot its
own count (e.g. (8, 2) for a long approach and a short reversal), and a
plan is admitted to the class whose Ns equals its natural quantized counts.
The solver takes the per-slot counts natively and emits the solution on
the uniform N-piece grid. Numpy and ctypes only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dftpav_tpu_torch.config import PlannerConfig
from dftpav_tpu_torch.frontend import GridMap2D, KinoAstarPlanner
from dftpav_tpu_torch.frontend.native import _dptr, _load
from dftpav_tpu_torch.types import Dims, Scenario


def quantized_counts(seg_durs, N: int, piece_duration: float = 1.0) -> tuple:
    """Per-segment piece counts quantized to the {2, 4, ..., N} class
    ladder from the reference's natural count max(round(dur/1s), 2)
    (traj_manager.cpp:543)."""
    allowed = [n for n in (2, 4, 8, 16, 32) if n <= N and N % n == 0]

    def quant(dur):
        want = max(2, int(round(dur / piece_duration)))
        for n in allowed:
            if n >= want:
                return n
        return allowed[-1]

    return tuple(quant(d) for d in seg_durs)


@dataclass
class PlanMeta:
    """Host-side metadata for one planned scenario."""

    n_segments: int
    durations: np.ndarray     # [n_segments] front-end time profile
    singuls: np.ndarray       # [n_segments]
    sample_traj: np.ndarray   # [M, 3] rough kino path
    dims: object = None       # the Dims class this scenario was built for


class ParkingPlanner:
    """Plans scenarios against a grid map and assembles solver inputs."""

    def __init__(self, grid: GridMap2D, cfg: PlannerConfig | None = None,
                 dims: Dims | None = None, dtype=np.float32,
                 small_dims: Dims | None = None, short_plan_s: float = 1.5,
                 dims_classes=None):
        """Piece-count classes. The reference picks each segment's piece
        count from its duration (max(round(dur/1s), 2),
        traj_manager.cpp:543); with static shapes we quantize to a ladder of
        problem classes (`dims_classes`, e.g. N in {2, 4, 8}) chosen by the
        longest segment's duration. Over-piecing a short gear segment onto
        N=8 makes the warm-start spline wildly jerky and the solve gets
        rejected; the ladder keeps piece granularity near the reference's.

        Back-compat: `small_dims`/`short_plan_s` emulate a two-class ladder;
        `dims` alone pins a single class (used by the batch bench, where
        scenario durations are homogeneous)."""
        self.grid = grid
        self.cfg = cfg or PlannerConfig()
        self.dims = dims or Dims(S=2, N=8, K=16, Kdes=32, H=4, O=0, Po=8)
        self.small_dims = small_dims
        self.short_plan_s = short_plan_s
        self.dims_classes = (sorted(dims_classes, key=lambda d: d.N)
                             if dims_classes else None)
        self.dtype = dtype
        self.astar = KinoAstarPlanner(grid, self.cfg.frontend,
                                      self.cfg.vehicle)

    def plan_scenario(self, start, end, start_ctrl=(0.0, 0.0)):
        """Front-end plan + scenario assembly for one (start, end) query.

        start/end: (x, y, yaw, signed_v). Returns (Scenario, PlanMeta) or
        (None, None) if the front end fails or needs more segments than
        dims.S.
        """
        dims, cfg = self.dims, self.cfg
        lib = _load()

        s = np.ascontiguousarray(start, dtype=np.float64)
        e = np.ascontiguousarray(end, dtype=np.float64)
        sc = np.ascontiguousarray(start_ctrl, dtype=np.float64)
        p = self.astar._params()
        h = lib.df_plan(self.grid._h, _dptr(p), _dptr(s), _dptr(sc),
                        _dptr(e))
        try:
            if lib.df_plan_status(h) != 1:
                return None, None
            nseg = lib.df_plan_nsegs(h)
            max_s = (max(d.S for d in self.dims_classes)
                     if self.dims_classes else dims.S)
            if nseg > max_s:
                return None, None
            seg_durs = [lib.df_plan_seg_duration(h, i) for i in range(nseg)]
            if self.dims_classes:
                if any(d.Ns is not None for d in self.dims_classes):
                    # per-SEGMENT class ladder: pick the class whose Ns
                    # prefix equals this plan's natural quantized counts —
                    # the static-shape form of the reference planning every
                    # scenario at its own piecing (traj_manager.cpp:543)
                    counts = quantized_counts(
                        seg_durs, self.dims_classes[0].N,
                        cfg.opt.traj_piece_duration)
                    dims = None
                    for d in self.dims_classes:
                        if d.S >= nseg and d.Ns is not None \
                                and d.Ns[:nseg] == counts:
                            dims = d
                            break
                    if dims is None:
                        return None, None
                else:
                    want = max(2, int(round(max(seg_durs)
                                            / cfg.opt.traj_piece_duration)))
                    dims = self.dims_classes[-1]
                    for d in self.dims_classes:
                        if d.N >= want:
                            dims = d
                            break
                    if nseg > dims.S:
                        return None, None
            elif self.small_dims is not None and \
                    max(seg_durs) < self.short_plan_s:
                dims = self.small_dims

            if dims.Ns is not None and not self.dims_classes:
                # single pinned per-segment class: admit only scenarios
                # whose natural quantized counts match it (the bench pins
                # one class; the ladder path above covers the rest)
                counts = quantized_counts(seg_durs, dims.N,
                                          cfg.opt.traj_piece_duration)
                if counts != dims.Ns[:nseg]:
                    return None, None

            ns_class = dims.ns_tuple
            N, K1 = dims.N, dims.K1
            dt_ = self.dtype
            ini = np.zeros((dims.S, 2, 3), dt_)
            fin = np.zeros((dims.S, 2, 3), dt_)
            inner = np.zeros((dims.S, N - 1, 2), dt_)
            init_T = np.ones((dims.S,), dt_)
            singul = np.ones((dims.S,), np.int32)
            seg_mask = np.zeros((dims.S,), bool)
            corr_n = np.zeros((dims.S, N, K1, dims.H, 2), dt_)
            corr_p = np.zeros((dims.S, N, K1, dims.H, 2), dt_)
            corr_mask = np.zeros((dims.S, N, K1, dims.H), bool)

            durations = np.zeros(nseg)
            singuls = np.zeros(nseg, np.int32)
            vp = cfg.vehicle
            for i in range(nseg):
                dur = lib.df_plan_seg_duration(h, i)
                durations[i] = dur
                sg = lib.df_plan_seg_singul(h, i)
                singuls[i] = sg
                # force piece count == the class's count for this slot
                # (uniform N, or the per-segment Ns[i] — module docstring)
                n_i = ns_class[i]
                piece_dur = dur / n_i
                dT = np.zeros(1)
                seg_inner = np.zeros((max(n_i - 1, 1), 2))
                states = np.zeros((n_i * K1, 3))
                corr = np.zeros((n_i * K1, 16))
                lib.df_plan_segment_scenario(
                    h, self.grid._h, i, dims.K, dims.Kdes, piece_dur,
                    vp.length, vp.width, vp.d_cr, 10.0,
                    _dptr(dT), _dptr(seg_inner), _dptr(states), _dptr(corr))
                ss = np.zeros(6)
                es = np.zeros(6)
                m = lib.df_plan_seg_npts(h, i)
                pts = np.zeros((m, 3))
                th = np.zeros(m)
                lib.df_plan_seg_data(h, i, _dptr(pts), _dptr(th), _dptr(ss),
                                     _dptr(es))
                ini[i] = ss.reshape(3, 2).T
                fin[i] = es.reshape(3, 2).T
                inner[i, :n_i - 1] = seg_inner[:n_i - 1]
                init_T[i] = dur
                singul[i] = sg
                seg_mask[i] = True
                c = corr.reshape(n_i, K1, 4, 4)
                corr_n[i, :n_i] = c[..., 0:2]
                corr_p[i, :n_i] = c[..., 2:4]
                corr_mask[i, :n_i] = True

            # pad unused segments with a copy of the last real one (finite
            # data; masked out of the cost)
            for i in range(nseg, dims.S):
                ini[i], fin[i] = ini[nseg - 1], fin[nseg - 1]
                inner[i] = inner[nseg - 1]
                init_T[i] = init_T[nseg - 1]
                singul[i] = singul[nseg - 1]
                corr_n[i], corr_p[i] = corr_n[nseg - 1], corr_p[nseg - 1]
                corr_mask[i] = corr_mask[nseg - 1]

            O, Po = dims.O, dims.Po
            scen = Scenario(
                ini_state=ini, fin_state=fin, init_inner=inner,
                init_T=init_T, singul=singul, seg_mask=seg_mask,
                corr_n=corr_n, corr_p=corr_p, corr_mask=corr_mask,
                obs_coef=np.zeros((O, Po, 6, 2), dt_),
                obs_dt=np.ones((O,), dt_),
                obs_rel_t0=np.zeros((O,), dt_),
                obs_mask=np.zeros((O,), bool),
            )
            ns = lib.df_plan_nsamples(h)
            samples = np.empty((ns, 3))
            lib.df_plan_samples(h, _dptr(samples))
            meta = PlanMeta(n_segments=nseg, durations=durations,
                            singuls=singuls, sample_traj=samples, dims=dims)
            return scen, meta
        finally:
            lib.df_plan_destroy(h)
