"""SSC planner: corridor + piecewise-Bezier QP in the Frenet frame (the port
of `dftpav_tpu/ssc/planner.py`; SscPlanner::RunQpOptimization and
SplineGenerator::GetBezierSplineUsingCorridor in the reference):

  min sum_n jerk(x_n) + w_prox * sum_i |p(t_i) - ref_i|^2
  s.t. continuity up to acc at cube junctions, start PVA, end PV,
       control points inside cube position bounds (Bezier hull property),
       derivative control points inside velocity/acc bounds.

Cubes have uniform duration, so Q, A, C are host numpy constants per
problem class (M, horizon), assembled once; only b, the cube bounds l/u and
the proximity term depend on the plan. The s and d dimensions are solved as
a batch axis of 2 through one ADMM, behind every plan's leading dims.
"""

from __future__ import annotations

import functools
from math import comb
from typing import NamedTuple

import numpy as np
import torch

from dftpav_tpu_torch.ops import kcost
from dftpav_tpu_torch.ssc.bezier import JERK_HESSIAN, N_DEG, N_ORD, \
    BezierSpline
from dftpav_tpu_torch.ssc.corridor import Corridor, CorridorConfig, \
    build_corridor
from dftpav_tpu_torch.ssc.qp import INFEASIBLE, QPResult, admm_qp
from dftpav_tpu_torch.ssc.voxel import build_corridor_voxel
from dftpav_tpu_torch.urban import lane as lane_mod


class SSCConfig(NamedTuple):
    M: int = 5                   # cubes (one per behavior layer by default)
    weight_proximity: float = 1.0  # ssc config weight_proximity
    v_lon: tuple = (0.0, 50.0)   # cube velocity bounds, s dim
    v_lat: tuple = (-3.0, 3.0)
    a_lon: tuple = (-8.0, 8.0)
    a_lat: tuple = (-3.0, 3.0)
    qp_iters: int = 150
    corridor: CorridorConfig = CorridorConfig()
    # "interval" = fast closed-form inflation (ssc/corridor.py);
    # "voxel" = grid-exact inflation matching ssc_map.cc (ssc/voxel.py)
    corridor_backend: str = "interval"


class _QPTemplate(NamedTuple):
    Q: np.ndarray        # [n, n] (without proximity weight folding)
    P: np.ndarray        # [n, n] proximity quadratic (unweighted)
    Bref: np.ndarray     # [n_ref, n] maps ctrl -> position at ref stamps (x s)
    A: np.ndarray        # [m_eq, n]
    C: np.ndarray        # [m_in, n]
    seg_of_pos_row: np.ndarray   # [m_in] segment index of each C row
    kind_of_row: np.ndarray      # [m_in] 0 pos / 1 vel / 2 acc
    n_eq: int


@functools.lru_cache(maxsize=None)
def _qp_template(M: int, duration: float, n_ref_per_seg: int) -> _QPTemplate:
    """Host-side assembly of the constant QP operators (numpy float64).

    Mirrors spline_generator.cc:368-725 with uniform segment duration.
    """
    n = M * N_ORD
    s = duration

    # objective: jerk hessian / s^3 per segment (spline_generator.cc:386)
    Q = np.zeros((n, n))
    for m in range(M):
        Q[m * N_ORD:(m + 1) * N_ORD, m * N_ORD:(m + 1) * N_ORD] = \
            JERK_HESSIAN / s ** 3

    # proximity: p(t_i) = s * sum_j x_j b_j(tau_i) at uniform stamps
    taus = (np.arange(n_ref_per_seg) + 1.0) / n_ref_per_seg
    rows = []
    for m in range(M):
        for tau in taus:
            row = np.zeros(n)
            for j in range(N_ORD):
                row[m * N_ORD + j] = s * comb(N_DEG, j) * tau ** j \
                    * (1 - tau) ** (N_DEG - j)
            rows.append(row)
    Bref = np.stack(rows)                       # [M * n_ref_per_seg, n]
    P = 2.0 * Bref.T @ Bref                     # d/dx of |Bref x - ref|^2

    # equality: continuity pos/vel/acc (scale s^(1-c) cancels on both sides
    # for uniform durations but is kept for fidelity), start PVA, end PV
    def d1(row, m, j, v):
        row[m * N_ORD + j] += v

    eq_rows, kinds = [], []
    for m in range(M - 1):
        for c in range(3):
            sc = s ** (1 - c)
            row = np.zeros(n)
            if c == 0:
                d1(row, m, 5, sc)
                d1(row, m + 1, 0, -sc)
            elif c == 1:
                d1(row, m, 4, -N_DEG * sc)
                d1(row, m, 5, N_DEG * sc)
                d1(row, m + 1, 0, N_DEG * sc)
                d1(row, m + 1, 1, -N_DEG * sc)
            else:
                k2 = N_DEG * (N_DEG - 1)
                d1(row, m, 3, k2 * sc)
                d1(row, m, 4, -2 * k2 * sc)
                d1(row, m, 5, k2 * sc)
                d1(row, m + 1, 0, -k2 * sc)
                d1(row, m + 1, 1, 2 * k2 * sc)
                d1(row, m + 1, 2, -k2 * sc)
            eq_rows.append(row)
    # start PVA (spline_generator.cc:555-600)
    for j, pat in enumerate([[(0, 1.0)],
                             [(0, -N_DEG), (1, N_DEG)],
                             [(0, 20.0), (1, -40.0), (2, 20.0)]]):
        row = np.zeros(n)
        for col, v in pat:
            d1(row, 0, col, v * s ** (1 - j))
        eq_rows.append(row)
    # end PV (end acc is disabled in the reference, ssc_planner.cc:312-314)
    for j, pat in enumerate([[(5, 1.0)],
                             [(4, -N_DEG), (5, N_DEG)]]):
        row = np.zeros(n)
        for col, v in pat:
            d1(row, M - 1, col, v * s ** (1 - j))
        eq_rows.append(row)
    A = np.stack(eq_rows)

    # inequalities (spline_generator.cc:648-714)
    in_rows, seg_of, kind_of = [], [], []
    for m in range(M):
        for j in range(N_ORD):
            row = np.zeros(n)
            d1(row, m, j, s)
            in_rows.append(row)
            seg_of.append(m)
            kind_of.append(0)
        for j in range(N_ORD - 1):
            row = np.zeros(n)
            d1(row, m, j, -N_DEG)
            d1(row, m, j + 1, N_DEG)
            in_rows.append(row)
            seg_of.append(m)
            kind_of.append(1)
        for j in range(N_ORD - 2):
            k2 = N_DEG * (N_DEG - 1) / s
            row = np.zeros(n)
            d1(row, m, j, k2)
            d1(row, m, j + 1, -2 * k2)
            d1(row, m, j + 2, k2)
            in_rows.append(row)
            seg_of.append(m)
            kind_of.append(2)
    C = np.stack(in_rows)
    return _QPTemplate(Q=Q, P=P, Bref=Bref, A=A, C=C,
                       seg_of_pos_row=np.asarray(seg_of),
                       kind_of_row=np.asarray(kind_of), n_eq=A.shape[0])


class SSCResult(NamedTuple):
    spline: BezierSpline
    corridor: Corridor
    qp: QPResult
    feasible: torch.Tensor   # [...] bool: corridor covers start & end


def ssc_plan(lane, ego_state, forward_traj, times, obs_trajs, obs_mask,
             geom_half_l, geom_half_w,
             cfg: SSCConfig = SSCConfig()) -> SSCResult:
    """Plan each behaviour's trajectory through its (s, d, t) corridor.

    lane: the behaviour's reference Lane (batch [...] or none);
    ego_state [..., 6] (steer-plant layout); forward_traj [..., T+1, 6] the
    ego forward simulation (the QP's seed and proximity reference); times
    [T+1] uniform host stamps starting at 0; obs_trajs [..., A, T+1, 6]
    predicted surround trajectories; obs_mask, geom_half_l/w [..., A].
    Computes in forward_traj's dtype on its device. Each plan's QP stops at
    its own exit (as `jax.vmap(ssc_plan)`), its s and d dims at a shared one
    (as JAX's one-plan call).
    """
    # full float32 matmuls (the proximity term): TF32 truncates operands
    # like the bf16 pass that, in JAX on the TPU, pushed the QP's equality
    # residual from 1e-3 to 3e0
    kcost._no_tf32()
    dtype, dev = forward_traj.dtype, forward_traj.device
    batch = forward_traj.shape[:-2]
    T = forward_traj.shape[-2] - 1
    M = cfg.M
    times_np = np.asarray(times, dtype=np.float64)
    duration = float(times_np[-1] - times_np[0]) / M
    tpl = _qp_template(M, duration, T // M)

    def const(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dtype)

    # --- Frenet projections ---
    seed_s, seed_d = lane_mod.frenet_of_point(
        lane_mod.lane_unsqueeze(lane, 1), forward_traj[..., 0:2])
    obs_s, obs_d = lane_mod.frenet_of_point(
        lane_mod.lane_unsqueeze(lane, 2), obs_trajs[..., 0:2])

    fs0 = lane_mod.frenet_of_state(lane, ego_state[..., 0:2],
                                   ego_state[..., 2], ego_state[..., 3])
    sdot0 = torch.clamp(fs0.s_dot, min=0.1)  # velocity_singularity_eps
    ddot0 = fs0.d_prime * fs0.s_dot
    last = forward_traj[..., -1, :]
    fsT = lane_mod.frenet_of_state(lane, last[..., 0:2], last[..., 2],
                                   last[..., 3])
    sdotT = torch.clamp(fsT.s_dot, min=0.1)
    ddotT = fsT.d_prime * fsT.s_dot

    build = (build_corridor_voxel if cfg.corridor_backend == "voxel"
             else functools.partial(build_corridor, cfg=cfg.corridor))
    corr = build(const(times_np), seed_s, seed_d, obs_s, obs_d,
                 geom_half_l, geom_half_w, obs_mask, M)

    # --- QP data, dims stacked as a batch of 2 (s, d) behind the plans ---
    Q = const(tpl.Q + cfg.weight_proximity * tpl.P)
    G = const(np.concatenate([tpl.A, tpl.C], axis=0))
    ref = torch.stack([seed_s[..., 1:], seed_d[..., 1:]], dim=-2)  # [.., 2, T]
    c_lin = -2.0 * cfg.weight_proximity * (ref @ const(tpl.Bref))

    zero = torch.zeros_like(sdot0)
    zeros_cont = torch.zeros(batch + (3 * (M - 1),), dtype=dtype, device=dev)
    b_s = torch.cat([zeros_cont, torch.stack([fs0.s, sdot0, zero], -1),
                     torch.stack([seed_s[..., -1], sdotT], -1)], -1)
    b_d = torch.cat([zeros_cont, torch.stack([fs0.d, ddot0, zero], -1),
                     torch.stack([seed_d[..., -1], ddotT], -1)], -1)
    b = torch.stack([b_s, b_d], dim=-2)                      # [..., 2, m_eq]

    seg = torch.as_tensor(tpl.seg_of_pos_row, device=dev)
    kind = tpl.kind_of_row
    pos_row = torch.as_tensor(kind == 0, device=dev)

    def bounds(corr_b, v, a):
        return torch.where(pos_row, corr_b[..., seg],
                           const(np.where(kind == 1, v, a)))

    lo = torch.stack([bounds(corr.s_lb, cfg.v_lon[0], cfg.a_lon[0]),
                      bounds(corr.d_lb, cfg.v_lat[0], cfg.a_lat[0])], -2)
    hi = torch.stack([bounds(corr.s_ub, cfg.v_lon[1], cfg.a_lon[1]),
                      bounds(corr.d_ub, cfg.v_lat[1], cfg.a_lat[1])], -2)
    qp = admm_qp(Q, c_lin, G, torch.cat([b, lo], -1), torch.cat([b, hi], -1),
                 n_eq=tpl.n_eq, iters=cfg.qp_iters,
                 independent_dims=len(batch))

    ctrl = qp.x.reshape(batch + (2, M, N_ORD))
    spline = BezierSpline(ctrl=ctrl, t_lb=corr.t_lb, t_ub=corr.t_ub)
    feasible = ((corr.s_ub > corr.s_lb).all(-1)
                & (corr.d_ub > corr.d_lb).all(-1) & corr.seed_free
                & (qp.status != INFEASIBLE).all(-1))
    return SSCResult(spline=spline, corridor=corr, qp=qp, feasible=feasible)
