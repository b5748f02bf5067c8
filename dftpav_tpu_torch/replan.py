"""Warm-started receding-horizon replanning for scenario batches.

Reference: TrajPlannerServer::Replan seeds each cycle from the executing
trajectory at now + Budget (0.5 s) to hide solve latency
(traj_server_ros.cpp:406-501, traj_server_ros.h:58). For a batch: take the
previous SolveResult, advance every lane's start state along its own
optimized trajectory by the replan period, and reuse the previous inner
waypoints and durations as the next initial guess, which every engine packs
through cost.initial_guess. Warm starts cut the L-BFGS iterations several
times over.

Every function takes the batch as the leading [B] axis of its tensors and
works in plain tensor operations on their device; nothing here reads a value
back to the host. `dt_shift` is a number or a [B] tensor (per-lane seed
times, as the gated stream passes its lanes' ages).
"""

from __future__ import annotations

import numpy as np
import torch

from dftpav_tpu_torch import minco, solver
from dftpav_tpu_torch.config import PlannerConfig
from dftpav_tpu_torch.types import Dims, Scenario, SolveResult, Weights


def _lanes(t, like: torch.Tensor) -> torch.Tensor:
    """t (a number or a [B] tensor) as a [B] tensor of like's dtype."""
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    return t.expand(like.shape[0]) if t.dim() == 0 else t


def _pieces_at(coeffs, dT, t):
    """(piece coefficients [B, M, 6, 2], tau [B, M]) of the uniform
    N-piece trajectories coeffs [B, N, 6, 2] (per-piece duration dT [B]) at
    times t [B, M], clamped to [0, N dT]."""
    N = coeffs.shape[1]
    tc = torch.minimum(torch.clamp(t, min=0.0), (dT * N)[:, None])
    idx = torch.clamp((tc / dT[:, None]).to(torch.int64), 0, N - 1)
    tau = tc / dT[:, None] - idx.to(coeffs.dtype)
    lane = torch.arange(coeffs.shape[0], device=coeffs.device)[:, None]
    return coeffs[lane, idx], tau


def _eval_flat_state(coeffs, dT, t):
    """Flat PVA [B, 2, 3] of the segment trajectories coeffs [B, N, 6, 2]
    at times t [B]."""
    b, tau = _pieces_at(coeffs, dT, t[:, None])
    p, v, a = minco.eval_derivatives(b[:, 0], dT, tau[:, 0],
                                     orders=(0, 1, 2))
    return torch.stack([p, v, a], dim=-1)


def _resample_segment(coeffs, dT, start_t, n: int):
    """(inner [B, n-1, 2], T_rem [B]): the tail [start_t, end] of the
    uniform N-piece segments coeffs [B, N, 6, 2] re-pieced into n uniform
    pieces (the warm guess's inner waypoints on the remaining horizon)."""
    total = dT * coeffs.shape[1]
    T_rem = torch.clamp(total - start_t, min=n * 1e-2)
    fr = torch.arange(1, n, dtype=coeffs.dtype, device=coeffs.device) / n
    b, tau = _pieces_at(coeffs, dT, start_t[:, None] + fr * T_rem[:, None])
    (p,) = minco.eval_derivatives(b, dT[:, None], tau, orders=(0,))
    return p, T_rem


def prev_inner_guess(prev: SolveResult, dt_shift, dims: Dims):
    """Inner waypoints [B, 1, N-1, 2] of the previous solutions resampled on
    the remaining horizon: the warm initial guess."""
    dT0 = prev.dT[:, 0]
    p, _T = _resample_segment(prev.coeffs[:, 0], dT0, _lanes(dt_shift, dT0),
                              dims.N)
    return p[:, None]


def warm_start_scenario(scen: Scenario, prev: SolveResult, dt_shift,
                        w: Weights, dims: Dims) -> Scenario:
    """Advance single-segment scenarios by dt_shift along their previous
    solutions: the new head state is the previous trajectory at dt_shift
    (traj_server_ros.cpp:442-464 without FilterSingularityState); the
    initial guess reuses the previous inner waypoints and the remaining
    duration (floored at N * mini_t); the obstacle clock advances with the
    seed time (obstacle trajectories live in absolute time,
    traj_optimizer.cpp:1362-1389)."""
    coeffs0, dT0 = prev.coeffs[:, 0], prev.dT[:, 0]
    t = _lanes(dt_shift, dT0)
    ini = scen.ini_state.clone()
    ini[:, 0] = _eval_flat_state(coeffs0, dT0, t)
    init_T = scen.init_T.clone()
    init_T[:, 0] = torch.maximum(dT0 * dims.N - t,
                                 (dims.N * w.mini_t + 1e-3).to(t.dtype))
    return scen._replace(
        ini_state=ini, init_inner=prev_inner_guess(prev, t, dims),
        init_T=init_T,
        obs_rel_t0=scen.obs_rel_t0 + t.to(scen.obs_rel_t0.dtype)[:, None])


def _sample_fractions(n_s: int, K: int, Kdes: int) -> np.ndarray:
    """Per-slot sample fractions: entry [i*K1 + k] is the segment fraction
    (i + k/K_i)/n_s of sample k of piece i (pieces 0 and n_s-1 use Kdes
    columns, interior K: the basis.sample_grid layout); padded columns
    repeat the piece end."""
    K1 = max(K, Kdes) + 1
    out = np.zeros((n_s * K1,))
    for i in range(n_s):
        Ki = Kdes if i in (0, n_s - 1) else K
        for k in range(K1):
            out[i * K1 + k] = (i + min(k, Ki) / Ki) / n_s
    return out


def _rows_for_fracs(g, n_src: int, K: int, Kdes: int):
    """Source sample-row indices (piece*K1 + col layout) nearest to segment
    fractions g [..., R] for a source segment of n_src pieces."""
    K1 = max(K, Kdes) + 1
    gp = torch.clamp(g * n_src, 0.0, n_src - 1e-6)
    p = torch.floor(gp).to(torch.int64)
    tau = gp - p.to(g.dtype)
    edge = (p == 0) | (p == n_src - 1)
    Kp = torch.where(edge, torch.full_like(tau, float(Kdes)),
                     torch.full_like(tau, float(K)))
    col = torch.round(tau * Kp).to(torch.int64)
    return p * K1 + col


def warm_start_scenario_multigear(scen: Scenario, prev: SolveResult,
                                  dt_shift, w: Weights,
                                  dims: Dims) -> Scenario:
    """Advance multi-gear scenarios by dt_shift along their previous
    solutions (Replan seeds from the executing SingulTrajData at now +
    Budget, locating the active LocalTrajData by wall time,
    traj_server_ros.cpp:406-501 and traj_container's locate-by-time).

    Locates the gear segment that holds dt_shift, truncates it and shifts
    the remaining segments up: new segment 0 is the rest of the active
    segment (its head the trajectory's state at the seed time), later
    segments keep their previous solutions as warm guesses, and freed slots
    are masked padding (copies of the last real segment, as
    pipeline.ParkingPlanner pads). Each target slot s re-pieces its source
    segment at the slot's own piece count dims.ns_tuple[s] (inner waypoints
    at k/Ns[s] of the remaining duration), and corridor rows are remapped by
    trajectory fraction from the source segment's layout to the slot's, so
    per-segment piece classes (Dims.Ns) warm-start right when a segment
    moves into a slot of another count. Obstacle clocks advance by
    dt_shift."""
    S, N, K1, H = dims.S, dims.N, dims.K1, dims.H
    ns = dims.ns_tuple
    dtype, dev = prev.coeffs.dtype, prev.coeffs.device
    B = scen.seg_mask.shape[0]
    lane = torch.arange(B, device=dev)
    segw = scen.seg_mask
    M = segw.to(torch.int64).sum(dim=1)                    # valid segments
    Ts = torch.where(segw, prev.dT * N, torch.zeros_like(prev.dT))
    cum = torch.cumsum(Ts, dim=1)
    dt = _lanes(dt_shift, prev.dT[:, 0])
    t = torch.minimum(torch.clamp(dt, min=0.0), cum[:, -1] - 1e-3)
    last = torch.clamp(M - 1, min=0)
    j = torch.minimum((cum <= t[:, None]).to(torch.int64).sum(dim=1), last)
    before = cum[lane, torch.clamp(j - 1, min=0)]
    t_local = t - torch.where(j > 0, before, torch.zeros_like(before))

    slots = torch.arange(S, device=dev)
    idx_new = torch.minimum(j[:, None] + slots, last[:, None])   # [B, S]
    new_mask = (slots < (M - j)[:, None]) & segw[:, :1]

    # per-slot inner waypoints at the slot's own piece fractions; solution
    # coefficients are always on the uniform N-piece output grid
    # (pallas_solve._finalize), whatever the source segment's piecing
    zero_t = torch.zeros_like(t_local)
    flat_n = scen.corr_n.reshape(B, S, N * K1, H, 2)
    flat_p = scen.corr_p.reshape(B, S, N * K1, H, 2)
    flat_m = scen.corr_mask.reshape(B, S, N * K1, H)
    inner, T_new, cn, cp, cm = [], [], [], [], []
    for s in range(S):
        src = idx_new[:, s]
        start_t = t_local if s == 0 else zero_t
        dT_s = prev.dT[lane, src]
        p, T_rem = _resample_segment(prev.coeffs[lane, src], dT_s, start_t,
                                     ns[s])
        inner.append(torch.cat([p, p.new_zeros((B, N - ns[s], 2))], dim=1))
        T_new.append(T_rem)

        # corridor rows by segment fraction (the nearest source sample):
        # the slot's fraction f maps to start_frac + f (1 - start_frac) of
        # its source segment, whose row layout depends on its piece count
        start_frac = torch.clamp(
            start_t / torch.clamp(dT_s * N, min=1e-6), 0.0, 1.0)
        f_t = torch.as_tensor(_sample_fractions(ns[s], dims.K, dims.Kdes),
                              dtype=dtype, device=dev)
        g = start_frac[:, None] + f_t * (1.0 - start_frac[:, None])
        rows = _rows_for_fracs(g, ns[0], dims.K, dims.Kdes)
        for jc in range(1, S):
            rows = torch.where(src[:, None] == jc,
                               _rows_for_fracs(g, ns[jc], dims.K, dims.Kdes),
                               rows)
        pad = N * K1 - rows.shape[1]
        rows = torch.cat([rows, rows.new_zeros((B, pad))], dim=1)
        at = (lane[:, None], src[:, None], rows)
        cn.append(flat_n[at])
        cp.append(flat_p[at])
        m = flat_m[at]
        if pad:
            valid = torch.arange(N * K1, device=dev) < (N * K1 - pad)
            m = m & valid[None, :, None]
        cm.append(m)

    ini = scen.ini_state[lane[:, None], idx_new]
    ini[:, 0] = _eval_flat_state(prev.coeffs[lane, j], prev.dT[lane, j],
                                 t_local)
    return scen._replace(
        ini_state=ini,
        fin_state=scen.fin_state[lane[:, None], idx_new],
        init_inner=torch.stack(inner, dim=1),
        init_T=torch.maximum(torch.stack(T_new, dim=1),
                             (N * w.mini_t + 1e-3).to(dtype)),
        singul=scen.singul[lane[:, None], idx_new],
        seg_mask=new_mask,
        corr_n=torch.stack(cn, dim=1).reshape(B, S, N, K1, H, 2),
        corr_p=torch.stack(cp, dim=1).reshape(B, S, N, K1, H, 2),
        corr_mask=torch.stack(cm, dim=1).reshape(B, S, N, K1, H),
        obs_rel_t0=scen.obs_rel_t0
        + dt.to(scen.obs_rel_t0.dtype)[:, None])


def check_replan_batch(scen: Scenario, prev: SolveResult, age, w: Weights,
                       dims: Dims, cfg: PlannerConfig,
                       horizon_s: float = 3.0, step_s: float = 0.05,
                       near_end_s: float = 1.5) -> torch.Tensor:
    """Batched CheckReplan: [B] bool, True where a lane must re-solve.

    The reference replans only when needed (traj_server_ros.cpp:359-402):
    no executing trajectory, the trajectory nearly exhausted, or a
    collision found sweeping the executing trajectory at 0.05 s
    granularity against the current environment. Batched equivalents:
      * failed or absent solve: ~prev.success;
      * near end AND the goal moved: remaining duration (from per-lane
        `age` [B], the execution time since the lane's last solve) below
        near_end_s while the trajectory's end no longer matches the
        scenario goal (the reference's is_near && target_moved,
        traj_server_ros.cpp:373-380: a lane parked at a static goal never
        re-solves);
      * collision sweep: the trajectory sampled every step_s over the next
        horizon_s against (a) the lane's dynamic obstacles, center distance
        below half the vehicle length, and (b) its static corridor, a
        sample more than 0.3 m outside a half-plane of its corridor row
        (the map itself lives on the host). S == 1 classes.
    """
    if dims.S != 1:
        raise ValueError("check_replan_batch: S == 1 classes")
    coeffs, dT = prev.coeffs[:, 0], prev.dT[:, 0]
    dtype, dev = coeffs.dtype, coeffs.device
    B, N = coeffs.shape[0], dims.N
    lane = torch.arange(B, device=dev)
    age = _lanes(age, dT)
    total = dT * N
    need = ~prev.success
    (end_pos,) = minco.eval_derivatives(coeffs[:, N - 1], dT,
                                        torch.ones_like(dT), orders=(0,))
    goal = scen.fin_state[:, -1, :, 0]
    target_moved = torch.sum((end_pos - goal) ** 2, dim=-1) > 0.1 ** 2
    need = need | ((total - age < near_end_s) & target_moved)

    n_t = int(round(horizon_s / step_s))
    ts = age[:, None] + step_s * torch.arange(1, n_t + 1, dtype=dtype,
                                              device=dev)
    live = ts < total[:, None]
    tc = torch.minimum(torch.clamp(ts, min=0.0), total[:, None])
    b, tau = _pieces_at(coeffs, dT, ts)
    (p,) = minco.eval_derivatives(b, dT[:, None], tau, orders=(0,))

    if dims.O > 0:
        # (a) dynamic obstacles: piecewise-quintic position at absolute
        # time, constant past the end; a center distance below half a
        # vehicle length means the planned clearance is gone (a cheap
        # extra trigger: the reference sweeps only the static map)
        obs_t = scen.obs_rel_t0[:, :, None] + ts[:, None]          # [B, O, M]
        ft = torch.clamp(obs_t / scen.obs_dt[:, :, None], 0.0,
                         dims.Po - 1e-4)
        pi = torch.clamp(torch.floor(ft).to(torch.int64), 0, dims.Po - 1)
        ptau = ft - pi.to(dtype)
        co = scen.obs_coef[lane[:, None, None],
                           torch.arange(dims.O, device=dev)[None, :, None],
                           pi]                               # [B, O, M, 6, 2]
        powers = ptau[..., None] ** torch.arange(6, dtype=dtype, device=dev)
        op = torch.einsum("bomk,bomkd->bomd", powers, co)
        d2 = torch.sum((op - p[:, None]) ** 2, dim=-1)
        hit = ((d2 < (0.5 * cfg.vehicle.length) ** 2)
               & scen.obs_mask[:, :, None] & live[:, None])
        need = need | hit.flatten(1).any(dim=1)

    # (b) static corridor containment: the sample row by trajectory
    # fraction; the center must satisfy the row's half-planes (+ margin)
    frac = torch.clamp(tc / torch.clamp(total, min=1e-6)[:, None], 0.0,
                       1.0 - 1e-6)
    gp = frac * N
    pc = torch.floor(gp).to(torch.int64)
    ptau2 = gp - pc.to(dtype)
    edge = (pc == 0) | (pc == N - 1)
    Kp = torch.where(edge, torch.full_like(ptau2, float(dims.Kdes)),
                     torch.full_like(ptau2, float(dims.K)))
    col = torch.round(ptau2 * Kp).to(torch.int64)
    at = (lane[:, None], 0, pc, col)
    cn, cp, cm = scen.corr_n[at], scen.corr_p[at], scen.corr_mask[at]
    viol = torch.sum(cn * (p[:, :, None, :] - cp), dim=-1)       # [B, M, H]
    out = torch.any((viol > 0.3) & cm, dim=-1) & live
    return need | out.any(dim=1)


def make_gated_replanner(cfg: PlannerConfig, dims: Dims, dt_shift: float,
                         max_iterations: int = 50, engine: str = "fused",
                         flags=None, capacity: float = 0.5,
                         check_kwargs: dict | None = None):
    """Gated batched replan stream: only lanes whose CheckReplan fires are
    re-solved; the rest keep executing their previous solution.

    State rides in (batch, prev, age): the scenario each lane last solved,
    its SolveResult, and the per-lane execution age [B] (seconds since that
    solve). Each tick every lane ages by dt_shift; the lanes that
    check_replan_batch flags are gathered (a stable argsort on the device)
    into a sub-batch of n_cap lanes, a static replan budget like the
    reference's one solve per cycle, warm-started from their own solutions,
    re-solved, and written back (a masked index write) with age 0. Lanes
    flagged beyond the budget retry next tick. Nothing is read back to the
    host: B and n_cap are the only host values.

    Returns step(batch, prev, age, w) -> (batch', prev', age', n_need), with
    n_need the count of flagged lanes as a device tensor.
    """
    if dims.S != 1:
        raise ValueError("gated stream: S == 1 classes")
    tb = 128
    ck = check_kwargs or {}
    base = solver.make_solver(cfg, dims, max_iterations=max_iterations,
                              engine=engine, flags=flags)

    def step(batch: Scenario, prev: SolveResult, age, w: Weights):
        B = batch.ini_state.shape[0]
        n_cap = min(B, max(tb, int(round(capacity * B / tb)) * tb))
        age_n = age + dt_shift
        need = check_replan_batch(batch, prev, age_n, w, dims, cfg, **ck)
        order = torch.argsort((~need).to(torch.int32), stable=True)
        idx = order[:n_cap]
        shifted = warm_start_scenario(Scenario(*(a[idx] for a in batch)),
                                      SolveResult(*(a[idx] for a in prev)),
                                      age_n[idx], w, dims)
        res = base(shifted, w)
        sel = need[idx]                                  # actually replanned

        def put(dst, new):
            out = dst.clone()
            keep = sel.reshape((-1,) + (1,) * (new.dim() - 1))
            out[idx] = torch.where(keep, new.to(dst.dtype), dst[idx])
            return out

        batch2 = Scenario(*(put(d, n) for d, n in zip(batch, shifted)))
        prev2 = SolveResult(*(put(d, n) for d, n in zip(prev, res)))
        age2 = put(age_n, torch.zeros_like(age_n[idx]))
        return batch2, prev2, age2, need.to(torch.int32).sum()

    return step


def make_replanner(cfg: PlannerConfig, dims: Dims, dt_shift: float,
                   max_iterations: int = 50, engine: str = "fused",
                   flags=None):
    """Replan step: (Scenario[B], SolveResult[B], Weights) ->
    (shifted Scenario[B], SolveResult[B]).

    Each call advances every lane along its own previous solution by
    dt_shift and re-solves warm-started: the batched 20 Hz
    PlanCycleCallback loop (traj_server_ros.cpp:116-192); call it in a host
    loop for a replan stream. Multi-gear classes (dims.S > 1) advance along
    the whole SingulTrajData, crossing gear boundaries as the seed time
    passes them. `engine` and `flags` go to solver.make_solver (default
    "fused": kernels A and B for CUDA tensors); the warm guess rides in the
    shifted scenario's init_inner / init_T."""
    warm = (warm_start_scenario if dims.S == 1
            else warm_start_scenario_multigear)
    base = solver.make_solver(cfg, dims, max_iterations=max_iterations,
                              engine=engine, flags=flags)

    def step(batch: Scenario, prev: SolveResult, w: Weights):
        shifted = warm(batch, prev, dt_shift, w, dims)
        return shifted, base(shifted, w)

    return step
