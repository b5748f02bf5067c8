"""Batched trajectory optimizer entry point (PolyTrajOptimizer::
OptimizeTrajectory, traj_optimizer.cpp:7-202, over a batch of scenarios).

Usage:
    solve = make_solver(cfg, dims, max_iterations=150, flags=EngineFlags.tuned())
    result = solve(scenario_batch, weights)     # SolveResult with [B] axis
    result = solve_with_retry(solve, scenario_batch, weights)

Engines (same per-lane algorithm):
  "fused": the whole-solve CUDA kernels for CUDA tensors (S <= 8, any
      Dims.Ns); CPU tensors run the plain round loop.
  "rounds": the plain PyTorch round loop on any device.
  "bminor": the batch-minor engine (ops/bcost objective by autograd,
      ops/blbfgs lockstep L-BFGS) on any device, any S with uniform N; its
      corridor term launches the K2/K3 kernels for CUDA tensors when
      OptConfig.corridor_backend is "auto" (the default) or "pallas".
  "vmap": the readable per-scenario reference (solve_one: cost.total_cost
      by autograd, lbfgs.minimize), plain PyTorch on any device, any S with
      uniform N; the only engine that takes OptConfig.ref_gradient_compat.
"""

from __future__ import annotations

import torch

from dftpav_tpu_torch import cost as cost_mod
from dftpav_tpu_torch import lbfgs, minco
from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
from dftpav_tpu_torch.types import Dims, Scenario, SolveResult, Weights


def clamp_boundary_states(scen: Scenario, w: Weights) -> Scenario:
    """Scale boundary velocity / acceleration below the per-direction
    limits (traj_optimizer.cpp:54-76). Works with or without a leading
    batch axis."""
    fwd = scen.singul > 0

    def lim(a, b):
        full = lambda v: torch.full(fwd.shape, float(v),
                                    dtype=scen.ini_state.dtype,
                                    device=fwd.device)
        return torch.where(fwd, full(a), full(b))

    max_vel = lim(w.max_forward_vel, w.max_backward_vel)
    max_acc = lim(w.max_forward_acc, w.max_backward_acc)

    def clamp(states, limit, col):
        v = states[..., col]
        n = torch.sqrt(torch.sum(v * v, dim=-1))
        scale = torch.where(n >= limit, (limit - 1e-2) / torch.clamp(
            n, min=1e-12), torch.ones_like(n))
        out = states.clone()
        out[..., col] = v * scale[..., None]
        return out

    ini, fin = scen.ini_state, scen.fin_state
    ini = clamp(clamp(ini, max_vel, 1), max_acc, 2)
    fin = clamp(clamp(fin, max_vel, 1), max_acc, 2)
    return scen._replace(ini_state=ini, fin_state=fin)


def solve_one(scen: Scenario, w: Weights, dims: Dims, cfg: PlannerConfig,
              max_iterations: int | None = None) -> SolveResult:
    """Solve each scenario of a batch (leaves with a leading [B]) on its
    own, in its dtype and on its device: the JAX package's per-scenario
    path, which it vmaps. Matmuls run in full float32 (TF32 off), as the
    JAX package traces this path under float32 matmul precision."""
    from dftpav_tpu_torch.ops import kcost

    kcost._no_tf32()
    return _solve_one(scen, w, dims, cfg, max_iterations)


def _solve_one(scen: Scenario, w: Weights, dims: Dims, cfg: PlannerConfig,
               max_iterations: int | None = None) -> SolveResult:
    scen = clamp_boundary_states(scen, w)
    x0 = cost_mod.initial_guess(scen, w, dims)              # [B, dim]

    scale = cfg.opt.cost_scale
    if cfg.opt.ref_gradient_compat:
        fun = cost_mod.ref_compat_value_and_grad(scen, w, dims, cfg, scale)
    else:
        def fun(x):
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                f = scale * cost_mod.total_cost(xg, scen, w, dims, cfg)[0]
                (g,) = torch.autograd.grad(f.sum(), xg)
            return f.detach(), g
    res = lbfgs.minimize(fun, x0, cfg.opt.lbfgs,
                         max_iterations=max_iterations)

    u = cost_mod.unpack(res.x, dims)
    T = cost_mod.virtual_to_real(u.vt, w.mini_t)
    dT = T / dims.N
    heads, tails = cost_mod.boundary_states(scen, u, w, dims)
    coeffs = minco.generate(u.inner, dT, heads, tails,
                            minco.maps_as(dims.N, res.x.dtype, res.x.device))

    cost = res.f / scale
    success = (res.status >= 0) & (cost < cfg.opt.reject_cost)
    return SolveResult(coeffs=coeffs, dT=dT, cost=cost, n_iters=res.n_iters,
                       status=res.status, success=success)


def minimize_bminor(batch: Scenario, w: Weights, dims: Dims,
                    cfg: PlannerConfig, max_iterations: int | None = None):
    """The batch-minor solve up to the optimized variables: clamp, initial
    guess, then ops/blbfgs.minimize_b on the scaled objective
    ops/bcost.total_cost_b with its autograd gradient. Returns the
    batch-minor scenario and the lbfgs.Result (x [dim, B])."""
    from dftpav_tpu_torch.ops import bcost, blbfgs, kcost

    kcost._no_tf32()
    batch = clamp_boundary_states(batch, w)
    x0 = cost_mod.initial_guess(batch, w, dims)             # [B, dim]
    bm = bcost.to_bminor(batch)
    scale = cfg.opt.cost_scale

    def fun(xT):
        with torch.enable_grad():
            xg = xT.detach().requires_grad_(True)
            fs = scale * bcost.total_cost_b(xg, bm, w, dims, cfg)[0]
            (g,) = torch.autograd.grad(fs.sum(), xg)
        return fs.detach(), g

    return bm, blbfgs.minimize_b(fun, x0.T.contiguous(), cfg.opt.lbfgs,
                                 max_iterations=max_iterations)


def solve_batch_bminor(batch: Scenario, w: Weights, dims: Dims,
                       cfg: PlannerConfig,
                       max_iterations: int | None = None) -> SolveResult:
    """Batch solve in the batch-minor layout, in the batch's dtype and on
    its device: every tensor carries the scenario batch as its trailing
    axis, and every lane steps in lockstep (minimize_bminor); then the
    MINCO coefficients of the optimized variables."""
    from dftpav_tpu_torch.ops import bcost

    bm, res = minimize_bminor(batch, w, dims, cfg, max_iterations)
    u = bcost.unpack_b(res.x, dims)
    T = cost_mod.virtual_to_real(u.vt, w.mini_t)            # [S, B]
    dT = T / dims.N
    heads, tails = bcost.boundary_states_b(bm, u, w, dims)
    maps = minco.maps_as(dims.N, res.x.dtype, res.x.device)
    coeffs = bcost.generate_b(u.inner, dT, heads, tails, maps)
    cost = res.f / cfg.opt.cost_scale
    success = (res.status >= 0) & (cost < cfg.opt.reject_cost)
    return SolveResult(coeffs=torch.movedim(coeffs, -1, 0), dT=dT.T,
                       cost=cost, n_iters=res.n_iters, status=res.status,
                       success=success)


def make_solver(cfg: PlannerConfig, dims: Dims,
                max_iterations: int | None = None, engine: str = "fused",
                flags: EngineFlags | None = None):
    """Build a batched solver: (Scenario with leading [B], Weights) ->
    SolveResult. `flags` (the kcost engines' knobs, "fused" and "rounds")
    defaults to EngineFlags() (lbfgs.hpp parity semantics); benchmarks pass
    EngineFlags.tuned()."""
    from dftpav_tpu_torch.ops import pallas_solve

    if engine not in ("fused", "rounds", "bminor", "vmap"):
        raise ValueError(f"unknown engine {engine!r}: 'fused', 'rounds', "
                         "'bminor' or 'vmap'")
    if engine != "vmap" and cfg.opt.ref_gradient_compat:
        raise ValueError(
            "ref_gradient_compat (the reference's cross-segment time-grad "
            "quirk) is implemented only by the per-scenario engine; use "
            "make_solver(..., engine='vmap')")
    if dims.Ns is not None and engine not in ("rounds", "fused"):
        raise ValueError(
            "per-segment piece classes (Dims.Ns) are implemented by the "
            "kcost-based engines (rounds/fused); the bminor/vmap paths "
            "assume uniform N")
    if engine in ("bminor", "vmap"):
        one = solve_batch_bminor if engine == "bminor" else solve_one

        def solve_lanes(batch: Scenario, w: Weights):
            return one(batch, w, dims, cfg, max_iterations=max_iterations)

        return solve_lanes
    impl = {"fused": pallas_solve.solve_batch_fused,
            "rounds": pallas_solve.solve_batch_rounds}[engine]
    flags = flags or EngineFlags()

    def solve(batch: Scenario, w: Weights):
        return impl(batch, w, dims, cfg, max_iterations=max_iterations,
                    flags=flags)

    return solve


def solve_with_retry(solve, batch: Scenario, w: Weights,
                     time_scales=(1.6, 0.7), pad_to: int = 128):
    """Solve, then re-solve the failed lanes with their initial durations
    scaled by each of `time_scales` in turn, keeping each lane's first
    successful result (the init_T retry ladder).

    The reference retries hard instances (traj_manager.cpp:90-103) and
    keeps the previous trajectory when the optimizer fails
    (traj_server_ros.cpp:166-186); most residual failures here are line
    searches stalled by a poor init_T, and a stretched or shrunk initial
    duration reaches another basin. The failed lanes are gathered on the
    batch's device into a batch padded to a multiple of `pad_to` (with
    copies of the first failed lane), re-solved, and scattered back; the
    count of failed lanes is the only value read back to the host per
    rung. `solve`: a (batch, w) -> SolveResult callable from make_solver.
    Returns a SolveResult on the batch's device."""
    res = solve(batch, w)
    out = list(res)
    success = res.success.clone()
    for scale in time_scales:
        idx = torch.nonzero(~success).flatten()
        n_fail = int(idx.numel())
        if n_fail == 0:
            break
        n = -(-n_fail // pad_to) * pad_to
        sel = torch.cat([idx, idx[:1].expand(n - n_fail)])
        sub = Scenario(*(a[sel] for a in batch))
        sub = sub._replace(init_T=sub.init_T * scale)
        r2 = solve(sub, w)
        ok2 = r2.success[:n_fail]
        fixed = idx[ok2]
        out = [_scatter_rows(o, fixed, f[:n_fail][ok2])
               for o, f in zip(out, r2)]
        success[fixed] = True
    return SolveResult(*out)._replace(success=success)


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """dst with rows idx replaced by `rows` (a copy)."""
    dst = dst.clone()
    dst[idx] = rows.to(dst.dtype)
    return dst
