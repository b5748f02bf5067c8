"""Batched trajectory optimizer entry point (PolyTrajOptimizer::
OptimizeTrajectory, traj_optimizer.cpp:7-202, over a batch of scenarios).

Usage:
    solve = make_solver(cfg, dims, max_iterations=150, flags=EngineFlags.tuned())
    result = solve(scenario_batch, weights)     # SolveResult with [B] axis

Engines (same per-lane algorithm):
  "fused": the whole-solve CUDA kernel for CUDA tensors; CPU tensors run
      the plain round loop.
  "rounds": the plain PyTorch round loop on any device.
"""

from __future__ import annotations

import torch

from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
from dftpav_tpu_torch.types import Dims, Scenario, Weights


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


def make_solver(cfg: PlannerConfig, dims: Dims,
                max_iterations: int | None = None, engine: str = "fused",
                flags: EngineFlags | None = None):
    """Build a batched solver: (Scenario with leading [B], Weights) ->
    SolveResult. `flags` defaults to EngineFlags() (lbfgs.hpp parity
    semantics); benchmarks pass EngineFlags.tuned()."""
    from dftpav_tpu_torch.ops import kcost, pallas_solve

    kcost.check_class(dims)
    flags = flags or EngineFlags()
    impl = {"fused": pallas_solve.solve_batch_fused,
            "rounds": pallas_solve.solve_batch_rounds}.get(engine)
    if impl is None:
        raise ValueError(f"unknown engine {engine!r}: 'fused' or 'rounds' "
                         "(the other JAX engines are ROADMAP.md Queue 1 "
                         "item 9)")

    def solve(batch: Scenario, w: Weights):
        return impl(batch, w, dims, cfg, max_iterations=max_iterations,
                    flags=flags)

    return solve
