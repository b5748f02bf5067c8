"""L-BFGS return codes (lbfgs.hpp / traj_optimizer.cpp:176-188) and the
per-lane result of ops/blbfgs.minimize_b.

The solvers live in ops/blbfgs.py (batch-minor L-BFGS), ops/pallas_solve.py
(plain round loop) and csrc/solve.cuh (the CUDA kernel); all report these
codes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Status:
    """Return codes; nonnegative = usable result."""

    CONVERGENCE = 0   # gnorm test
    STOP = 1          # past-delta test
    MAXITER = 2       # iteration cap (treated as success by the planner)
    MAXLS = 3         # line-search eval cap (treated as success by the planner)
    RUNNING = 99
    ERR_INVALID_FUNCVAL = -1
    ERR_WIDTHTOOSMALL = -2
    ERR_MINSTEP = -3
    ERR_MAXSTEP = -4
    ERR_INCREASEGRADIENT = -5

    @staticmethod
    def ok(status):
        return status >= 0


class Result(NamedTuple):
    """Solver output; every field carries the trailing lane axis [B]."""

    x: torch.Tensor          # [D, B]
    f: torch.Tensor
    g: torch.Tensor          # [D, B]
    n_iters: torch.Tensor    # int32
    n_evals: torch.Tensor    # int32
    status: torch.Tensor     # int32 Status codes
