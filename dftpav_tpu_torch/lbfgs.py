"""L-BFGS with Lewis-Overton line search for the per-scenario (vmap)
engine, its return codes (lbfgs.hpp / traj_optimizer.cpp:176-188) and the
per-lane result.

`minimize` is `dftpav_tpu/lbfgs.py minimize` (lbfgs_optimize, lbfgs.hpp:440)
over a batch of independent problems: the JAX package writes it for one
problem and vmaps it, and under vmap every lane keeps its own iteration and
line-search counts and exits on its own. ops/blbfgs.minimize_b is that
per-lane algorithm with masks (a lane that is not running is pre-accepted
and never moves), so `minimize` runs it with the lanes as the trailing axis.

The other solvers live in ops/pallas_solve.py (plain round loop) and
csrc/solve.cuh (the CUDA kernel); all report these codes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dftpav_tpu_torch.config import LBFGSParams


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
    """Solver output per lane [B]; x and g are [D, B] from
    ops/blbfgs.minimize_b and [B, D] from minimize."""

    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    n_iters: torch.Tensor    # int32
    n_evals: torch.Tensor    # int32
    status: torch.Tensor     # int32 Status codes


def minimize(fun: Callable, x0: torch.Tensor, p: LBFGSParams,
             max_iterations: int | None = None) -> Result:
    """Minimize each row of x0 [B, D] on its own: fun(x [B, D]) ->
    (f [B], g [B, D]), each lane's gradient its own. One problem x0 [D]
    takes fun(x [D]) -> (f, g [D]). Returns x and g shaped as x0 and per
    lane f, n_iters, n_evals and status."""
    from dftpav_tpu_torch.ops.blbfgs import minimize_b

    if x0.dim() == 1:
        def fun_b(xT):
            f, g = fun(xT[:, 0])
            return f.reshape(1), g[:, None]

        r = minimize_b(fun_b, x0[:, None], p, max_iterations)
        return Result(*(a[..., 0] for a in r))

    def fun_b(xT):
        f, g = fun(xT.T)
        return f, g.T

    r = minimize_b(fun_b, x0.T.contiguous(), p, max_iterations)
    return Result(x=r.x.T, f=r.f, g=r.g.T, n_iters=r.n_iters,
                  n_evals=r.n_evals, status=r.status)
