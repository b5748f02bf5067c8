"""L-BFGS return codes (lbfgs.hpp / traj_optimizer.cpp:176-188).

The solver itself lives in ops/pallas_solve.py (plain round loop) and
csrc/solve.cuh (the CUDA kernel); both report these codes.
"""

from __future__ import annotations


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
