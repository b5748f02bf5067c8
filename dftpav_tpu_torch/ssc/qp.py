"""Batched dense QP solver (OSQP-style ADMM), the OOQP-interface equivalent
(the port of `dftpav_tpu/ssc/qp.py`).

Solves  min 0.5 x'Qx + c'x  s.t.  l <= Gx <= u  (the first n_eq rows
equalities) by ADMM over G, which is batched matmuls and clips:

    x+ = solve[(Q + sigma I + rho G'G)] (sigma x - c + G'(rho z - y))
    z+ = clip(G x+ + y / rho, l, u)
    y+ = y + rho (G x+ - z+)

The (n x n) system matrix is factored once per solve (torch.linalg
lu_factor; once in all when Q and G carry no batch dims) and each iteration
is two triangular solves. The loop exits when the primal and dual residuals
drop below their tolerances or at the iteration cap, with a status code
SOLVED / MAX_ITER / INFEASIBLE.

Precision. The solve runs in float64 whatever the inputs' dtype, and its
outputs come back in that dtype. At the urban demo's class the system
matrix's condition number is ~2e6 and the stiff equality rows (rho 1e3)
carry positions of ~100 m, so float32 ADMM sits at its noise floor: its
outcome there depended on the LAPACK's rounding (JAX's float32 demo on the
CPU: SSC feasible 0.84; the same loop through PyTorch's float32 LU: 0.15,
and with only the solve in float64 the ego's speed ran to the 50 m/s
bound), while float64 converges in ~27 iterations. The problems are tiny,
so float64 costs the card no more time than float32.

Exit semantics. Called with batch dims, JAX's `lax.while_loop` steps every
problem until all are done, so `n_iters` is shared; under `jax.vmap` (how
JAX batches plans) each vmapped entry freezes at its own exit and keeps its
own count. `independent_dims` gives the port both: the first
`independent_dims` batch dims freeze entry by entry (vmap's semantics), the
rest share one exit (the batch-dims semantics). A frozen entry does not move,
so the exit is tested on the host only every `_CHECK_EVERY` iterations: the
same result as testing every iteration, with fewer waits for the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# status codes (ooqp SUCCESSFUL_TERMINATION / MAX_ITS_EXCEEDED / INFEASIBLE)
SOLVED, MAX_ITER, INFEASIBLE = 0, 1, 2

_CHECK_EVERY = 10   # iterations between host-side exit tests


class QPResult(NamedTuple):
    x: torch.Tensor           # [..., n]
    primal_res: torch.Tensor  # [...] max |Gx - z|
    dual_res: torch.Tensor    # [...] max |rho G'(z_prev - z)|
    eq_res: torch.Tensor      # [...] max |Ax - b| rows
    n_iters: torch.Tensor     # [...] int32 ADMM iterations executed
    status: torch.Tensor      # [...] int32 SOLVED / MAX_ITER / INFEASIBLE


def _vecmat(v, M):
    """v [..., m] times M [..., m, n] -> [..., n]."""
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def admm_qp(Q, c, G, l, u, n_eq: int, iters: int = 100, rho: float = 1.0,
            sigma: float = 1e-6, rho_eq_scale: float = 1e3,
            eps_primal: float = 1e-3, eps_dual: float = 1e-3,
            eps_infeasible: float = 1e-1,
            independent_dims: int = 0) -> QPResult:
    """Solve min 0.5 x'Qx + c'x s.t. l <= Gx <= u (first n_eq rows equality).

    Q [..., n, n], c [..., n], G [..., m, n], l/u [..., m] broadcast over
    the batch. Equality rows use a stiffer rho. Status is INFEASIBLE when
    the primal residual is still above eps_infeasible at exit. The first
    `independent_dims` batch dims stop entry by entry (as `jax.vmap` of the
    one-problem call), the others share the exit (as JAX's batch dims);
    `n_iters` is per entry of the first, broadcast over the others.
    """
    out_dtype = Q.dtype
    Q, c, G, l, u = (a.double() for a in (Q, c, G, l, u))
    n = Q.shape[-1]
    m = G.shape[-2]
    dtype, dev = Q.dtype, Q.device
    batch = torch.broadcast_shapes(Q.shape[:-2], c.shape[:-1],
                                   G.shape[:-2], l.shape[:-1], u.shape[:-1])
    group = batch[:independent_dims]
    rho_vec = torch.cat([
        torch.full((n_eq,), rho * rho_eq_scale, dtype=dtype, device=dev),
        torch.full((m - n_eq,), rho, dtype=dtype, device=dev)])
    GtRG = G.mT @ (rho_vec[:, None] * G)
    K = Q + sigma * torch.eye(n, dtype=dtype, device=dev) + GtRG
    lu, piv = torch.linalg.lu_factor(K)
    if K.dim() == 2:
        def solve(rhs):  # one factor for all: the batch as columns
            cols = rhs.reshape(-1, n).T
            return torch.linalg.lu_solve(lu, piv, cols).T.reshape(rhs.shape)
    else:
        def solve(rhs):
            return torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]

    x = torch.zeros(batch + (n,), dtype=dtype, device=dev)
    z = torch.minimum(torch.clamp(l, min=0.0), u).expand(
        batch + (m,)).clone()
    y = torch.zeros_like(z)
    primal = torch.full(batch, torch.inf, dtype=dtype, device=dev)
    dual = torch.full(batch, torch.inf, dtype=dtype, device=dev)
    k = torch.zeros(group, dtype=torch.int32, device=dev)
    shared = len(batch) - len(group)

    def pending(primal, dual, k):
        """[group] bool: the entry has not exited (while_loop's cond)."""
        todo = ~((primal < eps_primal) & (dual < eps_dual))
        if shared:
            todo = todo.flatten(len(group)).any(-1)
        return todo & (k < iters)

    run = pending(primal, dual, k)
    for it in range(iters):
        if it % _CHECK_EVERY == 0 and it and not bool(run.any()):
            break
        rhs = sigma * x - c + _vecmat(rho_vec * z - y, G)
        x_n = solve(rhs)
        Gx = _vecmat(x_n, G.mT)
        z_n = torch.minimum(torch.maximum(Gx + y / rho_vec, l), u)
        y_n = y + rho_vec * (Gx - z_n)
        p_n = (Gx - z_n).abs().amax(-1)
        d_n = _vecmat(rho_vec * (z - z_n), G).abs().amax(-1)
        r = run.reshape(group + (1,) * shared)
        x = torch.where(r[..., None], x_n, x)
        z = torch.where(r[..., None], z_n, z)
        y = torch.where(r[..., None], y_n, y)
        primal = torch.where(r, p_n, primal)
        dual = torch.where(r, d_n, dual)
        k = k + run.to(torch.int32)
        run = pending(primal, dual, k)

    Gx = _vecmat(x, G.mT)
    eq_res = ((Gx[..., :n_eq] - l[..., :n_eq]).abs().amax(-1) if n_eq > 0
              else torch.zeros(batch, dtype=dtype, device=dev))
    converged = (primal < eps_primal) & (dual < eps_dual)
    status = torch.where(converged, SOLVED,
                         torch.where(primal > eps_infeasible, INFEASIBLE,
                                     MAX_ITER)).to(torch.int32)
    n_iters = k.reshape(group + (1,) * shared).expand(batch)
    return QPResult(x=x.to(out_dtype), primal_res=primal.to(out_dtype),
                    dual_res=dual.to(out_dtype), eq_res=eq_res.to(out_dtype),
                    n_iters=n_iters, status=status)
