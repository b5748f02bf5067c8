"""Batch-minor L-BFGS with Lewis-Overton line search: one solver per lane,
the lanes as the trailing axis of every tensor.

Same algorithm and iterate path as `dftpav_tpu.ops.blbfgs` (lbfgs.hpp
semantics). Per-lane control flow is masking: a lane that is not running
enters each line search pre-accepted and never moves, so the inner loop
runs only as long as the slowest running lane; both loops run while any
lane is live, and each such test is one host sync. Every objective
evaluation covers all lanes.

The evaluation callback maps x [D, B] -> (f [B], g [D, B]).
"""

from __future__ import annotations

from typing import Callable

import torch

from dftpav_tpu_torch.config import LBFGSParams
from dftpav_tpu_torch.lbfgs import Result, Status


def _dot(a, b):
    """Decision-space dot product [D, B] x [D, B] -> [B]."""
    return torch.sum(a * b, dim=0)


def _line_search(fun, xp, gp, d, f0, stp0, p: LBFGSParams, active0):
    """Lewis-Overton weak-Wolfe search (lbfgs.hpp:276-389) on every lane at
    once. Lanes with active0 False start accepted and keep their point.
    Returns (x, f, g, count, code) with code 1 on acceptance, 2 when the
    trial cap was hit, a negative Status.ERR_* otherwise."""
    B = xp.shape[-1]
    dev = xp.device
    dginit = _dot(gp, d)
    dgtest = p.f_dec_coeff * dginit
    dstest = p.s_curv_coeff * dginit
    finit = f0

    x, f, g = xp, f0, gp
    stp = torch.zeros_like(f0) + stp0
    mu = torch.zeros_like(f0)
    nu = torch.full_like(f0, p.max_step)
    brackt = torch.zeros(B, dtype=torch.bool, device=dev)
    touched = torch.zeros(B, dtype=torch.bool, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    code = torch.where(
        active0, torch.where(dginit > 0.0, Status.ERR_INCREASEGRADIENT, 0),
        1).to(torch.int32)

    while bool(torch.any(code == 0)):
        act = code == 0
        x_try = xp + stp * d
        f_try, g_try = fun(x_try)
        # lanes that are done keep their carry
        x = torch.where(act, x_try, x)
        f = torch.where(act, f_try, f)
        g = torch.where(act, g_try, g)
        count = count + act.to(torch.int32)

        bad_f = ~torch.isfinite(f_try)
        if p.past > 0:
            early = (torch.abs(finit - f_try) / (torch.abs(finit) + 1.0)
                     < p.delta / max(p.past, 1))
        else:
            early = torch.zeros_like(act)
        armijo_fail = bad_f | (f_try > finit + stp * dgtest)
        wolfe_fail = _dot(g_try, d) < dstest

        nu = torch.where(act & armijo_fail, stp, nu)
        brackt = brackt | (act & armijo_fail)
        mu = torch.where(act & ~armijo_fail & wolfe_fail, stp, mu)

        accept = (early & ~bad_f) | (~armijo_fail & ~wolfe_fail)
        code = torch.where(act & accept, 1, code)
        cont = code == 0
        code = torch.where(cont & (count >= p.max_linesearch), 2, code)
        code = torch.where(cont & brackt & ((nu - mu) < p.machine_prec * nu),
                           Status.ERR_WIDTHTOOSMALL, code)
        stp_n = torch.where(brackt, 0.5 * (mu + nu), stp * 2.0)
        code = torch.where((code == 0) & (stp_n < p.min_step),
                           Status.ERR_MINSTEP, code)
        over = stp_n > p.max_step
        code = torch.where((code == 0) & over & touched, Status.ERR_MAXSTEP,
                           code)
        touched = touched | (act & over)
        stp_n = torch.where(over, torch.full_like(stp_n, p.max_step), stp_n)
        stp = torch.where(act, stp_n, stp)
    return x, f, g, count, code


def _two_loop(g, lm_s, lm_y, lm_ys, bound, ys, yy):
    """L-BFGS two-loop recursion (lbfgs.hpp:709-741) over the newest-first
    history [m, D, B]; entries at or past `bound` are dead."""
    m = lm_s.shape[0]
    zero = torch.zeros_like(ys)
    d = -g
    alphas = []
    for i in range(m):
        a = torch.where(i < bound, _dot(lm_s[i], d) / lm_ys[i], zero)
        d = d - a * lm_y[i]
        alphas.append(a)
    d = d * (ys / yy)
    for i in range(m - 1, -1, -1):
        b = torch.where(i < bound, _dot(lm_y[i], d) / lm_ys[i], zero)
        d = d + (alphas[i] - b) * lm_s[i]
    return d


def minimize_b(fun: Callable, x0: torch.Tensor, p: LBFGSParams,
               max_iterations: int | None = None) -> Result:
    """Minimize every lane: fun(x [D, B]) -> (f [B], g [D, B]). The Result
    fields carry the trailing [B] (x and g are [D, B])."""
    dtype, dev = x0.dtype, x0.device
    m = p.mem_size
    past = max(p.past, 1)
    max_iter = p.max_iterations if max_iterations is None else max_iterations
    D, B = x0.shape

    f0, g0 = fun(x0)
    x, f, g, d = x0, f0, g0, -g0
    gnorm = torch.amax(torch.abs(g0), dim=0)
    xnorm = torch.amax(torch.abs(x0), dim=0)
    already = gnorm / torch.clamp(xnorm, min=1.0) < p.g_epsilon

    # the 1e-300 floors are those of the JAX package: 0 in float32
    step = 1.0 / torch.clamp(torch.sqrt(_dot(d, d)), min=1e-300)
    pf = torch.zeros((past, B), dtype=dtype, device=dev)
    pf[0] = f0
    lm_s = torch.zeros((m, D, B), dtype=dtype, device=dev)
    lm_y = torch.zeros((m, D, B), dtype=dtype, device=dev)
    lm_ys = torch.ones((m, B), dtype=dtype, device=dev)
    izero = torch.zeros(B, dtype=torch.int32, device=dev)
    bound, k, n_evals = izero, izero + 1, izero + 1
    status = torch.where(already, Status.CONVERGENCE,
                         Status.RUNNING).to(torch.int32)
    slots = torch.arange(past, device=dev)[:, None]

    while bool(torch.any(status == Status.RUNNING)):
        run = status == Status.RUNNING
        xp, gp = x, g
        x_ls, f_ls, g_ls, ls_count, ls_code = _line_search(
            fun, xp, gp, d, f, step, p, run)
        n_evals = n_evals + ls_count

        failed = (ls_code < 0) | (ls_code == 2)
        x = torch.where(run & ~failed, x_ls, xp)
        g = torch.where(run & ~failed, g_ls, gp)
        f = torch.where(run, f_ls, f)
        status = torch.where(
            run & (ls_code < 0), ls_code,
            torch.where(run & (ls_code == 2), Status.MAXLS, status))

        gnorm = torch.amax(torch.abs(g), dim=0)
        xnorm = torch.amax(torch.abs(x), dim=0)
        conv = gnorm / torch.clamp(xnorm, min=1.0) < p.g_epsilon
        status = torch.where((status == Status.RUNNING) & conv,
                             Status.CONVERGENCE, status)
        if p.past > 0:
            slot = (k % p.past).long()
            pf_slot = torch.gather(pf, 0, slot[None])[0]
            rate = torch.abs(pf_slot - f) / torch.clamp(torch.abs(f), min=1.0)
            stop = (k >= p.past) & (rate < p.delta)
            status = torch.where((status == Status.RUNNING) & stop,
                                 Status.STOP, status)
            newpf = torch.where(status == Status.RUNNING, f, pf_slot)
            pf = torch.where(slots == slot[None], newpf[None], pf)
        status = torch.where((status == Status.RUNNING) & (k >= max_iter),
                             Status.MAXITER, status).to(torch.int32)
        k = torch.where(status == Status.RUNNING, k + 1, k)

        s = x - xp
        y = g - gp
        ys = _dot(y, s)
        yy = _dot(y, y)
        cau = _dot(s, s) * torch.sqrt(_dot(gp, gp)) * p.cautious_factor
        do_update = (ys > cau) & (status == Status.RUNNING)

        lm_s = torch.where(do_update, torch.cat([s[None], lm_s[:-1]]), lm_s)
        lm_y = torch.where(do_update, torch.cat([y[None], lm_y[:-1]]), lm_y)
        lm_ys = torch.where(do_update, torch.cat([ys[None], lm_ys[:-1]]),
                            lm_ys)
        bound = torch.where(do_update, torch.clamp(bound + 1, max=m), bound)

        d_new = _two_loop(g, lm_s, lm_y, lm_ys, bound, ys,
                          torch.clamp(yy, min=1e-300))
        d = torch.where(run, torch.where(do_update, d_new, -g), d)
        step = torch.ones_like(f)

    return Result(x=x, f=f, g=g, n_iters=k, n_evals=n_evals, status=status)
