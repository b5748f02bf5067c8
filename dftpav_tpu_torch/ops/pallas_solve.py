"""The batched whole-solve: asynchronous-lane L-BFGS with Lewis-Overton line
search, as a plain PyTorch round loop and as a CUDA kernel.

Same per-lane algorithm as `dftpav_tpu.ops.pallas_solve` (lbfgs.hpp
semantics): every round evaluates each running lane's current trial point;
lanes whose trial satisfies Lewis-Overton accept and finish their iteration
(convergence and past-delta tests, cautious history update of m pairs,
two-loop direction) in the same round, the others bracket and retry.
Lanes advance independently, so a batch pays the mean trial count per
lane, not the max.

`solve_batch_fused` is the wrapper: for CUDA tensors it evaluates the
initial point with kernel A (kcost.eval_fg) and runs the whole round loop
with kernel B (csrc/kernels.cu `dftpav_solve_fused`, one warp per lane,
each lane exiting on its own; S <= 8 gear segments of 2 to 32 pieces each,
any L-BFGS memory m and past window); for CPU tensors it runs the plain
loop, any S and N. Every class runs in the layout of its kernel class
(embedded_class, kcost.KClass): a capacity of 8, 16 or 32 pieces per
segment, each segment's inner waypoints in the leading rows of its N - 1
and its corridor rows in the leading pieces, the rest zero and masked.
Those rows are inert (zero value and zero gradient), so the L-BFGS products
are the native class's and only float32 summation order differs; the
result is mapped back and finalized in the native class. The TPU's multi-phase lane
compaction has no counterpart: it re-gathered the stragglers of 128-lane
tiles that ran until their slowest lane finished, and was bit-identical
per lane to the unphased solve, so a kernel whose lanes exit individually
computes the same result without it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dftpav_tpu_torch import cost as cost_mod
from dftpav_tpu_torch import minco
from dftpav_tpu_torch.config import EngineFlags, LBFGSParams, PlannerConfig, \
    resolve_vt_scale
from dftpav_tpu_torch.lbfgs import Status
from dftpav_tpu_torch.ops import bcost, kcost
from dftpav_tpu_torch.ops.blbfgs import _dot, _two_loop
from dftpav_tpu_torch.ops.kcost import KConsts, KScenario, StaticW, dp_of
from dftpav_tpu_torch.types import Dims, Scenario, SolveResult, Weights


class RoundState(NamedTuple):
    """Per-lane solver state of the round loop (lane axis last)."""

    xp: torch.Tensor       # [DP, B] iteration base point
    fp: torch.Tensor       # [B]
    gp: torch.Tensor       # [DP, B]
    d: torch.Tensor        # [DP, B] search direction
    stp: torch.Tensor      # [B] current trial step
    finit: torch.Tensor    # [B] line-search constants
    dgtest: torch.Tensor
    dstest: torch.Tensor
    mu: torch.Tensor       # [B] bracket
    nu: torch.Tensor
    brackt: torch.Tensor   # [B] bool
    touched: torch.Tensor  # [B] bool
    lscnt: torch.Tensor    # [B] int32 line-search trials
    lm_s: torch.Tensor     # [m, DP, B] history, newest first
    lm_y: torch.Tensor     # [m, DP, B]
    lm_ys: torch.Tensor    # [m, B]
    bound: torch.Tensor    # [B] int32 live history entries
    k: torch.Tensor        # [B] int32 iteration counter (starts at 1)
    pf: torch.Tensor       # [past, B] past-f window
    n_evals: torch.Tensor  # [B] int32
    status: torch.Tensor   # [B] int32 Status codes


def _solve_rounds(x0, sc: KScenario, kc: KConsts, sw: StaticW, dims: Dims,
                  p: LBFGSParams, max_iter: int,
                  flags: EngineFlags | None = None) -> RoundState:
    """The round loop in plain PyTorch, on the device of x0. The raw state
    leaves k = max_iter + 1 on budget-capped lanes (they finish the state
    transition before MAXITER is marked); reporting paths clamp it."""
    flags = flags or EngineFlags()
    dtype, dev = x0.dtype, x0.device
    B = x0.shape[1]
    m, past = p.mem_size, max(p.past, 1)

    def fg(x):
        return kcost.eval_fg_plain(x, sc, kc, sw, dims, flags)

    f0, g0 = fg(x0)
    d0 = -g0
    gnorm = torch.amax(torch.abs(g0), dim=0)
    xnorm = torch.amax(torch.abs(x0), dim=0)
    already = gnorm / torch.clamp(xnorm, min=1.0) < p.g_epsilon
    dginit0 = _dot(g0, d0)
    zrow = torch.zeros(B, dtype=dtype, device=dev)
    izero = torch.zeros(B, dtype=torch.int32, device=dev)
    c = RoundState(
        xp=x0, fp=f0, gp=g0, d=d0,
        stp=1.0 / torch.clamp(torch.sqrt(_dot(d0, d0)), min=1e-30),
        finit=f0, dgtest=p.f_dec_coeff * dginit0,
        dstest=p.s_curv_coeff * dginit0,
        mu=zrow, nu=zrow + p.max_step,
        brackt=torch.zeros(B, dtype=torch.bool, device=dev),
        touched=torch.zeros(B, dtype=torch.bool, device=dev),
        lscnt=izero,
        lm_s=torch.zeros((m,) + x0.shape, dtype=dtype, device=dev),
        lm_y=torch.zeros((m,) + x0.shape, dtype=dtype, device=dev),
        lm_ys=torch.ones((m, B), dtype=dtype, device=dev),
        bound=izero, k=izero + 1,
        pf=torch.cat([f0[None], torch.zeros((past - 1, B), dtype=dtype,
                                            device=dev)]),
        n_evals=izero + 1,
        status=torch.where(already, Status.CONVERGENCE,
                           Status.RUNNING).to(torch.int32),
    )
    slots = torch.arange(past, device=dev)[:, None]

    while bool(torch.any(c.status == Status.RUNNING)):
        act = c.status == Status.RUNNING
        x_try = c.xp + c.stp * c.d
        f_try, g_try = fg(x_try)
        n_evals = c.n_evals + act.to(torch.int32)

        # Lewis-Overton decision (lbfgs.hpp:276-389)
        dg = _dot(g_try, c.d)
        bad = ~torch.isfinite(f_try)
        early = ((p.past > 0)
                 & (torch.abs(c.finit - f_try) / (torch.abs(c.finit) + 1.0)
                    < p.delta / past))
        armijo_fail = bad | (f_try > c.finit + c.stp * c.dgtest)
        wolfe_fail = dg < c.dstest
        accept = act & ((early & ~bad) | (~armijo_fail & ~wolfe_fail))
        cont = act & ~accept

        # bracket / step update for continuing lanes
        nu = torch.where(cont & armijo_fail, c.stp, c.nu)
        brackt_b = c.brackt | (cont & armijo_fail)
        mu = torch.where(cont & ~armijo_fail & wolfe_fail, c.stp, c.mu)
        lscnt = c.lscnt + cont.to(torch.int32)
        code = torch.where(cont & (lscnt >= p.max_linesearch), 2, izero)
        code = torch.where(cont & (code == 0) & brackt_b
                           & ((nu - mu) < p.machine_prec * nu),
                           Status.ERR_WIDTHTOOSMALL, code)
        stp_n = torch.where(brackt_b, 0.5 * (mu + nu), c.stp * 2.0)
        code = torch.where(cont & (code == 0) & (stp_n < p.min_step),
                           Status.ERR_MINSTEP, code)
        over = stp_n > p.max_step
        code = torch.where(cont & (code == 0) & over & c.touched,
                           Status.ERR_MAXSTEP, code)
        touched_b = c.touched | (cont & over)
        stp_n = torch.where(over, torch.full_like(stp_n, p.max_step), stp_n)
        ls_fail = cont & (code != 0)
        status = torch.where(
            ls_fail, torch.where(code == 2, Status.MAXLS, code), c.status)

        # iteration end for accepted lanes
        gnorm = torch.amax(torch.abs(g_try), dim=0)
        xnorm = torch.amax(torch.abs(x_try), dim=0)
        conv = gnorm / torch.clamp(xnorm, min=1.0) < p.g_epsilon
        status = torch.where(accept & conv, Status.CONVERGENCE, status)
        if p.past > 0:
            slot = (c.k % past).long()
            pf_slot = torch.gather(c.pf, 0, slot[None])[0]
            rate = torch.abs(pf_slot - f_try) / torch.clamp(
                torch.abs(f_try), min=1.0)
            stop = (c.k >= past) & (rate < p.delta)
            status = torch.where(accept & (status == Status.RUNNING) & stop,
                                 Status.STOP, status)
            newpf = torch.where(status == Status.RUNNING, f_try, pf_slot)
            pf = torch.where((slots == slot[None]) & accept[None],
                             newpf[None], c.pf)
        else:
            pf = c.pf
        # lanes still running finish the whole state transition, and only
        # then may be marked MAXITER (k reaches max_iter + 1 first)
        running = accept & (status == Status.RUNNING)
        k = torch.where(running, c.k + 1, c.k)

        # cautious history update + new direction
        s = x_try - c.xp
        y = g_try - c.gp
        ys = _dot(y, s)
        yy = _dot(y, y)
        cau = _dot(s, s) * torch.sqrt(_dot(c.gp, c.gp)) * p.cautious_factor
        do_up = running & (ys > cau)
        up = do_up[None, None]
        lm_s = torch.where(up, torch.cat([s[None], c.lm_s[:-1]]), c.lm_s)
        lm_y = torch.where(up, torch.cat([y[None], c.lm_y[:-1]]), c.lm_y)
        lm_ys = torch.where(do_up[None], torch.cat([ys[None], c.lm_ys[:-1]]),
                            c.lm_ys)
        bound = torch.where(do_up, torch.clamp(c.bound + 1, max=m), c.bound)
        d_new = _two_loop(g_try, lm_s, lm_y, lm_ys, bound, ys,
                          torch.clamp(yy, min=1e-30))
        d_next = torch.where(do_up[None], d_new, -g_try)
        d = torch.where(accept[None], d_next, c.d)

        # next line-search setup for accepted lanes
        dginit = _dot(g_try, d_next)
        status = torch.where(running & (dginit > 0.0),
                             Status.ERR_INCREASEGRADIENT, status)
        status = torch.where(running & (status == Status.RUNNING)
                             & (k > max_iter), Status.MAXITER, status)
        if flags.adaptive_step:
            # warm-start the next search from the accepted step
            stp_init = torch.clamp(c.stp * flags.adaptive_step_mult,
                                   flags.adaptive_step_lo, 1.0)
        else:
            stp_init = torch.ones_like(c.stp)
        c = RoundState(
            xp=torch.where(accept[None], x_try, c.xp),
            fp=torch.where(accept | ls_fail, f_try, c.fp),
            gp=torch.where(accept[None], g_try, c.gp),
            d=d,
            stp=torch.where(accept, stp_init,
                            torch.where(cont, stp_n, c.stp)),
            finit=torch.where(accept, f_try, c.finit),
            dgtest=torch.where(accept, p.f_dec_coeff * dginit, c.dgtest),
            dstest=torch.where(accept, p.s_curv_coeff * dginit, c.dstest),
            mu=torch.where(accept, zrow, mu),
            nu=torch.where(accept, zrow + p.max_step, nu),
            brackt=brackt_b & ~accept,
            touched=touched_b & ~accept,
            lscnt=torch.where(accept, izero, lscnt),
            lm_s=lm_s, lm_y=lm_y, lm_ys=lm_ys, bound=bound, k=k, pf=pf,
            n_evals=n_evals, status=status.to(torch.int32))
    return c


def _prep(batch: Scenario, w: Weights, dims: Dims, dtype, sigma):
    """Clamp boundaries, pack x0 into padded [DP, B] rows (segment s's
    virtual time divided by sigma[s]; sigma as EngineFlags.vt_scale takes
    it), build the kernel-layout slabs and constants."""
    from dftpav_tpu_torch.solver import clamp_boundary_states

    sigma = resolve_vt_scale(sigma, dims.ns_tuple)
    batch = clamp_boundary_states(batch, w)
    x0 = cost_mod.initial_guess(batch, w, dims)           # [B, D]
    B, D = x0.shape
    n_in = 2 * dims.S * (dims.N - 1)
    if any(v != 1.0 for v in sigma):
        x0 = x0.clone()
        x0[:, n_in:n_in + dims.S] /= torch.as_tensor(sigma, dtype=x0.dtype,
                                                     device=x0.device)
    x0p = torch.zeros((dp_of(dims), B), dtype=dtype, device=x0.device)
    x0p[:D] = x0.T.to(dtype)
    sc = kcost.prep_scenario(batch, dims, dtype)
    kc = kcost.make_consts(dims, dtype, x0.device)
    return batch, x0p, sc, kc, D


def _finalize(batch, out_x, out_f, out_status, out_k, w, dims: Dims,
              cfg: PlannerConfig, D: int, sigma) -> SolveResult:
    """MINCO coefficients and SolveResult from the optimized variables
    (once per solve, outside the hot loop). With per-segment piece classes
    (Dims.Ns) each segment is generated on its own n_s pieces and then
    re-expressed exactly on the uniform N-piece grid (minco.subdivide), so
    the output is [S, N, 6, 2] with dT = T / N for every class."""
    n_in = 2 * dims.S * (dims.N - 1)
    sigma = resolve_vt_scale(sigma, dims.ns_tuple)
    x_fin = out_x[:D].clone()
    x_fin[n_in:n_in + dims.S] *= torch.as_tensor(
        sigma, dtype=x_fin.dtype, device=x_fin.device)[:, None]
    u = bcost.unpack_b(x_fin, dims)
    T = cost_mod.virtual_to_real(u.vt, float(w.mini_t))
    dT = T / dims.N
    bm = bcost.to_bminor(batch)
    heads, tails = bcost.boundary_states_b(bm, u, w, dims)
    heads, tails = heads.to(out_x.dtype), tails.to(out_x.dtype)
    if dims.Ns is None:
        maps = minco.maps_as(dims.N, out_x.dtype, out_x.device)
        coeffs = bcost.generate_b(u.inner, dT, heads, tails, maps)
    else:
        segs = []
        for s, n_s in enumerate(dims.ns_tuple):
            maps_s = minco.maps_as(n_s, out_x.dtype, out_x.device)
            c_s = bcost.generate_b(u.inner[s:s + 1, :n_s - 1],
                                   (T[s] / n_s)[None], heads[s:s + 1],
                                   tails[s:s + 1], maps_s)  # [1, n_s, 6, 2, B]
            segs.append(minco.subdivide(c_s[0], dims.N // n_s))
        coeffs = torch.stack(segs)                         # [S, N, 6, 2, B]
    cost = out_f / cfg.opt.cost_scale
    success = (out_status >= 0) & (cost < cfg.opt.reject_cost)
    return SolveResult(coeffs=torch.movedim(coeffs, -1, 0), dT=dT.T,
                       cost=cost, n_iters=out_k.to(torch.int32),
                       status=out_status.to(torch.int32), success=success)


def _no_trajtime_compat(cfg: PlannerConfig, dims: Dims) -> None:
    """The kcost objective offsets segments by the true cumulative time;
    the reference's offsets (OptConfig.ref_trajtime_compat) differ from it
    at S >= 3 and are the vmap and bminor engines' only."""
    if cfg.opt.ref_trajtime_compat and dims.S > 1:
        raise ValueError("ref_trajtime_compat at S > 1 is implemented by the "
                         "vmap and bminor engines only")


def solve_batch_rounds(batch: Scenario, w: Weights, dims: Dims,
                       cfg: PlannerConfig,
                       max_iterations: int | None = None,
                       flags: EngineFlags | None = None,
                       x0_override=None, return_x: bool = False):
    """The plain round loop end to end, in the batch's dtype and on its
    device. Weights must be uniform across the batch (one value each).
    x0_override ([DP, B]) warm-starts from a packed decision matrix;
    return_x adds the final packed matrix to the return."""
    _no_trajtime_compat(cfg, dims)
    kcost._no_tf32()
    flags = flags or EngineFlags()
    sigma = resolve_vt_scale(flags.vt_scale, dims.ns_tuple)
    dtype = batch.init_T.dtype
    p = cfg.opt.lbfgs
    max_iter = p.max_iterations if max_iterations is None else max_iterations
    sw = StaticW.build(w, cfg)
    batch, x0p, sc, kc, D = _prep(batch, w, dims, dtype, sigma)
    if x0_override is not None:
        x0p = x0_override.to(dtype)
    out = _solve_rounds(x0p, sc, kc, sw, dims, p, max_iter, flags=flags)
    res = _finalize(batch, out.xp, out.fp, out.status,
                    torch.clamp(out.k, max=max_iter), w, dims, cfg, D, sigma)
    return (res, out.xp) if return_x else res


# The class the kernels run a class in (kcost.KClass: capacity 8 for every
# segment of at most 8 pieces, 16 up to 16, 32 up to 32; the segments' own
# piece counts): Dims(S=1, N=24), for one, runs as KClass(S=1, N=32,
# Ns=(24,)).
embedded_class = kcost.kernel_class


def embed_scenario(batch: Scenario, dims: Dims, dims_e: Dims) -> Scenario:
    """A batch of class dims in the layout of embedded_class(dims): each
    segment's inner waypoints in its leading rows and its corridor rows in
    its leading pieces, zeros (and mask off) after them; rows past a
    segment's piece count are cut where the capacity is below dims.N."""
    if dims_e.N == dims.N:
        return batch

    def fit(a, rows):
        out = a.new_zeros(a.shape[:2] + (rows,) + a.shape[3:])
        n = min(rows, a.shape[2])
        out[:, :, :n] = a[:, :, :n]
        return out

    N = dims_e.N
    return batch._replace(
        init_inner=fit(batch.init_inner, N - 1), corr_n=fit(batch.corr_n, N),
        corr_p=fit(batch.corr_p, N), corr_mask=fit(batch.corr_mask, N))


def _move_x(x, dims_from: Dims, dims_to: Dims):
    """Packed decision rows x [DP, B] of one class as the other's, field by
    field in cost.unpack's order; inner waypoints keep their leading rows
    (padded with zeros, or cut). Two layouts of the same N are one."""
    if dims_from.N == dims_to.N and dims_from.S == dims_to.S:
        return x
    u = cost_mod.unpack(x[:dims_from.dim].T, dims_from)
    n = min(dims_from.N, dims_to.N) - 1
    inner = u.inner.new_zeros(u.inner.shape[:2] + (dims_to.N - 1, 2))
    inner[:, :, :n] = u.inner[:, :, :n]
    out = x.new_zeros((dp_of(dims_to), x.shape[1]))
    out[:dims_to.dim] = cost_mod.pack(u._replace(inner=inner)).T
    return out


def solve_batch_fused(batch: Scenario, w: Weights, dims: Dims,
                      cfg: PlannerConfig, max_iterations: int | None = None,
                      x0_override=None, return_x: bool = False,
                      flags: EngineFlags | None = None):
    """The whole solve on the card: float32, kernel A for the initial
    evaluation, kernel B for the round loop, the class in the layout of its
    kernel class (module docstring). CPU tensors run the plain round loop
    (solve_batch_rounds) instead. Same arguments and return as
    solve_batch_rounds; a class the kernels do not take (S > 8, a segment
    of more than 32 pieces, H > 8) raises NotImplementedError."""
    if not batch.init_T.is_cuda:
        return solve_batch_rounds(batch, w, dims, cfg, max_iterations,
                                  flags, x0_override, return_x)
    from dftpav_tpu_torch.ops import _cuda

    _no_trajtime_compat(cfg, dims)
    flags = flags or EngineFlags()
    sigma = resolve_vt_scale(flags.vt_scale, dims.ns_tuple)
    p = cfg.opt.lbfgs
    max_iter = p.max_iterations if max_iterations is None else max_iterations
    sw = StaticW.build(w, cfg)
    _cuda.check_domain(dims, mem=p.mem_size, past=p.past)
    dims_k = embedded_class(dims)
    bk, x0p, sc, kc, _D = _prep(embed_scenario(batch, dims, dims_k), w,
                                dims_k, torch.float32, sigma)
    if x0_override is not None:
        x0p = _move_x(x0_override.to(torch.float32).contiguous(), dims,
                      dims_k)
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, dims_k, flags)
    solve_batch_fused.launches += 1
    x, f, info = _cuda.launch_solve_fused(x0p, f0, g0, sc, kc, sw, dims_k,
                                          sigma, p, max_iter, flags)
    x = _move_x(x, dims_k, dims)
    # the clamped boundary states; embedding leaves them as they are
    batch = batch._replace(ini_state=bk.ini_state, fin_state=bk.fin_state)
    res = _finalize(batch, x, f, info[0], info[1], w, dims, cfg, dims.dim,
                    sigma)
    return (res, x) if return_x else res


solve_batch_fused.launches = 0
