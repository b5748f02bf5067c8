"""Kernel-layout objective: the trajectory-optimization cost over [R, B]
tensors (sample rows by lanes), and its CUDA kernel.

Same math as `dftpav_tpu.ops.kcost` (which carries the reference citations
to traj_optimizer.cpp):

  * the MINCO solve and the constraint-grid basis sampling collapse into one
    host-precomputed matrix per derivative order, P_o = Beta_o · M [R, C],
    applied to rhs = (scaled head PVA | inner waypoints | scaled tail PVA)
    per dimension; the jerk energy is dT^-5 · rhs^T Q rhs;
  * the sample axis is compacted to the rows that carry quadrature weight
    (r_rows: 168 for the bench class instead of 264 padded grid rows).

`eval_fg` is the wrapper: CUDA tensors go to the hand-written kernel
(csrc/kernels.cu `dftpav_eval_fg`, gradient derived by hand in
csrc/kcost.cuh), CPU tensors to `eval_fg_plain` (autograd). The plain
version evaluates all R rows in one pass (the TPU chunked them for VMEM).

Any S and per-segment piece classes (Dims.Ns): segments are a loop over the
same rows, each with its own sample maps (built for its piece count n_s,
zero-padded to C = N+5 rhs columns), gear-junction boundary overrides read
from the decision vector, and absolute obstacle time offset by the earlier
segments' durations. Every function here also takes a KClass, the layout
the kernels run a class in: N there is a capacity (8, 16 or 32) and each
segment's own piece count n_s is any from 2 to N (kernel_class). The
kernels take S <= 8 (ops/_cuda.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dftpav_tpu_torch import minco
from dftpav_tpu_torch.basis import sample_grid
from dftpav_tpu_torch.config import EngineFlags, resolve_vt_scale
from dftpav_tpu_torch.cost import hull_arrays, smoothed_l1, virtual_to_real
from dftpav_tpu_torch.types import Dims

DP = 16  # padded decision rows for the S=1 bench class (dim = 15 at N=8)


def _pad8(n: int) -> int:
    return ((n + 7) // 8) * 8


# Pieces per segment the kernels have layouts for (csrc/kernels.cu kCaps).
CAPACITIES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class KClass(Dims):
    """A class as the kernels lay it out: N is the capacity (the pieces per
    segment the decision vector, the rhs and the corridor slabs have room
    for) and Ns the segments' own piece counts, any from 2 to N (Dims wants
    divisors of N). Segment s's inner waypoints fill the leading n_s - 1 of
    its N - 1 rows and its corridor rows the leading n_s pieces; the rest
    is zero and carries zero gradient."""

    def __post_init__(self):
        ns = tuple(int(n) for n in (self.Ns if self.Ns is not None
                                    else (self.N,) * self.S))
        if len(ns) != self.S or not all(2 <= n <= self.N for n in ns):
            raise ValueError(f"KClass: piece counts {ns} for S={self.S} "
                             f"within a capacity of N={self.N}")
        object.__setattr__(self, "Ns", ns)


def kernel_class(dims: Dims) -> KClass:
    """The layout the kernels run `dims` in: the smallest capacity that
    holds every segment's piece count (a uniform N <= 8 at capacity 8 with
    Ns = (N,) * S, N from 9 to 16 at capacity 16, 17 to 32 at capacity 32;
    per-segment classes keep their counts). A class no capacity holds
    keeps its N (the kernels refuse it: ops/_cuda.py check_domain)."""
    if isinstance(dims, KClass):
        return dims
    ns = dims.ns_tuple
    cap = next((c for c in CAPACITIES if c >= max(ns)), dims.N)
    return KClass(S=dims.S, N=cap, K=dims.K, Kdes=dims.Kdes, H=dims.H,
                  O=dims.O, Po=dims.Po, Ns=ns)


@functools.lru_cache(maxsize=None)
def _active_idx(n_s: int, K: int, Kdes: int) -> tuple:
    """Flattened sample-row indices (within the n_s*K1 padded grid of one
    segment) that carry nonzero quadrature weight."""
    grid = sample_grid(n_s, K, Kdes)
    omg_eff = (grid.omg * grid.inv_k[:, None] * grid.pen_mask).reshape(-1)
    return tuple(int(i) for i in np.nonzero(omg_eff > 0)[0])


def seg_active(dims: Dims, seg: int) -> int:
    """Number of weight-carrying sample rows of segment `seg`."""
    return len(_active_idx(dims.ns_tuple[seg], dims.K, dims.Kdes))


@functools.lru_cache(maxsize=None)
def _r_rows(ns_tuple: tuple, K: int, Kdes: int) -> int:
    active = max(len(_active_idx(n, K, Kdes)) for n in ns_tuple)
    best = None
    for ch in (32, 24, 16, 8):
        r = ch * (-(-active // ch))
        score = r + 4 * (r // ch)
        if best is None or score < best[0]:
            best = (score, r)
    return best[1]


def r_rows(dims: Dims) -> int:
    """Compacted, padded sample rows per segment (the same count as the JAX
    package, so slabs and constants have identical shapes)."""
    return _r_rows(dims.ns_tuple, dims.K, dims.Kdes)


def dp_of(dims: Dims) -> int:
    """Padded decision-variable rows."""
    return max(_pad8(dims.dim), 16)


def bnd_rows(dims: Dims) -> int:
    """Boundary-slab rows: 12 per segment (6 head + 6 tail)."""
    return _pad8(12 * dims.S)


def misc_rows(dims: Dims) -> int:
    """singul[S] | seg_mask[S] | obs_dt[O] | obs_rel_t0[O] | obs_mask[O]."""
    return _pad8(2 * dims.S + 3 * dims.O)


@dataclasses.dataclass(frozen=True)
class StaticW:
    """Scalar parameters (types.Weights as Python floats) and hull geometry.
    One value per solve: the kernel takes them by value at launch."""

    wei_obs: float
    wei_surround: float
    wei_feas: float
    wei_time: float
    max_forward_vel: float
    max_forward_acc: float
    max_forward_cur: float
    max_backward_vel: float
    max_backward_acc: float
    max_backward_cur: float
    surround_clearance: float
    non_sinv: float
    mini_t: float
    epis: float
    lse_alpha: float
    cost_scale: float
    veh_len: float
    le: tuple          # ((x, y) * E) hull vertices, clockwise
    e_hat: tuple       # unit edge vectors ((x, y) * E)

    @staticmethod
    def build(w, cfg) -> "StaticW":
        le_np, delta_np, veh_len = hull_arrays(cfg)
        dl = delta_np / np.linalg.norm(delta_np, axis=-1, keepdims=True)
        return StaticW(
            **{f: float(getattr(w, f)) for f in (
                "wei_obs", "wei_surround", "wei_feas", "wei_time",
                "max_forward_vel", "max_forward_acc", "max_forward_cur",
                "max_backward_vel", "max_backward_acc", "max_backward_cur",
                "surround_clearance", "non_sinv", "mini_t", "epis",
                "lse_alpha")},
            cost_scale=float(cfg.opt.cost_scale), veh_len=float(veh_len),
            le=tuple((float(a), float(b)) for a, b in le_np),
            e_hat=tuple((float(a), float(b)) for a, b in dl),
        )


class KConsts(NamedTuple):
    """Lane-independent constants (per-segment leading axis)."""

    P: torch.Tensor        # [S, 3, R, C] sample maps for orders 0..2
    Q: torch.Tensor        # [S, Cq, C]   jerk quadratic form (padded rows 0)
    gridc: torch.Tensor    # [S, 2, R, 1] rows: omg*inv_k (0 on masked), frac


class KScenario(NamedTuple):
    """Per-lane problem slabs, lane axis minor (contiguous)."""

    bnd: torch.Tensor      # [bnd_rows, B] px py vx vy ax ay head, then tail
    misc: torch.Tensor     # [misc_rows, B]
    corr_n: torch.Tensor   # [H, 2, R, B]
    corr_p: torch.Tensor   # [H, 2, R, B]
    corr_m: torch.Tensor   # [H, R, B] float 0/1
    obs_c: torch.Tensor    # [max(O,1), 2, 6*Po, B] coeffs, row 6*p + c


@functools.lru_cache(maxsize=None)
def _host_constants(n_s: int, N: int, K: int, Kdes: int, r_pad: int):
    """Sample maps / jerk form / quadrature rows for one segment with n_s
    pieces, compacted to its weight-carrying rows and zero-padded to r_pad
    rows and C = N+5 rhs columns (float64 numpy)."""
    grid = sample_grid(n_s, K, Kdes)
    K1 = grid.tau.shape[1]
    R_s = n_s * K1
    idx = np.asarray(_active_idx(n_s, K, Kdes), np.int64)
    C = N + 5
    Mh, Mi, Mt = minco.minco_maps(n_s)
    M = np.concatenate([Mh, Mi, Mt], axis=1)           # [6n, n+5]
    P = np.zeros((3, r_pad, C))
    for o in range(3):
        beta = grid.beta[o]                            # [n, K1, 6]
        big = np.zeros((R_s, 6 * n_s))
        for n in range(n_s):
            big[n * K1:(n + 1) * K1, 6 * n:6 * n + 6] = beta[n]
        P[o, :idx.size, :n_s + 5] = (big @ M)[idx]
    J = np.zeros((6 * n_s, 6 * n_s))
    blk = np.array([[36.0, 72.0, 120.0],
                    [72.0, 192.0, 360.0],
                    [120.0, 360.0, 720.0]])
    for n in range(n_s):
        J[6 * n + 3:6 * n + 6, 6 * n + 3:6 * n + 6] = blk
    Q = M.T @ J @ M                                    # [n+5, n+5]
    Qp = np.zeros((max(16, _pad8(C)), C))
    Qp[:n_s + 5, :n_s + 5] = Q
    omg_eff = np.zeros((r_pad, 1))
    omg_eff[:idx.size] = (grid.omg * grid.inv_k[:, None]
                          * grid.pen_mask).reshape(R_s, 1)[idx]
    frac = np.zeros((r_pad, 1))
    frac[:idx.size] = grid.frac.reshape(R_s, 1)[idx]
    gridc = np.stack([omg_eff, frac])                  # [2, r_pad, 1]
    return P, Qp, gridc


def make_consts(dims: Dims, dtype=torch.float32, device=None) -> KConsts:
    r_pad = r_rows(dims)
    per_seg = [_host_constants(n_s, dims.N, dims.K, dims.Kdes, r_pad)
               for n_s in dims.ns_tuple]
    t = lambda i: torch.as_tensor(np.stack([c[i] for c in per_seg]),
                                  dtype=dtype, device=device)
    return KConsts(P=t(0), Q=t(1), gridc=t(2))


def prep_scenario(batch, dims: Dims, dtype=torch.float32) -> KScenario:
    """Batch-major Scenario (leading [B]) -> lane-minor kernel slabs on the
    batch's device. Corridor rows are gathered onto the compacted sample
    rows; padded rows reuse row 0's planes but carry zero quadrature
    weight, so they never contribute."""
    B = batch.ini_state.shape[0]
    S, K1, O, R = dims.S, dims.K1, dims.O, r_rows(dims)
    dev = batch.ini_state.device
    f = lambda a: a.to(dtype)

    gather = np.zeros((S, R), np.int64)
    for s, n_s in enumerate(dims.ns_tuple):
        idx = np.asarray(_active_idx(n_s, dims.K, dims.Kdes), np.int64)
        gather[s, :idx.size] = idx
    gather_t = torch.as_tensor(gather, device=dev)

    bnd = torch.zeros((bnd_rows(dims), B), dtype=dtype, device=dev)
    for s in range(S):
        head = f(batch.ini_state[:, s])                 # [B, 2, 3]
        tail = f(batch.fin_state[:, s])
        base = 12 * s
        for c in range(3):
            for d in range(2):
                bnd[base + 2 * c + d] = head[:, d, c]
                bnd[base + 6 + 2 * c + d] = tail[:, d, c]

    misc = torch.zeros((misc_rows(dims), B), dtype=dtype, device=dev)
    for s in range(S):
        misc[s] = f(batch.singul[:, s])
        misc[S + s] = f(batch.seg_mask[:, s])
    ob = 2 * S
    for o in range(O):
        misc[ob + o] = f(batch.obs_dt[:, o])
        misc[ob + O + o] = f(batch.obs_rel_t0[:, o])
        misc[ob + 2 * O + o] = f(batch.obs_mask[:, o])

    def compact(a):                   # [B, S, N, K1, ...] -> [B, S*R, ...]
        a = a.reshape(B, S, dims.N * K1, *a.shape[4:])
        return a[:, torch.arange(S, device=dev)[:, None], gather_t].reshape(
            B, S * R, *a.shape[3:])

    cn = compact(f(batch.corr_n)).permute(2, 3, 1, 0).contiguous()
    cp = compact(f(batch.corr_p)).permute(2, 3, 1, 0).contiguous()
    cm = compact(f(batch.corr_mask)).permute(2, 1, 0).contiguous()
    if O > 0:
        obs_c = f(batch.obs_coef).permute(1, 4, 2, 3, 0).reshape(
            O, 2, dims.Po * 6, B).contiguous()
    else:
        obs_c = torch.zeros((1, 2, dims.Po * 6, B), dtype=dtype, device=dev)
    return KScenario(bnd=bnd, misc=misc, corr_n=cn, corr_p=cp, corr_m=cm,
                     obs_c=obs_c)


def _neg_lse_over(vals, alpha):
    """-logsumexp(-alpha * v_i)/alpha, stable (soft-min of the list)."""
    neg = [-alpha * v for v in vals]
    m = functools.reduce(torch.maximum, neg)
    s = sum(torch.exp(v - m) for v in neg)
    return -(torch.log(s) + m) / alpha


def _pos_lse_over(vals, alpha):
    """logsumexp(alpha * v_i)/alpha (soft-max of the list)."""
    pos = [alpha * v for v in vals]
    m = functools.reduce(torch.maximum, pos)
    s = sum(torch.exp(v - m) for v in pos)
    return (torch.log(s) + m) / alpha


def _pre(x, sc: KScenario, sw: StaticW, dims: Dims, sigma: tuple):
    """Decision matrix [DP, B] -> per-segment (rhs_x, rhs_y, dT, tt, T):
    lists of S tensors ([C, B] rhs per dimension, piece duration,
    cumulative time offset of the segment's start, segment duration).

    Rows n_in + s hold segment s's virtual time divided by sigma[s] (the
    vt_scale preconditioning, packed by pallas_solve._prep); it is
    multiplied back here. Gear junction j (between segments j and j + 1)
    takes its position from the gear variables and its velocity
    -+non_sinv (cos a, sin a) when segment j + 1 is unmasked
    (costFunctionCallback:269-282). Segment s uses n_s - 1 inner
    waypoints, its rhs zero-padded to C = N + 5 rows."""
    S, N = dims.S, dims.N
    n_in = 2 * S * (N - 1)
    T = [virtual_to_real(x[n_in + s] * sigma[s], sw.mini_t) for s in range(S)]
    gp_row = lambda j, d: n_in + S + 2 * j + d
    ga = [x[n_in + S + 2 * (S - 1) + j] for j in range(S - 1)]
    jm = [sc.misc[S + s] > 0.5 for s in range(S)]
    b = sc.bnd
    rhs_x, rhs_y, dTs, tts = [], [], [], []
    trajtime = torch.zeros_like(T[0])
    for seg, n_seg in enumerate(dims.ns_tuple):
        dT = T[seg] / n_seg
        dT2 = dT * dT
        base = 12 * seg

        def rhs_dim(d):
            hp, hv, ha = b[base + d], b[base + 2 + d], b[base + 4 + d]
            tp, tv, ta = b[base + 6 + d], b[base + 8 + d], b[base + 10 + d]
            trig = torch.cos if d == 0 else torch.sin
            if seg > 0:
                hp = torch.where(jm[seg], x[gp_row(seg - 1, d)], hp)
                hv = torch.where(jm[seg], -sw.non_sinv * trig(ga[seg - 1]),
                                 hv)
            if seg < S - 1:
                tp = torch.where(jm[seg + 1], x[gp_row(seg, d)], tp)
                tv = torch.where(jm[seg + 1], sw.non_sinv * trig(ga[seg]),
                                 tv)
            rows = [hp, hv * dT, ha * dT2]
            rows += [x[2 * ((N - 1) * seg + j) + d] for j in range(n_seg - 1)]
            rows += [tp, tv * dT, ta * dT2]
            rows += [torch.zeros_like(hp)] * (N - n_seg)
            return torch.stack(rows)

        rhs_x.append(rhs_dim(0))
        rhs_y.append(rhs_dim(1))
        dTs.append(dT)
        tts.append(trajtime)
        trajtime = trajtime + T[seg]
    return rhs_x, rhs_y, dTs, tts, T


def _obstacle_cost(o, sc, sw, dims, sig_x, sig_y, u, v, wq, dT, tt, valid,
                   frac):
    """Dynamic-obstacle penalty rows (traj_optimizer.cpp:1311-1684): dual
    log-sum-exp signed distance between the ego hull and the obstacle hull,
    the obstacle a Po-piece quintic with constant-acceleration
    extrapolation past its horizon, sampled at the absolute time
    rel_t0 + tt + frac dT."""
    O, Po, ob = dims.O, dims.Po, 2 * dims.S
    alpha = sw.lse_alpha
    d_min = sw.surround_clearance + math.log(8.0) / alpha
    E = len(sw.le)
    dt_o = sc.misc[ob + o][None]
    rel_t0 = sc.misc[ob + O + o][None]
    mask_o = sc.misc[ob + 2 * O + o][None] > 0.5
    pt_time = rel_t0 + tt[None] + frac * dT[None]
    total = dt_o * Po
    inside = pt_time < total
    ft = torch.minimum(pt_time, total) / dt_o
    idxf = torch.clamp(torch.floor(ft), 0.0, Po - 1.0)
    tau = ft - idxf
    cx, cy = sc.obs_c[o, 0], sc.obs_c[o, 1]                 # [6*Po, B]

    def horner(tau_v, piece, order):
        """Derivative `order` (unscaled by dt) of the selected piece."""
        hx = hy = None
        for cdeg in range(5, order - 1, -1):
            kf = float(math.prod(cdeg - r for r in range(order)))
            rows = 6 * piece + cdeg
            kx = kf * torch.gather(cx, 0, rows)
            ky = kf * torch.gather(cy, 0, rows)
            hx = kx if hx is None else hx * tau_v + kx
            hy = ky if hy is None else hy * tau_v + ky
        return hx, hy

    piece = idxf.long()
    p_in_x, p_in_y = horner(tau, piece, 0)
    inv_dt_o = 1.0 / dt_o

    last = 6 * (Po - 1)
    pe_x = pe_y = ve_x = ve_y = ae_x = ae_y = 0.0
    for cdeg in range(6):
        pe_x = pe_x + cx[last + cdeg][None]
        pe_y = pe_y + cy[last + cdeg][None]
        if cdeg >= 1:
            ve_x = ve_x + cdeg * cx[last + cdeg][None]
            ve_y = ve_y + cdeg * cy[last + cdeg][None]
        if cdeg >= 2:
            ae_x = ae_x + cdeg * (cdeg - 1) * cx[last + cdeg][None]
            ae_y = ae_y + cdeg * (cdeg - 1) * cy[last + cdeg][None]
    ve_x, ve_y = ve_x * inv_dt_o, ve_y * inv_dt_o
    ae_x = ae_x * inv_dt_o * inv_dt_o
    ae_y = ae_y * inv_dt_o * inv_dt_o
    ex = torch.clamp(pt_time - total, min=0.0)
    pex_x = pe_x + ex * ve_x + 0.5 * ex * ex * ae_x
    pex_y = pe_y + ex * ve_y + 0.5 * ex * ex * ae_y
    p_u_x = torch.where(inside, p_in_x, pex_x)
    p_u_y = torch.where(inside, p_in_y, pex_y)

    # heading frame: polynomial extrapolation of the last piece
    tau_r = torch.where(inside, tau, 1.0 + ex / dt_o)
    piece_r = torch.where(inside, piece, torch.full_like(piece, Po - 1))
    v_r_x, v_r_y = horner(tau_r, piece_r, 1)
    # rsqrt of the clamped squared norm: a masked zero-coefficient slot
    # would otherwise put 0 * inf into the gradient
    vrn2 = v_r_x * v_r_x + v_r_y * v_r_y
    inv_vrn = torch.rsqrt(torch.clamp(vrn2, min=1e-24))
    uo = v_r_x * inv_vrn
    vo = v_r_y * inv_vrn

    rel_x = p_u_x - sig_x
    rel_y = p_u_y - sig_y
    near = rel_x * rel_x + rel_y * rel_y <= (1.5 * sw.veh_len) ** 2

    He, Ho, Rle, Rlo = [], [], [], []
    for e in range(E):
        ehx, ehy = sw.e_hat[e]
        lex, ley = sw.le[e]
        He.append((-v * ehx - u * ehy, u * ehx - v * ehy))
        Ho.append((-vo * ehx - uo * ehy, uo * ehx - vo * ehy))
        Rle.append((u * lex - v * ley, v * lex + u * ley))
        Rlo.append((uo * lex - vo * ley, vo * lex + uo * ley))

    d_all = []
    for e in range(E):
        hx, hy = He[e]
        d_tilde = hx * (rel_x - Rle[e][0]) + hy * (rel_y - Rle[e][1])
        cross = [hx * Rlo[f2][0] + hy * Rlo[f2][1] for f2 in range(E)]
        d_all.append(_neg_lse_over(cross, alpha) + d_tilde)
    for f2 in range(E):
        hx, hy = Ho[f2]
        d_tilde = hx * (-rel_x - Rlo[f2][0]) + hy * (-rel_y - Rlo[f2][1])
        cross = [hx * Rle[e][0] + hy * Rle[e][1] for e in range(E)]
        d_all.append(_neg_lse_over(cross, alpha) + d_tilde)

    d_val = d_min - _pos_lse_over(d_all, alpha)
    gate = near & mask_o & valid
    pen_d = torch.where(gate, smoothed_l1(d_val), torch.zeros_like(d_val))
    return torch.sum(wq * pen_d, dim=0)


def eval_cost(x, sc: KScenario, kc: KConsts, sw: StaticW, dims: Dims,
              flags: EngineFlags | None = None):
    """Scaled objective per lane: x [DP, B] -> f [B] (plain torch,
    differentiable). Each segment's terms are weighted by its seg_mask
    (S > 1)."""
    flags = flags or EngineFlags()
    S = dims.S
    rhs_xs, rhs_ys, dTs, tts, Ts = _pre(
        x, sc, sw, dims, resolve_vt_scale(flags.vt_scale, dims.ns_tuple))
    f = 0.0
    for seg in range(S):
        segw = sc.misc[S + seg] if S > 1 else 1.0
        f = f + segw * _segment_cost(seg, rhs_xs[seg], rhs_ys[seg],
                                     dTs[seg], tts[seg], Ts[seg], sc, kc, sw,
                                     dims)
    return sw.cost_scale * f


def _segment_cost(seg, rhs_x, rhs_y, dT, tt, T, sc, kc, sw, dims):
    """One segment's jerk energy, time, corridor, feasibility and obstacle
    terms [B]."""
    C = rhs_x.shape[0]
    Q = kc.Q[seg][:C]
    invdT = 1.0 / dT
    f = (torch.sum(rhs_x * (Q @ rhs_x), dim=0)
         + torch.sum(rhs_y * (Q @ rhs_y), dim=0)) * invdT ** 5
    f = f + sw.wei_time * T

    P0, P1, P2 = kc.P[seg, 0], kc.P[seg, 1], kc.P[seg, 2]   # [R, C]
    omg, frac = kc.gridc[seg, 0], kc.gridc[seg, 1]           # [R, 1]
    R = P0.shape[0]
    sig_x, sig_y = P0 @ rhs_x, P0 @ rhs_y                    # [R, B]
    invdTr = invdT[None]
    dsx = (P1 @ rhs_x) * invdTr
    dsy = (P1 @ rhs_y) * invdTr
    dd = invdTr * invdTr
    ddx = (P2 @ rhs_x) * dd
    ddy = (P2 @ rhs_y) * dd

    vn2 = dsx * dsx + dsy * dsy
    valid = (omg > 0.0) & (vn2 >= 1e-8)
    safe_vn2 = torch.where(valid, vn2, torch.ones_like(vn2))
    inv_vn = torch.rsqrt(safe_vn2)
    vel2_reci = 1.0 / safe_vn2
    vel2_reci_e = 1.0 / (safe_vn2 + sw.epis)
    vel32_reci_e = vel2_reci_e * torch.sqrt(vel2_reci_e)
    wq = torch.where(valid, omg * dT[None], torch.zeros_like(vn2))

    sgl = sc.misc[seg][None]
    fwd = sgl > 0.0
    full = lambda a, b: torch.where(fwd, torch.full_like(sgl, a),
                                    torch.full_like(sgl, b))
    max_vel = full(sw.max_forward_vel, sw.max_backward_vel)
    max_acc = full(sw.max_forward_acc, sw.max_backward_acc)
    max_cur = full(sw.max_forward_cur, sw.max_backward_cur)

    # ego rotation R = sgl * [[u, -v], [v, u]], (u, v) = unit dsig
    u = dsx * inv_vn * sgl
    v = dsy * inv_vn * sgl

    # static corridor (traj_optimizer.cpp:592-622), the segment's rows
    rows = slice(seg * R, (seg + 1) * R)
    acc_obs = 0.0
    for e in range(len(sw.le)):
        lex, ley = sw.le[e]
        bx = sig_x + u * lex - v * ley
        by = sig_y + v * lex + u * ley
        for h in range(dims.H):
            viol = sc.corr_n[h, 0, rows] * (bx - sc.corr_p[h, 0, rows]) \
                + sc.corr_n[h, 1, rows] * (by - sc.corr_p[h, 1, rows])
            acc_obs = acc_obs + smoothed_l1(viol) * sc.corr_m[h, rows]
    pen = sw.wei_obs * torch.sum(wq * acc_obs, dim=0)

    # feasibility (traj_optimizer.cpp:642-705)
    z_h1 = ddx * dsx + ddy * dsy
    z_h3 = ddy * dsx - ddx * dsy
    viola_vel = vn2 - max_vel * max_vel
    viola_acc = z_h1 * z_h1 * vel2_reci - max_acc * max_acc
    cur = z_h3 * vel32_reci_e
    feas = (smoothed_l1(viola_vel) + smoothed_l1(viola_acc)
            + 10.0 * (smoothed_l1(cur - max_cur)
                      + smoothed_l1(-cur - max_cur)))
    pen = pen + sw.wei_feas * torch.sum(wq * feas, dim=0)

    cost_dyn = 0.0
    for o in range(dims.O):
        cost_dyn = cost_dyn + _obstacle_cost(
            o, sc, sw, dims, sig_x, sig_y, u, v, wq, dT, tt, valid, frac)
    return f + pen + sw.wei_surround * cost_dyn


def _no_tf32() -> None:
    """The plain path runs float32 matmuls in full float32: TF32 truncates
    operands like the single-pass bf16 that broke the TPU line search."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def eval_fg_plain(x, sc: KScenario, kc: KConsts, sw: StaticW, dims: Dims,
                  flags: EngineFlags | None = None):
    """(f [B], g [DP, B]) by autograd through eval_cost, on any device.
    Padded decision rows carry exactly zero gradient."""
    _no_tf32()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = eval_cost(xg, sc, kc, sw, dims, flags)
        (g,) = torch.autograd.grad(f.sum(), xg)
    g[dims.dim:] = 0.0
    return f.detach(), g


def eval_fg(x, sc: KScenario, kc: KConsts, sw: StaticW, dims: Dims,
            flags: EngineFlags | None = None):
    """(f [B], g [DP, B]): the CUDA kernel for CUDA tensors, the plain
    autograd version for CPU tensors."""
    if not x.is_cuda:
        return eval_fg_plain(x, sc, kc, sw, dims, flags)
    from dftpav_tpu_torch.ops import _cuda

    flags = flags or EngineFlags()
    sigma = resolve_vt_scale(flags.vt_scale, dims.ns_tuple)
    eval_fg.launches += 1
    return _cuda.launch_eval_fg(x, sc, kc, sw, dims, sigma)


eval_fg.launches = 0
