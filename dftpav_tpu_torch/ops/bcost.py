"""Batch-minor trajectory-optimization objective: the cost of
`dftpav_tpu.ops.bcost` (cost.total_cost + cost.segment_penalties, with the
reference citations to traj_optimizer.cpp there) with the scenario batch as
the trailing axis of every tensor, differentiated by autograd.

Shapes are the single-scenario shapes with a trailing [B]; `to_bminor` moves
the leading batch axis of a Scenario to the back once, at solve entry. The
helpers that turn optimized variables into MINCO coefficients
(`unpack_b`, `boundary_states_b`, `generate_b`) also serve the round-loop
engines' `_finalize`.

The static-corridor term has three backends (OptConfig.corridor_backend):
the plain broadcast form ("xla"), or the CorridorPenalty function of
ops/pallas_penalty.py, whose forward and backward are CUDA kernels for
CUDA tensors ("pallas"; "auto", the default, picks it for CUDA tensors).

Two-component contractions are written out (x0*y0 + x1*y1) rather than as a
product followed by a sum over the component axis: the value is the same,
and eager PyTorch then never holds the product tensor, which for the
obstacle block is the largest of the evaluation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dftpav_tpu_torch import minco
from dftpav_tpu_torch.basis import sample_grid
from dftpav_tpu_torch.cost import Unpacked, hull_arrays, smoothed_l1, \
    virtual_to_real
from dftpav_tpu_torch.types import Dims, Scenario, Weights


def to_bminor(tree):
    """Move the leading batch axis of every leaf to the back."""
    return type(tree)(*(torch.movedim(a, 0, -1) for a in tree))


def from_bminor(tree):
    """Move the trailing batch axis of every leaf to the front."""
    return type(tree)(*(torch.movedim(a, -1, 0) for a in tree))


def _dot2(a, b):
    """Contraction over the component axis (-2, size 2) of [..., 2, B]."""
    return a[..., 0, :] * b[..., 0, :] + a[..., 1, :] * b[..., 1, :]


def _apply_R(R, pts):
    """R [..., 2, 2, B] applied to constant points pts [E, 2] (a tensor)
    -> [..., E, 2, B]."""
    px = pts[:, 0, None, None]                       # [E, 1, 1]
    py = pts[:, 1, None, None]
    return (R[..., None, :, 0, :] * px) + (R[..., None, :, 1, :] * py)


def _rot90(R):
    """[[0, -1], [1, 0]] @ R for R [..., 2, 2, B]."""
    return torch.stack([-R[..., 1, :, :], R[..., 0, :, :]], dim=-3)


def unpack_b(x: torch.Tensor, dims: Dims) -> Unpacked:
    """Decision matrix [dim, B] -> parts with trailing B."""
    S, N = dims.S, dims.N
    B = x.shape[-1]
    n_in = S * (N - 1) * 2
    inner = x[:n_in].reshape(S, N - 1, 2, B)
    vt = x[n_in:n_in + S]
    gp = x[n_in + S:n_in + S + 2 * (S - 1)].reshape(max(S - 1, 0), 2, B)
    ga = x[n_in + S + 2 * (S - 1):]
    return Unpacked(inner, vt, gp, ga)


def boundary_states_b(scen: Scenario, u: Unpacked, w: Weights, dims: Dims):
    """Per-segment head/tail PVA [S, 2, 3, B]. Each gear junction whose
    later segment is unmasked takes its position from the gear variable and
    the velocity +-non_sinv (cos a, sin a) (tail of the earlier segment +,
    head of the later -); accelerations stay the front end's
    (costFunctionCallback:269-282)."""
    heads, tails = scen.ini_state, scen.fin_state
    if dims.S > 1:
        gvel = w.non_sinv * torch.stack([torch.cos(u.gear_ang),
                                         torch.sin(u.gear_ang)], dim=-2)
        jmask = scen.seg_mask[1:, None]                     # [S-1, 1, B]
        h1 = torch.stack([torch.where(jmask, u.gear_pos, heads[1:, :, 0]),
                          torch.where(jmask, -gvel, heads[1:, :, 1]),
                          heads[1:, :, 2]], dim=2)
        t0 = torch.stack([torch.where(jmask, u.gear_pos, tails[:-1, :, 0]),
                          torch.where(jmask, gvel, tails[:-1, :, 1]),
                          tails[:-1, :, 2]], dim=2)
        heads = torch.cat([heads[:1], h1])
        tails = torch.cat([t0, tails[-1:]])
    return heads, tails


def generate_b(inner, dT, heads, tails, maps):
    """MINCO solve over [S, ..., B]: inner [S, N-1, 2, B], dT [S, B],
    heads/tails [S, 2, 3, B] -> normalized coeffs [S, N, 6, 2, B]."""
    Mh, Mi, Mt = maps
    N = Mh.shape[0] // 6
    S, B = dT.shape[0], dT.shape[-1]
    scale = torch.stack([torch.ones_like(dT), dT, dT * dT])   # [3, S, B]
    sc = scale.permute(1, 0, 2)[:, :, None]                   # [S, 3, 1, B]
    hs = heads.permute(0, 2, 1, 3) * sc                       # [S, 3, 2, B]
    ts = tails.permute(0, 2, 1, 3) * sc
    b = (torch.einsum("ik,skdb->sidb", Mh, hs)
         + torch.einsum("ik,skdb->sidb", Mi, inner)
         + torch.einsum("ik,skdb->sidb", Mt, ts))
    return b.reshape(S, N, 6, 2, B)


def jerk_cost_b(b, dT):
    """Jerk energy per segment: coeffs [S, N, 6, 2, B], dT [S, B] -> [S, B]
    (minco.jerk_cost)."""
    k = torch.arange(6, dtype=b.dtype, device=b.device)
    c = b * (dT[:, None, :] ** -k[:, None])[:, None, :, None, :]
    c3, c4, c5 = c[:, :, 3], c[:, :, 4], c[:, :, 5]           # [S, N, 2, B]
    t1 = dT[:, None]
    t2 = t1 * t1
    t3 = t2 * t1
    t4 = t2 * t2
    t5 = t4 * t1
    e = (36.0 * _dot2(c3, c3) * t1
         + 144.0 * _dot2(c4, c3) * t2
         + 192.0 * _dot2(c4, c4) * t3
         + 240.0 * _dot2(c5, c3) * t3
         + 720.0 * _dot2(c5, c4) * t4
         + 720.0 * _dot2(c5, c5) * t5)                        # [S, N, B]
    return torch.sum(e, dim=1)


def _tau_pows(tau):
    """tau [..., B] -> (1, tau, ..., tau^5) stacked at axis -2: [..., 6, B]."""
    pows = [torch.ones_like(tau)]
    for _ in range(5):
        pows.append(pows[-1] * tau)
    return torch.stack(pows, dim=-2)


def _piece_coeffs(coef, piece):
    """coef [O, Po, 6, 2, B] at per-sample piece indices [O, *lead, B]
    -> [O, *lead, 6, 2, B]."""
    O, Po, B = coef.shape[0], coef.shape[1], coef.shape[-1]
    lead = piece.shape[1:-1]
    idx = piece.reshape(O, -1, 1, B).expand(-1, -1, 12, -1)
    return torch.gather(coef.reshape(O, Po, 12, B), 1, idx).reshape(
        O, *lead, 6, 2, B)


def eval_obstacle_b(coef, dt, t):
    """Obstacle trajectories at times t (cost.eval_obstacle, trailing B).

    coef [O, Po, 6, 2, B] normalized-time coefficients; dt [O, B] piece
    durations; t [O, S, N, K1, B] times (>= 0, may pass the horizon).
    Returns pos [O, S, N, K1, 2, B] and the heading frame R
    [O, S, N, K1, 2, 2, B]. Within the horizon pos is the selected piece's
    polynomial; past it, constant-acceleration extrapolation from the end
    state, while R keeps extrapolating the last polynomial
    (traj_optimizer.cpp:1372-1389). The pieces are gathered, not summed
    with a one-hot select as on the TPU; the velocity and acceleration that
    the JAX version also returns are not computed, since the objective
    reads neither.
    """
    O, Po = coef.shape[0], coef.shape[1]
    dtb = dt.reshape(O, *([1] * (t.dim() - 2)), dt.shape[-1])   # [O,1,1,1,B]
    total = dtb * Po
    inside = t < total
    tc = torch.minimum(t, total)
    ft = tc / dtb
    idxf = torch.clamp(torch.floor(ft), 0, Po - 1)
    tau_in = ft - idxf
    piece = idxf.long()

    pows = _tau_pows(tau_in)                                  # [O,...,6,B]
    p_in = torch.sum(pows[..., :, None, :] * _piece_coeffs(coef, piece),
                     dim=-3)                                  # [O,...,2,B]

    # end state at tau = 1 of the last piece
    c_last = coef[:, -1]                                      # [O, 6, 2, B]
    kk = torch.arange(6, dtype=coef.dtype, device=coef.device)
    p_end = torch.sum(c_last, dim=1)                          # [O, 2, B]
    v_end = torch.sum(c_last * kk[:, None, None], dim=1) / dt[:, None]
    a_end = torch.sum(c_last * (kk * (kk - 1.0))[:, None, None],
                      dim=1) / (dt * dt)[:, None]

    ex = torch.clamp(t - total, min=0.0)[..., None, :]        # [O,...,1,B]
    bshape = (O,) + (1,) * (t.dim() - 2) + (2, t.shape[-1])
    p_ex = (p_end.reshape(bshape) + ex * v_end.reshape(bshape)
            + 0.5 * ex * ex * a_end.reshape(bshape))
    pos = torch.where(inside[..., None, :], p_in, p_ex)

    # heading frame: derivative of the selected (or extrapolated last) piece
    tau_r = torch.where(inside, tau_in, 1.0 + ex[..., 0, :] / dtb)
    piece_r = torch.where(inside, piece, torch.full_like(piece, Po - 1))
    pows_r = _tau_pows(tau_r)
    b1r = torch.cat([torch.zeros_like(pows_r[..., :1, :]),
                     pows_r[..., :5, :] * kk[1:, None]], dim=-2)
    v_r = torch.sum(b1r[..., :, None, :] * _piece_coeffs(coef, piece_r),
                    dim=-3)
    # rsqrt of the clamped SQUARED norm: sqrt(0) has an infinite derivative,
    # and a masked zero-coefficient obstacle slot would NaN the gradient
    vn2 = torch.clamp(_dot2(v_r, v_r), min=1e-24)
    vu = v_r * torch.rsqrt(vn2)[..., None, :]
    R = torch.stack([torch.stack([vu[..., 0, :], -vu[..., 1, :]], -2),
                     torch.stack([vu[..., 1, :], vu[..., 0, :]], -2)], -3)
    return pos, R


def _rot_from_vel_b(dsig, singul, inv_norm):
    """[S, N, K1, 2, B] -> ego_R [S, N, K1, 2, 2, B] = singul * [[dx, -dy],
    [dy, dx]] / |dsig| (traj_optimizer.cpp:581-583)."""
    sg = singul[:, None, None, None, None]                    # [S,1,1,1,1,B]
    R = torch.stack([torch.stack([dsig[..., 0, :], -dsig[..., 1, :]], -2),
                     torch.stack([dsig[..., 1, :], dsig[..., 0, :]], -2)], -3)
    return sg * R * inv_norm[..., None, None, :]


class Samples(NamedTuple):
    """The trajectory at the constraint grid, per segment [S, N, K1, ..., B]."""

    T: torch.Tensor          # [S, B] segment durations
    dT: torch.Tensor         # [S, B] piece durations
    coeffs: torch.Tensor     # [S, N, 6, 2, B]
    sig: torch.Tensor        # [S, N, K1, 2, B] position
    dsig: torch.Tensor       # velocity
    ddsig: torch.Tensor      # acceleration
    vn2: torch.Tensor        # [S, N, K1, B] |dsig|^2
    valid: torch.Tensor      # bool: penalized and moving
    wq: torch.Tensor         # quadrature weight (0 where invalid, seg mask in)
    sgl: torch.Tensor        # [S, B] gear sign, x's dtype


def samples_b(x: torch.Tensor, scen: Scenario, w: Weights,
              dims: Dims) -> Samples:
    """The MINCO trajectory of decision matrix x [dim, B] sampled at the
    constraint grid, with its quadrature weights."""
    dtype, dev = x.dtype, x.device
    N = dims.N
    grid = sample_grid(dims.N, dims.K, dims.Kdes)
    c = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)

    u = unpack_b(x, dims)
    T = virtual_to_real(u.vt, w.mini_t)                       # [S, B]
    dT = T / N
    heads, tails = boundary_states_b(scen, u, w, dims)
    bs = generate_b(u.inner, dT, heads, tails,
                    minco.maps_as(N, dtype, dev))             # [S,N,6,2,B]

    def sample(order):
        # [N, K1, 6] x [S, N, 6, 2, B] -> [S, N, K1, 2, B]
        return torch.einsum("nkc,sncdb->snkdb", c(grid.beta[order]), bs)

    sig = sample(0)
    dsig = sample(1) / dT[:, None, None, None]
    ddsig = sample(2) / (dT * dT)[:, None, None, None]

    vn2 = _dot2(dsig, dsig)                                   # [S, N, K1, B]
    pen_mask = torch.as_tensor(grid.pen_mask, device=dev)
    valid = pen_mask[None, :, :, None] & (torch.sqrt(vn2) >= 1e-4)
    # quadrature weight; the segment mask folded in is exactly
    # cost.total_cost's `segw * pens` (every penalty term is wq-weighted)
    step_full = dT[:, None, None, :] * c(grid.inv_k)[None, :, None, None]
    wq = torch.where(valid, c(grid.omg)[None, :, :, None] * step_full,
                     torch.zeros_like(vn2))
    wq = wq * scen.seg_mask.to(dtype)[:, None, None, :]
    return Samples(T=T, dT=dT, coeffs=bs, sig=sig, dsig=dsig, ddsig=ddsig,
                   vn2=vn2, valid=valid, wq=wq, sgl=scen.singul.to(dtype))


def _corridor_plain(sp: Samples, ego_R, scen: Scenario, le):
    """Static-corridor penalty (traj_optimizer.cpp:592-622) as broadcast
    tensor ops, without the weight: [B]."""
    bpt = sp.sig[:, :, :, None] + _apply_R(ego_R, le)         # [S,N,K1,E,2,B]
    rel = bpt[:, :, :, :, None] - scen.corr_p[:, :, :, None]  # [..,E,H,2,B]
    viol = _dot2(scen.corr_n[:, :, :, None], rel)            # [S,N,K1,E,H,B]
    pen = smoothed_l1(viol) * scen.corr_mask[:, :, :, None]
    return torch.sum(sp.wq[:, :, :, None, None, :] * pen, dim=(0, 1, 2, 3, 4))


def total_cost_b(x: torch.Tensor, scen: Scenario, w: Weights, dims: Dims,
                 cfg) -> tuple[torch.Tensor, dict]:
    """Per-lane objective [B] at decision matrix x [dim, B] for a
    batch-minor scenario; aux holds the terms, T and the coefficients."""
    dtype, dev = x.dtype, x.device
    B = x.shape[-1]
    grid = sample_grid(dims.N, dims.K, dims.Kdes)
    le_np, delta_np, veh_len = hull_arrays(cfg)
    c = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    le = c(le_np)

    sp = samples_b(x, scen, w, dims)
    T, dT, segw = sp.T, sp.dT, scen.seg_mask.to(dtype)
    smoo = torch.sum(segw * jerk_cost_b(sp.coeffs, dT), dim=0)    # [B]
    time_cost = torch.sum(segw * w.wei_time * T, dim=0)
    zero = torch.zeros((1, B), dtype=dtype, device=dev)
    if cfg.opt.ref_trajtime_compat:        # the reference's offsets (config)
        trajtime = torch.cat([zero, T[:-1]])
    else:
        trajtime = torch.cat([zero, torch.cumsum(T, dim=0)[:-1]])  # [S, B]

    safe_vn2 = torch.where(sp.valid, sp.vn2, torch.ones_like(sp.vn2))
    inv_vn = 1.0 / torch.sqrt(safe_vn2)
    vel2_reci = 1.0 / safe_vn2
    vel2_reci_e = 1.0 / (safe_vn2 + w.epis)
    vel32_reci_e = vel2_reci_e * torch.sqrt(vel2_reci_e)

    fwd = scen.singul > 0                                     # [S, B]

    def lim(a, b):
        return torch.where(fwd, a, b)[:, None, None, :]

    max_vel = lim(w.max_forward_vel, w.max_backward_vel)
    max_acc = lim(w.max_forward_acc, w.max_backward_acc)
    max_cur = lim(w.max_forward_cur, w.max_backward_cur)
    ego_R = _rot_from_vel_b(sp.dsig, sp.sgl, inv_vn)          # [S,N,K1,2,2,B]

    # --- static corridor penalty (traj_optimizer.cpp:592-622) ---
    backend = cfg.opt.corridor_backend
    if backend not in ("xla", "pallas", "auto"):
        raise ValueError(f"corridor_backend {backend!r}: 'xla', 'pallas' or "
                         "'auto'")
    if backend == "pallas" or (backend == "auto" and x.is_cuda):
        from dftpav_tpu_torch.ops.pallas_penalty import corridor_cost_pallas

        cost_obs = corridor_cost_pallas(
            sp.sig, sp.dsig, sp.sgl, sp.wq, scen.corr_n, scen.corr_p,
            scen.corr_mask, le_np, w.wei_obs)
    else:
        cost_obs = w.wei_obs * _corridor_plain(sp, ego_R, scen, le)

    # --- feasibility (traj_optimizer.cpp:642-705) ---
    dsig, ddsig = sp.dsig, sp.ddsig
    z_h1 = _dot2(ddsig, dsig)
    z_h3 = ddsig[..., 1, :] * dsig[..., 0, :] - ddsig[..., 0, :] * dsig[..., 1, :]
    viola_vel = sp.vn2 - max_vel * max_vel
    acc2 = z_h1 * z_h1 * vel2_reci
    viola_acc = acc2 - max_acc * max_acc
    cur = z_h3 * vel32_reci_e
    cost_feas = w.wei_feas * torch.sum(
        sp.wq * (smoothed_l1(viola_vel) + smoothed_l1(viola_acc)
                 + 10.0 * (smoothed_l1(cur - max_cur)
                           + smoothed_l1(-cur - max_cur))), dim=(0, 1, 2))

    # --- dynamic obstacles (traj_optimizer.cpp:1311-1684) ---
    cost_dyn = torch.zeros((B,), dtype=dtype, device=dev)
    if dims.O > 0:
        frac = c(grid.frac)
        abs_t = (trajtime[:, None, None, :]
                 + frac[None, :, :, None] * dT[:, None, None, :])
        pt_time = scen.obs_rel_t0[:, None, None, None, :] + abs_t[None]
        p_u, R_u = eval_obstacle_b(scen.obs_coef, scen.obs_dt,
                                   pt_time)                   # [O,S,N,K1,2,B]
        sig = sp.sig
        rel = p_u - sig[None]                                 # [O,S,N,K1,2,B]
        near = torch.sqrt(_dot2(rel, rel)) <= 1.5 * veh_len   # [O,S,N,K1,B]

        alpha = w.lse_alpha
        d_min = w.surround_clearance + math.log(8.0) / alpha
        dl_norm = np.linalg.norm(delta_np, axis=-1)
        e_hat = c(delta_np / dl_norm[:, None])                # [E, 2]
        H_e = _apply_R(_rot90(ego_R), e_hat)                  # [S,N,K1,E,2,B]
        H_o = _apply_R(_rot90(R_u), e_hat)                    # [O,S,N,K1,F,2,B]
        Rl_e = _apply_R(ego_R, le)                            # [S,N,K1,E,2,B]
        Rl_o = _apply_R(R_u, le)                              # [O,S,N,K1,F,2,B]

        rel = rel[:, :, :, :, None]                           # [O,S,N,K1,1,2,B]
        d_U_tilde = _dot2(H_e[None], rel - Rl_e[None])        # [O,S,N,K1,E,B]
        # cross_U[o, ..., e, f, b] = H_e[..., e, :, b] . Rl_o[o, ..., f, :, b]
        cross_U = _dot2(H_e[None, :, :, :, :, None], Rl_o[:, :, :, :, None])
        d_U = -torch.logsumexp(-alpha * cross_U, dim=-2) / alpha + d_U_tilde

        d_E_tilde = _dot2(H_o, -rel - Rl_o)                   # [O,S,N,K1,F,B]
        cross_E = _dot2(H_o[:, :, :, :, :, None], Rl_e[None, :, :, :, None])
        d_E = -torch.logsumexp(-alpha * cross_E, dim=-2) / alpha + d_E_tilde

        d_all = torch.cat([d_U, d_E], dim=-2)                 # [O,S,N,K1,8,B]
        d_val = d_min - torch.logsumexp(alpha * d_all, dim=-2) / alpha
        gate = near & scen.obs_mask[:, None, None, None] & sp.valid[None]
        pen_d = torch.where(gate, smoothed_l1(d_val), torch.zeros_like(d_val))
        cost_dyn = w.wei_surround * torch.sum(sp.wq[None] * pen_d,
                                              dim=(0, 1, 2, 3))

    total = smoo + time_cost + cost_obs + cost_dyn + cost_feas
    aux = dict(smoo=smoo, time=time_cost, obs=cost_obs, dyn=cost_dyn,
               feas=cost_feas, T=T, coeffs=sp.coeffs)
    return total, aux
