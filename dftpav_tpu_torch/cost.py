"""The trajectory-optimization objective in its readable per-scenario form
(`dftpav_tpu/cost.py`), and the building blocks shared with the batched
objectives (ops/kcost.py, ops/bcost.py) and the solver setup: the
smoothed-L1 hinge, the virtual-time map, decision-vector packing and the
hull constants.

`total_cost` reproduces the forward cost of the reference's
PolyTrajOptimizer::costFunctionCallback + addPVAGradCost2CT +
dynamicObsGradCostP (traj_optimizer.cpp:206-350, 422-779, 1311-1684); its
gradient is autograd's. It is the objective of make_solver(engine="vmap"),
the reference engine: plain PyTorch on any device, no kernel. Functions
take tensors with any leading batch shape (the JAX package's vmap axes),
each scenario computed on its own.

Known intentional deviations from the reference, as in the JAX package:
segment time offsets use the true cumulative sum of the durations (the
reference's `trajtimes = [0, T0, T1, ...]` with OptConfig.
ref_trajtime_compat), and autograd charges the dynamic-obstacle time
gradient to the right segment (the reference's attribution with
ref_compat_value_and_grad).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dftpav_tpu_torch import minco
from dftpav_tpu_torch.basis import SampleGrid, sample_grid
from dftpav_tpu_torch.types import Dims, Scenario, Weights

_PE = 1.0e-4


def smoothed_l1(x: torch.Tensor) -> torch.Tensor:
    """C^2 hinge (positiveSmoothedL1, traj_optimizer.cpp:783-806): 0 for
    x <= 0, cubic blend on (0, pe), x - pe/2 above. The clip keeps the cubic
    branch finite under autograd."""
    f3c = 1.0 / (_PE * _PE)
    f4c = -0.5 * f3c / _PE
    xc = torch.clamp(x, 0.0, _PE)
    small = (f4c * xc + f3c) * xc * xc * xc
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x < _PE, small, x - 0.5 * _PE))


def virtual_to_real(vt: torch.Tensor, mini_t) -> torch.Tensor:
    """Virtual -> real duration diffeomorphism (traj_optimizer.cpp:361-379)."""
    pos = (0.5 * vt + 1.0) * vt + 1.0
    neg = 1.0 / ((0.5 * vt - 1.0) * vt + 1.0)
    return torch.where(vt > 0.0, pos, neg) + mini_t


def real_to_virtual(rt: torch.Tensor, mini_t) -> torch.Tensor:
    big = torch.sqrt(torch.clamp(2.0 * rt - 1.0 - 2.0 * mini_t, min=0.0)) - 1.0
    small = 1.0 - torch.sqrt(torch.clamp(
        2.0 / torch.clamp(rt - mini_t, min=1e-12) - 1.0, min=0.0))
    return torch.where(rt > 1.0 + mini_t, big, small)


class Unpacked(NamedTuple):
    inner: torch.Tensor      # [..., S, N-1, 2]
    vt: torch.Tensor         # [..., S]
    gear_pos: torch.Tensor   # [..., S-1, 2]
    gear_ang: torch.Tensor   # [..., S-1]


def unpack(x: torch.Tensor, dims: Dims) -> Unpacked:
    """Decision vector(s) [..., dim] -> parts (traj_optimizer.cpp:96-115)."""
    S, N = dims.S, dims.N
    lead = x.shape[:-1]
    n_in = S * (N - 1) * 2
    inner = x[..., :n_in].reshape(*lead, S, N - 1, 2)
    vt = x[..., n_in:n_in + S]
    gp = x[..., n_in + S:n_in + S + 2 * (S - 1)].reshape(
        *lead, max(S - 1, 0), 2)
    ga = x[..., n_in + S + 2 * (S - 1):]
    return Unpacked(inner, vt, gp, ga)


def pack(u: Unpacked) -> torch.Tensor:
    """Parts -> decision vector(s) [..., dim] (the inverse of unpack)."""
    n = u.vt.dim() - 1                               # leading batch dims
    return torch.cat([u.inner.flatten(n), u.vt, u.gear_pos.flatten(n),
                      u.gear_ang], dim=-1)


def initial_guess(scen: Scenario, w: Weights, dims: Dims) -> torch.Tensor:
    """x0 [..., dim] from (batched) scenarios (traj_optimizer.cpp:96-115):
    the front end's waypoints and durations, and for S > 1 each gear
    junction at the earlier segment's end state (position, heading of its
    velocity)."""
    vt = real_to_virtual(scen.init_T, float(w.mini_t))
    inner = scen.init_inner
    if dims.S > 1:
        gear_pos = scen.fin_state[..., :-1, :, 0]
        gv = scen.fin_state[..., :-1, :, 1]
        gear_ang = torch.atan2(gv[..., 1], gv[..., 0])
    else:
        lead = inner.shape[:-3]
        gear_pos = inner.new_zeros((*lead, 0, 2))
        gear_ang = inner.new_zeros((*lead, 0))
    return pack(Unpacked(inner, vt, gear_pos, gear_ang))


def hull_arrays(cfg, dtype=np.float64):
    """(vec_le [4,2], delta_le [4,2], inflated vehicle length) as numpy
    constants: the clockwise optimizer hull with the closing edge folded
    into delta (traj_optimizer.cpp:1760-1776)."""
    le = np.asarray(cfg.ego_hull(), dtype)
    delta = np.roll(le, -1, axis=0) - le
    veh_len = cfg.vehicle.length + 2.0 * cfg.opt.half_margin
    return le, delta, veh_len


def boundary_states(scen: Scenario, u: Unpacked, w: Weights, dims: Dims):
    """Per-segment head and tail PVA [..., S, 2, 3] with the gear-junction
    decision overrides (costFunctionCallback:269-282): a junction whose
    later segment is unmasked takes its position from the gear variable
    and its velocity +-non_sinv (cos a, sin a) (tail of the earlier segment
    +, head of the later -); accelerations stay the front end's. A padded
    tail keeps its fin_state, or the last real segment's endpoint would
    become a free variable."""
    heads, tails = scen.ini_state, scen.fin_state
    if dims.S > 1:
        gvel = w.non_sinv * torch.stack([torch.cos(u.gear_ang),
                                         torch.sin(u.gear_ang)], dim=-1)
        jmask = scen.seg_mask[..., 1:, None]                  # [..., S-1, 1]
        h, t = heads[..., 1:, :, :], tails[..., :-1, :, :]
        h1 = torch.stack([torch.where(jmask, u.gear_pos, h[..., 0]),
                          torch.where(jmask, -gvel, h[..., 1]), h[..., 2]],
                         dim=-1)
        t0 = torch.stack([torch.where(jmask, u.gear_pos, t[..., 0]),
                          torch.where(jmask, gvel, t[..., 1]), t[..., 2]],
                         dim=-1)
        heads = torch.cat([heads[..., :1, :, :], h1], dim=-3)
        tails = torch.cat([t0, tails[..., -1:, :, :]], dim=-3)
    return heads, tails


def eval_obstacle(coef: torch.Tensor, dt: torch.Tensor, t: torch.Tensor):
    """Obstacle trajectories at times t (>= 0, may pass the horizon).

    coef [..., Po, 6, 2] normalized coefficients, dt [...] piece durations,
    t [..., *ts] times. Returns (pos, vel, acc) [..., *ts, 2] and the
    forward-singul frame R [..., *ts, 2, 2]. Within the horizon, the piece's
    polynomial; past it, p / v / a extrapolate the end state at constant
    acceleration while R keeps extrapolating the last polynomial
    (traj_optimizer.cpp:1372-1389, Trajectory::getR via locatePieceIdx)."""
    Po = coef.shape[-3]
    lead, ts = coef.shape[:-3], t.shape[coef.dim() - 3:]
    dte = dt.reshape(*lead, *([1] * len(ts)))
    total = dte * Po
    inside = t < total
    tc = torch.minimum(t, total)
    idx = torch.clamp((tc / dte).to(torch.int64), 0, Po - 1)
    tau_in = tc / dte - idx.to(coef.dtype)
    flat = idx.reshape(*lead, -1, 1).expand(*lead, -1, 12)
    ci = torch.gather(coef.reshape(*lead, Po, 12), -2, flat).reshape(
        *lead, *ts, 6, 2)
    p_in, v_in, a_in = minco.eval_derivatives(ci, dte, tau_in, (0, 1, 2))
    # end state (tau = 1 on the last piece)
    last = coef[..., -1, :, :].reshape(*lead, *([1] * len(ts)), 6, 2)
    p_end, v_end, a_end = minco.eval_derivatives(
        last, dte, torch.ones_like(dte), (0, 1, 2))
    ex = torch.clamp(t - total, min=0.0)[..., None]
    p_ex = p_end + ex * v_end + 0.5 * ex * ex * a_end
    v_ex = v_end + ex * a_end
    ins = inside[..., None]
    pos = torch.where(ins, p_in, p_ex)
    vel = torch.where(ins, v_in, v_ex)
    acc = torch.where(ins, a_in, a_end.expand_as(a_in))
    # rotation frame: the last piece's polynomial past the horizon (idx is
    # clipped to it there)
    tau_r = torch.where(inside, tau_in, 1.0 + ex[..., 0] / dte)
    (v_r,) = minco.eval_derivatives(ci, dte, tau_r, (1,))
    # rsqrt of the clamped SQUARED norm: sqrt(0) has an infinite derivative,
    # and a masked zero-coefficient obstacle slot would NaN the gradient
    vn2 = torch.clamp(torch.sum(v_r * v_r, -1, keepdim=True), min=1e-24)
    vu = v_r * torch.rsqrt(vn2)
    R = torch.stack([torch.stack([vu[..., 0], -vu[..., 1]], -1),
                     torch.stack([vu[..., 1], vu[..., 0]], -1)], -2)
    return pos, vel, acc, R


def _rot_from_vel(dsig, singul, inv_norm):
    """ego_R = singul * [[dx, -dy], [dy, dx]] / |dsigma|
    (traj_optimizer.cpp:581-583); dsig [..., N, K1, 2], singul [...]."""
    sg = singul.to(dsig.dtype)[..., None, None, None, None]
    R = torch.stack([torch.stack([dsig[..., 0], -dsig[..., 1]], -1),
                     torch.stack([dsig[..., 1], dsig[..., 0]], -1)], -2)
    return sg * R * inv_norm[..., None, None]


def segment_penalties(b, dT, singul, trajtime, scen_seg, w: Weights,
                      grid: SampleGrid, hull, obstacles, dims: Dims):
    """Penalty integrals of one gear segment per leading index
    (addPVAGradCost2CT).

    b [..., N, 6, 2] normalized coefficients; dT, singul (+-1) and
    trajtime (the segment's absolute start within the plan) [...];
    scen_seg = (corr_n, corr_p, corr_mask) of the segment
    [..., N, K1, H(, 2)]; obstacles = (obs_coef [..., O, Po, 6, 2],
    obs_dt, obs_rel_t0, obs_mask [..., O]) with the same leading shape.
    Returns dict(obs=, dyn=, feas=) of costs [...].
    """
    dtype, dev = b.dtype, b.device
    c = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    corr_n, corr_p, corr_mask = scen_seg
    le, delta_le, veh_len = hull
    le, delta_le = c(le), c(delta_le)
    beta = [c(bb) for bb in grid.beta[:3]]
    omg, inv_k, frac = c(grid.omg), c(grid.inv_k), c(grid.frac)
    pen_mask = torch.as_tensor(grid.pen_mask, device=dev)

    # --- sample sigma and derivatives: [..., N, K1, 2] ---
    dTe = dT[..., None, None, None]
    sig = torch.einsum("nkc,...ncd->...nkd", beta[0], b)
    dsig = torch.einsum("nkc,...ncd->...nkd", beta[1], b) / dTe
    ddsig = torch.einsum("nkc,...ncd->...nkd", beta[2], b) / (dTe * dTe)

    vn2 = torch.sum(dsig * dsig, -1)
    valid = pen_mask & (torch.sqrt(vn2) >= 1e-4)
    safe_vn2 = torch.where(valid, vn2, torch.ones_like(vn2))
    inv_vn = 1.0 / torch.sqrt(safe_vn2)
    vel2_reci = 1.0 / safe_vn2
    vel2_reci_e = 1.0 / (safe_vn2 + w.epis)
    vel32_reci_e = vel2_reci_e * torch.sqrt(vel2_reci_e)

    step = dT[..., None, None] * inv_k[:, None]         # [..., N, 1]
    wq = torch.where(valid, omg * step, torch.zeros_like(vn2))

    # per-direction limits (traj_optimizer.cpp:447-457)
    fwd = (singul > 0)[..., None, None]
    max_vel = torch.where(fwd, w.max_forward_vel, w.max_backward_vel)
    max_acc = torch.where(fwd, w.max_forward_acc, w.max_backward_acc)
    max_cur = torch.where(fwd, w.max_forward_cur, w.max_backward_cur)

    ego_R = _rot_from_vel(dsig, singul, inv_vn)         # [..., N, K1, 2, 2]

    # --- static corridor penalty (traj_optimizer.cpp:592-622) ---
    bpt = sig[..., None, :] + torch.einsum("...nkij,ej->...nkei", ego_R, le)
    viol = torch.einsum("...nkhd,...nkehd->...nkeh", corr_n,
                        bpt[..., :, None, :] - corr_p[..., None, :, :])
    pen = smoothed_l1(viol) * corr_mask[..., None, :].to(dtype)
    cost_obs = w.wei_obs * torch.sum(wq[..., None, None] * pen,
                                     dim=(-4, -3, -2, -1))

    # --- feasibility (traj_optimizer.cpp:642-705) ---
    z_h1 = torch.sum(ddsig * dsig, -1)
    z_h3 = ddsig[..., 1] * dsig[..., 0] - ddsig[..., 0] * dsig[..., 1]
    viola_vel = vn2 - max_vel * max_vel
    acc2 = z_h1 * z_h1 * vel2_reci
    viola_acc = acc2 - max_acc * max_acc
    cur = z_h3 * vel32_reci_e
    cost_feas = w.wei_feas * torch.sum(
        wq * (smoothed_l1(viola_vel) + smoothed_l1(viola_acc)
              + 10.0 * (smoothed_l1(cur - max_cur)
                        + smoothed_l1(-cur - max_cur))), dim=(-2, -1))

    # --- dynamic obstacles (traj_optimizer.cpp:1311-1684) ---
    cost_dyn = torch.zeros_like(cost_obs)
    if dims.O > 0:
        obs_coef, obs_dt, obs_rel_t0, obs_mask = obstacles
        abs_t = trajtime[..., None, None] + frac * dT[..., None, None]
        pt_time = obs_rel_t0[..., :, None, None] + abs_t[..., None, :, :]
        p_u, _v_u, _a_u, R_u = eval_obstacle(obs_coef, obs_dt, pt_time)
        # [..., O, N, K1, 2]; R_u [..., O, N, K1, 2, 2]

        # proximity gate (traj_optimizer.cpp:1393)
        near = torch.linalg.norm(p_u - sig[..., None, :, :, :], dim=-1) \
            <= 1.5 * veh_len

        alpha = w.lse_alpha
        d_min = w.surround_clearance + math.log(8.0) / alpha
        e_hat = delta_le / torch.linalg.norm(delta_le, dim=-1)[:, None]
        Bm = c([[0.0, -1.0], [1.0, 0.0]])
        # ego-edge normals H_e = B R_e dle / |dle|: [..., N, K1, E, 2]
        H_e = torch.einsum("ij,...nkjl,el->...nkei", Bm, ego_R, e_hat)
        # surround-edge normals: [..., O, N, K1, F, 2]
        H_o = torch.einsum("ij,...onkjl,fl->...onkfi", Bm, R_u, e_hat)
        Rl_e = torch.einsum("...nkij,ej->...nkei", ego_R, le)
        Rl_o = torch.einsum("...onkij,fj->...onkfi", R_u, le)

        rel = p_u[..., None, :] - sig[..., None, :, :, None, :]
        d_U_tilde = torch.sum(H_e[..., None, :, :, :, :]
                              * (rel - Rl_e[..., None, :, :, :, :]), -1)
        cross_U = torch.einsum("...nkei,...onkfi->...onkef", H_e, Rl_o)
        d_U = -torch.logsumexp(-alpha * cross_U, dim=-1) / alpha + d_U_tilde

        d_E_tilde = torch.sum(H_o * (-rel - Rl_o), -1)
        cross_E = torch.einsum("...onkfi,...nkei->...onkfe", H_o, Rl_e)
        d_E = -torch.logsumexp(-alpha * cross_E, dim=-1) / alpha + d_E_tilde

        d_all = torch.cat([d_U, d_E], dim=-1)              # [..., O,N,K1,8]
        d_val = d_min - torch.logsumexp(alpha * d_all, dim=-1) / alpha
        gate = near & obs_mask[..., :, None, None] & valid[..., None, :, :]
        pen_d = torch.where(gate, smoothed_l1(d_val), torch.zeros_like(d_val))
        cost_dyn = w.wei_surround * torch.sum(wq[..., None, :, :] * pen_d,
                                              dim=(-3, -2, -1))

    return dict(obs=cost_obs, dyn=cost_dyn, feas=cost_feas)


def total_cost(x: torch.Tensor, scen: Scenario, w: Weights, dims: Dims,
               cfg, trajtime_override=None) -> tuple[torch.Tensor, dict]:
    """Objective per scenario: x [..., dim] and scenarios with the same
    leading shape -> (f [...], aux). Mirrors costFunctionCallback
    (traj_optimizer.cpp:206-350); autograd of it is the vmap engine's
    oracle. trajtime_override ([..., S]) replaces the segments' absolute
    time offsets (ref_compat_value_and_grad splits the time chain with
    it)."""
    dtype, dev = x.dtype, x.device
    N, S = dims.N, dims.S
    grid = sample_grid(N, dims.K, dims.Kdes)
    maps = minco.maps_as(N, dtype, dev)
    hull = hull_arrays(cfg)

    u = unpack(x, dims)
    T = virtual_to_real(u.vt, w.mini_t)                      # [..., S]
    dT = T / N
    heads, tails = boundary_states(scen, u, w, dims)
    bs = minco.generate(u.inner, dT, heads, tails, maps)     # [..., S,N,6,2]

    segw = scen.seg_mask.to(dtype)
    smoo = torch.sum(segw * minco.jerk_cost(bs, dT), -1)
    time_cost = torch.sum(segw * w.wei_time * T, -1)

    zero = torch.zeros_like(T[..., :1])
    if trajtime_override is not None:
        trajtime = trajtime_override
    elif cfg.opt.ref_trajtime_compat:
        # reference quirk: segment i offset by T_{i-1} alone (OptConfig)
        trajtime = torch.cat([zero, T[..., :-1]], -1)
    else:
        trajtime = torch.cat([zero, torch.cumsum(T, -1)[..., :-1]], -1)
    # the obstacles are the scenario's, shared by its segments
    per_seg = lambda a, k: a.unsqueeze(-k - 1).expand(
        *a.shape[:a.dim() - k], S, *a.shape[a.dim() - k:])
    obstacles = (per_seg(scen.obs_coef, 4), per_seg(scen.obs_dt, 1),
                 per_seg(scen.obs_rel_t0, 1), per_seg(scen.obs_mask, 1))
    pens = segment_penalties(bs, dT, scen.singul, trajtime,
                             (scen.corr_n, scen.corr_p, scen.corr_mask), w,
                             grid, hull, obstacles, dims)

    cost_obs = torch.sum(segw * pens["obs"], -1)
    cost_dyn = torch.sum(segw * pens["dyn"], -1)
    cost_feas = torch.sum(segw * pens["feas"], -1)

    total = smoo + time_cost + cost_obs + cost_dyn + cost_feas
    aux = dict(smoo=smoo, time=time_cost, obs=cost_obs, dyn=cost_dyn,
               feas=cost_feas, T=T, coeffs=bs)
    return total, aux


def ref_compat_value_and_grad(scen: Scenario, w: Weights, dims: Dims, cfg,
                              scale=1.0):
    """(f, g) oracle that reproduces the compiled reference for S >= 2 with
    dynamic obstacles, its gradient bug included.

    The reference's hand-written adjoint credits the cross-segment
    absolute-time sensitivity of a constraint point in segment i to the
    CURRENT segment's duration, once per earlier segment
    (traj_optimizer.cpp:1674-1676): i * dF/dtrajtime_i is added to dF/dT_i,
    while its forward cost uses trajtime_i = T_{i-1}
    (traj_optimizer.cpp:230-234). The gradient is therefore not that of the
    value, and this oracle splits the chain as the JAX package does:

      f        = F(x, trajtime = [0, T_0, ..., T_{S-2}])
      g        = dF/dx holding trajtime fixed
      g_vt[i] += i * (dF/dtrajtime_i) * dT_i/dvt_i
    """
    n_in = dims.S * (dims.N - 1) * 2

    def fun(x):
        x = x.detach()
        vt = unpack(x, dims).vt.clone()
        T = virtual_to_real(vt, w.mini_t)
        tt = torch.cat([torch.zeros_like(T[..., :1]), T[..., :-1]], -1)
        with torch.enable_grad():
            xg = x.clone().requires_grad_(True)
            ttg = tt.requires_grad_(True)
            f = scale * total_cost(xg, scen, w, dims, cfg,
                                   trajtime_override=ttg)[0]
            gx, gh = torch.autograd.grad(f.sum(), (xg, ttg))
            vg = vt.clone().requires_grad_(True)
            (dT_dvt,) = torch.autograd.grad(
                virtual_to_real(vg, w.mini_t).sum(), vg)
        idx = torch.arange(dims.S, dtype=x.dtype, device=x.device)
        gx = gx.clone()
        gx[..., n_in:n_in + dims.S] += idx * gh * dT_dvt
        return f.detach(), gx

    return fun
