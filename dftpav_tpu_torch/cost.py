"""Objective building blocks shared by the objectives (ops/kcost.py,
ops/bcost.py) and the solver setup: the smoothed-L1 hinge, the virtual-time
map, decision-vector packing and the hull constants. Functions take tensors
with any leading batch shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
