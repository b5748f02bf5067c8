"""Quintic Bezier spline utilities for the SSC planner (the port of
`dftpav_tpu/ssc/bezier.py`). The spline stores *normalized* control points:
the position on segment n of duration s_n is
p(t) = s_n * sum_j x_{n,j} B^5_j((t - t_n)/s_n)."""

from __future__ import annotations

from math import comb
from typing import NamedTuple

import numpy as np
import torch

from dftpav_tpu_torch.urban.idm import _ipow

N_DEG = 5
N_ORD = N_DEG + 1

# jerk Hessian for quintic Bezier (bezier.h:130-151)
JERK_HESSIAN = np.array([
    [720.0, -1800.0, 1200.0, 0.0, 0.0, -120.0],
    [-1800.0, 4800.0, -3600.0, 0.0, 600.0, 0.0],
    [1200.0, -3600.0, 3600.0, -1200.0, 0.0, 0.0],
    [0.0, 0.0, -1200.0, 3600.0, -3600.0, 1200.0],
    [0.0, 600.0, 0.0, -3600.0, 4800.0, -1800.0],
    [-120.0, 0.0, 0.0, 1200.0, -1800.0, 720.0],
])


class BezierSpline(NamedTuple):
    """Piecewise quintic Bezier in the (s, d) Frenet plane.

    ctrl: [..., 2, M, 6] normalized control points (dim, segment, order);
    t_lb/t_ub: [..., M] segment time bounds.
    """

    ctrl: torch.Tensor
    t_lb: torch.Tensor
    t_ub: torch.Tensor


def _pow(x, n: int):
    return torch.ones_like(x) if n == 0 else _ipow(x, n)


def _bern(tau, deg: int):
    """[..., deg+1] Bernstein basis of degree deg at tau."""
    return torch.stack([comb(deg, j) * _pow(tau, j) * _pow(1 - tau, deg - j)
                        for j in range(deg + 1)], dim=-1)


def _diff_ctrl(ctrl):
    """Derivative control points: quintic -> quartic, scaled by N_DEG."""
    return N_DEG * (ctrl[..., 1:] - ctrl[..., :-1])


def bezier_eval(spline: BezierSpline, t):
    """(pos, vel, acc) [..., K, 2] of splines [...] at times t [..., K].

    Clamps t to the spline domain; position carries a factor s, velocity
    s^0, acceleration s^-1.
    """
    ctrl, t_lb, t_ub = spline.ctrl, spline.t_lb, spline.t_ub
    t = torch.minimum(torch.maximum(t, t_lb[..., :1]), t_ub[..., -1:] - 1e-9)
    # segment index: last n with t_lb[n] <= t
    n = torch.clamp((t[..., None] >= t_lb[..., None, :]).sum(-1) - 1, min=0)
    lead = n.shape[:-1]
    K = n.shape[-1]

    def seg(x):  # x [*, M] at n -> [*, K]
        return torch.gather(x.expand(lead + x.shape[-1:]), -1, n)

    s = seg(t_ub) - seg(t_lb)
    tau = (t - seg(t_lb)) / s

    def rows(c):  # c [*, 2, M, J] at n -> [*, K, 2, J]
        c = c.unsqueeze(-4).expand(lead + (K,) + c.shape[-3:])
        idx = n.reshape(n.shape + (1, 1, 1)).expand(
            n.shape + (c.shape[-3], 1, c.shape[-1]))
        return torch.gather(c, -2, idx).squeeze(-2)

    d1 = _diff_ctrl(ctrl)
    d2 = _diff_ctrl(d1)
    pos = (rows(ctrl) * _bern(tau, 5)[..., None, :]).sum(-1) * s[..., None]
    vel = (rows(d1) * _bern(tau, 4)[..., None, :]).sum(-1)
    acc = (rows(d2) * _bern(tau, 3)[..., None, :]).sum(-1) / s[..., None]
    return pos, vel, acc
