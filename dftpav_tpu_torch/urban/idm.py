"""Intelligent Driver Model family: IDM, IIDM, ACC(+CAH), context IDM (the
port of `dftpav_tpu/urban/idm.py`; common::IntelligentDriverModel in the
reference). Pure elementwise functions that broadcast over any batch; a
parameter is a float or a tensor that broadcasts with the states."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class IDMParam(NamedTuple):
    """IntelligentDriverModel::Param defaults."""

    desired_velocity: float = 0.0    # v0
    vehicle_length: float = 5.0      # l_{alpha-1}
    min_spacing: float = 2.0         # s0
    headway_time: float = 1.0        # T
    acc_max: float = 2.0             # a
    comfortable_braking: float = 3.0  # b
    hard_braking: float = 5.0
    exponent: int = 4                # delta


def _sqrt(x):
    return torch.sqrt(x) if torch.is_tensor(x) else math.sqrt(x)


def _ipow(x, n: int):
    """x ** n for a positive integer n by repeated squaring, in the order
    JAX's integer_pow multiplies."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _safe_pow(x, e):
    return torch.exp(e * torch.log(torch.clamp(x, min=1e-30)))


def _max(a, b):
    """Elementwise max of a tensor and a float or tensor."""
    if torch.is_tensor(b):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b)


def idm_acc(p: IDMParam, s, v, s_front, v_front):
    """Plain IDM (GetIdmDesiredAcceleration)."""
    s_star = p.min_spacing + torch.clamp(
        v * p.headway_time
        + v * (v - v_front) / (2.0 * _sqrt(p.acc_max * p.comfortable_braking)),
        min=0.0)
    s_alpha = torch.clamp(s_front - s - p.vehicle_length, min=1e-9)
    v0 = _max(torch.as_tensor(p.desired_velocity, dtype=v.dtype,
                              device=v.device), 1e-9)
    return p.acc_max * (1.0 - _ipow(v / v0, p.exponent)
                        - _ipow(s_star / s_alpha, 2))


def iidm_acc(p: IDMParam, s, v, s_front, v_front):
    """Improved IDM (GetIIdmDesiredAcceleration), clamped to
    [-hard_braking, acc_max]."""
    v0 = torch.clamp(torch.as_tensor(p.desired_velocity, dtype=v.dtype,
                                     device=v.device), min=1e-9)
    vr = v / v0
    a, b = p.acc_max, p.comfortable_braking
    below = v <= p.desired_velocity
    a_free = torch.where(
        below,
        a * (1.0 - _safe_pow(vr, p.exponent)),
        -b * (1.0 - _safe_pow(1.0 / torch.clamp(vr, min=1e-9),
                              a * p.exponent / b)),
    )
    s_alpha = torch.clamp(s_front - s - p.vehicle_length, min=1e-9)
    s_star = p.min_spacing + torch.clamp(
        v * p.headway_time + v * (v - v_front) / (2.0 * _sqrt(a * b)),
        min=0.0)
    z = s_star / s_alpha
    # z >= 1 -> constrained braking; z < 1 -> free-flow blend
    a_free_safe = torch.where(a_free.abs() < 1e-9, 1e-9, a_free)
    blend = a_free * (1.0 - _safe_pow(z, 2.0 * a / a_free_safe))
    a_out = torch.where(
        below,
        torch.where(z >= 1.0, a * (1.0 - z * z), blend),
        torch.where(z >= 1.0, a_free + a * (1.0 - z * z), a_free),
    )
    return torch.clamp(a_out, min=-p.hard_braking, max=p.acc_max)


def acc_acc(p: IDMParam, s, v, s_front, v_front):
    """ACC = IIDM blended with the constant-acceleration heuristic (CAH)
    (GetAccDesiredAcceleration)."""
    a_iidm = iidm_acc(p, s, v, s_front, v_front)
    b = p.comfortable_braking
    ds = torch.clamp(s_front - s, min=0.0)
    denom = v_front * v_front + 2.0 * ds * b
    acc_cah = (v * v * -b) / torch.clamp(denom, min=1e-9)
    coolness = 0.99
    blended = (1.0 - coolness) * a_iidm + coolness * (
        acc_cah - b * torch.tanh((a_iidm - acc_cah) / -b))
    return torch.where(a_iidm >= acc_cah, a_iidm, blended)


def _rk4(deriv, y0, dt):
    """One classic RK4 step on a tuple of tensors."""
    def add(y, k, h):
        return tuple(a + h * b for a, b in zip(y, k))

    k1 = deriv(y0)
    k2 = deriv(add(y0, k1, 0.5 * dt))
    k3 = deriv(add(y0, k2, 0.5 * dt))
    k4 = deriv(add(y0, k3, dt))
    return tuple(y + (dt / 6.0) * (a + 2 * b + 2 * c + d)
                 for y, a, b, c, d in zip(y0, k1, k2, k3, k4))


def idm_velocity(p: IDMParam, s, s_front, v, v_front, dt):
    """Desired velocity after dt under ACC dynamics: one RK4 step of the
    4-state IDM ODE [s, v, s_front, v_front] (IntelligentVelocityControl),
    the front vehicle at constant velocity."""
    v = torch.clamp(v, min=0.0)

    def deriv(y):
        si, vi, sf, vf = y
        acc = acc_acc(p, si, vi, sf, vf)
        acc = torch.maximum(acc, -torch.clamp(vi / dt, max=p.hard_braking))
        return vi, acc, vf, torch.zeros_like(vf)

    y0 = torch.broadcast_tensors(s, v, s_front, v_front)
    return torch.clamp(_rk4(deriv, y0, dt)[1], min=0.0)


def ctx_idm_velocity(p: IDMParam, s, v, s_front, v_front,
                     s_target, v_target, dt, k_s: float = 0.4,
                     k_v: float = 0.8):
    """Context IDM: velocity tracking a moving (gap) target state,
    v_ref = v_target + k_s (s_target - s); acc = clip(k_v (v_ref - v), -1, 1).
    s_front / v_front do not affect the result, as in the reference."""
    del s_front, v_front

    def deriv(y):
        si, vi, st, vt = y
        v_ref = vt + k_s * (st - si)
        acc = torch.clamp(k_v * (v_ref - vi), min=-1.0, max=1.0)
        return vi, acc, vt, torch.zeros_like(vt)

    y0 = torch.broadcast_tensors(s, v, s_target, v_target)
    return torch.clamp(_rk4(deriv, y0, dt)[1], min=0.0)
