"""RSS (Responsibility-Sensitive Safety) distance checks, elementwise (the
port of `dftpav_tpu/urban/rss.py`; common::RssChecker in the reference).
Every function broadcasts over any batch; reverse-gear cases return 0."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RssConfig(NamedTuple):
    """RssChecker::RssConfig defaults."""

    response_time: float = 0.1
    lon_acc_max: float = 2.0
    lon_brake_min: float = 4.0
    lon_brake_max: float = 5.0
    lat_acc_max: float = 1.0
    lat_brake_min: float = 1.0
    lat_brake_max: float = 1.0
    lat_miu: float = 0.5


def safe_longitudinal_distance(ego_vel, other_vel, other_in_front,
                               cfg: RssConfig = RssConfig()):
    """CalculateSafeLongitudinalDistance: same-direction forward traffic;
    negative velocities give 0."""
    ev = ego_vel.abs()
    ov = other_vel.abs()
    ev_rt = ev + cfg.lon_acc_max * cfg.response_time
    ov_rt = ov + cfg.lon_acc_max * cfg.response_time

    # Front: ego accelerates for rho then min-brakes; other max-brakes.
    ego_driven_front = ((ev + ev_rt) / 2.0 * cfg.response_time
                        + ev_rt * ev_rt / (2.0 * cfg.lon_brake_min))
    other_driven_front = ov * ov / (2.0 * cfg.lon_brake_max)
    d_front = ego_driven_front - other_driven_front

    # Rear: other accelerates then min-brakes; ego max-brakes.
    ego_driven_rear = ev * ev / (2.0 * cfg.lon_brake_max)
    other_driven_rear = ((ov + ov_rt) / 2.0 * cfg.response_time
                         + ov_rt * ov_rt / (2.0 * cfg.lon_brake_min))
    d_rear = other_driven_rear - ego_driven_rear

    fwd = (ego_vel >= 0.0) & (other_vel >= 0.0)
    d = torch.where(other_in_front, d_front, d_rear)
    d = torch.where(fwd, d, 0.0)
    return torch.clamp(d, min=0.0)


def safe_lateral_distance(ego_lat_vel, other_lat_vel, other_on_left,
                          cfg: RssConfig = RssConfig()):
    """CalculateSafeLateralDistance: velocities signed + = left; the miu
    margin added."""
    ref = ego_lat_vel if torch.is_tensor(ego_lat_vel) else other_lat_vel
    ego_lat_vel, other_lat_vel = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
          for x in (ego_lat_vel, other_lat_vel)))
    ev = ego_lat_vel.abs()
    ov = other_lat_vel.abs()
    ev_rt = ev + cfg.response_time * cfg.lat_acc_max
    ov_rt = ov + cfg.response_time * cfg.lat_acc_max
    ego_active = ev * ev / (2.0 * cfg.lat_brake_max)
    ego_passive = ((ev + ev_rt) / 2.0 * cfg.response_time
                   + ev_rt * ev_rt / (2.0 * cfg.lat_brake_min))
    other_active = ov * ov / (2.0 * cfg.lat_brake_max)
    other_passive = ((ov + ov_rt) / 2.0 * cfg.response_time
                     + ov_rt * ov_rt / (2.0 * cfg.lat_brake_min))

    e_pos = ego_lat_vel >= 0.0
    o_pos = other_lat_vel >= 0.0
    d_left = torch.where(
        e_pos & o_pos, ego_passive - other_active,
        torch.where(e_pos & ~o_pos, ego_passive + other_passive,
                    torch.where(~e_pos & ~o_pos, other_passive - ego_active,
                                0.0)))
    d_right = torch.where(
        o_pos & e_pos, other_passive - ego_active,
        torch.where(o_pos & ~e_pos, other_passive + ego_passive,
                    torch.where(~o_pos & ~e_pos, ego_passive - other_active,
                                0.0)))
    d = torch.where(other_on_left, d_left, d_right)
    return torch.clamp(d, min=0.0) + cfg.lat_miu


def rss_safe(ego_s, ego_d, ego_vs, ego_vd, other_s, other_d, other_vs,
             other_vd, cfg: RssConfig = RssConfig()):
    """RssCheck on Frenet states: True where the longitudinal OR the lateral
    gap exceeds its safe distance."""
    in_front = other_s > ego_s
    on_left = other_d > ego_d
    d_lon = safe_longitudinal_distance(ego_vs, other_vs, in_front, cfg)
    d_lat = safe_lateral_distance(ego_vd, other_vd, on_left, cfg)
    unsafe = ((ego_s - other_s).abs() < d_lon) \
        & ((ego_d - other_d).abs() < d_lat)
    return ~unsafe


# ---------------------------------------------------------------------------
# Typed RSS check (the EUDM safety ladder input)
# ---------------------------------------------------------------------------

# LongitudinalViolateType (rss_checker.h:16)
LEGAL, TOO_FAST, TOO_SLOW = 0, 1, 2

_EPS = 1.0e-6  # common kEPS


def safe_longitudinal_velocity(other_vs, other_in_front, lon_dist_abs,
                               cfg: RssConfig = RssConfig()):
    """CalculateSafeLongitudinalVelocity: (ego_vel_low, ego_vel_up), the
    RSS-legal band of the ego's longitudinal velocity given the gap
    ``lon_dist_abs`` to the other vehicle."""
    ov = other_vs.abs()
    ov_rt = ov + cfg.lon_acc_max * cfg.response_time
    other_passive = ((ov + ov_rt) / 2.0 * cfg.response_time
                     + ov_rt * ov_rt / (2.0 * cfg.lon_brake_min))

    a = 1.0 / (2.0 * cfg.lon_brake_min)
    b = (cfg.response_time
         + cfg.lon_acc_max * cfg.response_time / cfg.lon_brake_min)
    c0 = 0.5 * (cfg.lon_acc_max
                + cfg.lon_acc_max ** 2 / cfg.lon_brake_min) \
        * cfg.response_time ** 2

    def quad_root(c):
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        return (-b + torch.sqrt(disc)) / (2.0 * a)

    other_hard = ov * ov / (2.0 * cfg.lon_brake_max)
    up_front_fwd = quad_root(c0 - other_hard - lon_dist_abs)
    up_front_bwd = torch.where(other_passive > lon_dist_abs, 0.0,
                               quad_root(c0 - (lon_dist_abs - other_passive)))
    up_front = torch.where(other_vs >= 0.0, up_front_fwd, up_front_bwd)
    low_front = torch.zeros_like(up_front)

    low_rear_fwd = torch.where(
        other_passive < lon_dist_abs, 0.0,
        torch.sqrt(2.0 * cfg.lon_brake_max
                   * torch.clamp(other_passive - lon_dist_abs, min=0.0)))
    low_rear = torch.where(other_vs >= 0.0, low_rear_fwd, 0.0)
    up_rear = torch.full_like(low_rear, torch.inf)

    low = torch.where(other_in_front, low_front, low_rear)
    up = torch.where(other_in_front, up_front, up_rear)
    return low, up


def rss_check_typed(ego_s, ego_d, ego_vs, ego_vd,
                    other_s, other_d, other_vs, other_vd,
                    ego_len, ego_width, ego_dcr,
                    other_len, other_width, other_dcr,
                    cfg: RssConfig = RssConfig()):
    """RssCheck, vehicle overload: (is_safe, lon_type, rss_vel_low,
    rss_vel_up) on rear-axle Frenet states; the velocity bounds are 0
    where legal."""
    in_front = other_s > ego_s
    on_left = other_d > ego_d

    d_lat_safe = safe_lateral_distance(ego_vd, other_vd, on_left, cfg) \
        + 0.5 * (ego_width + other_width)
    lat_clear = (ego_d - other_d).abs() > d_lat_safe

    ego_front_off = 0.5 * ego_len + ego_dcr
    ego_back_off = abs(0.5 * ego_len - ego_dcr)
    oth_front_off = 0.5 * other_len + other_dcr
    oth_back_off = abs(0.5 * other_len - other_dcr)
    gap = (ego_s - other_s).abs()
    lon_dist = torch.where(in_front, gap - ego_front_off - oth_back_off,
                           gap - oth_front_off - ego_back_off)

    overlap_front = (lon_dist < 0.0) & in_front

    low, up = safe_longitudinal_velocity(other_vs, in_front, lon_dist, cfg)
    too_fast = ego_vs > up + _EPS
    too_slow = ego_vs < low - _EPS

    lon_type = torch.where(too_fast, TOO_FAST,
                           torch.where(too_slow, TOO_SLOW, LEGAL))
    lon_type = torch.where(overlap_front, TOO_FAST, lon_type)
    vel_low = torch.where(overlap_front, 0.0,
                          torch.where(too_fast | too_slow, low, 0.0))
    vel_up = torch.where(overlap_front, 0.0,
                         torch.where(too_fast | too_slow, up, 0.0))

    legal_early = (ego_vs < 0.0) | lat_clear
    is_safe = legal_early | ((lon_type == LEGAL) & ~overlap_front)
    lon_type = torch.where(legal_early, LEGAL, lon_type)
    vel_low = torch.where(legal_early, 0.0, vel_low)
    vel_up = torch.where(legal_early, 0.0, vel_up)
    return is_safe, lon_type, vel_low, vel_up
