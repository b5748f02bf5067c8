"""Check-only fixtures of the port: long single-gear drives pieced as the
reference pieces a segment, for capacity-32 classes (segments of 17 to 32
pieces). The JAX package has no counterpart; the tests feed both packages
these arrays, and chip_smoke.py's phase 16 solves them on the card.

Pure numpy. Carry a batch to the card with
`types.from_numpy(batch, Scenario)`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dftpav_tpu_torch.basis import sample_grid
from dftpav_tpu_torch.scenarios import (_corridor_from_boxes, _no_obstacles,
                                        stack_scenarios)
from dftpav_tpu_torch.types import Dims, Scenario, state_to_flat


def _aisle_drive(x0, y0):
    """at(f) -> (positions [..., 2], yaws) at arc lengths f (an array) along
    a drive through a lot's aisles: from (x0, y0) along +x to x = 52, a
    left U-turn of 6.5 m radius into the next aisle, along -x to x = 16, a
    right U-turn into the third, along +x (150-153 m to its far end from
    x0 of 4-7 m)."""
    x_far, x_near, R = 52.0, 16.0, 6.5
    ends = np.cumsum([x_far - x0, np.pi * R, x_far - x_near, np.pi * R])

    def at(s):
        s = np.asarray(s, np.float64)
        seg = np.searchsorted(ends, s)
        r = s - np.concatenate([[0.0], ends])[seg]
        th_a = -np.pi / 2 + r / R           # CCW about (x_far, y0 + R)
        th_b = -np.pi / 2 - r / R           # CW about (x_near, y0 + 3 R)
        x = np.choose(seg, [x0 + r, x_far + R * np.cos(th_a), x_far - r,
                            x_near + R * np.cos(th_b), x_near + r])
        y = np.choose(seg, [y0 + 0 * r, y0 + R + R * np.sin(th_a),
                            y0 + 2 * R + 0 * r, y0 + 3 * R + R * np.sin(th_b),
                            y0 + 4 * R + 0 * r])
        yaw = np.choose(seg, [0 * r, th_a + np.pi / 2, np.pi + 0 * r,
                              th_b + 1.5 * np.pi, 0 * r])
        return np.stack([x, y], axis=-1), yaw
    return at


def long_gear_scenario(dims: Dims, rng, wheel_base=2.85, dtype=np.float64,
                       n_obstacles=0, obstacle_speed=2.0) -> Scenario:
    """A long single-gear drive through a parking lot's aisles to a far
    bay, then the maneuvers into it: each segment pieced as the reference
    pieces one (max(round(dur / 1 s), 2), traj_manager.cpp:543), its
    n_s pieces of 0.8-1.2 s (the first segment's 0.8-1.0 s) at the speeds
    of the front end's time profile (FrontendConfig: up to 5 m/s forward,
    2 m/s in reverse). Segment 0 drives forward at 3.5-4.5 m/s along
    _aisle_drive from (4-7, 5-7) m (a 32-piece segment: 90-144 m, through
    two U-turns of 6.5 m radius), so that every class of up to 32 + 8 + 4 +
    2 + 2 pieces stays inside a 40 x 60 m lot (random_lot_grid's default);
    then reverse segments back into a bay, 1.0-1.4 rad off the car's axis
    (to the side that ends nearer the lot's centre) at 1.0-1.6 m/s, and
    forward ones within +-0.3 rad of it at 1.5-2.5 m/s, straight.
    Inner waypoints at the pieces' ends on the initial path, box corridors
    (half-width 10 m) on each segment's sample grid, as
    multi_gear_scenario; `n_obstacles` movers cross segment 0
    (straight_scenario's). A start at the front end's speed matters: from
    3-4x slower, the plain round loop in float64 stalls in its line search
    on ~40% of such lanes while it compresses the time."""
    S, N = dims.S, dims.N
    ns = dims.ns_tuple
    drive = _aisle_drive(rng.uniform(4.0, 7.0), rng.uniform(5.0, 7.0))
    durs, paths = [], []     # paths: f in [0, 1] -> (positions, yaws)
    for i in range(S):
        if i == 0:
            dur = ns[0] * rng.uniform(0.8, 1.0)
            L = dur * rng.uniform(3.5, 4.5)
            paths.append(lambda f, L=L: drive(np.asarray(f) * L))
        else:
            a, yaw = paths[-1](1.0)
            dur = ns[i] * rng.uniform(0.8, 1.2)
            if i % 2:                 # reverse, the car facing yaw + d
                d = rng.uniform(1.0, 1.4)
                L = dur * rng.uniform(1.0, 1.6)
                # into the bay on the side that ends nearer the centre
                if (np.hypot(*(a + L * np.array([np.cos(yaw + np.pi + d),
                                                 np.sin(yaw + np.pi + d)])
                               - (30.0, 20.0)))
                        > np.hypot(*(a + L * np.array(
                            [np.cos(yaw + np.pi - d),
                             np.sin(yaw + np.pi - d)]) - (30.0, 20.0)))):
                    d = -d
                ang, yaw_i = yaw + np.pi + d, yaw + d
            else:
                ang = yaw_i = yaw + rng.uniform(-0.3, 0.3)
                L = dur * rng.uniform(1.5, 2.5)
            u = L * np.array([np.cos(ang), np.sin(ang)])
            paths.append(lambda f, a=a, u=u, y=yaw_i: (
                a + np.asarray(f)[..., None] * u,
                np.full(np.shape(f), y)))
        durs.append(dur)
    sing = [1 if i % 2 == 0 else -1 for i in range(S)]

    ini_l, fin_l, inner_l, cn_l, cp_l, cm_l = [], [], [], [], [], []
    for i in range(S):
        at = paths[i]
        vi = 1.0 if i == 0 else 0.2
        vo = 0.5 if i == S - 1 else 0.2
        (p0, _y), (p1, y1) = at(0.0), at(1.0)
        y0 = paths[i - 1](1.0)[1] if i > 0 else at(0.0)[1]
        ini_l.append(state_to_flat(p0, float(y0), vi, 0.0, 0.0, wheel_base,
                                   sing[i], dtype=dtype))
        fin_l.append(state_to_flat(p1, float(y1), vo, 0.0, 0.0, wheel_base,
                                   sing[i], dtype=dtype))
        inner = np.zeros((N - 1, 2), dtype)
        inner[:ns[i] - 1] = at(np.arange(1, ns[i]) / ns[i])[0]
        inner_l.append(inner)
        grid = sample_grid(ns[i], dims.K, dims.Kdes)
        cen = at(grid.frac / ns[i])[0].astype(dtype)     # [n_s, K1, 2]
        cn = np.zeros((N, dims.K1, dims.H, 2), dtype)
        cp = np.zeros((N, dims.K1, dims.H, 2), dtype)
        cm = np.zeros((N, dims.K1, dims.H), bool)
        d1 = dataclasses.replace(dims, N=ns[i], Ns=None)
        cn[:ns[i]], cp[:ns[i]], cm[:ns[i]] = _corridor_from_boxes(
            cen, 10.0, 10.0, d1, dtype)
        cn_l.append(cn)
        cp_l.append(cp)
        cm_l.append(cm)
    obs = _no_obstacles(dims, dtype)
    horizon = max(30.0, durs[0])
    for o in range(min(n_obstacles, dims.O)):
        dt = horizon / dims.Po
        ang = rng.uniform(0, 2 * np.pi)
        vel = obstacle_speed * np.array([np.cos(ang), np.sin(ang)])
        start = paths[0](rng.uniform(0.3, 0.7))[0] + rng.uniform(-1.5, 1.5,
                                                                 2)
        for pp in range(dims.Po):
            obs["obs_coef"][o, pp, 0] = start + vel * (pp * dt)
            obs["obs_coef"][o, pp, 1] = vel * dt
        obs["obs_dt"][o] = dt
        obs["obs_mask"][o] = True
    return Scenario(
        ini_state=np.stack(ini_l), fin_state=np.stack(fin_l),
        init_inner=np.stack(inner_l), init_T=np.asarray(durs, dtype),
        singul=np.asarray(sing, np.int32), seg_mask=np.ones((S,), bool),
        corr_n=np.stack(cn_l), corr_p=np.stack(cp_l),
        corr_mask=np.stack(cm_l), **obs)


def long_gear_batch(dims: Dims, batch: int, seed=0, dtype=np.float64,
                    n_obstacles=0) -> Scenario:
    """`batch` lanes of long_gear_scenario from one seeded generator."""
    rng = np.random.default_rng(seed)
    return stack_scenarios([long_gear_scenario(dims, rng, dtype=dtype,
                                               n_obstacles=n_obstacles)
                            for _ in range(batch)])
