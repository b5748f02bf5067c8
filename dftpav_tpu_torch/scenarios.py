"""Synthetic parking problems for tests and benchmarks: random
single-segment maneuvers and a two-segment gear change.

Pure numpy, identical to `dftpav_tpu.scenarios` for the same seed (the
parity tests check the arrays bit for bit). Carry a batch to the card
with `types.from_numpy(batch, Scenario)`.
"""

from __future__ import annotations

import numpy as np

from dftpav_tpu_torch import minco
from dftpav_tpu_torch.basis import sample_grid
from dftpav_tpu_torch.config import VehicleParam
from dftpav_tpu_torch.types import Dims, Scenario, state_to_flat


def _init_traj_centers(ini, fin, inner, total_T, dims: Dims, dtype):
    """Sample the initial-guess MINCO trajectory at the constraint grid
    (corridors are centred on the curve the optimizer is seeded with,
    traj_manager.cpp:531-594). Returns positions and unit headings
    [N, K1, 2]."""
    N = dims.N
    grid = sample_grid(dims.N, dims.K, dims.Kdes)
    dT = total_T / N
    Ainv = minco.minco_inverse(N)
    rhs = np.zeros((6 * N, 2))
    rhs[0] = ini[:, 0]
    rhs[1] = ini[:, 1] * dT
    rhs[2] = ini[:, 2] * dT * dT
    rhs[5:6 * (N - 1):6] = inner
    rhs[6 * N - 3] = fin[:, 0]
    rhs[6 * N - 2] = fin[:, 1] * dT
    rhs[6 * N - 1] = fin[:, 2] * dT * dT
    b = (Ainv @ rhs).reshape(N, 6, 2)
    pos = np.einsum("nkc,ncd->nkd", grid.beta[0], b).astype(dtype)
    dpos = np.einsum("nkc,ncd->nkd", grid.beta[1], b).astype(dtype)
    vn = np.linalg.norm(dpos, axis=-1, keepdims=True)
    head = np.where(vn > 1e-9, dpos / np.maximum(vn, 1e-9),
                    np.array([1.0, 0.0], dtype))
    return pos, head


def _corridor_from_obb(pos, head, grow, dims: Dims, dtype,
                       vehicle=None, singul=1):
    """Heading-aligned rectangle corridors grown from the vehicle footprint
    by `grow` on every side (getRectangleConst, traj_manager.cpp:1213-1469)."""
    vp = vehicle or VehicleParam()
    h = head * float(singul)
    nvec = np.stack([-h[..., 1], h[..., 0]], axis=-1)
    center = pos + vp.d_cr * h
    ext_l = vp.length / 2.0 + grow
    ext_w = vp.width / 2.0 + grow
    n = np.stack([h, -h, nvec, -nvec], axis=-2).astype(dtype)   # [N,K1,4,2]
    p = np.stack([center + ext_l * h, center - ext_l * h,
                  center + ext_w * nvec, center - ext_w * nvec],
                 axis=-2).astype(dtype)
    mask = np.zeros(n.shape[:-1], bool)
    mask[..., :4] = True
    return n, p, mask


def _corridor_from_boxes(centers, half_x, half_y, dims: Dims, dtype):
    """Axis-aligned rectangle corridors around centers [N, K1, 2]:
    (corr_n, corr_p, corr_mask) for one segment, outward unit normal n and
    boundary point p per half-plane."""
    N, K1 = dims.N, dims.K1
    n = np.zeros((N, K1, dims.H, 2), dtype)
    p = np.zeros((N, K1, dims.H, 2), dtype)
    n[..., 0, :] = (1.0, 0.0)
    n[..., 1, :] = (-1.0, 0.0)
    n[..., 2, :] = (0.0, 1.0)
    n[..., 3, :] = (0.0, -1.0)
    p[..., 0, :] = centers + np.array([half_x, 0.0], dtype)
    p[..., 1, :] = centers - np.array([half_x, 0.0], dtype)
    p[..., 2, :] = centers + np.array([0.0, half_y], dtype)
    p[..., 3, :] = centers - np.array([0.0, half_y], dtype)
    mask = np.zeros((N, K1, dims.H), bool)
    mask[..., :4] = True
    return n, p, mask


def straight_scenario(dims: Dims, length=12.0, lateral=2.0, v0=1.0, v1=1.0,
                      corridor_half=8.0, wheel_base=2.85, dtype=np.float64,
                      n_obstacles=0, obstacle_speed=2.0, rng=None) -> Scenario:
    """One forward segment from (0, 0, yaw 0) to (length, lateral, yaw 0)
    in a corridor, with optional constant-velocity obstacles crossing the
    path (parking_moving_obstacles.cc:42-57)."""
    assert dims.S == 1, "straight_scenario builds single-segment problems"
    N = dims.N
    rng = rng or np.random.default_rng(0)

    ini = state_to_flat((0.0, 0.0), 0.0, v0, 0.0, 0.0, wheel_base, 1,
                        dtype=dtype)
    fin = state_to_flat((length, lateral), 0.0, v1, 0.0, 0.0, wheel_base, 1,
                        dtype=dtype)

    frac = np.linspace(0.0, 1.0, N + 1)[1:-1]
    inner = np.stack([length * frac, lateral * frac], axis=-1).astype(dtype)

    dist = float(np.hypot(length, lateral))
    init_T = np.array([max(dist / 3.0, 1.0)], dtype)

    pos_c, head_c = _init_traj_centers(ini, fin, inner, float(init_T[0]),
                                       dims, dtype)
    corr_n, corr_p, corr_mask = _corridor_from_obb(
        pos_c, head_c, corridor_half, dims, dtype)

    O, Po = dims.O, dims.Po
    obs_coef = np.zeros((O, Po, 6, 2), dtype)
    obs_dt = np.ones((O,), dtype)
    obs_rel_t0 = np.zeros((O,), dtype)
    obs_mask = np.zeros((O,), bool)
    for o in range(min(n_obstacles, O)):
        horizon = 30.0
        dt = horizon / Po
        ang = rng.uniform(0, 2 * np.pi)
        vel = obstacle_speed * np.array([np.cos(ang), np.sin(ang)])
        u = rng.uniform(0.3, 0.7)
        start = np.array([length * u + rng.uniform(-1.0, 1.0),
                          lateral * u + rng.uniform(-1.5, 1.5)])
        # piecewise-linear mover as quintic pieces: c0 start, c1 vel*dt
        for pp in range(Po):
            obs_coef[o, pp, 0] = start + vel * (pp * dt)
            obs_coef[o, pp, 1] = vel * dt
        obs_dt[o] = dt
        obs_mask[o] = True

    return Scenario(
        ini_state=ini[None], fin_state=fin[None], init_inner=inner[None],
        init_T=init_T, singul=np.array([1], np.int32),
        seg_mask=np.array([True]),
        corr_n=corr_n[None], corr_p=corr_p[None], corr_mask=corr_mask[None],
        obs_coef=obs_coef, obs_dt=obs_dt, obs_rel_t0=obs_rel_t0,
        obs_mask=obs_mask,
    )


def random_parking_scenario(dims: Dims, rng, wheel_base=2.85,
                            dtype=np.float64, n_obstacles=0) -> Scenario:
    """Random goal offset, speeds and corridor width; one forward segment."""
    length = rng.uniform(8.0, 18.0)
    lateral = rng.uniform(-4.0, 4.0)
    v0 = rng.uniform(0.2, 2.0)
    v1 = rng.uniform(0.2, 1.0)
    half = rng.uniform(3.0, 8.0)
    return straight_scenario(dims, length=length, lateral=lateral, v0=v0,
                             v1=v1, corridor_half=half, wheel_base=wheel_base,
                             dtype=dtype, n_obstacles=n_obstacles, rng=rng)


def stack_scenarios(scens: list[Scenario]) -> Scenario:
    """Stack single scenarios into a batch (leading [B] on every leaf)."""
    return Scenario(*(np.stack(parts) for parts in zip(*scens)))


def batch_scenarios(dims: Dims, batch: int, seed=0, dtype=np.float64,
                    n_obstacles=0) -> Scenario:
    rng = np.random.default_rng(seed)
    return stack_scenarios([
        random_parking_scenario(dims, rng, dtype=dtype,
                                n_obstacles=n_obstacles)
        for _ in range(batch)])


def gear_scenario(dims: Dims, wheel_base=2.85, dtype=np.float64) -> Scenario:
    """Two-segment forward/reverse maneuver (S=2): drive forward, then back
    into a lateral offset, which exercises the gear-position and -angle
    decision variables. Uniform-N classes only (Dims.Ns=None)."""
    assert dims.S == 2
    if dims.Ns is not None:
        raise NotImplementedError(
            "per-segment piece classes (Dims.Ns) are not ported yet: "
            "ROADMAP.md Queue 1 item 6")
    N = dims.N
    ini = state_to_flat((0.0, 0.0), 0.0, 1.0, 0.0, 0.0, wheel_base, 1,
                        dtype=dtype)
    mid_pos = np.array([8.0, 1.0])
    mid_yaw = 0.5
    mid_f = state_to_flat(mid_pos, mid_yaw, 0.2, 0.0, 0.0, wheel_base, 1,
                          dtype=dtype)
    mid_b = state_to_flat(mid_pos, mid_yaw, 0.2, 0.0, 0.0, wheel_base, -1,
                          dtype=dtype)
    end = state_to_flat((5.0, -2.0), 0.2, 0.5, 0.0, 0.0, wheel_base, -1,
                        dtype=dtype)

    def seg_inner(a, b):
        frac = np.linspace(0.0, 1.0, N + 1)[1:-1]
        return (np.asarray(a) + (np.asarray(b) - np.asarray(a))
                * frac[:, None]).astype(dtype)

    def seg_corridor(a, b):
        grid = sample_grid(N, dims.K, dims.Kdes)
        s_frac = (grid.frac / N).astype(dtype)              # [N, K1]
        c = (np.asarray(a)
             + (np.asarray(b) - np.asarray(a)) * s_frac[..., None])
        return _corridor_from_boxes(c, 10.0, 10.0, dims, dtype)

    n0, p0, m0 = seg_corridor((0.0, 0.0), mid_pos)
    n1, p1, m1 = seg_corridor(mid_pos, (5.0, -2.0))

    O, Po = dims.O, dims.Po
    return Scenario(
        ini_state=np.stack([ini, mid_b]),
        fin_state=np.stack([mid_f, end]),
        init_inner=np.stack([seg_inner((0.0, 0.0), mid_pos),
                             seg_inner(mid_pos, (5.0, -2.0))]),
        init_T=np.array([4.0, 4.0], dtype),
        singul=np.array([1, -1], np.int32),
        seg_mask=np.array([True, True]),
        corr_n=np.stack([n0, n1]), corr_p=np.stack([p0, p1]),
        corr_mask=np.stack([m0, m1]),
        obs_coef=np.zeros((O, Po, 6, 2), dtype), obs_dt=np.ones((O,), dtype),
        obs_rel_t0=np.zeros((O,), dtype), obs_mask=np.zeros((O,), bool),
    )
