"""Parking problems for tests and benchmarks: synthetic single-segment and
multi-gear maneuvers, and batches planned by the native front end on
random parking-lot grids (the real problem distribution).

Pure numpy, identical to `dftpav_tpu.scenarios` for the same seed (the
parity tests check the arrays bit for bit). Carry a batch to the card
with `types.from_numpy(batch, Scenario)`.
"""

from __future__ import annotations

import dataclasses

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


def _seg_inner(n_s, N, a, b, dtype):
    """Inner waypoints of one segment from a to b at its own k / n_s
    fractions, zero-padded to N - 1 slots."""
    frac = np.linspace(0.0, 1.0, n_s + 1)[1:-1]
    out = np.zeros((N - 1, 2), dtype)
    out[:n_s - 1] = (np.asarray(a) + (np.asarray(b) - np.asarray(a))
                     * frac[:, None]).astype(dtype)
    return out


def _seg_corridor(dims: Dims, n_s, a, b, dtype):
    """Box corridors (half-width 10 m) along a -> b on one segment's own
    n_s-piece sample grid, zero-padded to N pieces."""
    N = dims.N
    grid = sample_grid(n_s, dims.K, dims.Kdes)
    s_frac = (grid.frac / n_s).astype(dtype)             # [n_s, K1]
    c = np.asarray(a) + (np.asarray(b) - np.asarray(a)) * s_frac[..., None]
    cn = np.zeros((N, dims.K1, dims.H, 2), dtype)
    cp = np.zeros((N, dims.K1, dims.H, 2), dtype)
    cm = np.zeros((N, dims.K1, dims.H), bool)
    d1 = dataclasses.replace(dims, N=n_s, Ns=None)
    cn[:n_s], cp[:n_s], cm[:n_s] = _corridor_from_boxes(c, 10.0, 10.0, d1,
                                                        dtype)
    return cn, cp, cm


def _no_obstacles(dims: Dims, dtype):
    O, Po = dims.O, dims.Po
    return dict(obs_coef=np.zeros((O, Po, 6, 2), dtype),
                obs_dt=np.ones((O,), dtype),
                obs_rel_t0=np.zeros((O,), dtype),
                obs_mask=np.zeros((O,), bool))


def gear_scenario(dims: Dims, wheel_base=2.85, dtype=np.float64) -> Scenario:
    """Two-segment forward/reverse maneuver (S=2): drive forward, then back
    into a lateral offset, which exercises the gear-position and -angle
    decision variables. With per-segment piece classes (Dims.Ns) each
    segment's waypoints sit at its own k / n_s fractions, its corridors
    ride its own sample grid, and its initial duration scales with its
    piece count."""
    assert dims.S == 2
    ns = dims.ns_tuple
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
    n0, p0, m0 = _seg_corridor(dims, ns[0], (0.0, 0.0), mid_pos, dtype)
    n1, p1, m1 = _seg_corridor(dims, ns[1], mid_pos, (5.0, -2.0), dtype)
    return Scenario(
        ini_state=np.stack([ini, mid_b]),
        fin_state=np.stack([mid_f, end]),
        init_inner=np.stack([
            _seg_inner(ns[0], dims.N, (0.0, 0.0), mid_pos, dtype),
            _seg_inner(ns[1], dims.N, mid_pos, (5.0, -2.0), dtype)]),
        init_T=np.array([4.0, 4.0], dtype) if dims.Ns is None else
        np.array([max(2.0, 0.75 * ns[0]), max(2.0, 0.75 * ns[1])], dtype),
        singul=np.array([1, -1], np.int32),
        seg_mask=np.array([True, True]),
        corr_n=np.stack([n0, n1]), corr_p=np.stack([p0, p1]),
        corr_mask=np.stack([m0, m1]), **_no_obstacles(dims, dtype))


def multi_gear_scenario(dims: Dims, wheel_base=2.85,
                        dtype=np.float64) -> Scenario:
    """S-segment alternating-gear zig-zag (forward, reverse, forward, ...):
    S=3 is the 'pull past - back in - pull forward' parallel-park shape
    (the reference plans as many gear segments as the front end emits,
    traj_manager.cpp:543). Ns-aware like gear_scenario."""
    S, N = dims.S, dims.N
    ns = dims.ns_tuple
    pts = [np.array([0.0, 0.0])]
    yaws = [0.0]
    for i in range(S):
        if i % 2 == 0:
            pts.append(pts[-1] + np.array([7.0, 1.2 - 1.6 * (i // 2)]))
            yaws.append(0.45)
        else:
            pts.append(pts[-1] + np.array([-3.2, -2.4]))
            yaws.append(0.15)
    sing = [1 if i % 2 == 0 else -1 for i in range(S)]

    ini_l, fin_l, inner_l, cn_l, cp_l, cm_l, T_l = [], [], [], [], [], [], []
    for i in range(S):
        vi = 1.0 if i == 0 else 0.2
        vo = 0.5 if i == S - 1 else 0.2
        ini_l.append(state_to_flat(pts[i], yaws[i], vi, 0.0, 0.0,
                                   wheel_base, sing[i], dtype=dtype))
        fin_l.append(state_to_flat(pts[i + 1], yaws[i + 1], vo, 0.0, 0.0,
                                   wheel_base, sing[i], dtype=dtype))
        inner_l.append(_seg_inner(ns[i], N, pts[i], pts[i + 1], dtype))
        n_, p_, m_ = _seg_corridor(dims, ns[i], pts[i], pts[i + 1], dtype)
        cn_l.append(n_)
        cp_l.append(p_)
        cm_l.append(m_)
        T_l.append(4.0 if dims.Ns is None else max(2.0, 0.75 * ns[i]))
    return Scenario(
        ini_state=np.stack(ini_l), fin_state=np.stack(fin_l),
        init_inner=np.stack(inner_l), init_T=np.asarray(T_l, dtype),
        singul=np.asarray(sing, np.int32), seg_mask=np.ones((S,), bool),
        corr_n=np.stack(cn_l), corr_p=np.stack(cp_l),
        corr_mask=np.stack(cm_l), **_no_obstacles(dims, dtype))


# ---------------------------------------------------------------------------
# Front-end-sourced batches (the REAL problem distribution)
# ---------------------------------------------------------------------------

def random_lot_grid(rng, lot=(40.0, 60.0), res=0.1, n_boxes=6):
    """A randomized parking-lot occupancy grid: boundary walls + rectangular
    obstacle islands (the obstacles_norm.json analogue of the reference's
    playgrounds)."""
    from dftpav_tpu_torch.frontend import GridMap2D

    ny, nx = int(lot[0] / res), int(lot[1] / res)
    occ = np.zeros((ny, nx), np.uint8)
    occ[:3, :] = 1
    occ[-3:, :] = 1
    occ[:, :3] = 1
    occ[:, -3:] = 1
    for _ in range(n_boxes):
        w = rng.uniform(2.0, 5.0)
        h = rng.uniform(2.0, 5.0)
        x0 = rng.uniform(4.0, lot[1] - 4.0 - w)
        y0 = rng.uniform(4.0, lot[0] - 4.0 - h)
        occ[int(y0 / res):int((y0 + h) / res),
            int(x0 / res):int((x0 + w) / res)] = 1
    return GridMap2D(occ, origin=(0.0, 0.0), resolution=res)


def frontend_batch(dims: Dims, batch: int, seed=0, dtype=np.float32,
                   n_obstacles=0, lot=(40.0, 60.0), queries_per_grid=16,
                   max_search_time=0.1):
    """Batched scenarios from the ACTUAL front end: randomized lot grids,
    native kino A* + Reeds-Shepp + rectangle-corridor growth
    (traj_manager.cpp:160-238 pipeline), optional circling movers MINCO-fit
    as surround trajectories (parking_moving_obstacles.cc:42-100).

    Only plans whose gear-segment count fits dims.S are kept (for the S=1
    bench class that is the single-gear subset of the distribution — same
    class the synthetic bench draws from, but with real corridor geometry).
    Returns a Scenario with leading [batch].
    """
    from dftpav_tpu_torch.config import FrontendConfig, PlannerConfig
    from dftpav_tpu_torch.pipeline import ParkingPlanner
    from dftpav_tpu_torch.sim.obstacles import CircularMover, \
        fit_surround_trajs

    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(PlannerConfig(), frontend=FrontendConfig(
        max_search_time=max_search_time))
    out = []
    attempts = 0
    while len(out) < batch:
        grid = random_lot_grid(rng, lot=lot,
                               n_boxes=int(rng.integers(4, 9)))
        pp = ParkingPlanner(grid, cfg, dims, dtype=dtype)
        vp = cfg.vehicle

        def free_pose():
            for _ in range(50):
                x = rng.uniform(5.0, lot[1] - 5.0)
                y = rng.uniform(5.0, lot[0] - 5.0)
                yaw = rng.uniform(-np.pi, np.pi)
                if not grid.obb_collides(x, y, yaw, vp.length + 0.6,
                                         vp.width + 0.6, vp.d_cr):
                    return x, y, yaw
            return None

        for _ in range(queries_per_grid):
            if len(out) >= batch:
                break
            attempts += 1
            if attempts > 60 * batch:
                raise RuntimeError(
                    f"front end produced only {len(out)}/{batch} scenarios")
            sp = free_pose()
            if sp is None:
                continue
            # goal ahead-ish of the start so single-gear plans dominate when
            # dims.S == 1; multi-gear classes draw fully random goals
            if dims.S == 1:
                d = rng.uniform(8.0, 18.0)
                dyaw = rng.uniform(-0.7, 0.7)
                gx = sp[0] + d * np.cos(sp[2] + dyaw * 0.5)
                gy = sp[1] + d * np.sin(sp[2] + dyaw * 0.5)
                gyaw = sp[2] + dyaw
            else:
                g = free_pose()
                if g is None:
                    continue
                gx, gy, gyaw = g
            if not (3.0 < gx < lot[1] - 3.0 and 3.0 < gy < lot[0] - 3.0):
                continue
            if grid.obb_collides(gx, gy, gyaw, vp.length + 0.4,
                                 vp.width + 0.4, vp.d_cr):
                continue
            v0 = rng.uniform(0.2, 2.0)
            scen, meta = pp.plan_scenario((sp[0], sp[1], sp[2], v0),
                                          (gx, gy, gyaw, 0.0))
            if scen is None:
                continue
            if n_obstacles > 0 and dims.O > 0:
                movers = [CircularMover(
                    center=(rng.uniform(10.0, lot[1] - 10.0),
                            rng.uniform(10.0, lot[0] - 10.0)),
                    radius=rng.uniform(8.0, 14.0),
                    speed=rng.uniform(2.0, 4.5),
                    phase=rng.uniform(0.0, 2 * np.pi),
                    ccw=bool(rng.integers(0, 2)))
                    for _ in range(min(n_obstacles, dims.O))]
                obs = fit_surround_trajs(movers, 0.0, dims, dtype=dtype)
                scen = scen._replace(
                    obs_coef=obs["obs_coef"], obs_dt=obs["obs_dt"],
                    obs_rel_t0=obs["obs_rel_t0"], obs_mask=obs["obs_mask"])
            out.append(scen)
    return stack_scenarios(out)


def frontend_pool_multigear(classes, n_plans: int, seed=11,
                            dtype=np.float32, n_obstacles=0,
                            lot=(40.0, 60.0), queries_per_grid=16,
                            max_search_time=0.1):
    """Pool of TWO-gear front-end plans bucketed by per-segment piece
    class.

    `classes`: list of Dims with Ns set (the S=2 class ladder). Every
    successful nseg==2 plan is assembled for the class whose Ns equals its
    natural quantized counts (pipeline.plan_scenario ladder selection) —
    the reference plans EVERY scenario at its own piecing
    (traj_manager.cpp:543); this is its static-shape form. Returns
    (buckets, n_s2): buckets maps each class's Ns tuple to a list of
    Scenario, n_s2 counts all two-gear plans seen (including ones whose
    counts no class covers — the admission denominator for the
    distribution-weighted bench line).
    """
    from dftpav_tpu_torch.config import FrontendConfig, PlannerConfig
    from dftpav_tpu_torch.pipeline import ParkingPlanner
    from dftpav_tpu_torch.sim.obstacles import CircularMover, \
        fit_surround_trajs

    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(PlannerConfig(), frontend=FrontendConfig(
        max_search_time=max_search_time))
    buckets = {c.Ns: [] for c in classes}
    n_s2 = 0
    attempts = 0
    got = 0
    while got < n_plans and attempts < 80 * n_plans:
        grid = random_lot_grid(rng, lot=lot,
                               n_boxes=int(rng.integers(4, 9)))
        pp = ParkingPlanner(grid, cfg, classes[0], dtype=dtype,
                            dims_classes=list(classes))
        vp = cfg.vehicle

        def free_pose():
            for _ in range(50):
                x = rng.uniform(5.0, lot[1] - 5.0)
                y = rng.uniform(5.0, lot[0] - 5.0)
                yaw = rng.uniform(-np.pi, np.pi)
                if not grid.obb_collides(x, y, yaw, vp.length + 0.6,
                                         vp.width + 0.6, vp.d_cr):
                    return x, y, yaw
            return None

        for _ in range(queries_per_grid):
            if got >= n_plans:
                break
            attempts += 1
            sp = free_pose()
            g = free_pose()
            if sp is None or g is None:
                continue
            if grid.obb_collides(g[0], g[1], g[2], vp.length + 0.4,
                                 vp.width + 0.4, vp.d_cr):
                continue
            v0 = rng.uniform(0.2, 2.0)
            scen, meta = pp.plan_scenario((sp[0], sp[1], sp[2], v0),
                                          (g[0], g[1], g[2], 0.0))
            if scen is None or meta.n_segments != 2:
                continue
            n_s2 += 1
            got += 1
            key = meta.dims.Ns
            if n_obstacles > 0 and meta.dims.O > 0:
                movers = [CircularMover(
                    center=(rng.uniform(10.0, lot[1] - 10.0),
                            rng.uniform(10.0, lot[0] - 10.0)),
                    radius=rng.uniform(8.0, 14.0),
                    speed=rng.uniform(2.0, 4.5),
                    phase=rng.uniform(0.0, 2 * np.pi),
                    ccw=bool(rng.integers(0, 2)))
                    for _ in range(min(n_obstacles, meta.dims.O))]
                obs = fit_surround_trajs(movers, 0.0, meta.dims,
                                         dtype=dtype)
                scen = scen._replace(
                    obs_coef=obs["obs_coef"], obs_dt=obs["obs_dt"],
                    obs_rel_t0=obs["obs_rel_t0"], obs_mask=obs["obs_mask"])
            buckets[key].append(scen)
    return buckets, n_s2
