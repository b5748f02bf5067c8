"""The port's SSC back end against the JAX package on the CPU, in float64.

Bezier evaluation, the interval corridor and the voxel corridor (its cube
indices exactly), the ADMM QP under both of JAX's exit semantics (batch
dims: one shared exit; jax.vmap: each problem at its own), and ssc_plan on
both corridor backends, one plan at a time and batched: statuses and
iteration counts exact, QP x and the spline's control points to 1e-8
relative. Also: the QP's exit tested every iteration and every
`_CHECK_EVERY` iterations give bitwise the same result, and ssc_plan
turns TF32 off.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dftpav_tpu.ssc import bezier as jbezier
from dftpav_tpu.ssc import corridor as jcorridor
from dftpav_tpu.ssc import planner as jplanner
from dftpav_tpu.ssc import qp as jqp
from dftpav_tpu.ssc import voxel as jvoxel
from dftpav_tpu.urban import lane as jlane

from dftpav_tpu_torch.ssc import bezier, corridor, planner, qp, voxel
from dftpav_tpu_torch.urban import lane as lane_mod

torch.set_num_threads(1)
F64 = torch.float64


def t64(a):
    return torch.from_numpy(np.array(np.asarray(a), np.float64))


def close(ours, theirs, rel):
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours, theirs, rtol=rel,
                               atol=rel * max(1.0, np.abs(theirs).max()))


def same(ours, theirs):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def lanes():
    """tests/test_ssc.py's straight lane in float64: JAX's and the port's
    (through lane_set_from_numpy)."""
    jl = jlane.build_lane(np.stack([np.linspace(0, 300, 21), np.zeros(21)],
                                   1), ds=1.0, P=512, dtype=np.float64)
    ls = lane_mod.lane_set_from_numpy([np.asarray(f)[None] for f in jl],
                                      [-1], [-1], device="cpu", dtype=F64)
    return jl, ls.lane(0)


TIMES = np.linspace(0.0, 4.0, 11)


def plans(B, seed, A=3):
    """B seeded SSC inputs on the straight lane: the ego braking or not and
    changing lane or not (a smoothstep of 0 or +-3.5 m), A constant-velocity
    obstacles near lane centers, some masked out."""
    rng = np.random.default_rng(seed)
    t = TIMES
    v0 = rng.uniform(3.0, 10.0, B)[:, None]
    a = rng.uniform(0.0, 1.5, B)[:, None]
    t_stop = np.minimum(t, v0 / np.maximum(a, 1e-9))
    s = v0 * t_stop - 0.5 * a * t_stop ** 2
    v = np.maximum(v0 - a * t, 0.0)
    amp = rng.choice([0.0, 3.5, -3.5], B)[:, None]
    tau = t / t[-1]
    d = amp * (3 * tau ** 2 - 2 * tau ** 3)
    dd = amp * (6 * tau - 6 * tau ** 2) / t[-1]
    th = np.arctan2(dd, np.maximum(v, 0.1))
    fwd = np.stack([s, d, th, v, np.zeros_like(s), np.zeros_like(s)], -1)
    obs = np.zeros((B, A, len(t), 6))
    o_s = rng.uniform(8.0, 60.0, (B, A))[..., None]
    o_v = rng.uniform(0.0, 6.0, (B, A))[..., None]
    obs[..., 0] = o_s + o_v * t
    obs[..., 1] = (rng.choice([-3.5, 0.0, 3.5], (B, A))
                   + rng.uniform(-0.3, 0.3, (B, A)))[..., None]
    obs[..., 3] = o_v
    mask = rng.uniform(size=(B, A)) < 0.8
    return fwd[:, 0], fwd, obs, mask


def test_bezier_eval_matches_jax():
    rng = np.random.default_rng(0)
    ctrl = rng.normal(size=(4, 2, 5, 6))
    t_lb = np.cumsum(np.full((4, 5), 0.8), -1) - 0.8
    t_ub = t_lb + 0.8
    t = rng.uniform(-0.5, 4.5, (4, 7))
    ours = bezier.bezier_eval(bezier.BezierSpline(t64(ctrl), t64(t_lb),
                                                  t64(t_ub)), t64(t))
    for b in range(4):
        theirs = jbezier.bezier_eval(jbezier.BezierSpline(
            jnp.asarray(ctrl[b]), jnp.asarray(t_lb[b]), jnp.asarray(t_ub[b])),
            jnp.asarray(t[b]))
        for x, y in zip(ours, theirs):
            close(x[b], y, 1e-13)


def _corridor_cases():
    """tests/test_ssc.py's voxel layouts (corner obstacle, narrow slot,
    walls ahead and behind, free road) as one batch of 4 on T = 20, each
    obstacle moved by a few cm so that no box edge falls on a grid cell's
    center (there the last bit of the cell arithmetic decides, and XLA
    fuses a multiply-add that PyTorch rounds twice)."""
    T = 20
    times = np.linspace(0.0, 4.0, T + 1)
    seed_s = np.broadcast_to(8.0 * times, (4, T + 1)).copy()
    seed_d = np.zeros((4, T + 1))
    o_s = np.array([[12.03, 500.0], [12.02, 11.97], [20.07, -5.03],
                    [500.0, 500.0]])
    o_d = np.array([[1.53, 0.0], [2.93, -2.91], [0.0, 0.0], [0.0, 0.0]])
    hl = np.array([[2.0, 2.0], [4.0, 4.0], [2.0, 1.0], [2.44, 2.44]])
    hw = np.array([[1.0, 1.0], [1.9, 1.9], [50.0, 50.0], [0.95, 0.95]])
    mask = np.array([[True, False], [True, True], [True, True],
                     [False, False]])
    obs_s = np.repeat(o_s[..., None], T + 1, -1)
    obs_d = np.repeat(o_d[..., None], T + 1, -1)
    return times, seed_s, seed_d, obs_s, obs_d, hl, hw, mask


def _voxel_indices(c, s0, cfg=voxel.VoxelConfig()):
    """The cube bounds of a voxel corridor as grid indices."""
    def idx(v, origin, res, side):
        return np.rint((np.asarray(v) - side * 0.5 * res - origin) / res
                       - 0.5).astype(int)
    o_s = np.asarray(s0)[..., None] - cfg.s_back
    return np.stack([idx(c.s_lb, o_s, cfg.s_res, -1),
                     idx(c.s_ub, o_s, cfg.s_res, 1),
                     idx(c.d_lb, cfg.d_origin, cfg.d_res, -1),
                     idx(c.d_ub, cfg.d_origin, cfg.d_res, 1)])


@pytest.mark.parametrize("backend", ["interval", "voxel"])
def test_corridor_matches_jax(backend):
    """Interval corridor bounds exact; the voxel corridor's cube indices
    and seed test exact, its metric bounds (cell centers, where XLA's fused
    multiply-add moves the last bit) to 1e-12."""
    args = _corridor_cases()
    mod = voxel.build_corridor_voxel if backend == "voxel" \
        else corridor.build_corridor
    jmod = jvoxel.build_corridor_voxel if backend == "voxel" \
        else jcorridor.build_corridor
    ours = mod(t64(args[0]), *map(t64, args[1:7]),
               torch.from_numpy(args[7]), M=5)
    theirs = jax.jit(jax.vmap(lambda *a: jmod(*a, M=5),
                              in_axes=(None,) + (0,) * 7))(
        *map(jnp.asarray, args))
    if backend == "interval":
        for x, y in zip(ours, theirs):
            same(x, y)
        return
    s0 = args[1][:, 0]
    np.testing.assert_array_equal(_voxel_indices(ours, s0),
                                  _voxel_indices(theirs, s0))
    same(ours.seed_free, theirs.seed_free)
    for x, y in zip(ours, theirs):
        close(x.double(), y, 1e-12)
    assert not bool(ours.seed_free[2]) and bool(ours.seed_free[1])


def _qp_batch(B, seed):
    """B box-and-equality QPs of n = 6 whose ADMM exits differ."""
    rng = np.random.default_rng(seed)
    n, m, n_eq = 6, 9, 2
    R = rng.normal(size=(B, n, n))
    Q = R @ np.swapaxes(R, -1, -2) + np.eye(n) * rng.uniform(0.01, 2.0,
                                                              (B, 1, 1))
    c = rng.normal(size=(B, n)) * 3
    G = rng.normal(size=(B, m, n))
    lo = np.concatenate([rng.normal(size=(B, n_eq)),
                         -rng.uniform(0.2, 2.0, (B, m - n_eq))], -1)
    hi = lo.copy()
    hi[:, n_eq:] = rng.uniform(0.2, 2.0, (B, m - n_eq))
    return Q, c, G, lo, hi, n_eq


def test_admm_qp_exit_semantics_match_jax():
    """Batch dims share one exit (JAX's admm_qp called on a batch);
    independent_dims=1 stops each problem at its own (jax.vmap of the
    one-problem call): iteration counts and statuses exact, x to 1e-8."""
    Q, c, G, lo, hi, n_eq = _qp_batch(8, 0)
    ours = qp.admm_qp(*map(t64, (Q, c, G, lo, hi)), n_eq, iters=300)
    theirs = jax.jit(lambda *a: jqp.admm_qp(*a, n_eq, iters=300))(
        *map(jnp.asarray, (Q, c, G, lo, hi)))
    same(ours.n_iters, theirs.n_iters)
    same(ours.status, theirs.status)
    close(ours.x, theirs.x, 1e-8)
    assert len(set(ours.n_iters.tolist())) == 1

    ours = qp.admm_qp(*map(t64, (Q, c, G, lo, hi)), n_eq, iters=300,
                      independent_dims=1)
    theirs = jax.jit(jax.vmap(lambda *a: jqp.admm_qp(*a, n_eq, iters=300)))(
        *map(jnp.asarray, (Q, c, G, lo, hi)))
    same(ours.n_iters, theirs.n_iters)
    same(ours.status, theirs.status)
    close(ours.x, theirs.x, 1e-8)
    # residuals of ~1e-4: absolute, from x's own tolerance at |x| ~ 100
    np.testing.assert_allclose(ours.eq_res.numpy(), theirs.eq_res, rtol=0,
                               atol=1e-10)
    assert len(set(ours.n_iters.tolist())) >= 4


def test_admm_qp_exit_check_interval_changes_nothing(monkeypatch):
    """Testing the exit every iteration and every _CHECK_EVERY iterations
    give bitwise the same result (a frozen entry does not move)."""
    Q, c, G, lo, hi, n_eq = _qp_batch(8, 1)
    args = [t64(a) for a in (Q, c, G, lo, hi)]
    runs = []
    for every in (qp._CHECK_EVERY, 1, 7):
        monkeypatch.setattr(qp, "_CHECK_EVERY", every)
        for ind in (0, 1):
            runs.append(qp.admm_qp(*args, n_eq, iters=300,
                                   independent_dims=ind))
    for i in range(2, len(runs)):
        for x, y in zip(runs[i], runs[i % 2]):
            assert torch.equal(x, y)


def _plan_args(jl, lane, ego, fwd, obs, mask):
    half_l, half_w = np.full(mask.shape, 2.44), np.full(mask.shape, 0.95)
    jargs = (jl, *map(jnp.asarray, (ego, fwd)), TIMES, jnp.asarray(obs),
             jnp.asarray(mask), jnp.asarray(half_l), jnp.asarray(half_w))
    args = (lane, t64(ego), t64(fwd), TIMES, t64(obs),
            torch.from_numpy(mask), t64(half_l), t64(half_w))
    return jargs, args


def _check_plan(ours, theirs):
    same(ours.qp.n_iters, theirs.qp.n_iters)
    same(ours.qp.status, theirs.qp.status)
    same(ours.feasible, theirs.feasible)
    for x, y in zip(ours.corridor, theirs.corridor):
        same(x, y)
    close(ours.qp.x, theirs.qp.x, 1e-8)
    close(ours.spline.ctrl, theirs.spline.ctrl, 1e-8)


@pytest.mark.parametrize("backend", ["interval", "voxel"])
def test_ssc_plan_matches_jax(backend):
    """One plan at a time (the JAX call unbatched), both backends."""
    jl, lane = lanes()
    ego, fwd, obs, mask = plans(2, 2)
    jcfg = jplanner.SSCConfig(corridor_backend=backend)
    cfg = planner.SSCConfig(corridor_backend=backend)
    jfn = jax.jit(lambda e, f, o, m, hl, hw: jplanner.ssc_plan(
        jl, e, f, TIMES, o, m, hl, hw, jcfg, dtype=jnp.float64))
    for b in range(2):
        jargs, args = _plan_args(jl, lane, ego[b], fwd[b], obs[b], mask[b])
        theirs = jfn(*jargs[1:3], *jargs[4:])
        ours = planner.ssc_plan(*args, cfg)
        _check_plan(ours, theirs)
        assert float(ours.qp.eq_res.max()) < 5e-3


def test_batched_ssc_plan_matches_vmap():
    """The port's batched ssc_plan over 8 plans with different exit
    iterations against jax.vmap(ssc_plan): each plan's n_iters its own."""
    jl, lane = lanes()
    ego, fwd, obs, mask = plans(8, 3)
    jargs, args = _plan_args(jl, lane, ego, fwd, obs, mask)
    cfg = jplanner.SSCConfig()
    theirs = jax.jit(jax.vmap(lambda e, f, o, m, hl, hw: jplanner.ssc_plan(
        jl, e, f, TIMES, o, m, hl, hw, cfg, dtype=jnp.float64)))(
        *jargs[1:3], *jargs[4:])
    torch.backends.cuda.matmul.allow_tf32 = True
    ours = planner.ssc_plan(*args)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    _check_plan(ours, theirs)
    per_plan = ours.qp.n_iters[:, 0]
    assert torch.equal(ours.qp.n_iters[:, 1], per_plan)
    assert len(set(per_plan.tolist())) >= 3, per_plan
    # the same plans through one shared exit would all run to the slowest
    assert int(per_plan.min()) < int(per_plan.max())
