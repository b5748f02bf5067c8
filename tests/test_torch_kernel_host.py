"""The CUDA kernels' per-lane code, compiled for the host, against the
port's plain PyTorch versions.

csrc/kcost.cuh (objective + hand-written gradient) and csrc/solve.cuh (the
per-lane L-BFGS round loop) are __host__ __device__ code. Here a small C
harness instantiates them for double and float with g++ (no GPU, no nvcc)
and runs them lane by lane:

  * float64 objective and gradient vs autograd: f rtol 1e-11,
    g rtol 1e-9 / atol 1e-9 (the JAX parity tolerances);
  * float32 objective and gradient vs float64 autograd: per lane
    |df|/|f| <= 1e-4 and max|dg| <= 1e-3 * max(1, max|g|) (the tolerance
    the card is held to: float32 with another summation order over 166 rows
    and the alpha=100 log-sum-exp); at 8 obstacles, on a colliding lane
    where plain float32 itself loses digits, the gradient no further from
    float64 than max(1e-3, 4x plain float32's distance);
  * float64 round loop vs the plain round loop, 12 iterations: statuses, k,
    eval counts exact, fp rtol 1e-10, xp rtol 1e-9 / atol 1e-10;
  * the multi-gear classes S = 2, 3 and 4 (the park demo's S = 4, N = 8
    class): objective against autograd, 12-iteration paths;
  * the embedded form of uniform N = 2 / 4 classes (S = 1, 2 and 4): the
    objective against autograd with the unused rows exactly zero, and the
    native class's 12-iteration paths.

Each runs the per-lane code as a team (csrc/team.cuh) of one member (the
Solo path) or of 32 members run in turn, the card's one warp per lane:
rows split over the members, near (row, obstacle) pairs packed by the
ballot into batches of 32, partials reduce-scattered. A fixture whose
obstacles sit on the lanes' paths fills those batches.

The harness itself (its C source, build and calls) is
tests/_kernel_harness.py. Skips where g++ is absent.
"""

import dataclasses
import functools

import _kernel_harness
import numpy as np
import pytest
import torch

from dftpav_tpu_torch import scenarios
from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
from dftpav_tpu_torch.ops import kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

DIMS = Dims(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)

@functools.lru_cache(maxsize=None)
def _setup(B=16, seed=3, sigma=1.0):
    cfg = PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(scenarios.batch_scenarios(DIMS, B, seed=seed,
                                                 n_obstacles=2),
                       Scenario, device="cpu", dtype=torch.float64)
    _b, x0p, sc, kc, D = pallas_solve._prep(batch, w, DIMS, torch.float64,
                                            sigma)
    sw = kcost.StaticW.build(w, cfg)
    # move half of the lanes off the initial guess (seeded), a quarter of
    # them far enough to leave their corridors
    x = x0p.clone()
    rng = np.random.default_rng(23)
    scale = np.where(np.arange(B) >= 3 * B // 4, 4.0, 0.4)[B // 2:]
    x[:D, B // 2:] += torch.from_numpy(
        scale * rng.standard_normal((D, B - B // 2)))
    return cfg, sw, sc, kc, x0p, x, D


# the harness's instantiations: (dtype, members per lane, capacity, S)
INSTANCES = (("f64", 1, 8, 1), ("f32", 1, 8, 1), ("f64", 32, 8, 1),
             ("f32", 32, 8, 1), ("f64", 1, 8, 2), ("f64", 32, 8, 2),
             ("f32", 32, 8, 2), ("f64", 1, 8, 3), ("f64", 32, 8, 3),
             ("f64", 1, 8, 4), ("f64", 32, 8, 4))


def _host_eval(x, sc, kc, sw, sigma, dtype, G=1, dims=DIMS):
    """The objective with kernel A's team mapping, G members per lane
    (1: the Solo path; 32: the card's warp, its members run in turn)."""
    return _kernel_harness.host_eval(x, sc, kc, sw, sigma, dtype, G, dims,
                                     INSTANCES)


@pytest.mark.parametrize("vt", [1.0, "auto"])
def test_hand_gradient_f64_matches_autograd(vt):
    flags = EngineFlags(vt_scale=vt)
    sigma = 0.25 if vt == "auto" else 1.0
    cfg, sw, sc, kc, x0p, x, D = _setup(sigma=sigma)
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, DIMS, flags)
    f, g = _host_eval(x, sc, kc, sw, sigma, torch.float64)
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9,
                               atol=1e-9)
    assert not torch.any(g[D:])


def test_hand_gradient_f32_within_card_tolerance():
    cfg, sw, sc, kc, x0p, x, D = _setup()
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, DIMS)
    f, g = _host_eval(x, sc, kc, sw, 1.0, torch.float32)
    rel = (f.double() - f_ref).abs() / f_ref.abs()
    assert float(rel.max()) <= 1e-4, rel
    gmax = g_ref.abs().amax(dim=0).clamp(min=1.0)
    dg = (g.double() - g_ref).abs().amax(dim=0)
    assert bool((dg <= 1e-3 * gmax).all()), (dg / gmax)


def _host_solve(x0, f0, g0, sc, kc, sw, sigma, p, max_iter, flags, dtype,
                G=1, dims=DIMS):
    """Kernel B's per-lane solve with G members per lane (as _host_eval),
    reading the half-planes from the lane-major copy kernel B makes."""
    return _kernel_harness.host_solve(x0, f0, g0, sc, kc, sw, sigma, p,
                                      max_iter, flags, dtype, G, dims,
                                      INSTANCES)


@pytest.mark.parametrize("tuned", [False, True])
def test_host_solve_f64_matches_round_loop_12_iterations(tuned):
    flags = EngineFlags.tuned() if tuned else EngineFlags()
    sigma = 0.25 if tuned else 1.0
    cfg, sw, sc, kc, x0p, _x, D = _setup(sigma=sigma)
    p = cfg.opt.lbfgs
    ref = pallas_solve._solve_rounds(x0p, sc, kc, sw, DIMS, p, 12, flags)
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, DIMS, flags)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, sigma, p, 12, flags,
                             torch.float64)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    np.testing.assert_allclose(f.numpy(), ref.fp.numpy(), rtol=1e-10)
    np.testing.assert_allclose(x.numpy(), ref.xp.numpy(), rtol=1e-9,
                               atol=1e-10)


def test_host_solve_f32_converges_like_round_loop():
    """float32 whole solves (the card's arithmetic) reach the plain float64
    loop's quality on the bench flags: usable statuses and a cost p50
    within 2%. Single lanes may land in other basins either way (float
    paths drift apart), so the median needs a few dozen lanes."""
    flags = EngineFlags.tuned()
    cfg, sw, sc, kc, x0p, _x, D = _setup(B=64, sigma=0.25)
    p = dataclasses.replace(cfg.opt.lbfgs)
    ref = pallas_solve._solve_rounds(x0p, sc, kc, sw, DIMS, p, 150, flags)
    f0, g0 = _host_eval(x0p, sc, kc, sw, 0.25, torch.float32)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, 0.25, p, 150, flags,
                             torch.float32)
    assert bool((info[0] >= 0).all()), info[0]
    med, med_ref = float(f.double().median()), float(ref.fp.median())
    assert abs(med - med_ref) <= 0.02 * abs(med_ref), (med, med_ref)


@functools.lru_cache(maxsize=None)
def _near_setup():
    """The B=16 fixture with both obstacles of every lane moved onto its
    path (one at the start, one halfway, drifting at 0.3 m per piece), so
    that many sample rows are within reach and run the dual-number pass."""
    cfg, sw, sc, kc, x0p, x, D = _setup()
    obs, misc = sc.obs_c.clone(), sc.misc.clone()
    head, tail = sc.bnd[0:2], sc.bnd[6:8]
    obs.zero_()
    for o, pos in ((0, head), (1, 0.5 * (head + tail))):
        for piece in range(DIMS.Po):
            obs[o, :, 6 * piece] = pos
            obs[o, 0, 6 * piece + 1] = 0.3
        misc[2 + 2 * DIMS.O + o] = 1.0
    return cfg, sw, sc._replace(obs_c=obs, misc=misc), kc, x0p, x, D


def _case(name, sigma=1.0):
    return _near_setup() if name == "near" else _setup(sigma=sigma)


@pytest.mark.parametrize("case", ["bench", "near"])
def test_team_eval_f64_matches_autograd_and_solo(case):
    """32 members per lane, run in turn: autograd's value and gradient
    (f rtol 1e-11, g 1e-9), and the Solo path's to rounding."""
    cfg, sw, sc, kc, x0p, x, D = _case(case)
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, DIMS)
    f, g = _host_eval(x, sc, kc, sw, 1.0, torch.float64, G=32)
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9,
                               atol=1e-9)
    assert not torch.any(g[D:])
    f1, g1 = _host_eval(x, sc, kc, sw, 1.0, torch.float64, G=1)
    np.testing.assert_allclose(f.numpy(), f1.numpy(), rtol=1e-13)
    np.testing.assert_allclose(g.numpy(), g1.numpy(), rtol=1e-11,
                               atol=1e-11)


def test_near_fixture_runs_the_obstacle_block():
    """The near fixture's obstacle term is large on most lanes (it is
    computed only by the dual-number pass over packed pairs), and the
    plain objective agrees that it is."""
    cfg, sw, sc, kc, x0p, x, D = _near_setup()
    masked = sc.misc.clone()
    masked[2 + 2 * DIMS.O:2 + 3 * DIMS.O] = 0.0
    f, _g = _host_eval(x, sc, kc, sw, 1.0, torch.float64, G=32)
    f0, _g0 = _host_eval(x, sc._replace(misc=masked), kc, sw, 1.0,
                         torch.float64, G=32)
    f_ref = kcost.eval_fg(x, sc._replace(misc=masked), kc, sw, DIMS)[0]
    np.testing.assert_allclose(f0.numpy(), f_ref.numpy(), rtol=1e-11)
    assert int(((f - f0) > 1e-3 * f0.abs()).sum()) >= 3 * x.shape[1] // 4


@pytest.mark.parametrize("case", ["bench", "near"])
def test_team_eval_f32_within_card_tolerance(case):
    cfg, sw, sc, kc, x0p, x, D = _case(case)
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, DIMS)
    f, g = _host_eval(x, sc, kc, sw, 1.0, torch.float32, G=32)
    rel = (f.double() - f_ref).abs() / f_ref.abs()
    assert float(rel.max()) <= 1e-4, rel
    gmax = g_ref.abs().amax(dim=0).clamp(min=1.0)
    dg = (g.double() - g_ref).abs().amax(dim=0)
    assert bool((dg <= 1e-3 * gmax).all()), (dg / gmax)


@pytest.mark.parametrize("case", ["bench", "near"])
def test_team_solve_f64_matches_round_loop_12_iterations(case):
    """Kernel B's mapping (32 members, the lane-major half-planes), tuned
    flags: the plain round loop's 12-iteration path exactly."""
    flags = EngineFlags.tuned()
    cfg, sw, sc, kc, x0p, _x, D = _near_setup() if case == "near" \
        else _setup(sigma=0.25)
    p = cfg.opt.lbfgs
    ref = pallas_solve._solve_rounds(x0p, sc, kc, sw, DIMS, p, 12, flags)
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, DIMS, flags)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, 0.25, p, 12, flags,
                             torch.float64, G=32)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    np.testing.assert_allclose(f.numpy(), ref.fp.numpy(), rtol=1e-10)
    np.testing.assert_allclose(x.numpy(), ref.xp.numpy(), rtol=1e-9,
                               atol=1e-10)


def test_team_eval_8_obstacles_f32_as_close_as_float32_allows():
    """A class with 8 obstacles (on the card: fewer warps per block), at
    x0 of the last 64 lanes of the seed-11 fixture, one of them deep in a
    collision: the 32-member mapping in float64 equals plain float64, and
    in float32 its gradient is no further from float64 than max(1e-3, 4x
    plain float32's own distance), the gate chip_smoke.py holds kernel A
    to in phases 3 and 4. Plain float32 itself is ~5e-4 off on that
    lane."""
    dims8 = dataclasses.replace(DIMS, O=8)
    cfg = PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    sw = kcost.StaticW.build(w, cfg)
    npb = scenarios.batch_scenarios(dims8, 2048, seed=11, dtype=np.float32,
                                    n_obstacles=8)
    batch = from_numpy(Scenario(*(a[-64:] for a in npb)), Scenario,
                       device="cpu", dtype=torch.float32)
    _b, x0, sc, kc, D = pallas_solve._prep(batch, w, dims8, torch.float32,
                                           0.25)
    sc64 = kcost.KScenario(*(a.double() for a in sc))
    kc64 = kcost.KConsts(*(a.double() for a in kc))
    tuned = EngineFlags.tuned()                # sigma 0.25, as below
    f64, g64 = kcost.eval_fg_plain(x0.double(), sc64, kc64, sw, dims8, tuned)
    fh, gh = _host_eval(x0.double(), sc64, kc64, sw, 0.25, torch.float64,
                        G=32, dims=dims8)
    np.testing.assert_allclose(fh.numpy(), f64.numpy(), rtol=1e-11)
    np.testing.assert_allclose(gh.numpy(), g64.numpy(), rtol=1e-9,
                               atol=1e-9)
    f32, g32 = _host_eval(x0, sc, kc, sw, 0.25, torch.float32, G=32,
                          dims=dims8)
    fp, gp = kcost.eval_fg_plain(x0, sc, kc, sw, dims8, tuned)
    gmax = g64.abs().amax(dim=0).clamp(min=1.0)

    def rel_g(g):
        return float(((g.double() - g64).abs().amax(dim=0) / gmax).max())

    assert float(((f32.double() - f64).abs() / f64.abs()).max()) <= 1e-4
    assert rel_g(gp) > 1e-4                  # the lane float32 cannot hold
    assert rel_g(g32) <= max(1e-3, 4.0 * rel_g(gp)), (rel_g(g32), rel_g(gp))


# ---------------------------------------------------------------------------
# multi-gear classes: S = 2 to 4, per-segment piece counts (Dims.Ns)
# ---------------------------------------------------------------------------

# name: (S, Dims.Ns); S4-N8 is the park demo's uniform class
MG = {"8-2": (2, (8, 2)), "4-2-2": (3, (4, 2, 2)), "S4-N8": (4, None)}


@functools.lru_cache(maxsize=None)
def _mg_setup(name, appear=False, Bn=8):
    """Bn lanes of scenarios.gear_scenario (S=2) or multi_gear_scenario
    (S >= 3) for the class MG[name], inner waypoints jittered by a seeded
    +-0.3 m; half of the lanes' x moved off x0 as in _setup. appear: one
    obstacle (O=1) parked on the middle of segment 1 from t = 6 s (the end
    of segment 0 at x0) and 100 m away before, so that only rows that add
    the earlier segment's duration to their time meet it."""
    S, ns = MG[name]
    dims = Dims(S=S, N=8, K=16, Kdes=32, H=4, O=1 if appear else 0,
                Po=8, Ns=ns)
    make = scenarios.gear_scenario if dims.S == 2 \
        else scenarios.multi_gear_scenario
    rng = np.random.default_rng(41)
    lanes = []
    for _ in range(Bn):
        sc = make(dims)
        inner = sc.init_inner + rng.uniform(-0.3, 0.3, sc.init_inner.shape)
        inner[sc.init_inner == 0] = 0.0
        sc = sc._replace(init_inner=inner)
        if appear:
            mid = 0.5 * (sc.ini_state[1, :, 0] + sc.fin_state[1, :, 0])
            coef = np.zeros((1, 8, 6, 2))
            for piece in range(8):
                coef[0, piece, 0] = mid if piece >= 6 else (100.0, 100.0)
            sc = sc._replace(obs_coef=coef, obs_dt=np.ones(1),
                             obs_mask=np.ones(1, bool))
        lanes.append(sc)
    cfg = PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(scenarios.stack_scenarios(lanes), Scenario,
                       device="cpu", dtype=torch.float64)
    _b, x0p, sc, kc, D = pallas_solve._prep(batch, w, dims, torch.float64,
                                            "auto")
    x = x0p.clone()
    x[:D, Bn // 2:] += torch.from_numpy(
        0.3 * np.random.default_rng(23).standard_normal((D, Bn - Bn // 2)))
    return cfg, kcost.StaticW.build(w, cfg), sc, kc, x0p, x, D, dims


@pytest.mark.parametrize("name", list(MG))
def test_team_eval_multigear_f64_matches_autograd_and_solo(name):
    """S = 2 (DP 40), S = 3 (DP 56) and S = 4 (DP 72) with per-segment
    piece counts: the 32-member mapping (two or three coordinates per
    member past 32) equals autograd
    (f rtol 1e-11, g 1e-9) and the one-member path to rounding."""
    cfg, sw, sc, kc, x0p, x, D, dims = _mg_setup(name)
    tuned = EngineFlags.tuned()
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, dims, tuned)
    f, g = _host_eval(x, sc, kc, sw, "auto", torch.float64, G=32, dims=dims)
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9,
                               atol=1e-9)
    assert not torch.any(g[D:])
    f1, g1 = _host_eval(x, sc, kc, sw, "auto", torch.float64, G=1, dims=dims)
    np.testing.assert_allclose(f.numpy(), f1.numpy(), rtol=1e-13)
    np.testing.assert_allclose(g.numpy(), g1.numpy(), rtol=1e-11,
                               atol=1e-11)


def test_team_eval_s2_obstacle_needs_time_offset():
    """An obstacle that exists only at absolute times past segment 0's
    duration and sits on segment 1: the kernels' rows of segment 1 must
    sample it at tt_1 + t. The 32-member mapping equals autograd with it,
    in float64 and (to the card's tolerance) float32, and the obstacle
    term is material on every lane at x0."""
    cfg, sw, sc, kc, x0p, x, D, dims = _mg_setup("8-2", appear=True)
    tuned = EngineFlags.tuned()
    for xx in (x0p, x):
        f_ref, g_ref = kcost.eval_fg(xx, sc, kc, sw, dims, tuned)
        f, g = _host_eval(xx, sc, kc, sw, "auto", torch.float64, G=32,
                          dims=dims)
        np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-11)
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9,
                                   atol=1e-9)
    masked = sc.misc.clone()
    masked[2 * dims.S + 2 * dims.O] = 0.0
    f_off, _g = _host_eval(x0p, sc._replace(misc=masked), kc, sw, "auto",
                           torch.float64, G=32, dims=dims)
    f_on, _g = _host_eval(x0p, sc, kc, sw, "auto", torch.float64, G=32,
                          dims=dims)
    assert bool(((f_on - f_off) > 1e-2 * f_off.abs()).all()), (f_on, f_off)
    f32, g32 = _host_eval(x, sc, kc, sw, "auto", torch.float32, G=32,
                          dims=dims)
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, dims, tuned)
    assert float(((f32.double() - f_ref).abs() / f_ref.abs()).max()) <= 1e-4
    gmax = g_ref.abs().amax(dim=0).clamp(min=1.0)
    assert bool(((g32.double() - g_ref).abs().amax(dim=0)
                 <= 1e-3 * gmax).all())


@pytest.mark.parametrize("name", [n for n in MG if MG[n][0] < 4])
def test_team_solve_multigear_f64_matches_round_loop_12_iterations(name):
    """Kernel B's mapping on the multi-gear classes, tuned flags (sigma per
    segment): the plain round loop's 12-iteration path exactly."""
    flags = EngineFlags.tuned()
    cfg, sw, sc, kc, x0p, _x, D, dims = _mg_setup(name)
    p = cfg.opt.lbfgs
    ref = pallas_solve._solve_rounds(x0p, sc, kc, sw, dims, p, 12, flags)
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, dims, flags)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, "auto", p, 12, flags,
                             torch.float64, G=32, dims=dims)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    np.testing.assert_allclose(f.numpy(), ref.fp.numpy(), rtol=1e-10)
    np.testing.assert_allclose(x.numpy(), ref.xp.numpy(), rtol=1e-9,
                               atol=1e-10)


def test_team_solve_s4_f64_matches_round_loop_12_iterations():
    """Kernel B's mapping on the park demo's S = 4, N = 8 class (DP 72,
    three coordinates per member), tuned flags: the plain round loop's
    12-iteration path, statuses, k and evals exact. On two of its eight
    lanes the loop itself moves f by up to 4e-10 (relative) and x by
    1e-10 when x0 moves by one ulp, so f and x are held to 1e-10 / 1e-9
    or, where the loop's own move under three such perturbations is
    larger, to 4x that move."""
    flags = EngineFlags.tuned()
    cfg, sw, sc, kc, x0p, _x, D, dims = _mg_setup("S4-N8")
    p = cfg.opt.lbfgs
    ref = pallas_solve._solve_rounds(x0p, sc, kc, sw, dims, p, 12, flags)
    df, dx = torch.zeros_like(ref.fp), torch.zeros_like(ref.fp)
    for k in range(3):
        sgn = torch.from_numpy(
            np.random.default_rng(k).choice([-1.0, 1.0], x0p.shape))
        alt = pallas_solve._solve_rounds(x0p * (1 + 2.0 ** -52 * sgn), sc,
                                         kc, sw, dims, p, 12, flags)
        df = torch.maximum(df, (alt.fp - ref.fp).abs())
        dx = torch.maximum(dx, (alt.xp - ref.xp).abs().amax(dim=0))
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, dims, flags)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, "auto", p, 12, flags,
                             torch.float64, G=32, dims=dims)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    tol_f = torch.maximum(1e-10 * ref.fp.abs(), 4.0 * df)
    assert bool(((f - ref.fp).abs() <= tol_f).all()), (f - ref.fp, tol_f)
    tol_x = torch.maximum(1e-9 * ref.xp.abs() + 1e-10, 4.0 * dx)
    assert bool(((x - ref.xp).abs() <= tol_x).all())
    assert int((4.0 * df > 1e-10 * ref.fp.abs()).sum()) <= 2


# uniform N = 2 / 4 classes in their N = 8 form (pallas_solve.embedded_class)
# ---------------------------------------------------------------------------

EMBED = {"S2-N2": dict(S=2, N=2, K=16, Kdes=32, H=4, O=0, Po=8),
         "S1-N4": dict(S=1, N=4, K=16, Kdes=32, H=4, O=2, Po=8),
         "S1-N2": dict(S=1, N=2, K=16, Kdes=32, H=4, O=0, Po=8),
         "S4-N2": dict(S=4, N=2, K=16, Kdes=32, H=4, O=0, Po=8)}


@functools.lru_cache(maxsize=None)
def _embed_setup(name):
    """The class's fixture (gear_scenario at S = 2, multi_gear_scenario
    above, batch_scenarios at S = 1), 8 lanes, float64: the native and the
    embedded inputs."""
    dims = Dims(**EMBED[name])
    if dims.S >= 2:
        make = scenarios.gear_scenario if dims.S == 2 \
            else scenarios.multi_gear_scenario
        npb = scenarios.stack_scenarios([make(dims)] * 8)
    else:
        npb = scenarios.batch_scenarios(dims, 8, seed=5,
                                        n_obstacles=dims.O)
    cfg = PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(npb, Scenario, device="cpu", dtype=torch.float64)
    dims_e = pallas_solve.embedded_class(dims)
    native = pallas_solve._prep(batch, w, dims, torch.float64, "auto")[1:4]
    emb = pallas_solve._prep(pallas_solve.embed_scenario(batch, dims, dims_e),
                             w, dims_e, torch.float64, "auto")[1:4]
    return cfg, kcost.StaticW.build(w, cfg), dims, dims_e, native, emb


@pytest.mark.parametrize("name", list(EMBED))
def test_team_eval_embedded_f64_matches_autograd(name):
    """Kernel A's mapping on the embedded form of a uniform N = 2 / 4 class
    (32 members) equals autograd on it (f rtol 1e-11, g 1e-9), and the
    rows the class does not use carry exactly zero gradient (at S = 1 they
    are written, not left from an earlier lane)."""
    cfg, sw, dims, dims_e, native, (x0p, sc, kc) = _embed_setup(name)
    tuned = EngineFlags.tuned()
    f_ref, g_ref = kcost.eval_fg(x0p, sc, kc, sw, dims_e, tuned)
    f, g = _host_eval(x0p, sc, kc, sw, "auto", torch.float64, G=32,
                      dims=dims_e)
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9,
                               atol=1e-9)
    used = pallas_solve._move_x(torch.ones_like(native[0]), dims, dims_e)
    assert not torch.any(g[used == 0])


@pytest.mark.parametrize("name", list(EMBED))
def test_team_solve_embedded_f64_matches_round_loop_12_iterations(name):
    """Kernel B's mapping on the embedded form of a uniform N = 2 / 4
    class (what solve_batch_fused launches for it) takes the plain round
    loop's 12-iteration path on the native class: statuses, k and evals
    exact, x mapped back within 1e-9."""
    cfg, sw, dims, dims_e, (x0n, scn, kcn), (x0p, sc, kc) = \
        _embed_setup(name)
    flags = EngineFlags.tuned()
    p = cfg.opt.lbfgs
    ref = pallas_solve._solve_rounds(x0n, scn, kcn, sw, dims, p, 12, flags)
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, dims_e, flags)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, "auto", p, 12, flags,
                             torch.float64, G=32, dims=dims_e)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    np.testing.assert_allclose(f.numpy(), ref.fp.numpy(), rtol=1e-10)
    np.testing.assert_allclose(
        pallas_solve._move_x(x, dims_e, dims).numpy(), ref.xp.numpy(),
        rtol=1e-9, atol=1e-9)
