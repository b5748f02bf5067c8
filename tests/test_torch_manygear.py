"""Kernels A and B past four gear segments, on the CPU: classes of 5 to 8
segments (csrc/common.cuh kMaxS), at capacities 8 and 16, and the front
end's many-point turns with their padded segments.

  * JAX parity, float64, B = 8: the port's plain objective
    (kcost.eval_fg_plain) against JAX's kcost.eval_fg (plain XLA) on
    chip_smoke.py's phase-15 classes, Dims(S=5, N=8), Dims(S=6, N=8,
    Ns=(8, 4, 2, 2, 4, 8)), Dims(S=8, N=4) and Dims(S=5, N=16, Ns=(16, 8,
    4, 2, 2)), at x0 with half of the lanes moved off it: f rtol 1e-11, g
    rtol 1e-9 / atol 1e-9. All at O = 0: JAX's obstacle block costs ~100 s
    of compile at S = 5 (its rows are held to autograd by the harness
    below, at O = 2, and to JAX at S = 1 by tests/test_torch_kcost.py).
  * the front end's own lanes in an S = 6 class of 2 pieces per segment
    (chip_smoke.py's phase-15 front-end class): both packages'
    scenarios.frontend_batch on 20 x 30 m lots (seed 1: plans of 1 to 5
    segments, the rest of each lane padded with seg_mask False) give the
    same arrays; JAX's round loop (pallas_solve._solve_rounds, the loop of
    its plain-XLA engine) and the port's take the same 12-iteration path
    from the same packed inputs (statuses, k and evaluations exact, fp
    rtol 1e-10, xp rtol 1e-9 / atol 1e-10), and the port's plain objective
    at JAX's final iterates equals the values and gradients JAX's
    kcost.eval_fg computed there inside its loop (f 1e-11, g 1e-9).
    The front end's shortest segments (down to ~0.07 s; dT^-5 ~ 2e7 on a
    jerk form that cancels positions of ~20 m) leave float64 itself unable
    to resolve some lanes' f to 1e-11: moving x by one ulp moves f by up to
    ~1e-9 relative there. So on these lanes f, g, fp and xp are held to
    those tolerances or, where the port's own value moves more when its
    input moves by one ulp (three seeded signs), to 4x that move, as
    tests/test_torch_kclass.py holds its long paths.
  * the g++ harness (tests/_kernel_harness.py: csrc/kcost.cuh and
    csrc/solve.cuh with the card's 32-member warp mapping) at the new
    instantiations, S = 5 (with obstacles) and 8 at capacity 8, S = 5 at
    capacity 16, and the front-end lanes at S = 6: the objective against
    autograd (f rtol 1e-11, g 1e-9), the rows a class does not use exactly
    zero, and kernel B's per-lane solve against the plain round loop for
    12 iterations (statuses, k and evaluations exact, f rtol 1e-10, x
    within 1e-9; on the front-end lanes the one-ulp rule above).
  * the wrapper's domain (_cuda.check_domain, limits as numbers) and the
    weight vector's layout at the new limit and at a build's kMaxS of 4.

JAX's five programs (four objectives, one loop) are traced one after
another and compiled in parallel threads (XLA's compile releases the GIL),
which takes ~40 s off this module.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import _kernel_harness
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu import scenarios as jscen
from dftpav_tpu.ops import kcost as jkcost
from dftpav_tpu.ops import pallas_solve as jps
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import Scenario as JScenario
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, scenarios
from dftpav_tpu_torch.ops import _cuda, kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

B = 8
GRID = dict(K=16, Kdes=32, H=4, Po=8)
# chip_smoke.py's phase-15 classes (O = 0 here: module docstring)
CLASSES = {
    "S5-N8": dict(S=5, N=8, O=0, **GRID),
    "S6-N8-842248": dict(S=6, N=8, O=0, Ns=(8, 4, 2, 2, 4, 8), **GRID),
    "S8-N4": dict(S=8, N=4, O=0, **GRID),
    "S5-N16-168422": dict(S=5, N=16, O=0, Ns=(16, 8, 4, 2, 2), **GRID)}
# the front end's lanes: an S = 6 class of 2 pieces per segment on small
# lots, seed 1
FRONTEND = dict(S=6, N=2, O=0, **GRID)
FE_SEED, FE_LOT = 1, (20.0, 30.0)
# the harness's classes: S = 5 with two moving obstacles, the largest S at
# capacity 8, S = 5 at capacity 16, the front-end lanes
HOST = {"S5-N8-O2": dict(CLASSES["S5-N8"], O=2),
        "S8-N4": CLASSES["S8-N4"],
        "S5-N16-168422": CLASSES["S5-N16-168422"],
        "frontend-S6": FRONTEND}
INSTANCES = (("f64", 32, 8, 5), ("f64", 32, 8, 6), ("f64", 32, 8, 8),
             ("f64", 32, 16, 5))


def _jittered(dims, seed=5):
    """B lanes of multi_gear_scenario with inner waypoints jittered by a
    seeded +-0.3 m (padded slots kept zero), dims.O moving obstacles."""
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(B):
        sc = scenarios.multi_gear_scenario(dims, dtype=np.float64)
        inner = sc.init_inner + rng.uniform(-0.3, 0.3, sc.init_inner.shape)
        inner[sc.init_inner == 0] = 0.0
        lanes.append(sc._replace(init_inner=inner))
    npb = scenarios.stack_scenarios(lanes)
    if dims.O:
        obs = scenarios.batch_scenarios(Dims(S=1, N=8, O=dims.O, **GRID), B,
                                        seed=seed, dtype=np.float64,
                                        n_obstacles=dims.O)
        npb = npb._replace(obs_coef=obs.obs_coef, obs_dt=obs.obs_dt,
                           obs_rel_t0=obs.obs_rel_t0, obs_mask=obs.obs_mask)
    return npb


@functools.lru_cache(maxsize=None)
def _frontend():
    """(port's, JAX's) frontend_batch of the S = 6 class, float64, a 1 s
    search budget (the plans end within it; the wider budget keeps a
    loaded host from cutting one package's search and not the other's)."""
    kw = dict(seed=FE_SEED, dtype=np.float64, lot=FE_LOT, n_obstacles=0,
              max_search_time=1.0)
    return (scenarios.frontend_batch(Dims(**FRONTEND), B, **kw),
            jscen.frontend_batch(JDims(**FRONTEND), B, **kw))


def _lanes(kw):
    return _frontend()[0] if kw is FRONTEND else _jittered(Dims(**kw))


def _jax_inputs(kw, npb):
    """JAX's packed inputs of the class (tuned flags with mxu "f32")."""
    jdims = JDims(**kw)
    jcfg = jconfig.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    jflags = dataclasses.replace(jconfig.EngineFlags.tuned(), mxu="f32")
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, jdims.ns_tuple)
    _b, x0p, jsc, jkc, D = jps._prep(
        JScenario(*(jnp.asarray(a) for a in npb)), jw, jdims, jcfg,
        jnp.float64, sig)
    return jdims, jcfg, jflags, jkcost.StaticW.build(jw, jcfg), x0p, jsc, \
        jkc, D


def _port_inputs(kw, jsc):
    cfg = config.PlannerConfig()
    dims = Dims(**kw)
    return dict(
        sc=from_numpy(jax.tree.map(np.asarray, jsc), kcost.KScenario,
                      device="cpu", dtype=torch.float64),
        kc=kcost.make_consts(dims, torch.float64),
        sw=kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                   device="cpu"), cfg),
        dims=dims, flags=config.EngineFlags.tuned(), cfg=cfg)


def _ulp_moves(fn, x, n=3):
    """The largest change of fn(x)'s outputs (arrays, lanes last) when x
    moves by one ulp with seeded signs, per lane: how finely float64
    resolves them there."""
    ref = fn(x)
    moves = [torch.zeros(r.shape[-1], dtype=torch.float64) for r in ref]
    for k in range(n):
        sgn = torch.from_numpy(np.random.default_rng(k).choice(
            [-1.0, 1.0], tuple(x.shape)))
        for m, a, b in zip(moves, fn(x * (1 + 2.0 ** -52 * sgn)), ref):
            d = (a - b).abs()
            m.copy_(torch.maximum(m, d if d.dim() == 1 else d.amax(dim=0)))
    return moves


def _assert_within(a, ref, rtol, atol, move):
    """|a - ref| <= max(rtol |ref| + atol, 4 move) everywhere (move per
    lane, the last axis)."""
    tol = torch.maximum(rtol * ref.abs() + atol,
                        4.0 * torch.as_tensor(move, dtype=ref.dtype))
    assert bool(((a - ref).abs() <= tol).all()), ((a - ref).abs().max(),
                                                 tol.min())


# ---------------------------------------------------------------------------
# JAX parity, float64
# ---------------------------------------------------------------------------

def _moved(x0p, D):
    x = np.asarray(x0p).copy()
    x[:D, B // 2:] += 0.3 * np.random.default_rng(17).standard_normal(
        (D, B - B // 2))
    return jnp.asarray(x)


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """JAX's references as numpy: {class: (f, g, x, jsc)} of kcost.eval_fg
    at _moved(x0) for CLASSES, and "loop": (12 iterations of the round
    loop on the front-end lanes, jsc). Traced in turn, compiled in
    parallel threads, then run."""
    progs = {}
    for name, kw in CLASSES.items():
        jdims, _c, jflags, jsw, x0p, jsc, jkc, D = _jax_inputs(kw, _lanes(kw))
        fn = functools.partial(jkcost.eval_fg, sw=jsw, dims=jdims,
                               flags=jflags)
        x = _moved(x0p, D)
        progs[name] = (jax.jit(fn).lower(x, jsc, jkc), (x, jsc, jkc), jsc)
    jdims, jcfg, jflags, jsw, x0p, jsc, jkc, _D = _jax_inputs(
        FRONTEND, _frontend()[1])
    loop = functools.partial(jps._solve_rounds, sw=jsw, dims=jdims,
                             p=jcfg.opt.lbfgs, max_iter=12, flags=jflags)
    progs["loop"] = (jax.jit(loop).lower(x0p, jsc, jkc), (x0p, jsc, jkc),
                     jsc)
    with ThreadPoolExecutor(len(progs)) as pool:
        exe = dict(zip(progs, pool.map(lambda v: v[0].compile(),
                                       progs.values())))
    out = {}
    for name, (_low, args, jsc) in progs.items():
        res = jax.tree.map(np.asarray, exe[name](*args))
        out[name] = (res, np.asarray(args[0]), jsc)
    return out


@pytest.mark.parametrize("name", list(CLASSES))
def test_objective_matches_jax_eval_fg(name):
    """The port's plain objective equals JAX's kcost.eval_fg at x0 and at
    x0 moved by a seeded 0.3 N(0, 1) on half of the lanes."""
    (jf, jg), x, jsc = _jax_refs()[name]
    p = _port_inputs(CLASSES[name], jsc)
    f, g = kcost.eval_fg_plain(from_numpy(x, device="cpu",
                                          dtype=torch.float64),
                               p["sc"], p["kc"], p["sw"], p["dims"],
                               p["flags"])
    np.testing.assert_allclose(f.numpy(), jf, rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-9, atol=1e-9)
    assert not torch.any(g[p["dims"].dim:])


def test_frontend_lanes_match_between_packages():
    """Both packages' front ends plan the same S = 6 lanes: plans of 1 to
    5 gear segments, each padded to 6 with copies whose seg_mask is
    False."""
    port, ref = _frontend()
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    nseg = port.seg_mask.sum(axis=1)
    assert nseg.max() == 5 and nseg.min() == 1 and (nseg < 6).all()
    # the mask is a prefix: the real segments first
    assert all(port.seg_mask[i, :n].all() for i, n in enumerate(nseg))


def _loop_fn(sc, kc, sw, dims, p, iters, flags):
    """x0 -> (fp, xp) of the plain round loop."""
    def fn(x0):
        r = pallas_solve._solve_rounds(x0, sc, kc, sw, dims, p, iters, flags)
        return r.fp, r.xp
    return fn


@functools.lru_cache(maxsize=None)
def _frontend_loop():
    """(port's raw round state, JAX's as numpy, port inputs, the port
    loop's one-ulp moves of (fp, xp)): 12 iterations of both round loops
    from JAX's packed x0 of the front-end lanes."""
    ref, x0, jsc = _jax_refs()["loop"]
    p = _port_inputs(FRONTEND, jsc)
    fn = _loop_fn(p["sc"], p["kc"], p["sw"], p["dims"], p["cfg"].opt.lbfgs,
                  12, p["flags"])
    x0 = from_numpy(x0, device="cpu", dtype=torch.float64)
    out = pallas_solve._solve_rounds(x0, p["sc"], p["kc"], p["sw"],
                                     p["dims"], p["cfg"].opt.lbfgs, 12,
                                     p["flags"])
    return out, ref, p, _ulp_moves(fn, x0)


def test_round_loop_matches_jax_frontend_s6():
    out, ref, _p, (df, dx) = _frontend_loop()
    np.testing.assert_array_equal(out.status.numpy(),
                                  ref.status[0].astype(int))
    np.testing.assert_array_equal(out.k.clamp(max=12).numpy(),
                                  np.minimum(ref.k[0].astype(int), 12))
    np.testing.assert_array_equal(out.n_evals.numpy(),
                                  ref.n_evals[0].astype(int))
    _assert_within(out.fp, torch.from_numpy(ref.fp[0]), 1e-10, 0.0, df)
    _assert_within(out.xp, torch.from_numpy(ref.xp), 1e-9, 1e-10, dx)


def test_objective_matches_jax_at_frontend_iterates():
    """The port's plain objective at JAX's final iterates of the front-end
    lanes equals what JAX's kcost.eval_fg computed there (its loop's fp,
    gp): the padded segments carry no cost and their junctions no
    coupling in both."""
    _out, ref, p, _moves = _frontend_loop()

    def fg(x):
        return kcost.eval_fg_plain(x, p["sc"], p["kc"], p["sw"], p["dims"],
                                   p["flags"])
    xp = from_numpy(ref.xp, device="cpu", dtype=torch.float64)
    f, g = fg(xp)
    df, dg = _ulp_moves(fg, xp)
    _assert_within(f, torch.from_numpy(ref.fp[0]), 1e-11, 0.0, df)
    _assert_within(g, torch.from_numpy(ref.gp), 1e-9, 1e-9, dg)


# ---------------------------------------------------------------------------
# the kernels' per-lane code (g++ harness)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _host_case(name):
    """Native and kernel-class inputs of HOST[name], float64, B lanes, and
    x: half of the lanes moved off x0 (in the kernel layout)."""
    kw = HOST[name]
    dims = Dims(**kw)
    cfg = config.PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(_lanes(FRONTEND) if name == "frontend-S6"
                       else _jittered(dims), Scenario, device="cpu",
                       dtype=torch.float64)
    dims_e = pallas_solve.embedded_class(dims)
    native = pallas_solve._prep(batch, w, dims, torch.float64, "auto")[1:4]
    emb = pallas_solve._prep(pallas_solve.embed_scenario(batch, dims, dims_e),
                             w, dims_e, torch.float64, "auto")[1:4]
    x = native[0].clone()
    x[:dims.dim, B // 2:] += torch.from_numpy(0.3 * np.random.default_rng(
        23).standard_normal((dims.dim, B - B // 2)))
    return (cfg, kcost.StaticW.build(w, cfg), dims, dims_e, native, emb,
            pallas_solve._move_x(x, dims, dims_e))


@pytest.mark.parametrize("name", list(HOST))
def test_host_eval_matches_autograd(name):
    """Kernel A's mapping (32 members) at S = 5 to 8: autograd's value and
    gradient on the kernel class, rows the class does not use exactly
    zero, and the native class's objective."""
    _cfg, sw, dims, dims_e, native, (x0e, sce, kce), xe = _host_case(name)
    assert dims_e.N in (8, 16) and dims_e.Ns == dims.ns_tuple
    tuned = config.EngineFlags.tuned()

    def fg(x):
        return kcost.eval_fg(x, sce, kce, sw, dims_e, tuned)
    for x in (x0e, xe):
        f_ref, g_ref = fg(x)
        f, g = _kernel_harness.host_eval(x, sce, kce, sw, "auto",
                                         torch.float64, 32, dims_e,
                                         INSTANCES)
        df, dg = _ulp_moves(fg, x) if name == "frontend-S6" else (0.0, 0.0)
        _assert_within(f, f_ref, 1e-11, 0.0, df)
        _assert_within(g, g_ref, 1e-9, 1e-9, dg)
        used = pallas_solve._move_x(torch.ones_like(native[0]), dims, dims_e)
        assert not torch.any(g[used == 0])
    f_n, _g = kcost.eval_fg(pallas_solve._move_x(xe, dims_e, dims),
                            *native[1:], sw, dims, tuned)
    _assert_within(f, f_n, 1e-12, 0.0, df)


@pytest.mark.parametrize("name", list(HOST))
def test_host_solve_matches_round_loop(name):
    """Kernel B's mapping on the kernel class takes the plain round loop's
    12-iteration path on the native class: statuses, k and evals exact, f
    rtol 1e-10, x mapped back within 1e-9."""
    cfg, sw, dims, dims_e, (x0n, scn, kcn), (x0e, sce, kce), _x = \
        _host_case(name)
    flags = config.EngineFlags.tuned()
    p = cfg.opt.lbfgs
    ref = pallas_solve._solve_rounds(x0n, scn, kcn, sw, dims, p, 12, flags)
    f0, g0 = kcost.eval_fg(x0e, sce, kce, sw, dims_e, flags)
    x, f, info = _kernel_harness.host_solve(x0e, f0, g0, sce, kce, sw, "auto",
                                            p, 12, flags, torch.float64, 32,
                                            dims_e, INSTANCES)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    df, dx = (_ulp_moves(_loop_fn(scn, kcn, sw, dims, p, 12, flags), x0n)
              if name == "frontend-S6" else (0.0, 0.0))
    _assert_within(f, ref.fp, 1e-10, 0.0, df)
    _assert_within(pallas_solve._move_x(x, dims_e, dims), ref.xp, 1e-9,
                   1e-9, dx)


# ---------------------------------------------------------------------------
# the wrapper's domain and the weight vector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [
    Dims(S=5, N=8), Dims(S=6, N=8, Ns=(8, 4, 2, 2, 4, 8)), Dims(S=7, N=2),
    Dims(S=8, N=4), Dims(S=5, N=16, Ns=(16, 8, 4, 2, 2)), Dims(S=8, N=16),
    Dims(S=6, N=12)])
def test_domain_admits_many_gear(dims):
    """S = 5 to 8 run on the kernels at capacities 8 and 16 (the limits as
    numbers: no library is loaded)."""
    _cuda.check_domain(dims, max_s=_cuda.MAX_S, max_n=16, max_h=8)
    kd = kcost.kernel_class(dims)
    assert kd.S == dims.S and kd.N in kcost.CAPACITIES
    assert _cuda.MAX_S == 8


@pytest.mark.parametrize("dims", [Dims(S=9, N=8), Dims(S=9, N=16)])
def test_domain_refuses_nine_segments(dims):
    with pytest.raises(NotImplementedError, match="S <= 8"):
        _cuda.check_domain(dims)


def test_weight_vector_at_the_new_limit():
    """Every segment's slot holds its own class values at S = 8 (kMaxS
    slots per field, csrc/kcost.cuh WIdx: W_NS = 35, W_LEN = 60)."""
    cfg = config.PlannerConfig()
    sw = kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                 device="cpu"), cfg)
    dims = kcost.kernel_class(Dims(S=8, N=8, Ns=(8, 4, 2, 2, 4, 8, 2, 4),
                                   **GRID))
    v = _cuda.weight_vector(sw, "auto", dims)
    sig = config.resolve_vt_scale("auto", dims.ns_tuple)
    assert len(v) == 60 and v[34] == 8 and v[59] == 8
    assert v[35:43] == list(dims.ns_tuple)
    assert v[43:51] == _cuda.seg_rows(dims)
    assert v[51:59] == list(sig)


def test_weight_vector_for_a_four_slot_build():
    """A build whose kMaxS is 4 (chip_smoke.py --parent) gets its own
    layout: for a class of S <= 4 its vector is the new one's with the
    slots past the fourth left out."""
    cfg = config.PlannerConfig()
    sw = kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                 device="cpu"), cfg)
    dims = kcost.kernel_class(Dims(S=2, N=8, Ns=(8, 2), **GRID))
    wide = _cuda.weight_vector(sw, "auto", dims)
    four = _cuda.weight_vector(sw, "auto", dims, 4)
    assert len(four) == 48
    assert four == wide[:39] + wide[43:47] + wide[51:55] + wide[59:]
    # the unused slots repeat segment 0
    assert four[37:39] == [8, 8] and wide[37:43] == [8] * 6
