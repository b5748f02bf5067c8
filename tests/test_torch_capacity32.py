"""Kernels A and B at capacity 32, on the CPU: classes with a gear segment
of 17 to 32 pieces (kcost.CAPACITIES), each segment reading its own piece
count at run time.

  * JAX parity, float64, B = 8: the port's plain objective
    (kcost.eval_fg_plain) against JAX's kcost.eval_fg (plain XLA) on
    chip_smoke.py's phase-16 classes, Dims(S=1, N=32), Dims(S=1, N=24),
    Dims(S=2, N=32, Ns=(32, 8)) and Dims(S=5, N=32, Ns=(32, 8, 4, 2, 2)),
    at x0 with half of the lanes moved off it: f rtol 1e-11, g rtol 1e-9 /
    atol 1e-9; and the port's objective on N = 24 embedded into capacity 32
    (KClass(S=1, N=32, Ns=(24,)), the layout the kernels run it in) against
    JAX's native N = 24, the unused rows' gradient exactly zero. All at
    O = 0: JAX's obstacle block costs minutes of compile at these sizes
    (the harness below holds the obstacle rows to autograd at S = 1).
  * JAX's round loop (pallas_solve._solve_rounds, the loop of its plain-XLA
    engine "rounds") and the port's take the same 12-iteration path at
    Dims(S=1, N=32) from the same packed inputs: statuses, k and
    evaluations exact, fp rtol 1e-10, xp rtol 1e-9 / atol 1e-10.
  * the g++ harness (tests/_kernel_harness.py: csrc/kcost.cuh and
    csrc/solve.cuh with the card's 32-member warp mapping, whose gradient
    partials take 96 slots at capacity 32) at S = 1 (two movers), 2 and 5:
    the objective against autograd (f rtol 1e-11, g 1e-9), the rows a
    class does not use exactly zero, and kernel B's per-lane solve against
    the plain round loop on the native class for 12 iterations (statuses,
    k and evaluations exact). f and x there are held to rtol 1e-10 and
    1e-9 or, where the port's own loop moves more when x0 moves by one ulp
    (three seeded signs), to 4x that move, as tests/test_torch_manygear.py
    holds its front-end lanes: the long segments' jerk forms over positions
    of up to ~50 m resolve f to ~1e-10 in float64.
  * the front end's route: ParkingPlanner's class ladder takes a long
    drive into an N = 32 class; the wrapper's domain (_cuda.check_domain)
    at the new limit and the weight vector's capacity.

The lanes are _fixtures.long_gear_batch's: a drive through a 40 x 60 m
lot's aisles at the front end's speeds, then the maneuvers into a bay,
pieced as the reference pieces a segment (0.8-1.2 s a piece). JAX's
programs (four objectives, one loop) are traced one after another and
compiled in parallel threads, as tests/test_torch_manygear.py does.
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
from dftpav_tpu.ops import kcost as jkcost
from dftpav_tpu.ops import pallas_solve as jps
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import Scenario as JScenario
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import _fixtures, config
from dftpav_tpu_torch.ops import _cuda, kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

B = 8
GRID = dict(K=16, Kdes=32, H=4, Po=8)
# chip_smoke.py's phase-16 classes (O = 0 here: module docstring)
CLASSES = {
    "C32-N32": dict(S=1, N=32, O=0, **GRID),
    "C32-N24": dict(S=1, N=24, O=0, **GRID),
    "C32-S2-32-8": dict(S=2, N=32, O=0, Ns=(32, 8), **GRID),
    "C32-S5": dict(S=5, N=32, O=0, Ns=(32, 8, 4, 2, 2), **GRID)}
LOOP = "C32-N32"
# the harness's classes: S = 1 with two movers, S = 2 and 5
HOST = {"C32-N32-O2": dict(CLASSES["C32-N32"], O=2),
        "C32-S2-32-8": CLASSES["C32-S2-32-8"],
        "C32-S5": CLASSES["C32-S5"]}
INSTANCES = (("f64", 32, 32, 1), ("f64", 32, 32, 2), ("f64", 32, 32, 5))


def _lanes(kw, seed=5):
    return _fixtures.long_gear_batch(Dims(**kw), B, seed=seed,
                                     dtype=np.float64, n_obstacles=kw["O"])


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
    """JAX's references as numpy: {class: ((f, g), x, jsc)} of
    kcost.eval_fg at _moved(x0) for CLASSES, and "loop": (12 iterations of
    the round loop at LOOP, x0, jsc). Traced in turn, compiled in parallel
    threads, then run."""
    progs = {}
    for name, kw in CLASSES.items():
        jdims, _c, jflags, jsw, x0p, jsc, jkc, D = _jax_inputs(kw, _lanes(kw))
        fn = functools.partial(jkcost.eval_fg, sw=jsw, dims=jdims,
                               flags=jflags)
        x = _moved(x0p, D)
        progs[name] = (jax.jit(fn).lower(x, jsc, jkc), (x, jsc, jkc), jsc)
    kw = CLASSES[LOOP]
    jdims, jcfg, jflags, jsw, x0p, jsc, jkc, _D = _jax_inputs(kw, _lanes(kw))
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


def test_embedded_n24_matches_jax_native():
    """N = 24 in the layout the kernels run it in (capacity 32, its own
    piece count 24) gives JAX's native N = 24 objective: f rtol 1e-11, the
    gradient's used rows g 1e-9, every other row exactly zero."""
    kw = CLASSES["C32-N24"]
    (jf, jg), x, _jsc = _jax_refs()["C32-N24"]
    dims = Dims(**kw)
    dims_e = pallas_solve.embedded_class(dims)
    assert (dims_e.N, dims_e.Ns) == (32, (24,))
    cfg = config.PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(_lanes(kw), Scenario, device="cpu",
                       dtype=torch.float64)
    _b, _x0, sce, kce, _D = pallas_solve._prep(
        pallas_solve.embed_scenario(batch, dims, dims_e), w, dims_e,
        torch.float64, "auto")
    xe = pallas_solve._move_x(from_numpy(x, device="cpu",
                                         dtype=torch.float64), dims, dims_e)
    f, g = kcost.eval_fg_plain(xe, sce, kce, kcost.StaticW.build(w, cfg),
                               dims_e, config.EngineFlags.tuned())
    np.testing.assert_allclose(f.numpy(), jf, rtol=1e-11)
    np.testing.assert_allclose(
        pallas_solve._move_x(g, dims_e, dims).numpy(), jg, rtol=1e-9,
        atol=1e-9)
    used = pallas_solve._move_x(torch.ones_like(from_numpy(
        x, device="cpu", dtype=torch.float64)), dims, dims_e)
    assert not torch.any(g[used == 0])


def test_round_loop_matches_jax_n32():
    """JAX's round loop and the port's take the same 12-iteration path at
    N = 32 from JAX's packed inputs."""
    ref, x0, jsc = _jax_refs()["loop"]
    p = _port_inputs(CLASSES[LOOP], jsc)
    out = pallas_solve._solve_rounds(
        from_numpy(x0, device="cpu", dtype=torch.float64), p["sc"], p["kc"],
        p["sw"], p["dims"], p["cfg"].opt.lbfgs, 12, p["flags"])
    np.testing.assert_array_equal(out.status.numpy(),
                                  ref.status[0].astype(int))
    np.testing.assert_array_equal(out.k.clamp(max=12).numpy(),
                                  np.minimum(ref.k[0].astype(int), 12))
    np.testing.assert_array_equal(out.n_evals.numpy(),
                                  ref.n_evals[0].astype(int))
    np.testing.assert_allclose(out.fp.numpy(), ref.fp[0], rtol=1e-10)
    np.testing.assert_allclose(out.xp.numpy(), ref.xp, rtol=1e-9,
                               atol=1e-10)


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
    batch = from_numpy(_lanes(kw), Scenario, device="cpu",
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
    """Kernel A's mapping (32 members) at capacity 32: autograd's value and
    gradient on the kernel class, rows the class does not use exactly
    zero, and the native class's objective."""
    _cfg, sw, dims, dims_e, native, (x0e, sce, kce), xe = _host_case(name)
    assert dims_e.N == 32 and dims_e.Ns == dims.ns_tuple
    tuned = config.EngineFlags.tuned()

    def fg(x):
        return kcost.eval_fg(x, sce, kce, sw, dims_e, tuned)
    for x in (x0e, xe):
        f_ref, g_ref = fg(x)
        f, g = _kernel_harness.host_eval(x, sce, kce, sw, "auto",
                                         torch.float64, 32, dims_e,
                                         INSTANCES)
        np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-11)
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9,
                                   atol=1e-9)
        used = pallas_solve._move_x(torch.ones_like(native[0]), dims, dims_e)
        assert not torch.any(g[used == 0])
    f_n, _g = kcost.eval_fg(pallas_solve._move_x(xe, dims_e, dims),
                            *native[1:], sw, dims, tuned)
    np.testing.assert_allclose(f.numpy(), f_n.numpy(), rtol=1e-12)


def _loop_fn(sc, kc, sw, dims, p, iters, flags):
    """x0 -> (fp, xp) of the plain round loop."""
    def fn(x0):
        r = pallas_solve._solve_rounds(x0, sc, kc, sw, dims, p, iters, flags)
        return r.fp, r.xp
    return fn


@pytest.mark.parametrize("name", list(HOST))
def test_host_solve_matches_round_loop(name):
    """Kernel B's mapping on the kernel class takes the plain round loop's
    12-iteration path on the native class: statuses, k and evals exact, f
    and x mapped back within the module docstring's tolerances."""
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
    df, dx = _ulp_moves(_loop_fn(scn, kcn, sw, dims, p, 12, flags), x0n)
    _assert_within(f, ref.fp, 1e-10, 0.0, df)
    _assert_within(pallas_solve._move_x(x, dims_e, dims), ref.xp, 1e-9,
                   1e-9, dx)


# ---------------------------------------------------------------------------
# the front end's route to capacity 32
# ---------------------------------------------------------------------------

def test_pipeline_routes_a_long_drive_to_capacity32():
    """A 112 m single-gear drive down a 160 m lot plans as one segment of
    ~23 s, which the reference pieces at 23 (max(round(dur / 1 s), 2)):
    ParkingPlanner's ladder up to N = 32 takes it into Dims(S=1, N=32),
    which the kernels run at capacity 32 (chip_smoke.py's phase 16 solves
    such plans on the card)."""
    from dftpav_tpu_torch.frontend import GridMap2D
    from dftpav_tpu_torch.pipeline import ParkingPlanner, quantized_counts

    res = 0.2
    occ = np.zeros((int(30 / res), int(160 / res)), np.uint8)
    occ[:3, :] = occ[-3:, :] = occ[:, :3] = occ[:, -3:] = 1
    classes = [Dims(S=1, N=n, K=16, Kdes=32, H=4, O=0, Po=8)
               for n in (2, 4, 8, 16, 32)]
    pp = ParkingPlanner(GridMap2D(occ, origin=(0.0, 0.0), resolution=res),
                        dims_classes=classes)
    sc, meta = pp.plan_scenario((8.0, 15.0, 0.0, 0.0),
                                (120.0, 15.0, 0.0, 0.0))
    assert meta.n_segments == 1 and 16.5 < meta.durations[0] < 32.5
    assert quantized_counts(meta.durations, 32) == (32,)
    assert meta.dims == classes[-1]
    assert sc.init_inner.shape == (1, 31, 2)
    _cuda.check_domain(meta.dims)
    assert kcost.kernel_class(meta.dims).N == 32


# ---------------------------------------------------------------------------
# the wrapper's domain and the weight vector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [
    Dims(S=1, N=17), Dims(S=1, N=24), Dims(S=1, N=32),
    Dims(S=2, N=32, Ns=(32, 8)), Dims(S=5, N=32, Ns=(32, 8, 4, 2, 2)),
    Dims(S=8, N=17), Dims(S=8, N=32)])
def test_domain_admits_capacity32(dims):
    """Segments of 17 to 32 pieces run on the kernels at capacity 32, at
    S = 1 and up to S = 8 (the limits as numbers: no library is loaded)."""
    _cuda.check_domain(dims)
    kd = kcost.kernel_class(dims)
    assert kd.N == 32 and kd.Ns == dims.ns_tuple and kd.S == dims.S
    assert _cuda.MAX_N == 32 and kcost.CAPACITIES == (8, 16, 32)


def test_domain_refuses_33_pieces():
    with pytest.raises(NotImplementedError, match="N <= 32"):
        _cuda.check_domain(Dims(S=1, N=33))


def test_weight_vector_carries_capacity32():
    """The class at the vector's end (csrc/kcost.cuh WIdx): S, each
    segment's pieces, rows kept and sigma, then the capacity, 32."""
    cfg = config.PlannerConfig()
    sw = kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                 device="cpu"), cfg)
    dims = kcost.kernel_class(Dims(S=5, N=32, Ns=(32, 8, 4, 2, 2), **GRID))
    v = _cuda.weight_vector(sw, "auto", dims)
    assert len(v) == 60 and v[34] == 5 and v[59] == 32
    assert v[35:40] == [32, 8, 4, 2, 2]
    assert v[43:48] == _cuda.seg_rows(dims) == [576, 168, 104, 64, 64]
    assert v[51:56] == list(config.resolve_vt_scale("auto", dims.ns_tuple))
    # N = 24 rides capacity 32 with its own count
    v24 = _cuda.weight_vector(sw, "auto", kcost.kernel_class(Dims(S=1,
                                                                  N=24)))
    assert v24[35] == 24 and v24[59] == 32
