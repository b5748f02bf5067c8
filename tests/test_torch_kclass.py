"""Kernels A and B over the rest of K1's class domain, on the CPU: any piece
count N from 2 to 16 (capacities 8 and 16, kcost.KClass) and the L-BFGS
history m and past window taken from the config.

  * JAX parity, float64, B = 8: the port's plain round loop
    (pallas_solve._solve_rounds) against JAX's, the loop of its plain-XLA
    engine "rounds" (not the fused engine in interpret mode, whose compile
    is what pushes tests/test_megakernel.py past the clock), from the same
    packed inputs: statuses, k and evaluation counts exact, fp rtol 1e-10
    (1e-9 over 30 iterations), xp rtol 1e-9 / atol 1e-10
    (tests/test_torch_solver.py's gates); and the
    port's kcost.eval_fg_plain at JAX's final iterates against the values
    and gradients JAX's kcost.eval_fg computed there inside its loop (fp,
    gp): f rtol 1e-11, g rtol 1e-9 / atol 1e-9. Classes: Dims(S=1, N=6),
    Dims(S=2, N=5), Dims(S=1, N=16), Dims(S=2, N=16, Ns=(16, 8)), 12
    iterations, and the bench class at mem_size 64 and 256, 30 iterations
    (so that the history holds more than 16 pairs). All at O = 0: JAX's
    obstacle block adds ~20 s of compile per class and obstacle; the
    obstacle rows are held to JAX by tests/test_torch_kcost.py and to the
    harness below.
  * the g++ harness (tests/_kernel_harness.py: csrc/kcost.cuh and
    csrc/solve.cuh with the card's 32-member warp mapping) at capacity 8
    with n_s = 3, 5, 6 (which do not divide it) and at capacity 16: the
    objective against autograd (f rtol 1e-11, g 1e-9) with the rows the
    class does not use exactly zero, and kernel B's per-lane solve against
    the plain round loop on the native class, 12 iterations at m = 16 and
    30 at m = 64 (the history in a per-lane scratch, as the card places
    it past 16 pairs).
  * the embedding (pallas_solve.embedded_class, embed_scenario, _move_x)
    and the wrapper's domain check (_cuda.check_domain, with its limits as
    numbers): what runs, what raises NotImplementedError and its message.
"""

import dataclasses
import functools

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

from dftpav_tpu_torch import config, scenarios
from dftpav_tpu_torch.ops import _cuda, kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

B = 8
# name: Dims keywords; O = 0 where JAX compiles the class (module docstring)
CLASSES = {
    "S1-N6": dict(S=1, N=6, K=8, Kdes=12, H=4, O=0, Po=8),
    "S2-N5": dict(S=2, N=5, K=8, Kdes=12, H=4, O=0, Po=8),
    "S1-N16": dict(S=1, N=16, K=16, Kdes=32, H=4, O=0, Po=8),
    "S2-N16-8": dict(S=2, N=16, K=16, Kdes=32, H=4, O=0, Po=8, Ns=(16, 8))}
BENCH = dict(S=1, N=8, K=16, Kdes=32, H=4, O=0, Po=8)
# JAX parity runs: (class, mem_size, iterations)
RUNS = {"S1-N6": ("S1-N6", 16, 12), "S2-N5": ("S2-N5", 16, 12),
        "S1-N16": ("S1-N16", 16, 12), "S2-N16-8": ("S2-N16-8", 16, 12),
        "bench-m64": ("bench", 64, 30), "bench-m256": ("bench", 256, 30)}
# the harness's classes: capacity 8 at n_s = 3, 6, 5 (with obstacles at
# S = 1), capacity 16
HOST = {"S1-N3": dict(S=1, N=3, K=8, Kdes=12, H=4, O=2, Po=8),
        "S1-N6": dict(CLASSES["S1-N6"], O=2),
        "S2-N5": CLASSES["S2-N5"],
        "S1-N16": dict(CLASSES["S1-N16"], O=2),
        "S2-N16-8": CLASSES["S2-N16-8"]}
INSTANCES = (("f64", 32, 8, 1), ("f64", 32, 8, 2), ("f64", 32, 16, 1),
             ("f64", 32, 16, 2))


def _kw(name):
    return BENCH if name == "bench" else CLASSES[name]


def _numpy_batch(dims, seed=5, dtype=np.float64):
    """B lanes of the class: batch_scenarios at S = 1 (with dims.O
    obstacles), gear_scenario at S = 2 with its inner waypoints jittered by
    a seeded +-0.3 m (padded slots kept zero)."""
    if dims.S == 1:
        return scenarios.batch_scenarios(dims, B, seed=seed, dtype=dtype,
                                         n_obstacles=dims.O)
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(B):
        sc = scenarios.gear_scenario(dims, dtype=dtype)
        inner = sc.init_inner + rng.uniform(-0.3, 0.3, sc.init_inner.shape)
        inner[sc.init_inner == 0] = 0.0
        lanes.append(sc._replace(init_inner=inner.astype(dtype)))
    return scenarios.stack_scenarios(lanes)


# ---------------------------------------------------------------------------
# JAX parity, float64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(run):
    """(port's raw round state, JAX's as numpy, port inputs) for RUNS[run],
    tuned flags (JAX's with mxu="f32", the port's frame)."""
    name, m, iters = RUNS[run]
    kw = _kw(name)
    dims, jdims = Dims(**kw), JDims(**kw)
    flags = config.EngineFlags.tuned()
    jflags = dataclasses.replace(jconfig.EngineFlags.tuned(), mxu="f32")
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, jdims.ns_tuple)
    npb = _numpy_batch(dims)
    _b, x0p, jsc, jkc, _D = jps._prep(
        JScenario(*(jnp.asarray(a) for a in npb)), jw, jdims, jcfg,
        jnp.float64, sig)
    jp = dataclasses.replace(jcfg.opt.lbfgs, mem_size=m)
    ref = jps._solve_rounds(x0p, jsc, jkc, jkcost.StaticW.build(jw, jcfg),
                            jdims, jp, iters, flags=jflags)
    ref = jax.tree.map(np.asarray, ref)
    port = dict(
        x0=from_numpy(np.asarray(x0p), device="cpu", dtype=torch.float64),
        sc=from_numpy(jax.tree.map(np.asarray, jsc), kcost.KScenario,
                      device="cpu", dtype=torch.float64),
        kc=kcost.make_consts(dims, torch.float64),
        sw=kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                   device="cpu"), cfg),
        dims=dims, flags=flags,
        p=dataclasses.replace(cfg.opt.lbfgs, mem_size=m), iters=iters)
    out = pallas_solve._solve_rounds(port["x0"], port["sc"], port["kc"],
                                     port["sw"], dims, port["p"], iters,
                                     flags)
    return out, ref, port


@pytest.mark.parametrize("run", list(RUNS))
def test_round_loop_matches_jax(run):
    out, ref, port = _jax_run(run)
    n = port["iters"]
    np.testing.assert_array_equal(out.status.numpy(),
                                  ref.status[0].astype(int))
    np.testing.assert_array_equal(out.k.clamp(max=n).numpy(),
                                  np.minimum(ref.k[0].astype(int), n))
    np.testing.assert_array_equal(out.n_evals.numpy(),
                                  ref.n_evals[0].astype(int))
    # over 30 iterations the two float64 loops' last-bit differences grow
    # to ~2e-10 in f (still well inside "iterates to 1e-9")
    np.testing.assert_allclose(out.fp.numpy(), ref.fp[0],
                               rtol=1e-10 if n <= 12 else 1e-9, atol=0)
    np.testing.assert_allclose(out.xp.numpy(), ref.xp, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("run", list(RUNS))
def test_objective_matches_jax_eval_fg(run):
    """The port's plain objective at JAX's final iterates equals what JAX's
    kcost.eval_fg computed there (its loop's fp, gp)."""
    _out, ref, port = _jax_run(run)
    f, g = kcost.eval_fg_plain(
        from_numpy(ref.xp, device="cpu", dtype=torch.float64), port["sc"],
        port["kc"], port["sw"], port["dims"], port["flags"])
    np.testing.assert_allclose(f.numpy(), ref.fp[0], rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), ref.gp, rtol=1e-9, atol=1e-9)


def test_long_history_changes_the_path():
    """At 30 iterations the bench class's history outgrows 16 pairs: m = 64
    and m = 256 take paths of their own (the parity above is not m = 16's
    path twice), and the same one while no lane has used more than 64."""
    m64, _ref, port = _jax_run("bench-m64")
    m256 = _jax_run("bench-m256")[0]
    m16 = pallas_solve._solve_rounds(
        port["x0"], port["sc"], port["kc"], port["sw"], port["dims"],
        dataclasses.replace(port["p"], mem_size=16), port["iters"],
        port["flags"])
    assert int(m64.bound.max()) > 16
    assert not torch.equal(m16.xp, m64.xp)
    assert torch.equal(m64.xp, m256.xp)


# ---------------------------------------------------------------------------
# the kernels' per-lane code (g++ harness)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _host_case(name):
    """Native and kernel-class inputs of HOST[name], float64, B lanes, and
    x: half of the lanes moved off x0 (in the kernel layout)."""
    dims = Dims(**HOST[name])
    cfg = config.PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(_numpy_batch(dims), Scenario, device="cpu",
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
    """Kernel A's mapping (32 members) at a piece count that does not
    divide capacity 8, or at capacity 16 (constants per segment for its own
    n_s): autograd's value and gradient on the kernel class, rows the class
    does not use exactly zero, and the native class's objective."""
    cfg, sw, dims, dims_e, native, (x0e, sce, kce), xe = _host_case(name)
    assert dims_e.N in (8, 16) and dims_e.Ns == dims.ns_tuple
    tuned = config.EngineFlags.tuned()
    for x in (x0e, xe):
        f_ref, g_ref = kcost.eval_fg(x, sce, kce, sw, dims_e, tuned)
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


@pytest.mark.parametrize("name,m,iters", [
    (n, 16, 12) for n in HOST] + [("S1-N6", 64, 30), ("S1-N16", 64, 30)])
def test_host_solve_matches_round_loop(name, m, iters):
    """Kernel B's mapping on the kernel class takes the plain round loop's
    path on the native class: statuses, k and evals exact, f rtol 1e-10, x
    mapped back within 1e-9; at m = 64 over 30 iterations, with the
    history past 16 pairs in the per-lane scratch the card uses."""
    cfg, sw, dims, dims_e, (x0n, scn, kcn), (x0e, sce, kce), _x = \
        _host_case(name)
    flags = config.EngineFlags.tuned()
    p = dataclasses.replace(cfg.opt.lbfgs, mem_size=m)
    ref = pallas_solve._solve_rounds(x0n, scn, kcn, sw, dims, p, iters,
                                     flags)
    if m > 16:
        assert int(ref.bound.max()) > 16
    f0, g0 = kcost.eval_fg(x0e, sce, kce, sw, dims_e, flags)
    x, f, info = _kernel_harness.host_solve(x0e, f0, g0, sce, kce, sw, "auto",
                                            p, iters, flags, torch.float64,
                                            32, dims_e, INSTANCES)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=iters).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    # over 30 iterations a lane's path can magnify last-bit differences
    # (the warp's butterfly sums against torch's): f and x are held to
    # 1e-10 / 1e-9 or, where the loop itself moves more when x0 moves by
    # one ulp (three seeded signs), to 4x that move (as the S = 4 test of
    # tests/test_torch_kernel_host.py does)
    df = torch.zeros_like(ref.fp)
    dx = torch.zeros_like(ref.fp)
    for k in range(3 if iters > 12 else 0):
        sgn = torch.from_numpy(
            np.random.default_rng(k).choice([-1.0, 1.0], x0n.shape))
        alt = pallas_solve._solve_rounds(x0n * (1 + 2.0 ** -52 * sgn), scn,
                                         kcn, sw, dims, p, iters, flags)
        df = torch.maximum(df, (alt.fp - ref.fp).abs())
        dx = torch.maximum(dx, (alt.xp - ref.xp).abs().amax(dim=0))
    tol_f = torch.maximum(1e-10 * ref.fp.abs(), 4.0 * df)
    assert bool(((f - ref.fp).abs() <= tol_f).all()), (f - ref.fp, tol_f)
    xn = pallas_solve._move_x(x, dims_e, dims)
    tol_x = torch.maximum(1e-9 * ref.xp.abs() + 1e-9, 4.0 * dx)
    assert bool(((xn - ref.xp).abs() <= tol_x).all())


# ---------------------------------------------------------------------------
# the embedding and the wrapper's domain
# ---------------------------------------------------------------------------

EMBED = {"S1-N3": (Dims(S=1, N=3), 8, (3,)),
         "S1-N6": (Dims(**CLASSES["S1-N6"]), 8, (6,)),
         "S2-N5": (Dims(**CLASSES["S2-N5"]), 8, (5, 5)),
         "S1-N8": (Dims(S=1, N=8), 8, (8,)),
         "S1-N12": (Dims(S=1, N=12, K=8, Kdes=12), 16, (12,)),
         "S1-N16": (Dims(**CLASSES["S1-N16"]), 16, (16,)),
         "S2-N16-8": (Dims(**CLASSES["S2-N16-8"]), 16, (16, 8)),
         "S2-N16-8-4": (Dims(S=2, N=16, Ns=(8, 4)), 8, (8, 4)),
         "S4-N10": (Dims(S=4, N=10, K=8, Kdes=12), 16, (10,) * 4)}


@pytest.mark.parametrize("name", list(EMBED))
def test_embedded_class_and_round_trip(name):
    """The capacity each class runs at and its piece counts; x moved into
    the kernel layout and back is x, its rows land where the plain
    objective reads them (one row per decision variable), and the
    scenario's rows are the class's, the rest zero and masked."""
    dims, cap, ns = EMBED[name]
    dims_e = pallas_solve.embedded_class(dims)
    assert isinstance(dims_e, kcost.KClass) and dims_e.N == cap
    assert dims_e.Ns == ns and dims_e.S == dims.S
    assert pallas_solve.embedded_class(dims_e) is dims_e
    # the native rows the class reads: segment s's first n_s - 1 inner
    # waypoints, the times and the gear rows
    used = torch.zeros(kcost.dp_of(dims), 4, dtype=torch.bool)
    for s, n in enumerate(ns):
        used[2 * (dims.N - 1) * s:2 * ((dims.N - 1) * s + n - 1)] = True
    used[2 * dims.S * (dims.N - 1):dims.dim] = True
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (kcost.dp_of(dims), 4))) * used
    x_e = pallas_solve._move_x(x, dims, dims_e)
    assert x_e.shape == (kcost.dp_of(dims_e), 4)
    assert torch.equal(pallas_solve._move_x(x_e, dims_e, dims), x)
    assert int((x_e != 0).sum()) == int(used.sum())
    if dims.N == cap:
        assert x_e is x
    if dims.K == 16 and dims.O == 0 and dims.S <= 2:
        batch = from_numpy(_numpy_batch(dims, dtype=np.float64), Scenario,
                           device="cpu", dtype=torch.float64)
        be = pallas_solve.embed_scenario(batch, dims, dims_e)
        assert be.init_inner.shape[2] == cap - 1
        assert be.corr_mask.shape[2] == cap
        for s, n in enumerate(ns):
            assert torch.equal(be.init_inner[:, s, :n - 1],
                               batch.init_inner[:, s, :n - 1])
            assert not torch.any(be.corr_mask[:, s, n:])


@pytest.mark.parametrize("dims,mem,past", [
    (Dims(S=1, N=2), 1, 0), (Dims(S=1, N=16), 256, 3),
    (Dims(S=4, N=16), 16, 8), (Dims(S=4, N=5), 64, 20),
    (Dims(S=2, N=16, Ns=(16, 8)), 1000, 0), (Dims(S=3, N=7), 16, 3)])
def test_domain_admits(dims, mem, past):
    """S <= 4, 2 to 16 pieces per segment, any m >= 1 and past >= 0 run on
    the kernels (the limits as numbers: no library is loaded)."""
    _cuda.check_domain(dims, max_s=4, max_n=16, max_h=8, mem=mem, past=past)
    kd = kcost.kernel_class(dims)
    assert kd.N in kcost.CAPACITIES and max(kd.Ns) <= kd.N


@pytest.mark.parametrize("dims,limit", [
    (Dims(S=9, N=8), "S <= 8"), (Dims(S=9, N=2), "S <= 8"),
    (Dims(S=1, N=33), "N <= 32"),
    (Dims(S=2, N=64, Ns=(64, 32)), "N <= 32")])
def test_domain_refuses_with_the_limit(dims, limit):
    """What the kernels refuse raises NotImplementedError naming the limit
    (the plain round loop takes every class)."""
    with pytest.raises(NotImplementedError, match=limit):
        _cuda.check_domain(dims, max_s=8, max_n=32, max_h=8)


def test_domain_refuses_bad_lbfgs_settings():
    for mem, past in ((0, 3), (16, -1)):
        with pytest.raises(ValueError):
            _cuda.check_domain(Dims(), mem=mem, past=past)


def test_plain_loop_takes_a_class_the_kernels_refuse():
    """N = 33 is past the kernels' domain, and on CPU tensors
    solve_batch_fused (the fused engine's entry) still runs it: the plain
    round loop takes every class."""
    cfg = config.PlannerConfig()
    dims = Dims(S=1, N=33, K=8, Kdes=12, H=4, O=0, Po=8)
    with pytest.raises(NotImplementedError, match="N <= 32"):
        _cuda.check_domain(dims)
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(_numpy_batch(dims), Scenario, device="cpu",
                       dtype=torch.float64)
    res = pallas_solve.solve_batch_fused(batch, w, dims, cfg, 2)
    assert res.coeffs.shape == (B, 1, 33, 6, 2)
    assert bool(torch.isfinite(res.coeffs).all())
