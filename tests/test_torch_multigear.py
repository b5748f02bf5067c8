"""The port's multi-gear classes (S >= 2, per-segment piece classes
Dims.Ns) against the JAX package, float64, B <= 8.

  * plain objective and gradient (ops.kcost.eval_fg, autograd) against
    JAX kcost.eval_fg: f rtol 1e-11, g rtol 1e-9 / atol 1e-9, on uniform
    S=2 with a moving obstacle (tests/test_megakernel.py:228 _gear_batch),
    (8, 2), (2, 8) and (4, 2, 2);
  * the 12-iteration round loop against JAX _solve_rounds, tuned flags
    (per-slot vt_scale "auto"): statuses, k and eval counts exact, fp rtol
    1e-10, xp rtol 1e-9 / atol 1e-10;
  * _finalize coefficients and dT of an Ns class against JAX to 1e-9, and
    minco.subdivision_matrix equal;
  * solve_with_retry on the rounds engine, 12 iterations, time scales
    (1.6, 0.7): the same success mask and costs to 1e-9;
  * pipeline.quantized_counts equal on a grid of durations;
  * uniform N = 2 / 4 classes in the kernels' N = 8 form
    (pallas_solve.embedded_class), port only: the plain objective on the
    embedded class equals the native one (f 1e-12, used rows of g 1e-10,
    the other rows exactly zero), the plain round loop takes the native
    12-iteration paths (statuses, k, evals exact, x within 1e-9), and
    which classes still raise NotImplementedError in the binding.

Each JAX reference is computed once per module (plain XLA on the CPU).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu import minco as jminco
from dftpav_tpu import solver as jsolver
from dftpav_tpu.ops import kcost as jkcost
from dftpav_tpu.ops import pallas_solve as jps
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, minco, scenarios, solver
from dftpav_tpu_torch.ops import kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

B = 4
# name: (Ns or None, S, obstacles)
CLASSES = {"S2-O1": (None, 2, 1), "8-2": ((8, 2), 2, 0),
           "2-8": ((2, 8), 2, 0), "4-2-2": ((4, 2, 2), 3, 0)}


def _kw(name):
    ns, S, O = CLASSES[name]
    return dict(S=S, N=8, K=16, Kdes=32, H=4, O=O, Po=8, Ns=ns)


def gear_batch(dims: Dims, Bn=B, seed=5, dtype=np.float64):
    """B lanes of gear_scenario (S=2) or multi_gear_scenario (S=3), the
    inner waypoints jittered by a seeded +-0.3 m, and for O >= 1 one
    constant-velocity obstacle per lane crossing the first segment (as
    tests/test_megakernel.py _gear_batch), so that the obstacle rows of
    later segments sample it at absolute times offset by the earlier
    segments' durations."""
    make = scenarios.gear_scenario if dims.S == 2 \
        else scenarios.multi_gear_scenario
    rng = np.random.default_rng(seed)
    scens = []
    for i in range(Bn):
        sc = make(dims, dtype=dtype)
        inner = sc.init_inner + rng.uniform(
            -0.3, 0.3, sc.init_inner.shape).astype(dtype)
        inner[sc.init_inner == 0] = 0.0            # keep padded slots zero
        sc = sc._replace(init_inner=inner)
        if dims.O >= 1:
            obs_coef = np.zeros((dims.O, dims.Po, 6, 2), dtype)
            dt = 30.0 / dims.Po
            vel = np.array([0.6, 0.3 + 0.05 * i])
            start = np.array([6.0 + 0.5 * i, 0.0])
            for pp in range(dims.Po):
                obs_coef[0, pp, 0] = start + vel * (pp * dt)
                obs_coef[0, pp, 1] = vel * dt
            mask = np.zeros(dims.O, bool)
            mask[0] = True
            obs_dt = np.ones(dims.O, dtype)
            obs_dt[0] = dt
            sc = sc._replace(obs_coef=obs_coef, obs_dt=obs_dt,
                             obs_mask=mask)
        scens.append(sc)
    return scenarios.stack_scenarios(scens)


def _jax_tuned():
    return dataclasses.replace(jconfig.EngineFlags.tuned(), mxu="f32")


@functools.lru_cache(maxsize=None)
def _objective(name):
    """(port inputs, JAX f and g) at x0 plus a seeded perturbation of half
    of the lanes."""
    jdims, dims = JDims(**_kw(name)), Dims(**_kw(name))
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    jflags = _jax_tuned()
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, jdims.ns_tuple)
    batch = jax.tree.map(jnp.asarray, gear_batch(dims))
    _b, x0p, jsc, jkc, D = jps._prep(batch, jw, jdims, jcfg, jnp.float64,
                                     sig)
    x = np.asarray(x0p).copy()
    rng = np.random.default_rng(17)
    x[:D, B // 2:] += 0.3 * rng.standard_normal((D, B - B // 2))
    f, g = jkcost.eval_fg(jnp.asarray(x), jsc, jkc,
                          jkcost.StaticW.build(jw, jcfg), jdims,
                          flags=jflags)
    port = dict(
        x=from_numpy(x, device="cpu", dtype=torch.float64),
        sc=from_numpy(jax.tree.map(np.asarray, jsc), kcost.KScenario,
                      device="cpu", dtype=torch.float64),
        kc=kcost.make_consts(dims, torch.float64),
        sw=kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                   device="cpu"), cfg),
        dims=dims, D=D)
    return port, np.asarray(f), np.asarray(g)


@pytest.mark.parametrize("name", list(CLASSES))
def test_eval_fg_matches_jax(name):
    p, f_ref, g_ref = _objective(name)
    f, g = kcost.eval_fg(p["x"], p["sc"], p["kc"], p["sw"], p["dims"],
                         config.EngineFlags.tuned())
    assert g.shape == (kcost.dp_of(p["dims"]), B)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-9, atol=1e-9)
    assert not torch.any(g[p["D"]:])
    if p["dims"].Ns is not None:
        # the unused inner-waypoint slots of short segments carry no cost
        ns, N = p["dims"].ns_tuple, p["dims"].N
        for s, n_s in enumerate(ns):
            assert not torch.any(g[2 * ((N - 1) * s + n_s - 1):
                                   2 * (N - 1) * (s + 1)])


def test_obstacle_time_offset_matters():
    """The S=2 obstacle case is sensitive to the obstacles' absolute time:
    a shift of the prediction's start by 1 s changes f, so a later
    segment sampled without the earlier segment's duration would too."""
    p, f_ref, _g = _objective("S2-O1")
    sc = p["sc"]
    S, O = p["dims"].S, p["dims"].O
    shifted = sc.misc.clone()
    shifted[2 * S + O] += 1.0           # rel_t0 of obstacle 0
    f0 = kcost.eval_cost(p["x"], sc, p["kc"], p["sw"], p["dims"],
                         config.EngineFlags.tuned())
    f1 = kcost.eval_cost(p["x"], sc._replace(misc=shifted), p["kc"], p["sw"],
                         p["dims"], config.EngineFlags.tuned())
    np.testing.assert_allclose(f0.numpy(), f_ref, rtol=1e-11)
    assert float((f1 - f0).abs().max()) > 1e-6 * float(f0.abs().max())


@functools.lru_cache(maxsize=None)
def _path12(name):
    jdims, dims = JDims(**_kw(name)), Dims(**_kw(name))
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    jflags = _jax_tuned()
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, jdims.ns_tuple)
    batch = jax.tree.map(jnp.asarray, gear_batch(dims))
    _b, x0p, jsc, jkc, _D = jps._prep(batch, jw, jdims, jcfg, jnp.float64,
                                      sig)
    ref = jps._solve_rounds(x0p, jsc, jkc, jkcost.StaticW.build(jw, jcfg),
                            jdims, jcfg.opt.lbfgs, 12, flags=jflags)
    ref = jax.tree.map(np.asarray, ref)
    out = pallas_solve._solve_rounds(
        from_numpy(np.asarray(x0p), device="cpu", dtype=torch.float64),
        from_numpy(jax.tree.map(np.asarray, jsc), kcost.KScenario,
                   device="cpu", dtype=torch.float64),
        kcost.make_consts(dims, torch.float64),
        kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                device="cpu"), cfg),
        dims, cfg.opt.lbfgs, 12, config.EngineFlags.tuned())
    return out, ref


def test_round_loop_matches_jax_12_iterations():
    out, ref = _path12("8-2")
    np.testing.assert_array_equal(out.status.numpy(),
                                  ref.status[0].astype(int))
    np.testing.assert_array_equal(out.k.clamp(max=12).numpy(),
                                  np.minimum(ref.k[0].astype(int), 12))
    np.testing.assert_array_equal(out.n_evals.numpy(),
                                  ref.n_evals[0].astype(int))
    np.testing.assert_allclose(out.fp.numpy(), ref.fp[0], rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(out.xp.numpy(), ref.xp, rtol=1e-9, atol=1e-10)


def test_finalize_matches_jax_on_ns_class():
    """Coefficients on the uniform N-piece grid (each segment generated on
    its own n_s pieces, then subdivided) and dT, from the same optimized
    variables."""
    name = "8-2"
    out, ref = _path12(name)
    jdims, dims = JDims(**_kw(name)), Dims(**_kw(name))
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    sig = jconfig.resolve_vt_scale("auto", jdims.ns_tuple)
    npb = gear_batch(dims)
    jb, _x, _s, _k, D = jps._prep(jax.tree.map(jnp.asarray, npb), jw, jdims,
                                  jcfg, jnp.float64, sig)
    k = np.minimum(ref.k[0], 12)
    jres = jps._finalize(jb, jnp.asarray(ref.xp), jnp.asarray(ref.fp[0]),
                         jnp.asarray(ref.status[0]), jnp.asarray(k), jw,
                         jdims, jcfg, D, sig)
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    pb, _x0, _sc, _kc, D2 = pallas_solve._prep(
        from_numpy(npb, Scenario, device="cpu", dtype=torch.float64), w,
        dims, torch.float64, "auto")
    res = pallas_solve._finalize(pb, out.xp, out.fp, out.status,
                                 out.k.clamp(max=12), w, dims, cfg, D2,
                                 "auto")
    assert D2 == D and tuple(res.coeffs.shape) == (B, 2, 8, 6, 2)
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(jres.coeffs),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(res.dT.numpy(), np.asarray(jres.dT),
                               rtol=1e-9)
    for r in (2, 4, 8):
        np.testing.assert_array_equal(minco.subdivision_matrix(r),
                                      jminco.subdivision_matrix(r))


def test_solve_with_retry_matches_jax():
    """The init_T retry ladder on the rounds engine, 12 iterations, with
    the rejection cost lowered to 1e4 so that the first solve fails on
    some lanes (those with stretched initial durations) and the ladder
    re-solves them: the success mask, statuses and costs equal JAX's."""
    name = "8-2"
    jdims, dims = JDims(**_kw(name)), Dims(**_kw(name))
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    jcfg = dataclasses.replace(jcfg, opt=dataclasses.replace(
        jcfg.opt, reject_cost=1e4))
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(
        cfg.opt, reject_cost=1e4))
    npb = gear_batch(dims, seed=9)
    npb = npb._replace(init_T=npb.init_T * np.where(
        np.arange(B) % 2 == 0, 1.0, 3.0)[:, None])
    jsolve = jsolver.make_solver(jcfg, jdims, max_iterations=12,
                                 engine="rounds", flags=_jax_tuned())
    jb = jax.tree.map(jnp.asarray, npb)
    jw = jweights(jcfg.opt, jnp.float64)
    first = np.asarray(jsolve(jb, jw).success)
    jres = jsolver.solve_with_retry(jsolve, jb, jw, time_scales=(1.6, 0.7),
                                    pad_to=B)
    assert not first.all() and jres.success.sum() > first.sum()
    solve = solver.make_solver(cfg, dims, max_iterations=12,
                               engine="rounds",
                               flags=config.EngineFlags.tuned())
    res = solver.solve_with_retry(
        solve, from_numpy(npb, Scenario, device="cpu", dtype=torch.float64),
        weights_from_config(cfg.opt, torch.float64, device="cpu"),
        time_scales=(1.6, 0.7), pad_to=B)
    np.testing.assert_array_equal(res.success.numpy(), jres.success)
    np.testing.assert_array_equal(res.status.numpy(), jres.status)
    np.testing.assert_allclose(res.cost.numpy(), jres.cost, rtol=1e-9)
    np.testing.assert_allclose(res.coeffs.numpy(), jres.coeffs, rtol=1e-9,
                               atol=1e-9)


def test_quantized_counts_match_jax():
    from dftpav_tpu import pipeline as jpipeline

    from dftpav_tpu_torch import pipeline

    durs = np.linspace(0.0, 12.0, 97)
    for N in (2, 4, 8):
        for pd in (0.5, 1.0, 1.5):
            for d0 in durs[::4]:
                segs = (float(d0), float(durs[-1] - d0))
                assert pipeline.quantized_counts(segs, N, pd) == \
                    jpipeline.quantized_counts(segs, N, pd)


# uniform N = 2 / 4 classes in the kernels' N = 8 form
# (pallas_solve.embedded_class), float64 on the plain versions
# ---------------------------------------------------------------------------

EMBED = {"S2-N2": dict(S=2, N=2, K=16, Kdes=32, H=4, O=0, Po=8),
         "S1-N4": dict(S=1, N=4, K=16, Kdes=32, H=4, O=2, Po=8)}


@functools.lru_cache(maxsize=None)
def _embedded(name):
    """The class's fixture (gear_scenario with jittered inner waypoints at
    S = 2, batch_scenarios at S = 1), B lanes, native and embedded: the
    plain objective's inputs of both, half of the lanes moved off x0."""
    dims = Dims(**EMBED[name])
    if dims.S == 2:
        npb = gear_batch(dims, Bn=B, seed=9)
    else:
        npb = scenarios.batch_scenarios(dims, B, seed=9, n_obstacles=2)
    cfg = config.PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(npb, Scenario, device="cpu", dtype=torch.float64)
    dims_e = pallas_solve.embedded_class(dims)
    out = {}
    for d, b in ((dims, batch),
                 (dims_e, pallas_solve.embed_scenario(batch, dims, dims_e))):
        _b, x0p, sc, kc, D = pallas_solve._prep(b, w, d, torch.float64,
                                                "auto")
        out[d] = (x0p, sc, kc)
    x = out[dims][0].clone()
    x[:dims.dim, B // 2:] += torch.from_numpy(0.3 * np.random.default_rng(
        29).standard_normal((dims.dim, B - B // 2)))
    return dims, dims_e, x, out, kcost.StaticW.build(w, cfg)


def test_embedded_class_routing():
    """Which layout the kernels run each class in (capacity 8 or 16, the
    segments' own piece counts), and what still raises
    NotImplementedError in the binding's checks (the plain round loop
    takes every class)."""
    import types as pytypes

    emb = pallas_solve.embedded_class
    assert emb(Dims(**EMBED["S2-N2"])) == kcost.KClass(
        **dict(EMBED["S2-N2"], N=8, Ns=(2, 2)))
    assert emb(Dims(**EMBED["S1-N4"])).Ns == (4,)
    for keep, cap in ((Dims(S=1, N=8), 8), (Dims(S=2, N=8, Ns=(8, 2)), 8),
                      (Dims(S=1, N=3), 8), (Dims(S=1, N=16), 16),
                      (Dims(S=2, N=4, Ns=(4, 2)), 8)):
        kd = emb(keep)
        assert (kd.N, kd.Ns, kd.S) == (cap, keep.ns_tuple, keep.S)
    from dftpav_tpu_torch.ops import _cuda
    lib = pytypes.SimpleNamespace(dftpav_kernel_max_s=lambda: _cuda.MAX_S)
    for dims in (Dims(S=9, N=2), Dims(S=9, N=4), Dims(S=1, N=33)):
        with pytest.raises(NotImplementedError):
            _cuda._check_inputs(lib, None, None, None, emb(dims))


@pytest.mark.parametrize("name", list(EMBED))
def test_embedded_objective_equals_native(name):
    """The plain objective on the embedded class equals the native one: f
    within 1e-12, the gradient's used rows within 1e-10 and every other
    row exactly zero (the JAX package's tests/test_perseg.py:64-105 claim,
    held for the port)."""
    dims, dims_e, x, out, sw = _embedded(name)
    tuned = config.EngineFlags.tuned()
    f, g = kcost.eval_fg_plain(x, *out[dims][1:], sw, dims, tuned)
    x_e = pallas_solve._move_x(x, dims, dims_e)
    fe, ge = kcost.eval_fg_plain(x_e, *out[dims_e][1:], sw, dims_e, tuned)
    np.testing.assert_allclose(fe.numpy(), f.numpy(), rtol=1e-12)
    np.testing.assert_allclose(pallas_solve._move_x(ge, dims_e, dims).numpy(),
                               g.numpy(), rtol=1e-10, atol=1e-10)
    used = pallas_solve._move_x(torch.ones_like(x), dims, dims_e) != 0
    assert used.sum() == B * dims.dim
    assert not torch.any(ge[~used])
    # the embedded x0 is the native x0 in the embedded layout
    assert torch.equal(out[dims_e][0],
                       pallas_solve._move_x(out[dims][0], dims, dims_e))


@pytest.mark.parametrize("name", list(EMBED))
def test_embedded_round_loop_equals_native_12_iterations(name):
    """The plain round loop on the embedded class takes the native class's
    12-iteration paths: statuses, k and evals exact, x mapped back within
    1e-9."""
    dims, dims_e, _x, out, sw = _embedded(name)
    tuned = config.EngineFlags.tuned()
    p = config.PlannerConfig().opt.lbfgs
    ref = pallas_solve._solve_rounds(*out[dims], sw, dims, p, 12, tuned)
    emb = pallas_solve._solve_rounds(*out[dims_e], sw, dims_e, p, 12, tuned)
    for field in ("status", "n_evals"):
        np.testing.assert_array_equal(getattr(emb, field).numpy(),
                                      getattr(ref, field).numpy())
    np.testing.assert_array_equal(emb.k.clamp(max=12).numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_allclose(
        pallas_solve._move_x(emb.xp, dims_e, dims).numpy(), ref.xp.numpy(),
        rtol=1e-9, atol=1e-9)
