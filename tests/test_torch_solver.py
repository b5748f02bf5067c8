"""The port's plain round loop and solver entry against the JAX package.

  * 12-iteration iterate path, float64, B=8, default and tuned flags:
    `_solve_rounds` in both packages from the same packed inputs. Statuses,
    min(k, 12) and eval counts exact; fp rtol 1e-10; xp rtol 1e-9 / atol
    1e-10 (tests/test_megakernel.py:85-98).
  * End to end, float64, B=32, 150 iterations, tuned flags:
    `solve_batch_rounds` in both packages. Success counts within one lane,
    cost p50 within 2%, SolveResult shapes and dtypes equal. Engines drift
    apart chaotically after ~20 iterations even in float64, hence the
    looser gate.
  * Dispatch: make_solver(engine="fused") on CPU tensors runs the plain
    loop without launching a kernel; asking for CUDA without a card
    raises; the kernels raise NotImplementedError past S = 3, and the
    bminor engine rejects Dims.Ns with ValueError.

The class has one moving obstacle (O=1): the JAX reference compiles the
obstacle block once per obstacle (~12 s each on the CPU), and the
two-obstacle bench class is covered by tests/test_torch_kcost.py here and
by chip_smoke.py on the card.

The JAX side's tuned flags keep mxu="f32": the 3-pass bf16 split it
otherwise selects is an MXU device trick the port does not carry.
"""

import dataclasses
import functools

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
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, scenarios, solver
from dftpav_tpu_torch.ops import _cuda, kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, SolveResult, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

KW = dict(S=1, N=8, K=16, Kdes=32, H=4, O=1, Po=8)
DIMS, JDIMS = Dims(**KW), JDims(**KW)


def _flags(tuned):
    if tuned:
        return (config.EngineFlags.tuned(),
                dataclasses.replace(jconfig.EngineFlags.tuned(), mxu="f32"))
    return config.EngineFlags(), jconfig.EngineFlags()


@functools.lru_cache(maxsize=None)
def _path12(tuned):
    flags, jflags = _flags(tuned)
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, JDIMS.ns_tuple)
    batch = jax.tree.map(jnp.asarray, jscen.batch_scenarios(
        JDIMS, 8, seed=3, n_obstacles=1))
    _b, x0p, jsc, jkc, _D = jps._prep(batch, jw, JDIMS, jcfg, jnp.float64,
                                      sig)
    jsw = jkcost.StaticW.build(jw, jcfg)
    ref = jps._solve_rounds(x0p, jsc, jkc, jsw, JDIMS, jcfg.opt.lbfgs, 12,
                            flags=jflags)
    ref = jax.tree.map(np.asarray, ref)
    out = pallas_solve._solve_rounds(
        from_numpy(np.asarray(x0p), device="cpu", dtype=torch.float64),
        from_numpy(jax.tree.map(np.asarray, jsc), kcost.KScenario,
                   device="cpu", dtype=torch.float64),
        kcost.make_consts(DIMS, torch.float64),
        kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                device="cpu"), cfg),
        DIMS, cfg.opt.lbfgs, 12, flags)
    return out, ref


@pytest.mark.parametrize("tuned", [False, True], ids=["default", "tuned"])
def test_round_loop_matches_jax_12_iterations(tuned):
    out, ref = _path12(tuned)
    np.testing.assert_array_equal(out.status.numpy(),
                                  ref.status[0].astype(int))
    np.testing.assert_array_equal(out.k.clamp(max=12).numpy(),
                                  np.minimum(ref.k[0].astype(int), 12))
    np.testing.assert_array_equal(out.n_evals.numpy(),
                                  ref.n_evals[0].astype(int))
    np.testing.assert_allclose(out.fp.numpy(), ref.fp[0], rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(out.xp.numpy(), ref.xp, rtol=1e-9, atol=1e-10)


@functools.lru_cache(maxsize=None)
def _e2e():
    flags, jflags = _flags(True)
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    npb = scenarios.batch_scenarios(DIMS, 32, seed=5, n_obstacles=1)
    ref = jps.solve_batch_rounds(
        jax.tree.map(jnp.asarray, npb), jweights(jcfg.opt, jnp.float64),
        JDIMS, jcfg, max_iterations=150, flags=jflags)
    res = pallas_solve.solve_batch_rounds(
        from_numpy(npb, Scenario, device="cpu", dtype=torch.float64),
        weights_from_config(cfg.opt, torch.float64, device="cpu"), DIMS, cfg,
        max_iterations=150, flags=flags)
    return res, jax.tree.map(np.asarray, ref)


def test_solve_batch_rounds_end_to_end_matches_jax():
    res, ref = _e2e()
    assert isinstance(res, SolveResult) and res._fields == ref._fields
    for a, b in zip(res, ref):
        assert tuple(a.shape) == b.shape
        assert a.numpy().dtype == b.dtype
    assert abs(int(res.success.sum()) - int(ref.success.sum())) <= 1
    med, med_ref = float(res.cost.median()), float(np.median(ref.cost))
    assert abs(med - med_ref) <= 0.02 * med_ref, (med, med_ref)
    assert bool((res.status >= 0).all())
    assert torch.isfinite(res.coeffs).all()


def test_fused_engine_on_cpu_runs_plain_loop_without_kernels():
    cfg = config.PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(scenarios.batch_scenarios(DIMS, 8, seed=9,
                                                 n_obstacles=1),
                       Scenario, device="cpu", dtype=torch.float64)
    kcost.eval_fg.launches = 0
    pallas_solve.solve_batch_fused.launches = 0
    flags = config.EngineFlags.tuned()
    fused = solver.make_solver(cfg, DIMS, 20, engine="fused", flags=flags)
    rounds = solver.make_solver(cfg, DIMS, 20, engine="rounds", flags=flags)
    a, b = fused(batch, w), rounds(batch, w)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert kcost.eval_fg.launches == 0
    assert pallas_solve.solve_batch_fused.launches == 0
    res, xout = pallas_solve.solve_batch_fused(batch, w, DIMS, cfg, 20,
                                               return_x=True, flags=flags)
    assert tuple(xout.shape) == (kcost.DP, 8)
    warm = pallas_solve.solve_batch_fused(batch, w, DIMS, cfg, 20,
                                          x0_override=xout, flags=flags)
    assert float(warm.cost.median()) <= float(res.cost.median()) * 1.001


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _cuda._lib is None          # importing the binding built nothing
    with pytest.raises(RuntimeError):
        _cuda.library()
    npb = scenarios.batch_scenarios(DIMS, 2, seed=1, n_obstacles=1)
    with pytest.raises((RuntimeError, AssertionError)):
        from_numpy(npb, Scenario, device="cuda")


def test_multigear_raises_not_implemented():
    """What still raises for multi-gear classes: the kernels past
    S = 8 (NotImplementedError in the binding's checks; the plain round
    loop takes any S), and the bminor and vmap engines with per-segment
    piece classes (ValueError, as in JAX). make_solver takes S=2 and
    Dims.Ns on "fused" and "rounds"."""
    import types as pytypes

    cfg = config.PlannerConfig()
    lib = pytypes.SimpleNamespace(dftpav_kernel_max_s=lambda: _cuda.MAX_S)
    with pytest.raises(NotImplementedError):
        _cuda._check_inputs(lib, None, None, None,
                            Dims(S=9, N=8, K=16, Kdes=32, H=4, O=1, Po=8))
    for dims in (Dims(S=2, N=8, K=16, Kdes=32, H=4, O=1, Po=8),
                 Dims(S=2, N=8, K=16, Kdes=32, H=4, O=1, Po=8, Ns=(8, 2)),
                 Dims(S=1, N=8, K=16, Kdes=32, H=4, O=1, Po=8, Ns=(4,))):
        for engine in ("fused", "rounds"):
            assert callable(solver.make_solver(cfg, dims, engine=engine))
    # the bminor engine rejects per-segment piece classes, as in JAX, and
    # takes uniform-N multi-segment classes
    with pytest.raises(ValueError):
        solver.make_solver(cfg, Dims(S=1, N=8, K=16, Kdes=32, H=4, O=1, Po=8,
                                     Ns=(4,)), engine="bminor")
    assert callable(solver.make_solver(
        cfg, Dims(S=2, N=8, K=16, Kdes=32, H=4, O=1, Po=8), engine="bminor"))
    with pytest.raises(ValueError):
        solver.make_solver(cfg, Dims(S=1, N=8, K=16, Kdes=32, H=4, O=1, Po=8,
                                     Ns=(4,)), engine="vmap")
