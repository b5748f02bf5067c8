"""The park demo's S = 4 class (Dims(S=4, N=8), examples/park_demo.py:37-38)
in the port's plain objective and round loop against the JAX package,
float64 on the CPU, B = 4 lanes of multi_gear_scenario at S = 4 (no
obstacles: JAX's round loop compiles in ~35 s here, ~100 s with one):

  * ops.kcost.eval_fg (autograd) against JAX kcost.eval_fg, tuned flags
    (per-segment vt_scale "auto"), at x0 and at a seeded move of half of
    the lanes: f rtol 1e-11, g rtol 1e-9 / atol 1e-9, padded rows zero;
  * the 12-iteration round loop against JAX _solve_rounds: statuses, k and
    eval counts exact, fp rtol 1e-10, xp rtol 1e-9 / atol 1e-10.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu.ops import kcost as jkcost
from dftpav_tpu.ops import pallas_solve as jps
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, scenarios
from dftpav_tpu_torch.ops import kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, from_numpy, weights_from_config

torch.set_num_threads(1)

B = 4
KW = dict(S=4, N=8, K=16, Kdes=32, H=4, O=0, Po=8)


def _batch():
    """multi_gear_scenario at S = 4, inner waypoints jittered by a seeded
    +-0.3 m."""
    dims = Dims(**KW)
    rng = np.random.default_rng(5)
    lanes = []
    for _ in range(B):
        sc = scenarios.multi_gear_scenario(dims)
        lanes.append(sc._replace(init_inner=sc.init_inner + rng.uniform(
            -0.3, 0.3, sc.init_inner.shape)))
    return scenarios.stack_scenarios(lanes)


@functools.lru_cache(maxsize=None)
def _jax_setup():
    jdims = JDims(**KW)
    jcfg = jconfig.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    jflags = dataclasses.replace(jconfig.EngineFlags.tuned(), mxu="f32")
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, jdims.ns_tuple)
    batch = jax.tree.map(jnp.asarray, _batch())
    _b, x0p, jsc, jkc, D = jps._prep(batch, jw, jdims, jcfg, jnp.float64,
                                     sig)
    cfg = config.PlannerConfig()
    port = dict(
        sc=from_numpy(jax.tree.map(np.asarray, jsc), kcost.KScenario,
                      device="cpu", dtype=torch.float64),
        kc=kcost.make_consts(Dims(**KW), torch.float64),
        sw=kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                   device="cpu"), cfg),
        x0=from_numpy(np.asarray(x0p), device="cpu", dtype=torch.float64))
    return jdims, jcfg, jw, jflags, x0p, jsc, jkc, D, port


def test_s4_eval_fg_matches_jax():
    jdims, jcfg, jw, jflags, x0p, jsc, jkc, D, p = _jax_setup()
    x = np.asarray(x0p).copy()
    x[:D, B // 2:] += 0.3 * np.random.default_rng(17).standard_normal(
        (D, B - B // 2))
    dims = Dims(**KW)
    assert kcost.dp_of(dims) == 72
    f_ref, g_ref = jkcost.eval_fg(jnp.asarray(x), jsc, jkc,
                                  jkcost.StaticW.build(jw, jcfg), jdims,
                                  flags=jflags)
    f, g = kcost.eval_fg(torch.from_numpy(x), p["sc"], p["kc"], p["sw"],
                         dims, config.EngineFlags.tuned())
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-9,
                               atol=1e-9)
    assert not torch.any(g[D:])


def test_s4_round_loop_matches_jax_12_iterations():
    jdims, jcfg, jw, jflags, x0p, jsc, jkc, D, p = _jax_setup()
    ref = jax.tree.map(np.asarray, jps._solve_rounds(
        x0p, jsc, jkc, jkcost.StaticW.build(jw, jcfg), jdims,
        jcfg.opt.lbfgs, 12, flags=jflags))
    cfg = config.PlannerConfig()
    out = pallas_solve._solve_rounds(p["x0"], p["sc"], p["kc"], p["sw"],
                                     Dims(**KW), cfg.opt.lbfgs, 12,
                                     config.EngineFlags.tuned())
    np.testing.assert_array_equal(out.status.numpy(),
                                  ref.status[0].astype(int))
    np.testing.assert_array_equal(out.k.clamp(max=12).numpy(),
                                  np.minimum(ref.k[0].astype(int), 12))
    np.testing.assert_array_equal(out.n_evals.numpy(),
                                  ref.n_evals[0].astype(int))
    np.testing.assert_allclose(out.fp.numpy(), ref.fp[0], rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(out.xp.numpy(), ref.xp, rtol=1e-9, atol=1e-10)
