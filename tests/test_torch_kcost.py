"""The port's plain objective (ops.kcost.eval_cost / eval_fg, autograd
gradient) against the JAX package's kcost.eval_cost / eval_fg, float64,
B=8, on the same inputs.

The inputs are made once with numpy: the JAX package packs x0 and the
kernel slabs, `from_numpy` carries them across, and a seeded perturbation
moves half of the lanes off the initial guess. Tolerances are the ones
tests/test_megakernel.py holds JAX engines to: f rtol 1e-11, g rtol 1e-9
and atol 1e-9. The JAX side runs as plain XLA (the body the Pallas kernel
traces), once per configuration.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu import scenarios as jscen
from dftpav_tpu.ops import kcost as jkcost
from dftpav_tpu.ops.pallas_solve import _prep as jprep
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config
from dftpav_tpu_torch.ops import kcost
from dftpav_tpu_torch.types import Dims, from_numpy, weights_from_config

torch.set_num_threads(1)

B = 8
CASES = {"O2-default": (2, "default"), "O1-auto": (1, "auto"),
         "O0-default": (0, "default")}


def _flags(name, mod):
    return mod.EngineFlags() if name == "default" else \
        mod.EngineFlags(vt_scale="auto")


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port inputs, JAX f, JAX g) for one configuration."""
    O, fl = CASES[name]
    kw = dict(S=1, N=8, K=16, Kdes=32, H=4, O=O, Po=8)
    jdims, dims = JDims(**kw), Dims(**kw)
    jcfg, cfg = jconfig.PlannerConfig(), config.PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float64)
    jflags = _flags(fl, jconfig)
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, jdims.ns_tuple)
    batch = jax.tree.map(jnp.asarray, jscen.batch_scenarios(
        jdims, B, seed=3, n_obstacles=O))
    _b, x0p, jsc, jkc, D = jprep(batch, jw, jdims, jcfg, jnp.float64, sig)
    x = np.asarray(x0p).copy()
    rng = np.random.default_rng(17)
    x[:D, B // 2:] += 0.3 * rng.standard_normal((D, B - B // 2))
    sw = jkcost.StaticW.build(jw, jcfg)
    f, g = jkcost.eval_fg(jnp.asarray(x), jsc, jkc, sw, jdims, flags=jflags)
    port = dict(
        x=from_numpy(x, device="cpu", dtype=torch.float64),
        sc=from_numpy(jax.tree.map(np.asarray, jsc), kcost.KScenario,
                      device="cpu", dtype=torch.float64),
        kc=kcost.make_consts(dims, torch.float64),
        sw=kcost.StaticW.build(weights_from_config(cfg.opt, torch.float64,
                                                   device="cpu"),
                               cfg),
        dims=dims, flags=_flags(fl, config), D=D)
    jref = dict(f=np.asarray(f), g=np.asarray(g), x=x, sc=jsc, kc=jkc,
                sw=sw, dims=jdims, flags=jflags)
    return port, jref


@pytest.mark.parametrize("name", list(CASES))
def test_eval_fg_matches_jax(name):
    p, j = _case(name)
    f, g = kcost.eval_fg(p["x"], p["sc"], p["kc"], p["sw"], p["dims"],
                         p["flags"])
    assert f.shape == (B,) and g.shape == (kcost.DP, B)
    np.testing.assert_allclose(f.numpy(), j["f"], rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), j["g"], rtol=1e-9, atol=1e-9)
    # padded decision rows carry exactly zero gradient
    assert not torch.any(g[p["D"]:])
    assert torch.isfinite(g).all()


def test_eval_cost_matches_jax():
    p, j = _case("O2-default")
    f = kcost.eval_cost(p["x"], p["sc"], p["kc"], p["sw"], p["dims"],
                        p["flags"])
    f_ref = jkcost.eval_cost(jnp.asarray(j["x"]), j["sc"], j["kc"], j["sw"],
                             j["dims"], flags=j["flags"])
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-11)


def test_eval_fg_is_autograd_of_eval_cost():
    """The plain gradient is d(eval_cost)/dx, checked by central
    differences on one lane's active decision rows."""
    p, _ = _case("O2-default")
    x = p["x"]
    _f, g = kcost.eval_fg(x, p["sc"], p["kc"], p["sw"], p["dims"])
    h = 1e-6
    for i in (0, 5, p["D"] - 1):
        e = torch.zeros_like(x)
        e[i] = h
        fp = kcost.eval_cost(x + e, p["sc"], p["kc"], p["sw"], p["dims"])
        fm = kcost.eval_cost(x - e, p["sc"], p["kc"], p["sw"], p["dims"])
        np.testing.assert_allclose(((fp - fm) / (2 * h)).numpy(),
                                   g[i].numpy(), rtol=1e-5, atol=1e-6)
