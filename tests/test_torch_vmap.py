"""The port's per-scenario reference engine (make_solver(engine="vmap"):
cost.total_cost by autograd, lbfgs.minimize) against the JAX package's,
float64 on the CPU, B = 4 lanes of a three-segment gear class with a
moving obstacle (S >= 3, where the reference's time-offset quirk shows).

  * total_cost, each term of aux, T and the coefficients, with and without
    OptConfig.ref_trajtime_compat; f rtol 1e-11, g rtol 1e-9 / atol 1e-9;
  * the batch-minor objective with ref_trajtime_compat equal to
    total_cost with it;
  * ref_compat_value_and_grad (the reference's cross-segment time-gradient
    attribution): f rtol 1e-11, g 1e-9, and its gradient differs from the
    objective's on the later segments' durations;
  * lbfgs.minimize and make_solver(engine="vmap") over 12 iterations
    against JAX's vmap engine: statuses, iteration and evaluation counts
    exact, iterates to 1e-9; the vmap solver's coefficients and costs too;
  * the ref_gradient_compat guard: ValueError for every other engine, as
    in JAX.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu import cost as jcost
from dftpav_tpu import lbfgs as jlbfgs
from dftpav_tpu import solver as jsolver
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import Scenario as JScenario
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, cost, lbfgs, scenarios, solver
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

B = 4
KW = dict(S=3, N=4, K=8, Kdes=12, H=4, O=1, Po=4)


@functools.lru_cache(maxsize=None)
def _batch():
    """B lanes of multi_gear_scenario (S = 3), inner waypoints jittered by
    a seeded +-0.3 m, the corridor boxes narrowed from 10 m to 1.2 m half
    width (so that the corridor term is live), one constant-velocity
    obstacle crossing the first two segments, so that the later segments'
    rows sample it at absolute times offset by the earlier durations."""
    dims = Dims(**KW)
    rng = np.random.default_rng(5)
    lanes = []
    for i in range(B):
        sc = scenarios.multi_gear_scenario(dims)
        inner = sc.init_inner + rng.uniform(-0.3, 0.3, sc.init_inner.shape)
        sc = sc._replace(init_inner=inner,
                         corr_p=sc.corr_p - 8.8 * sc.corr_n)
        coef = np.zeros((dims.O, dims.Po, 6, 2))
        dt = 16.0 / dims.Po
        vel = np.array([0.5, 0.2 + 0.05 * i])
        start = np.array([2.0 + 0.5 * i, -1.0])
        for pp in range(dims.Po):
            coef[0, pp, 0] = start + vel * (pp * dt)
            coef[0, pp, 1] = vel * dt
        sc = sc._replace(obs_coef=coef, obs_dt=np.full(dims.O, dt),
                         obs_mask=np.ones(dims.O, bool))
        lanes.append(sc)
    return scenarios.stack_scenarios(lanes)


def _cfgs(**opt):
    jc, c = jconfig.PlannerConfig(), config.PlannerConfig()
    return (dataclasses.replace(jc, opt=dataclasses.replace(jc.opt, **opt)),
            dataclasses.replace(c, opt=dataclasses.replace(c.opt, **opt)))


def _both():
    npb = _batch()
    jb = JScenario(*(jnp.asarray(a) for a in npb))
    tb = from_numpy(npb, Scenario, device="cpu", dtype=torch.float64)
    jw = jweights(jconfig.PlannerConfig().opt, jnp.float64)
    tw = weights_from_config(config.PlannerConfig().opt, torch.float64,
                             device="cpu")
    return jb, tb, jw, tw


@functools.lru_cache(maxsize=None)
def _points():
    """x0 of every lane and a seeded move of half of them off it."""
    jb, tb, jw, tw = _both()
    x0 = np.asarray(jax.vmap(lambda s: jcost.initial_guess(
        jsolver.clamp_boundary_states(s, jw), jw, JDims(**KW)))(jb))
    x = x0.copy()
    x[B // 2:] += 0.2 * np.random.default_rng(17).standard_normal(
        x[B // 2:].shape)
    return x


@pytest.mark.parametrize("compat", [False, True])
def test_total_cost_terms_match_jax(compat):
    jcfg, cfg = _cfgs(ref_trajtime_compat=compat)
    jb, tb, jw, tw = _both()
    x = _points()
    jd, d = JDims(**KW), Dims(**KW)

    def jf(xi, s):
        return jcost.total_cost(xi, s, jw, jd, jcfg)

    (jtot, jaux), jg = jax.jit(jax.vmap(jax.value_and_grad(
        jf, has_aux=True)))(jnp.asarray(x), jb)
    xt = torch.from_numpy(x).requires_grad_(True)
    tot, aux = cost.total_cost(xt, tb, tw, d, cfg)
    (g,) = torch.autograd.grad(tot.sum(), xt)
    for k in ("smoo", "time", "obs", "dyn", "feas", "T", "coeffs"):
        np.testing.assert_allclose(aux[k].detach().numpy(),
                                   np.asarray(jaux[k]), rtol=1e-11,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(tot.detach().numpy(), np.asarray(jtot),
                               rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-9)
    # every term is live on this fixture
    for k in ("obs", "dyn", "feas"):
        assert float(aux[k].detach().max()) > 0.0, k


def test_bminor_objective_takes_ref_trajtime_compat():
    """The batch-minor objective honours ref_trajtime_compat as JAX's does
    (dftpav_tpu/ops/bcost.py:267): it equals total_cost with the flag, and
    the flag moves f at S = 3 with an obstacle."""
    from dftpav_tpu_torch.ops import bcost

    _jc, cfg = _cfgs(ref_trajtime_compat=True)
    _jb, tb, _jw, tw = _both()
    x = torch.from_numpy(_points())
    d = Dims(**KW)
    f_b = bcost.total_cost_b(x.T, bcost.to_bminor(tb), tw, d, cfg)[0]
    f_c = cost.total_cost(x, tb, tw, d, cfg)[0]
    np.testing.assert_allclose(f_b.numpy(), f_c.numpy(), rtol=1e-12)
    f_true = cost.total_cost(x, tb, tw, d, config.PlannerConfig())[0]
    assert float((f_c - f_true).abs().max()) > 1e-6 * float(f_true.max())


def test_ref_compat_value_and_grad_matches_jax():
    jcfg, cfg = _cfgs(ref_trajtime_compat=True, ref_gradient_compat=True)
    jb, tb, jw, tw = _both()
    x = _points()
    jd, d = JDims(**KW), Dims(**KW)
    scale = cfg.opt.cost_scale
    jf, jg = jax.jit(jax.vmap(lambda xi, s: jcost.ref_compat_value_and_grad(
        s, jw, jd, jcfg, scale)(xi)))(jnp.asarray(x), jb)
    f, g = cost.ref_compat_value_and_grad(tb, tw, d, cfg, scale)(
        torch.from_numpy(x))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-9)
    # the reference's attribution moves the later segments' time rows
    xt = torch.from_numpy(x).requires_grad_(True)
    tot = scale * cost.total_cost(xt, tb, tw, d, cfg)[0]
    (g_true,) = torch.autograd.grad(tot.sum(), xt)
    n_in = 2 * d.S * (d.N - 1)
    assert float((g - g_true)[:, n_in + 1:n_in + d.S].abs().max()) > 1e-6
    np.testing.assert_allclose(g[:, :n_in].numpy(), g_true[:, :n_in].numpy(),
                               rtol=1e-12, atol=1e-15)


def _assert_same_path(res, ref, x, x_ref):
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.n_iters.numpy(),
                                  np.asarray(ref.n_iters))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-9,
                               atol=1e-9)


def test_lbfgs_minimize_matches_jax_12_iterations():
    """lbfgs.minimize on the scaled objective from each lane's x0 against
    JAX's minimize under vmap: statuses, iterations and evaluations exact,
    x, f and g to 1e-9."""
    jcfg, cfg = _cfgs()
    jb, tb, jw, tw = _both()
    x0 = _points()
    jd, d = JDims(**KW), Dims(**KW)
    scale = cfg.opt.cost_scale
    p = cfg.opt.lbfgs

    def jmin(xi, s):
        fun = jax.value_and_grad(
            lambda v: scale * jcost.total_cost(v, s, jw, jd, jcfg)[0])
        return jlbfgs.minimize(fun, xi, jcfg.opt.lbfgs, max_iterations=12)

    ref = jax.jit(jax.vmap(jmin))(jnp.asarray(x0), jb)

    def value_and_grad(scen):
        def fun(x):
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                f = scale * cost.total_cost(xg, scen, tw, d, cfg)[0]
                (g,) = torch.autograd.grad(f.sum(), xg)
            return f.detach(), g
        return fun

    res = lbfgs.minimize(value_and_grad(tb), torch.from_numpy(x0), p,
                         max_iterations=12)
    _assert_same_path(res, ref, res.x, ref.x)
    np.testing.assert_array_equal(res.n_evals.numpy(),
                                  np.asarray(ref.n_evals))
    np.testing.assert_allclose(res.f.numpy(), np.asarray(ref.f), rtol=1e-9)
    np.testing.assert_allclose(res.g.numpy(), np.asarray(ref.g), rtol=1e-9,
                               atol=1e-9)
    # one problem without a batch axis takes the same path
    fun1 = value_and_grad(Scenario(*(a[1] for a in tb)))
    one = lbfgs.minimize(fun1, torch.from_numpy(x0[1]), p,
                         max_iterations=12)
    assert int(one.n_evals) == int(res.n_evals[1])
    np.testing.assert_allclose(one.x.numpy(), res.x[1].numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("compat", [False, True])
def test_vmap_engine_matches_jax_12_iterations(compat):
    """make_solver(engine="vmap") against JAX's, 12 iterations, with and
    without the reference's time offsets and gradient attribution:
    statuses and iterations exact, costs, durations and coefficients to
    1e-9."""
    jcfg, cfg = _cfgs(ref_trajtime_compat=compat, ref_gradient_compat=compat)
    jb, tb, jw, tw = _both()
    ref = jsolver.make_solver(jcfg, JDims(**KW), max_iterations=12,
                              engine="vmap")(jb, jw)
    res = solver.make_solver(cfg, Dims(**KW), max_iterations=12,
                             engine="vmap")(tb, tw)
    _assert_same_path(res, ref, res.coeffs, ref.coeffs)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(res.dT.numpy(), np.asarray(ref.dT), rtol=1e-9)
    np.testing.assert_array_equal(res.success.numpy(),
                                  np.asarray(ref.success))


def test_ref_gradient_compat_guard_matches_jax():
    """ref_gradient_compat is the vmap engine's only: every other engine
    raises ValueError, as JAX's make_solver does; Dims.Ns is the kcost
    engines' only."""
    jcfg, cfg = _cfgs(ref_gradient_compat=True)
    for engine in ("fused", "rounds", "bminor"):
        with pytest.raises(ValueError, match="ref_gradient_compat"):
            jsolver.make_solver(jcfg, JDims(**KW), engine=engine)
        with pytest.raises(ValueError, match="ref_gradient_compat"):
            solver.make_solver(cfg, Dims(**KW), engine=engine)
    assert callable(solver.make_solver(cfg, Dims(**KW), engine="vmap"))
    ns = dict(KW, Ns=(4, 2, 2))
    for engine in ("vmap", "bminor"):
        with pytest.raises(ValueError, match="Ns"):
            jsolver.make_solver(jconfig.PlannerConfig(), JDims(**ns),
                                engine=engine)
        with pytest.raises(ValueError, match="Ns"):
            solver.make_solver(config.PlannerConfig(), Dims(**ns),
                               engine=engine)
