"""The port's batch-minor engine against the JAX package, float64, on the
same numpy inputs (one torch thread; each JAX reference compiled once).

  * ops.bcost.total_cost_b value and x-gradient against JAX
    bcost.total_cost_b for the three cases of tests/test_ops.py (S=1 with
    and without obstacles, S=2 gear_scenario), with the port's corridor
    backends "xla" and "pallas" (on CPU tensors the latter runs the
    CorridorPenalty function's plain forward and backward): f rtol 1e-11,
    g rtol 1e-9 / atol 1e-9. Half of the lanes are moved far enough off
    the initial guess that the corridor hinge is active.
  * ops.blbfgs.minimize_b on the quadratics and the lane-isolation problem
    of tests/test_ops.py, the quadratics against JAX blbfgs.minimize_b
    (x and f atol 1e-8).
  * The solve, B=8, bench dims with two obstacles, the port's "pallas"
    backend against JAX's "xla" one (JAX's two backends are bit-identical
    at S=1, tests/test_pallas.py, and its interpret-mode kernel is slow
    inside a while loop): 12 iterations of solver.minimize_bminor against
    the JAX clamp / initial guess / blbfgs.minimize_b chain with statuses,
    iterations and evaluation counts exact and x rtol 1e-9 (atol 1e-10);
    then solver.solve_batch_bminor at 150 iterations, success count and
    cost p50 within 2% of JAX's.
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
from dftpav_tpu import solver as jsolver
from dftpav_tpu.ops import bcost as jbcost
from dftpav_tpu.ops import blbfgs as jblbfgs
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, cost, scenarios, solver
from dftpav_tpu_torch.lbfgs import Status
from dftpav_tpu_torch.ops import bcost, blbfgs
from dftpav_tpu_torch.types import Dims, Scenario, SolveResult, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

CASES = {"straight-obs": (dict(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8), 8,
                          2),
         "straight": (dict(S=1, N=8, K=16, Kdes=32, H=4, O=0, Po=8), 8, 0),
         "gear": (dict(S=2, N=5, K=8, Kdes=12, H=4, O=0, Po=8), 4, 0)}


def _cfg(backend):
    cfg = config.PlannerConfig()
    return dataclasses.replace(
        cfg, opt=dataclasses.replace(cfg.opt, corridor_backend=backend))


def _w():
    return weights_from_config(config.OptConfig(), torch.float64,
                               device="cpu")


def _jw():
    return jweights(jconfig.OptConfig(), jnp.float64)


def _np_batch(kind):
    kw, B, nobs = CASES[kind]
    if kind == "gear":
        return scenarios.stack_scenarios(
            [scenarios.gear_scenario(Dims(**kw))] * B)
    return scenarios.batch_scenarios(Dims(**kw), B, seed=3,
                                     n_obstacles=nobs)


@functools.lru_cache(maxsize=None)
def _cost_case(kind):
    """(numpy batch, x [dim, B], JAX f [B], JAX g [dim, B])."""
    kw, B, _ = CASES[kind]
    npb = _np_batch(kind)
    x0 = cost.initial_guess(from_numpy(npb, Scenario, device="cpu",
                                       dtype=torch.float64), _w(),
                            Dims(**kw)).numpy()
    scale = np.where(np.arange(B) < B // 2, 0.01,
                     12.0 if kind == "gear" else 5.0)[:, None]
    x = (x0 + scale * np.random.default_rng(0).standard_normal(x0.shape)).T
    jd, jcfg, jw = JDims(**kw), jconfig.PlannerConfig(), _jw()
    jbm = jbcost.to_bminor(jax.tree.map(jnp.asarray, npb))

    def total(xT):
        return jbcost.total_cost_b(xT, jbm, jw, jd, jcfg)[0]

    f, g = jax.jit(lambda xT: (total(xT), jax.grad(
        lambda z: jnp.sum(total(z)))(xT)))(jnp.asarray(x))
    return npb, np.ascontiguousarray(x), np.asarray(f), np.asarray(g)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("kind", list(CASES))
def test_total_cost_b_matches_jax(kind, backend):
    npb, x, f_ref, g_ref = _cost_case(kind)
    dims = Dims(**CASES[kind][0])
    bm = bcost.to_bminor(from_numpy(npb, Scenario, device="cpu",
                                    dtype=torch.float64))
    xg = torch.from_numpy(x).requires_grad_(True)
    f, aux = bcost.total_cost_b(xg, bm, _w(), dims, _cfg(backend))
    (g,) = torch.autograd.grad(f.sum(), xg)
    assert float(aux["obs"].detach().max()) > 0.0  # corridor term active
    np.testing.assert_allclose(f.detach().numpy(), f_ref, rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-9, atol=1e-9)


def test_total_cost_b_rejects_unknown_backend():
    npb, x, _f, _g = _cost_case("straight")
    bm = bcost.to_bminor(from_numpy(npb, Scenario, device="cpu",
                                    dtype=torch.float64))
    with pytest.raises(ValueError):
        bcost.total_cost_b(torch.from_numpy(x), bm, _w(),
                           Dims(**CASES["straight"][0]), _cfg("triton"))


def test_total_cost_b_auto_is_xla_on_cpu():
    """"auto" takes the plain broadcast form for CPU tensors: the same
    value and gradient as "xla", bit for bit."""
    npb, x, _f, _g = _cost_case("straight-obs")
    dims = Dims(**CASES["straight-obs"][0])
    bm = bcost.to_bminor(from_numpy(npb, Scenario, device="cpu",
                                    dtype=torch.float64))
    out = []
    for backend in ("auto", "xla"):
        xg = torch.from_numpy(x).requires_grad_(True)
        f = bcost.total_cost_b(xg, bm, _w(), dims, _cfg(backend))[0]
        out += [f.detach(), torch.autograd.grad(f.sum(), xg)[0]]
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])


def test_minimize_b_matches_jax_on_quadratics():
    """On smooth strictly convex problems both packages agree to rounding."""
    D, B = 12, 9
    rng = np.random.default_rng(1)
    A = rng.standard_normal((B, D, D))
    Q = np.einsum("bij,bkj->bik", A, A) + 10.0 * np.eye(D)
    c = rng.standard_normal((B, D))
    p = config.PlannerConfig().opt.lbfgs

    def jfun(xT):
        f = 0.5 * jnp.einsum("db,bde,eb->b", xT, Q, xT) - jnp.sum(c.T * xT, 0)
        return f, jnp.einsum("bde,eb->db", Q, xT) - c.T

    ref = jax.jit(lambda x0: jblbfgs.minimize_b(
        jfun, x0, jconfig.LBFGSParams(), max_iterations=100))(
        jnp.zeros((D, B)))
    Qt, ct = torch.from_numpy(Q), torch.from_numpy(c)

    def fun(xT):
        f = 0.5 * torch.einsum("db,bde,eb->b", xT, Qt, xT) \
            - torch.sum(ct.T * xT, 0)
        return f, torch.einsum("bde,eb->db", Qt, xT) - ct.T

    res = blbfgs.minimize_b(fun, torch.zeros((D, B), dtype=torch.float64), p,
                            max_iterations=100)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-8)
    np.testing.assert_allclose(res.f.numpy(), np.asarray(ref.f), atol=1e-8)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    assert bool((res.status >= 0).all())
    # near the exact solution (the past-delta stop at 1e-4 halts early)
    xstar = np.linalg.solve(Q, c[..., None])[..., 0]
    np.testing.assert_allclose(res.x.numpy().T, xstar, atol=5e-3)


def test_minimize_b_lane_isolation():
    """A hard lane does not perturb an easy lane's result."""
    p = config.PlannerConfig().opt.lbfgs

    def f_easy(x):
        return torch.sum((x - 1.0) ** 2, dim=0)

    def f_rosen(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def fun_b(xT):
        with torch.enable_grad():
            xg = xT.detach().requires_grad_(True)
            fs = torch.stack([f_easy(xg[:, 0]), f_rosen(xg[:, 1])])
            (g,) = torch.autograd.grad(fs.sum(), xg)
        return fs.detach(), g

    x0 = torch.tensor([[0.0, 0.0], [-1.2, 1.0]], dtype=torch.float64).T
    res = blbfgs.minimize_b(fun_b, x0, p, max_iterations=300)
    np.testing.assert_allclose(res.x[:, 0].numpy(), [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(res.x[:, 1].numpy(), [1.0, 1.0], atol=1e-5)

    def fun_solo(xT):
        with torch.enable_grad():
            xg = xT.detach().requires_grad_(True)
            fs = f_easy(xg[:, 0])[None]
            (g,) = torch.autograd.grad(fs.sum(), xg)
        return fs.detach(), g

    solo = blbfgs.minimize_b(fun_solo, x0[:, :1].contiguous(), p,
                             max_iterations=300)
    assert torch.equal(res.x[:, 0], solo.x[:, 0])


SOLVE_KW = dict(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)


@functools.lru_cache(maxsize=None)
def _jax_minimize():
    """JAX solve_batch_bminor's chain up to the lbfgs Result, compiled
    once with the iteration budget as an argument."""
    jd, jcfg, jw = JDims(**SOLVE_KW), jconfig.PlannerConfig(), _jw()
    scale = jcfg.opt.cost_scale

    def run(batch, max_iter):
        with jax.default_matmul_precision("float32"):
            batch = jax.vmap(
                lambda s: jsolver.clamp_boundary_states(s, jw))(batch)
            x0 = jax.vmap(lambda s: jcost.initial_guess(s, jw, jd))(batch)
            bm = jbcost.to_bminor(batch)

            def f_sum(xT):
                fs = scale * jbcost.total_cost_b(xT, bm, jw, jd, jcfg)[0]
                return jnp.sum(fs), fs

            def fun(xT):
                (_, f), g = jax.value_and_grad(f_sum, has_aux=True)(xT)
                return f, g

            return jblbfgs.minimize_b(fun, x0.T, jcfg.opt.lbfgs,
                                      max_iterations=max_iter)

    return jax.jit(run)


def _solve_batch():
    return scenarios.batch_scenarios(Dims(**SOLVE_KW), 8, seed=5,
                                     n_obstacles=2)


def test_minimize_bminor_matches_jax_12_iterations():
    npb = _solve_batch()
    ref = _jax_minimize()(jax.tree.map(jnp.asarray, npb), jnp.int32(12))
    _bm, res = solver.minimize_bminor(
        from_numpy(npb, Scenario, device="cpu", dtype=torch.float64), _w(),
        Dims(**SOLVE_KW), _cfg("pallas"), max_iterations=12)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.n_iters.numpy(),
                                  np.asarray(ref.n_iters))
    np.testing.assert_array_equal(res.n_evals.numpy(),
                                  np.asarray(ref.n_evals))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(res.f.numpy(), np.asarray(ref.f), rtol=1e-10)


def test_solve_batch_bminor_150_iterations_matches_jax():
    npb = _solve_batch()
    cfg = _cfg("pallas")
    ref = _jax_minimize()(jax.tree.map(jnp.asarray, npb), jnp.int32(150))
    cost_ref = np.asarray(ref.f) / cfg.opt.cost_scale
    ok_ref = (np.asarray(ref.status) >= 0) & (cost_ref < cfg.opt.reject_cost)
    solve = solver.make_solver(cfg, Dims(**SOLVE_KW), 150, engine="bminor")
    res = solve(from_numpy(npb, Scenario, device="cpu", dtype=torch.float64),
                _w())
    assert isinstance(res, SolveResult)
    assert tuple(res.coeffs.shape) == (8, 1, 8, 6, 2)
    assert tuple(res.dT.shape) == (8, 1)
    assert torch.isfinite(res.coeffs).all()
    assert abs(int(res.success.sum()) - int(ok_ref.sum())) <= 1
    med = float(np.median(res.cost.numpy()))
    med_ref = float(np.median(cost_ref))
    assert abs(med - med_ref) <= 0.02 * med_ref, (med, med_ref)
    assert bool((res.status != Status.RUNNING).all())


def test_bminor_engine_runs_two_segments():
    """S=2 (uniform N) through make_solver: finite coefficients of the
    gear class, every lane done, and the gear variables in x."""
    dims = Dims(**CASES["gear"][0])
    npb = _np_batch("gear")
    res = solver.make_solver(_cfg("pallas"), dims, 20, engine="bminor")(
        from_numpy(npb, Scenario, device="cpu", dtype=torch.float64), _w())
    assert tuple(res.coeffs.shape) == (4, 2, 5, 6, 2)
    assert torch.isfinite(res.coeffs).all() and torch.isfinite(res.cost).all()
    assert bool((res.status != Status.RUNNING).all())
