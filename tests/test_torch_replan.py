"""The port's replanning path (dftpav_tpu_torch.replan and the minco
evaluation helpers) against the JAX package, float64 on the CPU.

  * minco.eval_derivatives / flat_states / eval_segment_states on random
    coefficients: within 1e-12;
  * warm_start_scenario and prev_inner_guess on synthetic previous
    solutions (random coefficients and piece durations from a numpy seed,
    no solve), one seed time for the batch and one per lane: within 1e-12;
  * warm_start_scenario_multigear on S = 2 uniform, Ns = (8, 2), (2, 8) and
    S = 3 (4, 2, 2), with per-lane seed times inside segment 0, past each
    gear switch and past the end, and lanes with fewer valid segments:
    masks, singul and gathered corridor rows exact, floats within 1e-12;
  * check_replan_batch on the tests/test_replan_gating.py fixture (B = 8,
    solved here by the port's plain loop, the same result fed to both):
    equal masks, fresh and with a blocked corridor, near the end with a
    static and a moved goal, and with a failed lane;
  * one make_gated_replanner and one make_replanner step, engine "rounds",
    10 iterations, on the same fixture without its obstacles (the JAX
    round loop compiles its obstacle block for ~30 s per obstacle; the
    obstacle terms of the gate and the shift are checked above): flagged
    lanes and the gather order exact, statuses, iterations and successes
    exact, ages exact, coefficients, durations and costs within 1e-9.

The JAX references are computed once per module (plain XLA on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu import minco as jminco
from dftpav_tpu import replan as jreplan
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import Scenario as JScenario
from dftpav_tpu.types import SolveResult as JSolveResult
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, minco, replan, scenarios, solver
from dftpav_tpu_torch.types import Dims, Scenario, SolveResult, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

B = 8
GATE_KW = dict(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)
TIGHT = dict(rtol=1e-12, atol=1e-12)


def _port(tree, cls):
    return from_numpy(tree, cls, device="cpu", dtype=torch.float64)


def _jax(tree, cls):
    return cls(*(jnp.asarray(np.asarray(a)) for a in tree))


def _np(tree):
    return [np.asarray(a) for a in tree]


def _weights():
    return (weights_from_config(config.PlannerConfig().opt, torch.float64,
                                device="cpu"),
            jweights(jconfig.PlannerConfig().opt, jnp.float64))


def _assert_same(port_tree, jax_tree):
    """Leaf by leaf: integer and bool leaves exact, floats within 1e-12."""
    for name, a, b in zip(type(port_tree)._fields, port_tree, jax_tree):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **TIGHT)


def _synthetic_prev(S, N, seed):
    """A SolveResult [B] of random normalized coefficients and per-piece
    durations (numpy), as a solve would leave it."""
    rng = np.random.default_rng(seed)
    return SolveResult(
        coeffs=rng.standard_normal((B, S, N, 6, 2)),
        dT=rng.uniform(0.3, 0.8, (B, S)), cost=rng.uniform(1, 2, B),
        n_iters=np.full(B, 10, np.int32), status=np.zeros(B, np.int32),
        success=np.ones(B, bool))


def test_eval_derivatives_flat_states_and_segment_states():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((7, 6, 2))
    tau = rng.uniform(0.0, 1.0, 7)
    out = minco.eval_derivatives(torch.from_numpy(b), 0.7,
                                 torch.from_numpy(tau), orders=(0, 1, 2, 3))
    ref = jminco.eval_derivatives(jnp.asarray(b), 0.7, jnp.asarray(tau),
                                  orders=(0, 1, 2, 3))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TIGHT)
    seg = rng.standard_normal((8, 6, 2))
    t = np.linspace(-0.3, 8 * 0.45 + 0.3, 41)
    for singul in (1, -1):
        st = minco.eval_segment_states(torch.from_numpy(seg), 0.45, singul,
                                       2.85, torch.from_numpy(t))
        jst = jminco.eval_segment_states(jnp.asarray(seg), 0.45, singul,
                                         2.85, jnp.asarray(t))
        assert st.keys() == jst.keys()
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       err_msg=k, **TIGHT)


@functools.lru_cache(maxsize=None)
def _single_inputs():
    dims = Dims(**GATE_KW)
    scen = scenarios.batch_scenarios(dims, B, seed=3, n_obstacles=2)
    rng = np.random.default_rng(4)
    scen = scen._replace(obs_rel_t0=rng.uniform(0.0, 2.0, (B, dims.O)))
    return dims, scen, _synthetic_prev(1, dims.N, 5)


@pytest.mark.parametrize("per_lane", [False, True])
def test_warm_start_scenario_and_prev_inner_guess(per_lane):
    dims, scen, prev = _single_inputs()
    jdims = JDims(**GATE_KW)
    w, jw = _weights()
    # per lane: inside the trajectory, at 0, and past its end (clamped)
    dt = (np.array([0.1, 0.0, 0.35, 1.2, 2.0, 3.5, 7.0, 0.05])
          if per_lane else np.full(B, 0.1))
    shift = torch.from_numpy(dt) if per_lane else 0.1
    out = replan.warm_start_scenario(_port(scen, Scenario),
                                     _port(prev, SolveResult), shift, w,
                                     dims)
    ref = jax.jit(jax.vmap(lambda s, p, t: jreplan.warm_start_scenario(
        s, p, t, jw, jdims)))(_jax(scen, JScenario),
                             _jax(prev, JSolveResult), jnp.asarray(dt))
    _assert_same(out, ref)
    guess = replan.prev_inner_guess(_port(prev, SolveResult), shift, dims)
    jguess = jax.vmap(lambda p, t: jreplan.prev_inner_guess(p, t, jdims))(
        _jax(prev, JSolveResult), jnp.asarray(dt))
    np.testing.assert_allclose(guess.numpy(), np.asarray(jguess), **TIGHT)


# name: (Ns or None, S, obstacles)
MG = {"S2": (None, 2, 2), "8-2": ((8, 2), 2, 0), "2-8": ((2, 8), 2, 0),
      "4-2-2": ((4, 2, 2), 3, 0)}


def _mg_kw(name):
    ns, S, O = MG[name]
    return dict(S=S, N=8, K=16, Kdes=32, H=4, O=O, Po=8, Ns=ns)


@pytest.mark.parametrize("name", list(MG))
def test_warm_start_scenario_multigear(name):
    dims, jdims = Dims(**_mg_kw(name)), JDims(**_mg_kw(name))
    w, jw = _weights()
    make = scenarios.gear_scenario if dims.S == 2 \
        else scenarios.multi_gear_scenario
    rng = np.random.default_rng(7)
    lanes = []
    for i in range(B):
        sc = make(dims)
        inner = sc.init_inner + rng.uniform(-0.3, 0.3, sc.init_inner.shape)
        inner[sc.init_inner == 0] = 0.0
        # lanes 6 and 7 hold one segment fewer than the class
        mask = sc.seg_mask.copy()
        if i >= 6:
            mask[dims.S - 1] = False
        lanes.append(sc._replace(
            init_inner=inner, seg_mask=mask,
            obs_rel_t0=rng.uniform(0.0, 2.0, sc.obs_rel_t0.shape)))
    scen = scenarios.stack_scenarios(lanes)
    prev = _synthetic_prev(dims.S, dims.N, 8)
    # per-lane seed times: inside segment 0, past each gear switch, past
    # the end, and on the lanes with fewer segments inside and past
    seg_T = prev.dT * dims.N
    cum = np.cumsum(seg_T, axis=1)
    dt = np.array([0.3 * seg_T[0, 0], 0.0, cum[2, 0] + 0.2,
                   cum[3, dims.S - 2] + 0.2, cum[4, -1] + 1.0,
                   0.6 * seg_T[5, 0], cum[6, 0] + 0.1, 0.2])
    out = replan.warm_start_scenario_multigear(
        _port(scen, Scenario), _port(prev, SolveResult),
        torch.from_numpy(dt), w, dims)
    ref = jax.jit(jax.vmap(lambda s, p, t:
                          jreplan.warm_start_scenario_multigear(
                              s, p, t, jw, jdims)))(_jax(scen, JScenario),
                             _jax(prev, JSolveResult), jnp.asarray(dt))
    _assert_same(out, ref)
    # the lanes seeded past a gear switch rolled (the fixture reaches it)
    assert not bool(out.seg_mask[2, dims.S - 1])


@functools.lru_cache(maxsize=None)
def _gate_fixture(O=2):
    """tests/test_replan_gating.py's fixture: batch_scenarios(seed=7, B=8,
    float32, O obstacles) solved by the plain loop, 80 iterations (the
    port's), then as float64 numpy for both packages."""
    dims, cfg = Dims(**dict(GATE_KW, O=O)), config.PlannerConfig()
    scen = scenarios.batch_scenarios(dims, B, seed=7, dtype=np.float32,
                                     n_obstacles=O)
    res = solver.make_solver(cfg, dims, max_iterations=80, engine="rounds")(
        from_numpy(scen, Scenario, device="cpu"),
        weights_from_config(cfg.opt, device="cpu"))
    f64 = lambda t: [a.astype(np.float64) if a.dtype.kind == "f" else a
                     for a in _np(t)]
    return Scenario(*f64(scen)), SolveResult(*f64(res))


def _gate_cases(O=2):
    scen, prev = _gate_fixture(O)
    cp = scen.corr_p.copy()
    cp[0] -= 50.0 * scen.corr_n[0]           # lane 0's planes past its path
    fin = scen.fin_state.copy()
    fin[:, -1, :, 0] += 2.0                  # the goal moves 2 m
    near = prev.dT[:, 0] * 8 - 1.0           # < near_end_s remaining
    failed = prev._replace(success=prev.success & (np.arange(B) != 2))
    zero = np.zeros(B)
    return {"fresh": (scen, prev, zero),
            "blocked": (scen._replace(corr_p=cp), prev, zero),
            "near_static": (scen, prev, near),
            "near_moved": (scen._replace(fin_state=fin), prev, near),
            "failed": (scen, failed, zero)}


def test_check_replan_batch_masks_equal():
    dims, jdims = Dims(**GATE_KW), JDims(**GATE_KW)
    cfg, jcfg = config.PlannerConfig(), jconfig.PlannerConfig()
    w, jw = _weights()
    jcheck = jax.jit(lambda s, p, a: jreplan.check_replan_batch(
        s, p, a, jw, jdims, jcfg))
    got = {}
    for case, (scen, prev, age) in _gate_cases().items():
        need = replan.check_replan_batch(
            _port(scen, Scenario), _port(prev, SolveResult),
            torch.from_numpy(age), w, dims, cfg).numpy()
        ref = np.asarray(jcheck(_jax(scen, JScenario),
                                _jax(prev, JSolveResult), jnp.asarray(age)))
        np.testing.assert_array_equal(need, ref, err_msg=case)
        got[case] = need
    # the triggers of tests/test_replan_gating.py fire here too
    assert got["blocked"][0] and got["failed"][2]
    np.testing.assert_array_equal(got["blocked"][1:], got["fresh"][1:])
    assert got["near_moved"].all()
    assert got["near_moved"].sum() > got["near_static"].sum()


STEP_KW = dict(GATE_KW, O=0)


def _step_inputs():
    """The fixture without obstacles, lane 0's corridor blocked and lane 2
    failed, so that both are flagged."""
    cases = _gate_cases(O=0)
    return cases["blocked"][0], cases["failed"][1]


def _assert_result_close(res, jres):
    for name in ("n_iters", "status", "success"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    for name in ("coeffs", "dT", "cost"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_gated_replanner_step_rounds_10_iterations():
    dims, jdims = Dims(**STEP_KW), JDims(**STEP_KW)
    cfg, jcfg = config.PlannerConfig(), jconfig.PlannerConfig()
    w, jw = _weights()
    scen, prev = _step_inputs()
    age = np.linspace(0.0, 0.7, B)
    step = replan.make_gated_replanner(cfg, dims, dt_shift=0.1,
                                       max_iterations=10, engine="rounds",
                                       capacity=0.5)
    jstep = jreplan.make_gated_replanner(jcfg, jdims, dt_shift=0.1,
                                         max_iterations=10, engine="rounds",
                                         capacity=0.5)
    b2, p2, a2, n_need = step(_port(scen, Scenario), _port(prev, SolveResult),
                              torch.from_numpy(age), w)
    jb2, jp2, ja2, jn_need = jstep(_jax(scen, JScenario),
                                   _jax(prev, JSolveResult),
                                   jnp.asarray(age), jw)
    # the gate: flagged lanes and their gather order
    need = replan.check_replan_batch(
        _port(scen, Scenario), _port(prev, SolveResult),
        torch.from_numpy(age + 0.1), w, dims, cfg)
    jneed = jreplan.check_replan_batch(
        _jax(scen, JScenario), _jax(prev, JSolveResult),
        jnp.asarray(age + 0.1), jw, jdims, jcfg)
    np.testing.assert_array_equal(need.numpy(), np.asarray(jneed))
    idx = torch.argsort((~need).to(torch.int32), stable=True).numpy()
    jidx = np.asarray(jnp.argsort(jnp.where(jneed, 0, 1), stable=True))
    np.testing.assert_array_equal(idx, jidx)
    assert int(n_need) == int(jn_need) == int(need.sum()) >= 2
    np.testing.assert_array_equal(a2.numpy(), np.asarray(ja2))
    assert int((a2 == 0).sum()) == int(need.sum())
    _assert_same(b2, jb2)
    _assert_result_close(p2, jp2)
    keep = ~need.numpy()
    for name in SolveResult._fields:
        np.testing.assert_array_equal(getattr(p2, name).numpy()[keep],
                                      getattr(prev, name)[keep])


def test_replanner_step_rounds_10_iterations():
    dims, jdims = Dims(**STEP_KW), JDims(**STEP_KW)
    cfg, jcfg = config.PlannerConfig(), jconfig.PlannerConfig()
    w, jw = _weights()
    scen, prev = _gate_fixture(O=0)
    step = replan.make_replanner(cfg, dims, dt_shift=0.1, max_iterations=10,
                                 engine="rounds")
    jstep = jreplan.make_replanner(jcfg, jdims, dt_shift=0.1,
                                   max_iterations=10, engine="rounds")
    shifted, res = step(_port(scen, Scenario), _port(prev, SolveResult), w)
    jshifted, jres = jstep(_jax(scen, JScenario), _jax(prev, JSolveResult),
                           jw)
    _assert_same(shifted, jshifted)
    _assert_result_close(res, jres)
