"""The port's host constants, fixtures and setup against the JAX package.

Everything here is numpy or cheap tensor code: Dims helpers, MINCO maps,
the sample grid, the kernel-layout constants and slabs, the fixtures (bit
for bit from the same seed), the boundary clamp and the initial guess
(exact in float64), Status codes and config defaults. Also checks that
the port imports neither jax nor the JAX package.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu import cost as jcost
from dftpav_tpu import lbfgs as jlbfgs
from dftpav_tpu import minco as jminco
from dftpav_tpu import scenarios as jscen
from dftpav_tpu import solver as jsolver
from dftpav_tpu.basis import sample_grid as jsample_grid
from dftpav_tpu.ops import kcost as jkcost
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import config, cost, minco, scenarios, solver
from dftpav_tpu_torch.basis import sample_grid
from dftpav_tpu_torch.lbfgs import Status
from dftpav_tpu_torch.ops import kcost
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

CLASSES = [dict(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8),
           dict(S=1, N=8, K=16, Kdes=32, H=4, O=0, Po=8),
           dict(S=2, N=8, K=16, Kdes=32, H=4, O=1, Po=8, Ns=(8, 2)),
           dict(S=1, N=4, K=8, Kdes=16, H=4, O=1, Po=4)]


@pytest.mark.parametrize("kw", CLASSES)
def test_dims_helpers_match(kw):
    d, jd = Dims(**kw), JDims(**kw)
    assert (d.ns_tuple, d.K1, d.n_inner, d.dim) == \
        (jd.ns_tuple, jd.K1, jd.n_inner, jd.dim)
    assert kcost.r_rows(d) == jkcost.r_rows(jd)
    assert kcost.dp_of(d) == jkcost.dp_of(jd)
    assert kcost.bnd_rows(d) == jkcost.bnd_rows(jd)
    assert kcost.misc_rows(d) == jkcost.misc_rows(jd)
    for s in range(d.S):
        assert kcost.seg_active(d, s) == jkcost.seg_active(jd, s)


@pytest.mark.parametrize("N", [2, 4, 8])
def test_minco_maps_and_sample_grid(N):
    for a, b in zip(minco.minco_maps(N), jminco.minco_maps(N)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(minco.minco_matrix(N),
                                  jminco.minco_matrix(N))
    g, jg = sample_grid(N, 16, 32), jsample_grid(N, 16, 32)
    for f in dataclasses.fields(g):
        a, b = getattr(g, f.name), getattr(jg, f.name)
        if f.name == "beta":
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    M = minco.maps_as(N, torch.float64)
    np.testing.assert_array_equal(M[1].numpy(), minco.minco_maps(N)[1])


def test_make_consts_match():
    kw = CLASSES[0]
    kc = kcost.make_consts(Dims(**kw), torch.float64)
    jkc = jkcost.make_consts(JDims(**kw), jnp.float64)
    for a, b in zip(kc, jkc):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


GEAR_KW = dict(S=2, N=5, K=8, Kdes=12, H=4, O=1, Po=8)


@pytest.mark.parametrize("seed,O,dtype", [(7, 2, np.float32),
                                          (3, 2, np.float64),
                                          (11, 0, np.float64),
                                          ("gear", 1, np.float32),
                                          ("gear", 1, np.float64)])
def test_batch_scenarios_bit_identical(seed, O, dtype):
    if seed == "gear":                   # gear_scenario, uniform N
        a = scenarios.gear_scenario(Dims(**GEAR_KW), dtype=dtype)
        b = jscen.gear_scenario(JDims(**GEAR_KW), dtype=dtype)
    else:
        kw = dict(CLASSES[0], O=O)
        a = scenarios.batch_scenarios(Dims(**kw), 16, seed=seed, dtype=dtype,
                                      n_obstacles=O)
        b = jscen.batch_scenarios(JDims(**kw), 16, seed=seed, dtype=dtype,
                                  n_obstacles=O)
    assert a._fields == b._fields
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_gear_initial_guess_exact():
    """initial_guess at S=2 (gear positions and angles from fin_state) on
    the clamped gear batch, against JAX exactly."""
    dims, jdims = Dims(**GEAR_KW), JDims(**GEAR_KW)
    npb = scenarios.stack_scenarios([scenarios.gear_scenario(dims)] * 3)
    npb = npb._replace(fin_state=npb.fin_state
                       * np.array([1.0, 30.0, 0.5])[:, None, None, None])
    w = weights_from_config(config.OptConfig(), torch.float64, device="cpu")
    jw = jweights(jconfig.OptConfig(), jnp.float64)
    c = solver.clamp_boundary_states(
        from_numpy(npb, Scenario, device="cpu", dtype=torch.float64), w)
    jc = jax.vmap(lambda s: jsolver.clamp_boundary_states(s, jw))(
        jax.tree.map(jnp.asarray, npb))
    x0 = cost.initial_guess(c, w, dims)
    jx0 = jax.vmap(lambda s: jcost.initial_guess(s, jw, jdims))(jc)
    assert tuple(x0.shape) == (3, dims.dim)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    u = cost.unpack(x0, dims)
    np.testing.assert_array_equal(cost.pack(u).numpy(), x0.numpy())


@pytest.fixture(scope="module")
def setup64():
    kw = CLASSES[0]
    dims, jdims = Dims(**kw), JDims(**kw)
    cfg, jcfg = config.PlannerConfig(), jconfig.PlannerConfig()
    npb = scenarios.batch_scenarios(dims, 8, seed=3, n_obstacles=2)
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    jw = jweights(jcfg.opt, jnp.float64)
    b = from_numpy(npb, Scenario, device="cpu", dtype=torch.float64)
    jb = jax.tree.map(jnp.asarray, jscen.batch_scenarios(
        jdims, 8, seed=3, n_obstacles=2))
    return dims, jdims, w, jw, b, jb


def test_clamp_and_initial_guess_exact(setup64):
    dims, jdims, w, jw, b, jb = setup64
    # make some boundary states exceed the limits so the clamp acts
    b = b._replace(ini_state=b.ini_state * 6.0)
    jb = jb._replace(ini_state=jb.ini_state * 6.0)
    c = solver.clamp_boundary_states(b, w)
    jc = jax.vmap(lambda s: jsolver.clamp_boundary_states(s, jw))(jb)
    np.testing.assert_array_equal(c.ini_state.numpy(),
                                  np.asarray(jc.ini_state))
    np.testing.assert_array_equal(c.fin_state.numpy(),
                                  np.asarray(jc.fin_state))
    x0 = cost.initial_guess(c, w, dims)
    jx0 = jax.vmap(lambda s: jcost.initial_guess(s, jw, jdims))(jc)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))


def test_prep_scenario_slabs_exact(setup64):
    dims, jdims, w, jw, b, jb = setup64
    sc = kcost.prep_scenario(b, dims, torch.float64)
    jsc = jkcost.prep_scenario(jb, jdims, jnp.float64)
    assert sc._fields == jsc._fields
    for a, j in zip(sc, jsc):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))


def test_status_and_config_defaults():
    for name in ("CONVERGENCE", "STOP", "MAXITER", "MAXLS", "RUNNING",
                 "ERR_INVALID_FUNCVAL", "ERR_WIDTHTOOSMALL", "ERR_MINSTEP",
                 "ERR_MAXSTEP", "ERR_INCREASEGRADIENT"):
        assert getattr(Status, name) == getattr(jlbfgs.Status, name)
    for cls, jcls in ((config.OptConfig, jconfig.OptConfig),
                      (config.LBFGSParams, jconfig.LBFGSParams),
                      (config.VehicleParam, jconfig.VehicleParam)):
        ours = dataclasses.asdict(cls())
        theirs = dataclasses.asdict(jcls())
        for k, v in ours.items():
            if (cls, k) == (config.OptConfig, "corridor_backend"):
                # the one intended difference: the port picks the corridor
                # kernels for CUDA tensors by default ("auto", which is the
                # JAX default "xla" on CPU tensors)
                assert (v, theirs[k]) == ("auto", "xla")
                continue
            assert theirs[k] == v, (cls.__name__, k)
    assert config.PlannerConfig().ego_hull() == \
        jconfig.PlannerConfig().ego_hull()
    t, jt = config.EngineFlags.tuned(), jconfig.EngineFlags.tuned()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(jt, f.name)
    assert config.resolve_vt_scale("auto", (8, 2)) == \
        jconfig.resolve_vt_scale("auto", (8, 2))


def test_urban_and_ssc_config_defaults():
    """The urban and SSC configs, layouts and host constants equal JAX's,
    field by field."""
    from dftpav_tpu.sim import arena as jarena
    from dftpav_tpu.ssc import bezier as jbezier, corridor as jcorridor
    from dftpav_tpu.ssc import planner as jplanner, qp as jqp
    from dftpav_tpu.ssc import voxel as jvoxel
    from dftpav_tpu.urban import forward_sim as jfsim, idm as jidm
    from dftpav_tpu.urban import mpdm as jmpdm, rss as jrss
    from dftpav_tpu.urban import steer as jsteer

    from dftpav_tpu_torch.sim import arena
    from dftpav_tpu_torch.ssc import bezier, corridor as scorridor
    from dftpav_tpu_torch.ssc import planner, qp, voxel
    from dftpav_tpu_torch.urban import forward_sim as fsim, idm, mpdm, rss
    from dftpav_tpu_torch.urban import steer

    pairs = [(mpdm.MPDMConfig, jmpdm.MPDMConfig),
             (planner.SSCConfig, jplanner.SSCConfig),
             (scorridor.CorridorConfig, jcorridor.CorridorConfig),
             (voxel.VoxelConfig, jvoxel.VoxelConfig),
             (idm.IDMParam, jidm.IDMParam), (rss.RssConfig, jrss.RssConfig),
             (steer.SteerLimits, jsteer.SteerLimits),
             (fsim.SimParam, jfsim.SimParam)]
    for cls, jcls in pairs:
        assert cls._fields == jcls._fields, cls.__name__
        for f, a, b in zip(cls._fields, cls(), jcls()):
            if hasattr(a, "_fields"):
                assert tuple(a) == tuple(float(x) if hasattr(x, "dtype")
                                         else x for x in b), (cls, f)
            else:
                assert a == float(b) if hasattr(b, "dtype") else a == b, \
                    (cls.__name__, f)
    assert fsim.AgentGeom._fields == jfsim.AgentGeom._fields
    assert mpdm.MPDMConfig().n_steps == jmpdm.MPDMConfig().n_steps
    assert (mpdm.BEHAVIORS, fsim.LAT_RANGE) == (jmpdm.BEHAVIORS,
                                                 jfsim.LAT_RANGE)
    assert (steer.X, steer.Y, steer.TH, steer.V, steer.ST, steer.ACC,
            steer.STATE_DIM) == (jsteer.X, jsteer.Y, jsteer.TH, jsteer.V,
                                 jsteer.ST, jsteer.ACC, jsteer.STATE_DIM)
    assert (arena.AX, arena.AY, arena.ATH, arena.AST, arena.AV,
            arena.ARENA_STATE_DIM) == (jarena.AX, jarena.AY, jarena.ATH,
                                       jarena.AST, jarena.AV,
                                       jarena.ARENA_STATE_DIM)
    assert (qp.SOLVED, qp.MAX_ITER, qp.INFEASIBLE) == \
        (jqp.SOLVED, jqp.MAX_ITER, jqp.INFEASIBLE)
    np.testing.assert_array_equal(bezier.JERK_HESSIAN, jbezier.JERK_HESSIAN)
    for args in ((5, 0.8, 2), (4, 1.0, 5)):
        for a, b in zip(planner._qp_template(*args),
                        jplanner._qp_template(*args)):
            np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter in which
    jax and the JAX package cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dftpav_tpu'] = None\n"
        "import dftpav_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dftpav_tpu_torch.__path__, 'dftpav_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'dftpav_tpu_torch.ops._cuda' in sys.modules\n"
        "assert 'dftpav_tpu_torch.ops.pallas_penalty' in sys.modules\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
