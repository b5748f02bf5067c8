"""The port's front end against the JAX package's: the same native C++
(native/dftpav_native.cpp) through the port's own ctypes binding and
build, the surround-trajectory fit, and the two-gear plan pool that the
multi-gear path is measured on.

  * frontend_pool_multigear over the nine S=2 piece classes (bench.py
    MG_ALL), 12 plans, seed 11, 2 obstacles, a 1 s search budget: the same
    buckets, counts, n_s2 and arrays, exactly;
  * fit_surround_trajs of circular movers: to 1e-12;
  * the port builds its library from the repository's source into
    dftpav_tpu_torch/_build/ and loads that one.
"""

import functools

import numpy as np
import pytest

from dftpav_tpu import scenarios as jscen
from dftpav_tpu.sim import obstacles as jobs
from dftpav_tpu.types import Dims as JDims

from dftpav_tpu_torch import scenarios
from dftpav_tpu_torch.frontend import native
from dftpav_tpu_torch.sim import obstacles
from dftpav_tpu_torch.types import Dims

MG_ALL = ((8, 2), (4, 2), (2, 8), (2, 2), (4, 8), (8, 8), (2, 4), (4, 4),
          (8, 4))
KW = dict(S=2, N=8, K=16, Kdes=32, H=4, O=2, Po=8)


@functools.lru_cache(maxsize=None)
def _pools():
    """Both pools with a 1 s search budget per query (the bench uses 0.1 s;
    these searches end within it, and the wider budget keeps a loaded test
    host from cutting one package's search and not the other's)."""
    ref = jscen.frontend_pool_multigear(
        [JDims(**KW, Ns=ns) for ns in MG_ALL], 12, seed=11,
        dtype=np.float32, n_obstacles=2, max_search_time=1.0)
    port = scenarios.frontend_pool_multigear(
        [Dims(**KW, Ns=ns) for ns in MG_ALL], 12, seed=11,
        dtype=np.float32, n_obstacles=2, max_search_time=1.0)
    return port, ref


def test_frontend_pool_multigear_matches_jax():
    (buckets, n_s2), (ref, n_ref) = _pools()
    assert n_s2 == n_ref == 12
    assert list(buckets) == list(ref) == list(MG_ALL)
    assert [len(v) for v in buckets.values()] == \
        [len(v) for v in ref.values()]
    for ns in MG_ALL:
        for a, b in zip(buckets[ns], ref[ns]):
            assert a._fields == b._fields
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
    # the pool holds real two-gear plans with obstacles on the first class
    first = buckets[MG_ALL[0]]
    assert first and all(bool(s.obs_mask.all()) and s.seg_mask.all()
                         for s in first)


@pytest.mark.parametrize("Po", [4, 8])
def test_fit_surround_trajs_matches_jax(Po):
    movers = [obstacles.CircularMover(center=(20.0, 15.0), radius=12.0,
                                      speed=4.5, phase=0.3, ccw=True),
              obstacles.CircularMover(center=(30.0, 10.0), radius=8.5,
                                      speed=2.0, phase=2.0, ccw=False)]
    jmovers = [jobs.CircularMover(center=m.center, radius=m.radius,
                                  speed=m.speed, phase=m.phase, ccw=m.ccw)
               for m in movers]
    dims, jdims = Dims(O=3, Po=Po), JDims(O=3, Po=Po)
    for dtype in (np.float32, np.float64):
        got = obstacles.fit_surround_trajs(movers, 1.5, dims, dtype=dtype)
        ref = jobs.fit_surround_trajs(jmovers, 1.5, jdims, dtype=dtype)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12,
                                       atol=1e-12)


def test_port_builds_its_own_native_library():
    so = native.build()
    assert so.parent == native.BUILD_DIR
    assert so.parent.parent.name == "dftpav_tpu_torch"
    assert so.exists() and so == native.library_path()
    lib = native._load()
    assert lib._name == str(so)
    grid = scenarios.random_lot_grid(np.random.default_rng(0))
    assert grid.occupied(0.05, 0.05)          # the lot's boundary wall
    assert grid.occupied(-5.0, -5.0)          # outside the map
    d = native.reeds_shepp_distance(4.0, (0.0, 0.0, 0.0), (5.0, 2.0, 0.5))
    assert d > np.hypot(5.0, 2.0)
