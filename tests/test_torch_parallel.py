"""The port's sharded solver over torch.distributed on the CPU: two gloo
ranks in spawned processes (a file:// store in the test's directory),
against the port's local solve and JAX's make_sharded_solver.

tests/test_parallel.py's class (Dims(S=1, N=6, K=8, Kdes=12, H=4, O=0,
Po=8), B = 16, 120 iterations, float64) through engine "rounds": each
rank's lanes equal the local solve of the same slice (cost rtol 1e-12,
coefficients 1e-9),
the all-reduced lane counts and iteration sum equal JAX's psum'd metrics
on the same batch (the successful lanes' cost sum, summed in float32 in
another order, to 1e-6). Then the dry run's three legs at two ranks with
reduced budgets. Ranks write nothing to the test's stdout or stderr.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dftpav_tpu import parallel as jparallel
from dftpav_tpu import scenarios as jscenarios
from dftpav_tpu.config import PlannerConfig as JPlannerConfig
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import solver
from dftpav_tpu_torch.config import PlannerConfig
from dftpav_tpu_torch.parallel import dryrun, sharding
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

from _torch_capture import fds_to_file

torch.set_num_threads(1)
B, ITERS, TIMEOUT = 16, 120, 120.0
DIMS = dict(S=1, N=6, K=8, Kdes=12, H=4, O=0, Po=8)


def _ranks(tmp_path, target, args):
    with fds_to_file() as log:
        try:
            return dryrun.run_ranks(
                target, 2, args, device="cpu", timeout=TIMEOUT,
                init_method=f"file://{tmp_path}/store")
        except BaseException:
            log.seek(0)
            raise AssertionError("ranks failed; their output:\n"
                                 + log.read()[-4000:])


def _batch():
    return jscenarios.batch_scenarios(JDims(**DIMS), B, seed=5,
                                      dtype=np.float64)


def _solve_rank(rank, world, device, scens, iters):
    """One rank: the sharded solve of the whole batch (numpy leaves)."""
    torch.set_num_threads(1)
    batch = from_numpy(scens, Scenario, device=device, dtype=torch.float64)
    w = weights_from_config(PlannerConfig().opt, torch.float64, device)
    fn = sharding.make_sharded_solver(PlannerConfig(), Dims(**DIMS), iters,
                                      engine="rounds")
    res, metrics = fn(batch, w)
    return ({k: v.numpy() for k, v in res._asdict().items()},
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def jax_metrics():
    """JAX's sharded "rounds" solve of the same batch on a 2-device mesh."""
    mesh = jparallel.make_mesh(jax.devices()[:2])
    fn = jparallel.make_sharded_solver(mesh, JPlannerConfig(), JDims(**DIMS),
                                       max_iterations=ITERS, engine="rounds")
    _, m = fn(jax.tree.map(jnp.asarray, _batch()),
              jweights(JPlannerConfig().opt, dtype=jnp.float64))
    return {k: float(v) for k, v in m.items()}


def test_sharded_rounds_matches_local_and_jax(tmp_path, jax_metrics):
    scens = _batch()
    ranks = _ranks(tmp_path, _solve_rank, (tuple(scens), ITERS))
    batch = from_numpy(scens, Scenario, device="cpu", dtype=torch.float64)
    w = weights_from_config(PlannerConfig().opt, torch.float64, "cpu")
    local = solver.make_solver(PlannerConfig(), Dims(**DIMS), ITERS,
                               engine="rounds")
    # each rank against the local solve of its own slice: the plain loop's
    # CPU matmuls round differently at another batch size (2e-13 in the
    # first gradient at B = 16 against 8), which 120 iterations amplify
    los = [local(sharding.shard_of(batch, r, 2), w) for r in range(2)]
    for (res, _), lo in zip(ranks, los):
        for k in ("cost", "coeffs", "dT", "n_iters", "status", "success"):
            want = getattr(lo, k).numpy()
            if want.dtype.kind == "f":
                np.testing.assert_allclose(
                    res[k], want, rtol=1e-12 if k == "cost" else 1e-9,
                    atol=0 if k == "cost" else 1e-9)
            else:
                np.testing.assert_array_equal(res[k], want)
    m0, m1 = ranks[0][1], ranks[1][1]
    assert m0 == m1                         # all-reduced on every rank
    ok = torch.cat([lo.success for lo in los])
    its = torch.cat([lo.n_iters for lo in los])
    assert m0["n_total"] == B == jax_metrics["n_total"]
    assert m0["n_solved"] == float(ok.sum()) == jax_metrics["n_solved"]
    assert m0["iters_sum"] == float(its.sum()) == jax_metrics["iters_sum"]
    np.testing.assert_allclose(m0["cost_sum"], jax_metrics["cost_sum"],
                               rtol=1e-6)


def test_sharded_solver_rejects_uneven_batch():
    scens = from_numpy(_batch(), Scenario, device="cpu",
                       dtype=torch.float64)
    with pytest.raises(ValueError):
        sharding.shard_of(scens, 0, 3)
    sl = sharding.shard_of(scens, 1, 4)
    assert sl.init_T.shape[0] == 4
    assert torch.equal(sl.init_T, scens.init_T[4:8])


def test_init_process_group_defaults_to_a_card(tmp_path, monkeypatch):
    """Entry points default to the card: with none, opening the group
    without a device raises rather than fall back to a CPU rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.init_process_group(0, 1, f"file://{tmp_path}/store")
    assert not torch.distributed.is_initialized()


def _dry_rank(rank, world, device, iters, per_rank):
    torch.set_num_threads(1)
    return dryrun.dryrun_multichip(rank, world, device, iters, per_rank)


def test_dryrun_legs_two_ranks(tmp_path):
    """The dry run's three legs on two CPU ranks (engine "rounds"), with
    budgets of 10 / 5 / 3 iterations and 2 / 2 / 8 lanes per rank."""
    legs = _ranks(tmp_path, _dry_rank, ((10, 5, 3), (2, 2, 8)))
    assert legs[0] == [dict(l, wall_s=legs[0][i]["wall_s"])
                       for i, l in enumerate(legs[1])]
    assert [l["leg"] for l in legs[0]] == ["bench", "gear_8_2",
                                           "per_rank_64"]
    assert [l["n_total"] for l in legs[0]] == [4.0, 4.0, 16.0]
    assert all(l["engine"] == "rounds" for l in legs[0])
    assert legs[0][1]["n_solved"] >= 1
