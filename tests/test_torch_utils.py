"""The port's utils against the JAX package's on the CPU: the metrics
summary, the trajectory wire format (the JSON text identical) and the
checkpoint format (files written by either package load in the other,
leaves in jax.tree.flatten's order: dict keys sorted, None an empty
subtree), and the profiling hooks (a torch.profiler trace file, host-clock
timing of CPU tensors)."""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dftpav_tpu import utils as jutils
from dftpav_tpu_torch import utils
from dftpav_tpu_torch.utils import checkpoint, profiling

from _torch_capture import fds_to_file


class Pair(NamedTuple):
    a: object
    b: object


def _records(m):
    m.count("solves", 64)
    m.count("solves", 32.5)
    m.count("fails")
    for v in (3.0, 1.5, 7.25, 2.0, 9.5):
        m.record("step", v)
    m.record("replan", 11.0)
    m.throughput("solves", 1000, 2.0)
    return m


def test_metrics_summary_matches_jax():
    ours, theirs = _records(utils.Metrics()), _records(jutils.Metrics())
    assert ours.summary() == theirs.summary()
    assert ours.dumps() == theirs.dumps()
    with ours.timer("t"):
        pass
    assert ours.summary()["t"]["n"] == 1
    ours.reset()
    assert ours.summary() == {}
    t = utils.TicToc()
    assert t.toc() >= 0.0


def _trajectory():
    rng = np.random.default_rng(2)
    return rng.normal(size=(2, 4, 6, 2)), np.array([0.9, 1.1]), \
        np.array([1, -1])


def test_trajectory_wire_format_matches_jax(tmp_path):
    coeffs, dT, singul = _trajectory()
    ours = utils.trajectory_to_dict(torch.from_numpy(coeffs),
                                    torch.from_numpy(dT),
                                    torch.from_numpy(singul), 3.25)
    theirs = jutils.trajectory_to_dict(coeffs, dT, singul, 3.25)
    assert json.dumps(ours) == json.dumps(theirs)
    assert ours["format"] == "dftpav_tpu/poly_traj@1"
    # a file of each package loads in the other
    p_ours, p_theirs = str(tmp_path / "o.json"), str(tmp_path / "t.json")
    utils.save_trajectory(p_ours, coeffs, dT, singul, 3.25)
    jutils.save_trajectory(p_theirs, coeffs, dT, singul, 3.25)
    assert open(p_ours).read() == open(p_theirs).read()
    for got in (jutils.load_trajectory(p_ours),
                utils.load_trajectory(p_theirs)):
        np.testing.assert_array_equal(got[0], coeffs)
        np.testing.assert_array_equal(got[1], dT)
        assert got[2].tolist() == [1, -1] and got[3] == 3.25
    with pytest.raises(ValueError):
        utils.trajectory_from_dict({"format": "other"})


def _tree(rng, leaf):
    """A tree with unsorted dict keys, a None field, a NamedTuple, a list
    and a tuple; `leaf` maps each numpy array to the package's type."""
    return {
        "zeta": leaf(rng.normal(size=(3, 2))),
        "alpha": Pair(a=leaf(np.arange(5, dtype=np.int32)), b=None),
        "mid": None,
        "beta": [leaf(np.array([True, False, True])),
                 (leaf(rng.normal(size=4)), leaf(np.array(2.5)))],
    }


def test_checkpoint_files_cross_between_packages(tmp_path):
    ours = _tree(np.random.default_rng(0), torch.from_numpy)
    theirs = _tree(np.random.default_rng(0), jnp.asarray)
    leaves = checkpoint.tree_flatten(ours)
    jleaves = jax.tree.leaves(theirs)
    assert len(leaves) == len(jleaves) == 5
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    p_ours, p_theirs = str(tmp_path / "ours.npz"), str(tmp_path / "j.npz")
    utils.save_pytree(p_ours, ours, metadata={"step": 7})
    jutils.save_pytree(p_theirs, theirs, metadata={"step": 9})
    with open(p_ours + ".json") as f:
        assert json.load(f)["n_leaves"] == 5

    got_j, meta_j = jutils.load_pytree(p_ours, theirs)    # ours in JAX
    got_o, meta_o = utils.load_pytree(p_theirs, ours)     # JAX's in ours
    assert meta_j == {"step": 7} and meta_o == {"step": 9}
    assert jax.tree.structure(got_j) == jax.tree.structure(theirs)
    assert got_o["mid"] is None and got_o["alpha"].b is None
    assert isinstance(got_o["alpha"], Pair) and list(got_o) == list(ours)
    for a, b, c in zip(checkpoint.tree_flatten(got_o),
                       jax.tree.leaves(got_j), leaves):
        assert torch.is_tensor(a) and a.dtype == c.dtype
        np.testing.assert_array_equal(a.numpy(), c.numpy())
        np.testing.assert_array_equal(np.asarray(b), c.numpy())
    # a path without the suffix, as JAX's loader accepts it
    base = str(tmp_path / "plain")
    utils.save_pytree(base, ours, metadata={"step": 3})
    assert os.path.exists(base + ".npz") and os.path.exists(base + ".json")
    again, meta = utils.load_pytree(base, ours)
    assert meta == {"step": 3}
    np.testing.assert_array_equal(again["zeta"].numpy(),
                                  ours["zeta"].numpy())
    with pytest.raises(ValueError):
        utils.load_pytree(p_ours, {"only": torch.zeros(1)})


def test_profiling_trace_and_cpu_timing(tmp_path):
    x = torch.randn(64, 64, dtype=torch.float64)
    with fds_to_file(), profiling.trace(str(tmp_path / "prof")):
        y = x @ x
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert profiling.sync(y) == float(y[0, 0])
    assert profiling.sync({"b": [y], "a": None}) == float(y[0, 0])
    ms = profiling.device_time_ms(lambda a, b: a @ b, (x, x), k=3, reps=2)
    assert ms > 0.0
