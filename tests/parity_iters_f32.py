"""Iterations in float32: the port's plain round loop against the JAX
package's round loop ("rounds" engine, mxu="f32", no lane-compaction
phases) on the bench fixture, on the CPU. Not a pytest module (it takes
minutes); run it from the repo root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/parity_iters_f32.py [B]

B defaults to 1024 (the bench fixture's first lanes, seed 7, 2 obstacles,
tuned flags, 150 iterations). Prints one JSON line: success, cost p50 and
iterations p50 / p90 / p99 of both, and the share of lanes whose
12-iteration paths (status, k, evals) are equal.
"""

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dftpav_tpu import config as jconfig
from dftpav_tpu import scenarios as jscen
from dftpav_tpu import solver as jsolver
from dftpav_tpu.ops import kcost as jkcost
from dftpav_tpu.ops import pallas_solve as jps
from dftpav_tpu.types import Dims as JDims
from dftpav_tpu.types import weights_from_config as jweights

from dftpav_tpu_torch import scenarios
from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
from dftpav_tpu_torch.ops import kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config


def main(B=1024, iters=150):
    kw = dict(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)
    dims, jdims = Dims(**kw), JDims(**kw)
    npb = scenarios.batch_scenarios(dims, B, seed=7, dtype=np.float32,
                                    n_obstacles=2)
    jnpb = jscen.batch_scenarios(jdims, B, seed=7, dtype=np.float32,
                                 n_obstacles=2)
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(npb, jnpb))
    jflags = dataclasses.replace(jconfig.EngineFlags.tuned(), mxu="f32",
                                 phases=())
    flags = EngineFlags.tuned()
    jcfg, cfg = jconfig.PlannerConfig(), PlannerConfig()
    jw = jweights(jcfg.opt, jnp.float32)
    w = weights_from_config(cfg.opt, torch.float32, device="cpu")
    jb = jax.tree.map(jnp.asarray, jnpb)
    b = from_numpy(npb, Scenario, device="cpu", dtype=torch.float32)

    t0 = time.perf_counter()
    jr = jax.tree.map(np.asarray, jsolver.make_solver(
        jcfg, jdims, iters, engine="rounds", flags=jflags)(jb, jw))
    t_jax = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = pallas_solve.solve_batch_rounds(b, w, dims, cfg, iters, flags=flags)
    t_port = time.perf_counter() - t0

    _b, x0, sc, kc, _D = pallas_solve._prep(b, w, dims, torch.float32,
                                            "auto")
    raw = pallas_solve._solve_rounds(x0, sc, kc, kcost.StaticW.build(w, cfg),
                                     dims, cfg.opt.lbfgs, 12, flags)
    sig = jconfig.resolve_vt_scale(jflags.vt_scale, jdims.ns_tuple)
    _jb, jx0, jsc, jkc, _jD = jps._prep(jb, jw, jdims, jcfg, jnp.float32,
                                        sig)
    jraw = jax.tree.map(np.asarray, jps._solve_rounds(
        jx0, jsc, jkc, jkcost.StaticW.build(jw, jcfg), jdims,
        jcfg.opt.lbfgs, 12, flags=jflags))
    eq12 = ((raw.status.numpy() == jraw.status[0])
            & (raw.k.clamp(max=12).numpy() == np.minimum(jraw.k[0], 12))
            & (raw.n_evals.numpy() == jraw.n_evals[0]))

    def pcts(a):
        return [float(np.percentile(np.asarray(a, float), q))
                for q in (50, 90, 99)]

    print(json.dumps(dict(
        B=B, same_fixture=same, jax_seconds=t_jax, port_seconds=t_port,
        jax=dict(success=float(np.mean(jr.success)),
                 cost_p50=float(np.median(jr.cost)),
                 iters_p50_p90_p99=pcts(jr.n_iters)),
        port=dict(success=float(r.success.float().mean()),
                  cost_p50=float(np.median(r.cost.numpy())),
                  iters_p50_p90_p99=pcts(r.n_iters.numpy())),
        share_12iter_equal=float(eq12.mean()),
        x0_max_abs_diff=float(np.abs(x0.numpy() - np.asarray(jx0)).max()))))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
