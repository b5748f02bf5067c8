"""Sharded-solver dry run over N ranks (the counterpart of JAX's
`__graft_entry__.dryrun_multichip`), and the spawner that runs a function on
N ranks with the process group open.

    python -m dftpav_tpu_torch.parallel.dryrun --nproc 2 --device cpu
    python -m dftpav_tpu_torch.parallel.dryrun --nproc 1 --device cuda
    python -m dftpav_tpu_torch.parallel.dryrun --nproc 2 --device cuda \\
        --backend gloo      # two ranks on one card

Three legs, each one sharded solve whose all-reduced metrics are checked:
  1. the bench class (Dims(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8),
     batch_scenarios seed 7, float32, 2 obstacles) at 150 iterations;
  2. the (8, 2) per-segment two-gear class (Dims.Ns) on stacked
     gear_scenario copies at 60 iterations with EngineFlags.tuned();
  3. 64 scenarios per rank of the bench class at 25 iterations (compile and
     execution at a deployment batch shape, not convergence statistics).
The engine is "fused" (kernels A and B) on CUDA ranks and "rounds" (the
plain round loop) on CPU ranks, as JAX runs "rounds" on its CPU mesh.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from dftpav_tpu_torch.parallel.sharding import (init_process_group,
                                                make_sharded_solver)

LEG_ITERS = (150, 60, 25)
LEG_PER_RANK = (2, 2, 64)


def _rank_entry(tx, target, rank, world, init_method, device, backend, args):
    """One spawned rank: open the group, run target(rank, world, device,
    *args), send its result (or the traceback) back, close the group."""
    try:
        dev = init_process_group(rank, world, init_method, device, backend)
        try:
            tx.send(target(rank, world, dev, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:      # reported by the parent, which raises
        tx.send(RuntimeError(f"rank {rank}:\n{traceback.format_exc()}"))
    finally:
        tx.close()


def run_ranks(target, world: int, args=(), device="cuda",
              backend: str | None = None, timeout: float = 600.0,
              init_method: str | None = None) -> list:
    """Run target(rank, world, device, *args) in `world` spawned processes
    with the default process group open (over `init_method`, by default a
    file:// store in a temporary directory; `backend` as
    init_process_group picks it), rank r on `device` (a bare "cuda" means
    card r modulo the card count; with no card the ranks raise). Returns
    the ranks' return values in rank
    order; raises if a rank raised, died without a result, or gave none
    within `timeout` seconds. Every process is joined (or terminated)
    before it returns."""
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init = init_method or "file://" + os.path.join(tmp, "store")
        pipes, procs = [], []
        try:
            for r in range(world):
                rx, tx = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_rank_entry, daemon=True, args=(
                    tx, target, r, world, init, str(device), backend, args))
                p.start()
                tx.close()
                pipes.append(rx)
                procs.append(p)
            out = []
            for r, rx in enumerate(pipes):
                if not rx.poll(max(0.0, deadline - time.monotonic())):
                    raise TimeoutError(f"rank {r}: no result in {timeout} s")
                try:
                    got = rx.recv()
                except EOFError:
                    raise RuntimeError(f"rank {r} exited without a result "
                                       f"(code {procs[r].exitcode})") from None
                if isinstance(got, BaseException):
                    raise got
                out.append(got)
            return out
        finally:
            for p in procs:
                p.join(timeout=max(5.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.terminate()
                    p.join()


def bench_batch(dims, B, device):
    """The bench fixture: batch_scenarios(B, seed 7, float32, 2 obstacles)
    on `device` (lane b is the same for every B)."""
    from dftpav_tpu_torch import scenarios
    from dftpav_tpu_torch.types import Scenario, from_numpy

    return from_numpy(scenarios.batch_scenarios(
        dims, B, seed=7, dtype=np.float32, n_obstacles=2), Scenario,
        device=device, dtype=torch.float32)


def dryrun_multichip(rank: int, world: int, device, iters=LEG_ITERS,
                     per_rank=LEG_PER_RANK):
    """The three legs (module docstring) on the open default process group,
    each rank on `device`; `iters` and `per_rank` give each leg's iteration
    budget and lanes per rank; the engine follows the device (module
    docstring). Returns one dict per leg (the all-reduced
    metrics, the batch, engine and this rank's wall seconds); raises where
    a leg's metrics are wrong."""
    from dftpav_tpu_torch import scenarios
    from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
    from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
        weights_from_config

    device = torch.device(device)
    engine = "fused" if device.type == "cuda" else "rounds"
    cfg = PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float32, device=device)
    dims = Dims(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)
    dims2 = Dims(S=2, N=8, K=16, Kdes=32, H=4, O=2, Po=8, Ns=(8, 2))
    gear = scenarios.stack_scenarios(
        [scenarios.gear_scenario(dims2)] * (per_rank[1] * world))
    gear = from_numpy(gear, Scenario, device=device, dtype=torch.float32)
    legs = [
        ("bench", dims, bench_batch(dims, per_rank[0] * world, device), None),
        ("gear_8_2", dims2, gear, EngineFlags.tuned()),
        ("per_rank_64", dims, bench_batch(dims, per_rank[2] * world, device),
         None),
    ]
    out = []
    for (name, d, batch, flags), n_it, n_rank in zip(legs, iters, per_rank):
        fn = make_sharded_solver(cfg, d, max_iterations=n_it, engine=engine,
                                 flags=flags)
        t0 = time.perf_counter()
        _res, metrics = fn(batch, w)
        stats = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0
        if stats["n_total"] != n_rank * world:
            raise RuntimeError(f"dry run leg {name}: {stats}")
        if name == "gear_8_2" and stats["n_solved"] < 1:
            raise RuntimeError(f"dry run leg {name} solved nothing: {stats}")
        out.append(dict(leg=name, engine=engine, B=n_rank * world,
                        iters=n_it, wall_s=wall, **stats))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on card r modulo the count) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device; pass --device cpu")
    legs = run_ranks(dryrun_multichip, args.nproc, device=args.device,
                     backend=args.backend, timeout=900.0)
    for leg in legs[0]:
        print(json.dumps(dict(leg, world=args.nproc)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
