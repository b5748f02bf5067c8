"""Scenario data-parallel solver over torch.distributed (the port of
`dftpav_tpu/parallel/sharding.py`, whose jax.sharding.Mesh and shard_map
become a process group and a rank's slice).

Per-scenario solver state stays on its rank's device (problems are
kilobytes; nothing is model-sharded); the batch axis is split into
contiguous slices, one per rank; the only communication is one all-reduce
of the statistics JAX psums. One process per rank: `nccl` between cards,
`gloo` on CPU ranks (gloo also all-reduces CUDA tensors, so several ranks
may share one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dftpav_tpu_torch import solver
from dftpav_tpu_torch.config import PlannerConfig
from dftpav_tpu_torch.types import Dims, Scenario, SolveResult, Weights

METRIC_KEYS = ("n_solved", "n_total", "iters_sum", "cost_sum")


def init_process_group(rank: int, world_size: int, init_method: str,
                       device="cuda", backend: str | None = None):
    """Open the default process group for this rank: `backend` (default:
    nccl for a CUDA device, gloo otherwise) over an explicit `init_method`
    (a `file://` store or `tcp://127.0.0.1:<port>`). Where `device` is a
    card (a bare "cuda" means card `rank` modulo the card count), makes it
    this process's current CUDA device; raises with no card (pass
    device="cpu" for a CPU rank). Returns the rank's torch.device. Close
    the group with torch.distributed.destroy_process_group()."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: no CUDA device; pass "
                               "device=\"cpu\" for a CPU rank")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return device


def shard_of(batch: Scenario, rank: int, world: int) -> Scenario:
    """Rank `rank`'s contiguous slice of a batch whose size divides evenly
    by `world`."""
    B = batch.init_T.shape[0]
    if B % world:
        raise ValueError(f"batch {B} does not divide over {world} ranks")
    n = B // world
    return Scenario(*(a[rank * n:(rank + 1) * n] for a in batch))


def metrics_of(res: SolveResult) -> torch.Tensor:
    """[4] float32 on the result's device, in METRIC_KEYS order: solved and
    total lanes, the sum of iterations, and the sum of the successful
    lanes' costs, each summed in float32 as JAX's `_metrics_of` does."""
    ok = res.success.to(torch.float32)
    return torch.stack([
        ok.sum(),
        torch.tensor(float(res.cost.shape[0]), dtype=torch.float32,
                     device=ok.device),
        res.n_iters.to(torch.float32).sum(),
        torch.where(res.success, res.cost, 0.0).to(torch.float32).sum()])


def make_sharded_solver(cfg: PlannerConfig, dims: Dims,
                        max_iterations: int | None = None,
                        engine: str | None = None,
                        weights: Weights | None = None, flags=None,
                        group=None):
    """A solver that splits the scenario batch over the ranks of `group`
    (the default process group unless given).

    Returns fn(batch: Scenario[B, ...], w: Weights) -> (SolveResult of this
    rank's slice, metrics): every rank passes the whole batch, B must
    divide evenly by the world size, and rank r solves lanes [r B / world,
    (r + 1) B / world) through `solver.make_solver` on the batch's device
    (`engine=None`: make_solver's default). metrics is a dict of the
    all-reduced (SUM) float32 scalars n_solved, n_total, iters_sum and
    cost_sum (successful lanes), the same on every rank.

    `weights` is accepted for the JAX signature, where the fused kernel
    bakes its weights at trace time: the port's fused engine takes them per
    call, so it is used only where the call passes w=None.
    """
    kw = {} if engine is None else {"engine": engine}
    local = solver.make_solver(cfg, dims, max_iterations=max_iterations,
                               flags=flags, **kw)

    def fn(batch: Scenario, w: Weights | None = None):
        rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        res = local(shard_of(batch, rank, world),
                    weights if w is None else w)
        m = metrics_of(res)
        dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
        return res, dict(zip(METRIC_KEYS, m.unbind()))

    return fn
