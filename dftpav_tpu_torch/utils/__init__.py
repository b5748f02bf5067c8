"""Auxiliary subsystems: metrics, checkpointing, serialization, profiling
(the port of `dftpav_tpu/utils/`, without its TPU-only executable cache,
compile-cache and vma shims).

A metrics registry with timers and throughput counters, pytree checkpoints
and a trajectory wire format whose files cross between this package and the
JAX one, and profiler hooks (torch.profiler traces, CUDA-event timing).
"""

from dftpav_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_pytree,
    save_pytree,
)
from dftpav_tpu_torch.utils.metrics import Metrics, TicToc  # noqa: F401
from dftpav_tpu_torch.utils.serialization import (  # noqa: F401
    load_trajectory,
    save_trajectory,
    trajectory_from_dict,
    trajectory_to_dict,
)
