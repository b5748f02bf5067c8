"""Multi-GPU scaling: scenario data parallelism over torch.distributed (the
port of `dftpav_tpu/parallel/`).

Scenarios are embarrassingly parallel: each rank solves its contiguous
slice of the batch on its own device, and the only collective is one
all-reduce of convergence and throughput statistics.
"""

from dftpav_tpu_torch.parallel.sharding import (  # noqa: F401
    init_process_group,
    make_sharded_solver,
)
