"""SSC (spatio-temporal semantic corridor) planner, the urban back end (the
port of `dftpav_tpu/ssc/`): an (s, d, t) corridor of cubes around a
behavioural forward trajectory and a piecewise quintic Bezier QP solved by a
batched ADMM. Batch-first: every function takes leading batch dims (plans),
and the batched QP freezes each plan at its own exit, as `jax.vmap` of the
one-plan JAX functions does."""

from dftpav_tpu_torch.ssc.bezier import BezierSpline, bezier_eval  # noqa: F401
from dftpav_tpu_torch.ssc.corridor import (  # noqa: F401
    Corridor,
    build_corridor,
)
from dftpav_tpu_torch.ssc.planner import ssc_plan  # noqa: F401
from dftpav_tpu_torch.ssc.qp import admm_qp  # noqa: F401
