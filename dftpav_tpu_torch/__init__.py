"""dftpav_tpu_torch -- the batched MINCO trajectory optimizer in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of `dftpav_tpu` (JAX on a TPU), which stays beside it as the
reference. This slice covers the batched whole-solve of the single-segment
parking class: scenarios -> solver.make_solver(engine="fused") ->
ops.pallas_solve.solve_batch_fused -> the CUDA kernels in csrc/.
"""

from dftpav_tpu_torch import config as config
from dftpav_tpu_torch import types as types

__version__ = "0.1.0"
