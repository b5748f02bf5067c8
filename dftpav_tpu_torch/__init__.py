"""dftpav_tpu_torch -- the batched MINCO trajectory optimizer in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of `dftpav_tpu` (JAX on a TPU), which stays beside it as the
reference. Ported: the batched whole-solve of the parking classes
(scenarios -> solver.make_solver(engine="fused") ->
ops.pallas_solve.solve_batch_fused -> kernels A and B in csrc/), the
batch-minor engine (solver.make_solver(engine="bminor") -> ops.blbfgs over
ops.bcost, whose corridor term is kernels K2 and K3 in csrc/), the front end
(frontend, pipeline), the replanning path above the solver: warm and
gated replan streams (replan), the executing trajectory (container), and the
bicycle plant and closed-loop planner server (sim); the park demo's
playgrounds and figures (playgrounds, viz; examples/park_demo_torch.py) and
the host geometry (geo, corridor_builders); the per-scenario reference
engine (solver.make_solver(engine="vmap") over cost.total_cost and
lbfgs.minimize); the urban path (urban: lanes, forward simulation, MPDM,
EUDM and the behaviour server; ssc: corridor and QP; sim.arena;
examples/urban_demo_torch.py), which has no kernel; the scenario-parallel
solver over torch.distributed (parallel: kernels A and B, or K2 / K3, per
rank); and the host utilities (utils: metrics, checkpoints and the
trajectory wire format shared with the JAX package, profiling).
"""

from dftpav_tpu_torch import config as config
from dftpav_tpu_torch import types as types

__version__ = "0.1.0"
