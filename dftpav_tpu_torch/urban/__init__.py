"""Urban driving stack: lanes, Frenet transforms, car-following and
lane-change models, MPDM and EUDM behaviour planning, the behaviour server
(the port of `dftpav_tpu/urban/`).

Batch-first: every function takes leading batch dims where the JAX package
vmaps (over agents, behaviours or scenes), and the horizon is a Python loop
over a fixed number of steps. Entry points run on the card unless the
caller passes CPU tensors.
"""

from dftpav_tpu_torch.urban.lane import (  # noqa: F401
    Lane,
    LaneSet,
    build_lane,
    frenet_of_point,
    frenet_of_state,
    lane_point,
    state_of_frenet,
)
