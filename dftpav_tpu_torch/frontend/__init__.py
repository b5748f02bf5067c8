"""Host-side front end: occupancy grid, kinodynamic A*, Reeds-Shepp curves
and corridor growth, in native C++ (native/dftpav_native.cpp) bound with
ctypes."""

from dftpav_tpu_torch.frontend.native import (  # noqa: F401
    GridMap2D,
    KinoAstarPlanner,
    reeds_shepp_distance,
    reeds_shepp_sample,
)
