"""Simulation stack: bicycle plant, moving obstacles and the closed-loop
planner server (the phy_simulator / vehicle_model / TrajPlannerServer
equivalents without ROS)."""

from dftpav_tpu_torch.sim.vehicle import BicycleModel, VehicleState  # noqa: F401
from dftpav_tpu_torch.sim.obstacles import (  # noqa: F401
    CircularMover,
    fit_surround_trajs,
)
from dftpav_tpu_torch.sim.server import PlannerServer, SimLoop  # noqa: F401
