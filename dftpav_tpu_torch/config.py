"""Configuration for the planner, optimizer and solver.

Same fields and defaults as `dftpav_tpu.config` (the reference's deployed
values, minco_config.pb.txt), as plain frozen dataclasses. The TPU-only
engine knobs (`mxu`, `frame`, `clean_hist`, `obs_ckpt`, `phases`,
`t_prescale`) have no counterpart here: they tuned Mosaic layouts, MXU
passes and 128-lane tiles (see ROADMAP.md "Not to port").
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VehicleParam:
    """Car-like vehicle geometry (common::VehicleParam, semantics.h:66-76).
    ``d_cr`` is the rear-axle-to-body-center distance."""

    width: float = 1.90
    length: float = 4.88
    wheel_base: float = 2.85
    d_cr: float = 1.015
    max_steering_angle: float = 0.7  # rad

    def inflate(self, margin: float) -> "VehicleParam":
        """Grow width/length by 2*margin (traj_optimizer.cpp:1747-1748)."""
        return dataclasses.replace(
            self, width=self.width + 2.0 * margin,
            length=self.length + 2.0 * margin)


@dataclasses.dataclass(frozen=True)
class LBFGSParams:
    """L-BFGS parameters (lbfgs.hpp defaults as overridden by
    traj_optimizer.cpp:127-134). mem_size 16 is exact BFGS for the <= 16
    decision variables of the single-segment class."""

    mem_size: int = 16
    past: int = 3
    delta: float = 1.0e-4
    g_epsilon: float = 1.0e-16
    max_iterations: int = 12000
    max_linesearch: int = 24
    min_step: float = 1.0e-32
    max_step: float = 1.0e20
    f_dec_coeff: float = 1.0e-4
    s_curv_coeff: float = 0.9
    cautious_factor: float = 1.0e-6
    machine_prec: float = 1.0e-16


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """Back-end optimizer configuration (opt_cfg, minco_config.pb.txt:65-100)."""

    traj_resolution: int = 16
    destraj_resolution: int = 32
    wei_obs: float = 1000.0
    wei_surround: float = 5000.0
    wei_feas: float = 2500.0
    wei_sqrvar: float = 500.0
    wei_time: float = 500.0
    surround_clearance: float = 0.4
    half_margin: float = 0.15
    traj_piece_duration: float = 1.0

    max_forward_vel: float = 5.0
    max_forward_acc: float = 8.0
    max_forward_cur: float = 1.0
    max_backward_vel: float = 2.0
    max_backward_acc: float = 4.0
    max_backward_cur: float = 1.0
    max_latacc: float = 5.0
    max_phidot: float = 10000.0

    non_sinv: float = 0.24
    gear_opt: bool = True
    mini_t: float = 0.1
    epis: float = 0.0
    lse_alpha: float = 100.0

    lbfgs: LBFGSParams = dataclasses.field(default_factory=LBFGSParams)

    reject_cost: float = 50000.0
    # Objective scaling: keeps the float32 past-delta stop test meaningful
    # (raw costs ~1e3-1e4 would drown the 1e-4 relative test in rounding).
    cost_scale: float = 1.0e-3

    # Reproduce the reference's segment-time-offset quirk: costFunctionCallback
    # builds trajtimes = [0, T0, T1, ...] (traj_optimizer.cpp:230-234), so
    # segment i >= 2 is offset by T_{i-1} alone instead of sum(T[:i]). The
    # default uses the true cumulative sum; golden parity runs against the
    # compiled C++ at S >= 3 only (cost.total_cost, ops/bcost.py).
    ref_trajtime_compat: bool = False

    # Also reproduce the reference's cross-segment time-gradient
    # misattribution (traj_optimizer.cpp:1674-1676): the per-scenario engine
    # then follows the compiled C++ iterate path for S >= 2 with obstacles
    # (cost.ref_compat_value_and_grad; make_solver(engine="vmap") only).
    ref_gradient_compat: bool = False

    # Corridor-penalty backend of the batch-minor engine (ops/bcost.py):
    # "xla" the plain broadcast form, "pallas" the CorridorPenalty function
    # of ops/pallas_penalty.py (CUDA kernels for CUDA tensors, its plain
    # forward and backward for CPU tensors), "auto" "pallas" for CUDA
    # tensors and "xla" otherwise. The names are the JAX package's; its
    # default is "xla", this one's "auto", so that CUDA tensors run the
    # corridor kernels K2/K3 without a flag ("xla" stays the reference).
    corridor_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class EngineFlags:
    """Solver knobs shared by the plain round loop and the CUDA solve.

    Defaults are the lbfgs.hpp parity semantics; `tuned()` is the
    benchmark stack.

    adaptive_step: the next line search starts from the lane's previous
        accepted step x mult, clipped to [lo, 1], instead of 1.0.
    vt_scale: virtual-time preconditioning sigma (float, per-slot tuple or
        "auto"; see resolve_vt_scale).
    """

    adaptive_step: bool = False
    adaptive_step_lo: float = 0.5
    adaptive_step_mult: float = 2.0
    vt_scale: float | tuple | str = 1.0

    @staticmethod
    def tuned() -> "EngineFlags":
        return EngineFlags(adaptive_step=True, adaptive_step_lo=1e-3,
                           adaptive_step_mult=1.2, vt_scale="auto")


def resolve_vt_scale(vt_scale, ns_tuple) -> tuple:
    """Per-segment-slot virtual-time sigma: "auto" gives
    sigma_s = min(1, 2 / Ns[s]) (0.25 for an 8-piece slot)."""
    if vt_scale == "auto":
        return tuple(min(1.0, 2.0 / n) for n in ns_tuple)
    if isinstance(vt_scale, (int, float)):
        return (float(vt_scale),) * len(ns_tuple)
    assert len(vt_scale) == len(ns_tuple), (vt_scale, ns_tuple)
    return tuple(float(v) for v in vt_scale)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Kinodynamic A* front end (map_cfg, minco_config.pb.txt:13-63,
    kino_astar.cpp:372-442)."""

    map_size_x: float = 1000.0
    map_size_y: float = 1000.0
    horizon: float = 50.0
    yaw_resolution: float = 0.3
    lambda_heu: float = 5.0
    allocate_num: int = 100000
    check_num: int = 5
    max_search_time: float = 1.0
    traj_forward_penalty: float = 1.0
    traj_back_penalty: float = 2.5
    traj_gear_switch_penalty: float = 15.0
    traj_steer_penalty: float = 0.5
    traj_steer_change_penalty: float = 0.0
    map_resolution: float = 0.3
    step_arc: float = 0.9
    checkl: float = 0.2
    oneshot_range: float = 15.0     # Reeds-Shepp one-shot within this range
    max_frontend_forward_vel: float = 5.0
    max_frontend_forward_acc: float = 8.0
    max_frontend_backward_vel: float = 2.0
    max_frontend_backward_acc: float = 4.0
    max_frontend_cur: float = 1.0
    non_siguav: float = 0.2         # near-zero speed (kino_astar.h:207)
    collision_margin: float = 0.2   # A* vehicle inflation (kino_astar.cpp:426)
    sample_time: float = 0.1        # flat-trajectory resampling period
    # yaw-keyed node table first, the 2D key on failure (the reference's
    # use3d retry, traj_manager.cpp:85-93)
    use3d: bool = True


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    vehicle: VehicleParam = dataclasses.field(default_factory=VehicleParam)
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    frontend: FrontendConfig = dataclasses.field(
        default_factory=FrontendConfig)

    replan_rate_hz: float = 20.0
    control_rate_hz: float = 100.0
    plan_budget_s: float = 0.5

    def ego_hull(self):
        """Clockwise body-frame hull of the optimizer-inflated vehicle about
        the rear axle (traj_optimizer.cpp:1760-1770), as 4 (x, y) pairs."""
        vp = self.vehicle.inflate(self.opt.half_margin)
        hl, hw, dcr = vp.length / 2.0, vp.width / 2.0, vp.d_cr
        return [
            (dcr + hl, hw),
            (dcr + hl, -hw),
            (dcr - hl, -hw),
            (dcr - hl, hw),
        ]
