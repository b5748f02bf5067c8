"""ctypes binding of the native front end (native/dftpav_native.cpp at the
root of the repository).

The library is built on first use with g++ (the flags of native/build.sh)
into dftpav_tpu_torch/_build/, under a name keyed by a hash of the source
and the flags, so an edited source rebuilds by itself. The search, the
Reeds-Shepp curves and the corridor growth run in C++; this layer marshals
numpy arrays.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import pathlib
import shutil
import subprocess
from dataclasses import dataclass

import numpy as np

SOURCE = (pathlib.Path(__file__).resolve().parents[2] / "native"
          / "dftpav_native.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-Wall", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> pathlib.Path:
    """Path of the shared library for the current source (built or not)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdftpav_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile native/dftpav_native.cpp with g++ unless the library for it
    exists; returns its path."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the front end is built from "
                           "native/dftpav_native.cpp on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _load():
    """The loaded front-end library (built on first call), its entry points
    typed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ct.CDLL(str(build()))
    D, P, I = ct.c_double, ct.c_void_p, ct.c_int
    dp = ct.POINTER(ct.c_double)
    sigs = {
        "df_map_create": (P, [I, I, D, D, D, ct.POINTER(ct.c_uint8)]),
        "df_map_destroy": (None, [P]),
        "df_map_occupied": (I, [P, D, D]),
        "df_map_obb_collides": (I, [P, D, D, D, D, D, D]),
        "df_map_line_collides": (I, [P, D, D, D, D, D]),
        "df_rs_distance": (D, [D, dp, dp]),
        "df_rs_sample": (None, [D, dp, dp, I, dp]),
        "df_plan": (P, [P, dp, dp, dp, dp]),
        "df_plan_status": (I, [P]),
        "df_plan_total_time": (D, [P]),
        "df_plan_nsegs": (I, [P]),
        "df_plan_seg_npts": (I, [P, I]),
        "df_plan_seg_singul": (I, [P, I]),
        "df_plan_seg_duration": (D, [P, I]),
        "df_plan_seg_data": (None, [P, I, dp, dp, dp, dp]),
        "df_plan_nsamples": (I, [P]),
        "df_plan_samples": (None, [P, dp]),
        "df_plan_destroy": (None, [P]),
        "df_corridors": (None, [P, dp, I, D, D, D, D, dp]),
        "df_plan_segment_scenario": (None, [P, P, I, I, I, D, D, D, D, D,
                                            dp, dp, dp, dp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_double))


class GridMap2D:
    """Occupancy grid with the reference's collision checks (outside the
    map counts as occupied; box checks sample the perimeter)."""

    def __init__(self, occ: np.ndarray, origin=(0.0, 0.0), resolution=0.1):
        lib = _load()
        occ = np.ascontiguousarray(occ, dtype=np.uint8)
        self.occ = occ
        self.origin = origin
        self.resolution = float(resolution)
        self.ny, self.nx = occ.shape
        self._h = lib.df_map_create(
            self.nx, self.ny, float(origin[0]), float(origin[1]),
            self.resolution, occ.ctypes.data_as(ct.POINTER(ct.c_uint8)))

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.df_map_destroy(self._h)

    def occupied(self, x, y) -> bool:
        return bool(_load().df_map_occupied(self._h, float(x), float(y)))

    def obb_collides(self, x, y, yaw, length, width, d_cr) -> bool:
        return bool(_load().df_map_obb_collides(
            self._h, float(x), float(y), float(yaw), float(length),
            float(width), float(d_cr)))

    def line_collides(self, p0, p1, spacing) -> bool:
        return bool(_load().df_map_line_collides(
            self._h, float(p0[0]), float(p0[1]), float(p1[0]), float(p1[1]),
            float(spacing)))

    def corridors(self, states: np.ndarray, veh_length, veh_width, d_cr,
                  limit=10.0) -> np.ndarray:
        """Grown rectangles per state (x, y, yaw): [n, 4, 4] rows of
        (nx, ny, px, py) outward half-planes (left, front, right, back)."""
        states = np.ascontiguousarray(states, dtype=np.float64)
        n = states.shape[0]
        out = np.empty((n, 4, 4), dtype=np.float64)
        _load().df_corridors(self._h, _dptr(states), n, float(veh_length),
                             float(veh_width), float(d_cr), float(limit),
                             _dptr(out))
        return out


def reeds_shepp_distance(radius, q0, q1) -> float:
    q0 = np.ascontiguousarray(q0, dtype=np.float64)
    q1 = np.ascontiguousarray(q1, dtype=np.float64)
    return float(_load().df_rs_distance(float(radius), _dptr(q0), _dptr(q1)))


def reeds_shepp_sample(radius, q0, q1, n) -> np.ndarray:
    q0 = np.ascontiguousarray(q0, dtype=np.float64)
    q1 = np.ascontiguousarray(q1, dtype=np.float64)
    out = np.empty((n, 3), dtype=np.float64)
    _load().df_rs_sample(float(radius), _dptr(q0), _dptr(q1), n, _dptr(out))
    return out


@dataclass
class FlatSegment:
    """One single-gear segment of the front-end trajectory
    (plan_utils::FlatTrajData, traj_container.hpp:18-34)."""

    singul: int
    pts: np.ndarray          # [M, 3] (x, y, dt)
    thetas: np.ndarray       # [M]
    start_state: np.ndarray  # [2, 3] flat PVA
    final_state: np.ndarray  # [2, 3]
    duration: float


class KinoAstarPlanner:
    """Kinodynamic A* front end (path_searching::KinoAstar)."""

    def __init__(self, grid: GridMap2D, cfg=None, vehicle=None):
        from dftpav_tpu_torch.config import FrontendConfig, VehicleParam
        self.grid = grid
        self.cfg = cfg or FrontendConfig()
        self.vehicle = vehicle or VehicleParam()

    def _params(self) -> np.ndarray:
        """The native planner's parameter vector (its order)."""
        c, v = self.cfg, self.vehicle
        return np.array([
            v.wheel_base, v.length + 2 * c.collision_margin,
            v.width + 2 * c.collision_margin, v.d_cr, c.max_frontend_cur,
            c.step_arc, c.map_resolution, c.yaw_resolution, c.lambda_heu,
            c.max_search_time, c.check_num, c.allocate_num, c.oneshot_range,
            c.checkl, c.traj_forward_penalty, c.traj_back_penalty,
            c.traj_gear_switch_penalty, c.traj_steer_penalty,
            c.traj_steer_change_penalty, c.horizon,
            c.max_frontend_forward_vel, c.max_frontend_forward_acc,
            c.max_frontend_backward_vel, c.max_frontend_backward_acc,
            c.non_siguav, c.sample_time, 1.0 if c.use3d else 0.0,
        ], dtype=np.float64)

    def plan(self, start, end, start_ctrl=(0.0, 0.0)):
        """start / end: (x, y, yaw, signed v). Returns (segments,
        sample_traj), or (None, None) when no path is found."""
        lib = _load()
        s = np.ascontiguousarray(start, dtype=np.float64)
        e = np.ascontiguousarray(end, dtype=np.float64)
        sc = np.ascontiguousarray(start_ctrl, dtype=np.float64)
        p = self._params()
        h = lib.df_plan(self.grid._h, _dptr(p), _dptr(s), _dptr(sc), _dptr(e))
        try:
            if lib.df_plan_status(h) != 1:
                return None, None
            segs = []
            for i in range(lib.df_plan_nsegs(h)):
                m = lib.df_plan_seg_npts(h, i)
                pts = np.empty((m, 3), np.float64)
                thetas = np.empty((m,), np.float64)
                ss = np.empty((6,), np.float64)
                es = np.empty((6,), np.float64)
                lib.df_plan_seg_data(h, i, _dptr(pts), _dptr(thetas),
                                     _dptr(ss), _dptr(es))
                segs.append(FlatSegment(
                    singul=lib.df_plan_seg_singul(h, i), pts=pts,
                    thetas=thetas, start_state=ss.reshape(3, 2).T.copy(),
                    final_state=es.reshape(3, 2).T.copy(),
                    duration=lib.df_plan_seg_duration(h, i)))
            ns = lib.df_plan_nsamples(h)
            samples = np.empty((ns, 3), np.float64)
            lib.df_plan_samples(h, _dptr(samples))
            return segs, samples
        finally:
            lib.df_plan_destroy(h)
