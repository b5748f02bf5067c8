"""Scenario asset loader (the port's copy of `dftpav_tpu/playgrounds.py`).

Replaces the reference's playground JSON trees
(src/Sim/core/playgrounds/*/{vehicle_set,obstacles_norm,...}.json) with a
single self-describing JSON per scene: map raster spec, box obstacles, ego
start/goal, circulating movers. The assets are the repo's
`playgrounds/*.json`, read in place.

A scene with a lane net (`highway_v1`, `ring_v1`) also carries its LaneSet
(built by `urban.lane`, on the card unless `load` is given another device)
and LaneGraph (`urban.route`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from dftpav_tpu_torch.frontend import GridMap2D
from dftpav_tpu_torch.sim.obstacles import CircularMover

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "playgrounds")


@dataclass
class Playground:
    name: str
    grid: GridMap2D
    start: tuple
    goal: tuple
    movers: list = field(default_factory=list)
    description: str = ""
    # urban scenes (lane_net_norm.json equivalents): a LaneSet + LaneGraph
    # and initial traffic placements [(lane_id, s, v), ...]
    lane_set: object = None
    lane_graph: object = None
    agents: list = field(default_factory=list)


def _rasterize(spec: dict) -> GridMap2D:
    res = float(spec["map"]["resolution"])
    sx, sy = spec["map"]["size"]
    ox, oy = spec["map"].get("origin", (0.0, 0.0))
    nx, ny = int(round(sx / res)), int(round(sy / res))
    occ = np.zeros((ny, nx), np.uint8)
    if spec["map"].get("border", True):
        b = max(1, int(round(0.3 / res)))
        occ[:b, :] = 1
        occ[-b:, :] = 1
        occ[:, :b] = 1
        occ[:, -b:] = 1
    for ob in spec.get("obstacles", []):
        if ob["type"] == "box":
            x0, y0 = ob["xy"]
            w, h = ob["wh"]
            ix0 = max(0, int(round((x0 - ox) / res)))
            iy0 = max(0, int(round((y0 - oy) / res)))
            ix1 = min(nx, int(round((x0 - ox + w) / res)))
            iy1 = min(ny, int(round((y0 - oy + h) / res)))
            occ[iy0:iy1, ix0:ix1] = 1
        elif ob["type"] == "circle":
            cx, cy = ob["xy"]
            r = ob["r"]
            ys, xs = np.mgrid[0:ny, 0:nx]
            px = ox + (xs + 0.5) * res
            py = oy + (ys + 0.5) * res
            occ[(px - cx) ** 2 + (py - cy) ** 2 <= r * r] = 1
        else:
            raise ValueError(f"unknown obstacle type {ob['type']!r}")
    return GridMap2D(occ, origin=(ox, oy), resolution=res)


def _build_lane_net(spec: dict, device, dtype):
    """Lane net from a spec (the lane_net_norm.json equivalent).

    Lane entries: either explicit "waypoints" [[x,y],...], a "straight"
    {y, x0, x1}, or a "ring" {center, radius} (closed loop, sampled CCW).
    "left"/"right"/"successors" wire the lateral/longitudinal graph.
    """
    from dftpav_tpu_torch.urban import lane as lane_mod
    from dftpav_tpu_torch.urban.route import LaneGraph

    lanes, lengths, succ = [], [], []
    entries = spec["lane_net"]["lanes"]
    P = int(spec["lane_net"].get("samples", 1024))
    ds = float(spec["lane_net"].get("ds", 1.0))
    for e in entries:
        closed = bool(e.get("closed", False))
        if "waypoints" in e:
            wps = np.asarray(e["waypoints"], dtype=np.float64)
        elif "straight" in e:
            s = e["straight"]
            n = 31
            wps = np.stack([np.linspace(s["x0"], s["x1"], n),
                            np.full(n, s["y"])], 1)
        elif "ring" in e:
            r = e["ring"]
            th = np.linspace(0, 2 * np.pi, 181)
            wps = np.stack([r["center"][0] + r["radius"] * np.cos(th),
                            r["center"][1] + r["radius"] * np.sin(th)], 1)
            closed = True
        else:
            raise ValueError(f"lane entry needs waypoints/straight/ring: {e}")
        lane = lane_mod.build_lane(wps, ds=ds, P=P, closed=closed,
                                   dtype=dtype, device=device)
        lanes.append(lane)
        lengths.append(float(lane.length))
        succ.append(list(e.get("successors", [])))
    left = [e.get("left", -1) for e in entries]
    right = [e.get("right", -1) for e in entries]
    lane_set = lane_mod.build_lane_set(lanes, left, right)
    return lane_set, LaneGraph(successors=succ, lengths=lengths)


def load(name_or_path: str, device="cuda",
         dtype=torch.float32) -> Playground:
    """Load a playground by name (from the repo's playgrounds/) or explicit
    path. A lane net is built on `device` (the card unless the caller names
    another) in `dtype`."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(ASSET_DIR, name_or_path + ".json")
    with open(path) as f:
        spec = json.load(f)
    lane_set = lane_graph = None
    if "lane_net" in spec:
        lane_set, lane_graph = _build_lane_net(spec, device, dtype)
    movers = [CircularMover(center=tuple(m["center"]), radius=m["radius"],
                            speed=m["speed"], phase=m.get("phase", 0.0),
                            ccw=m.get("ccw", True))
              for m in spec.get("movers", [])]
    agents = [tuple(a) for a in spec.get("agents", [])]
    return Playground(
        name=spec.get("name", os.path.basename(path)),
        grid=_rasterize(spec),
        start=tuple(spec["ego"]["start"]),
        goal=tuple(spec["ego"]["goal"]),
        movers=movers,
        description=spec.get("description", ""),
        lane_set=lane_set,
        lane_graph=lane_graph,
        agents=agents,
    )


def available() -> list[str]:
    return sorted(p[:-5] for p in os.listdir(ASSET_DIR)
                  if p.endswith(".json"))
