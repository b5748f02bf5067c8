"""Scenario asset loader (the port's copy of `dftpav_tpu/playgrounds.py`).

Replaces the reference's playground JSON trees
(src/Sim/core/playgrounds/*/{vehicle_set,obstacles_norm,...}.json) with a
single self-describing JSON per scene: map raster spec, box obstacles, ego
start/goal, circulating movers. The assets are the repo's
`playgrounds/*.json`, read in place.

A scene with a lane net (`highway_v1`, `ring_v1`) needs the urban stack's
lane and route modules, which the port does not have yet (ROADMAP.md
Queue 1 item 6): `load` raises NotImplementedError for it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

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
    # and initial traffic placements [(lane_id, s, v), ...]; None until the
    # urban stack is ported
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


def load(name_or_path: str) -> Playground:
    """Load a playground by name (from the repo's playgrounds/) or explicit
    path. Raises NotImplementedError for a scene with a lane net (the urban
    stack, ROADMAP.md Queue 1 item 6)."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(ASSET_DIR, name_or_path + ".json")
    with open(path) as f:
        spec = json.load(f)
    if "lane_net" in spec:
        raise NotImplementedError(
            f"{spec.get('name', path)}: a playground with a lane net needs "
            "urban.lane and urban.route, not ported yet (ROADMAP.md Queue 1 "
            "item 6)")
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
        agents=agents,
    )


def available() -> list[str]:
    return sorted(p[:-5] for p in os.listdir(ASSET_DIR)
                  if p.endswith(".json"))
