"""Route planning over a lane graph (host-side, NumPy; the port's copy of
`dftpav_tpu/urban/route.py`).

Reference: planning::RoutePlanner
(src/Sim/core/route_planner/src/route_planner/route_planner.cc): walks the
lane net's successor graph to produce a navigation lane-id sequence
(``navi_path``), either by random expansion up to ~200 m or toward an
assigned target; the behavior planner consumes the path via
GetRefLaneForStateByBehavior.

Routing is branchy graph search over a handful of lanes — host work, not
device work; the output feeds the planners as plain lane-id arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LaneGraph:
    """Longitudinal successor structure on top of LaneSet's lateral adjacency.

    successors[i] = list of lane ids reachable when lane i ends; lengths[i]
    = arc length of lane i.
    """

    successors: list[list[int]]
    lengths: list[float]

    @property
    def n_lanes(self) -> int:
        return len(self.successors)


class RoutePlanner:
    """Random-expansion / assigned-target navigation
    (route_planner.cc:14-60)."""

    READY, IN_PROGRESS, FINISHED = 0, 1, 2

    def __init__(self, graph: LaneGraph, max_length: float = 200.0,
                 restart: bool = True, seed: int = 0):
        self.graph = graph
        self.max_length = max_length
        self.restart = restart
        self.rng = np.random.default_rng(seed)
        self.status = self.READY
        self.navi_path: list[int] = []

    def run_once(self, current_lane: int, s_on_lane: float,
                 target_lane: int | None = None) -> list[int]:
        """Update and return the navigation path starting at current_lane."""
        if self.status == self.READY:
            if target_lane is None:
                self._expand_random(current_lane)
            else:
                self._search_target(current_lane, target_lane)
            self.status = self.IN_PROGRESS
        elif self.status == self.IN_PROGRESS:
            self._check_progress(current_lane, s_on_lane)
        elif self.status == self.FINISHED and self.restart:
            self.status = self.READY
            return self.run_once(current_lane, s_on_lane, target_lane)
        return self.navi_path

    def _expand_random(self, start: int):
        """GetNaviPathByRandomExpansion: follow random successors to ~200 m."""
        path, length = [start], self.graph.lengths[start]
        cur = start
        while length < self.max_length:
            nxt = self.graph.successors[cur]
            if not nxt:
                break
            cur = int(self.rng.choice(nxt))
            if cur in path:  # loop closed (ring nets)
                break
            path.append(cur)
            length += self.graph.lengths[cur]
        self.navi_path = path

    def _search_target(self, start: int, goal: int):
        """BFS shortest lane sequence to the target lane."""
        from collections import deque

        prev = {start: None}
        q = deque([start])
        while q:
            cur = q.popleft()
            if cur == goal:
                break
            for nxt in self.graph.successors[cur]:
                if nxt not in prev:
                    prev[nxt] = cur
                    q.append(nxt)
        if goal not in prev:
            self.navi_path = [start]
            return
        path = []
        node: int | None = goal
        while node is not None:
            path.append(node)
            node = prev[node]
        self.navi_path = path[::-1]

    def _check_progress(self, current_lane: int, s_on_lane: float):
        """CheckNaviProgress: drop passed lanes; finish at the path end."""
        if current_lane in self.navi_path:
            idx = self.navi_path.index(current_lane)
            self.navi_path = self.navi_path[idx:]
            if (len(self.navi_path) == 1
                    and s_on_lane >= self.graph.lengths[current_lane] - 5.0):
                self.status = self.FINISHED
        else:
            self.status = self.READY
