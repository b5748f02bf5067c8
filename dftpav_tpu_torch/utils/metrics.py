"""Metrics registry: counters, wall timers, throughput summaries (the port of
`dftpav_tpu/utils/metrics.py`, pure host code; common::TicToc and the
reference's printf timing lines).

A registry of named counters and timing series with a one-line JSON summary,
so long batched runs report solves/s, per-stage latency percentiles and
success rates uniformly. Work queued on the card is not done when the host
returns: synchronise (`torch.cuda.synchronize()` or a readback) before
`toc()`.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np


class TicToc:
    """Wall timer (common::TicToc: tic() resets, toc() returns ms)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


class Metrics:
    """Named counters + timing series with percentile summaries."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.series: dict[str, list[float]] = defaultdict(list)

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def record(self, name: str, value_ms: float):
        self.series[name].append(float(value_ms))

    def timer(self, name: str):
        """Context manager recording a wall-time sample under `name`."""
        metrics = self

        class _Timer:
            def __enter__(self):
                self.t = TicToc()
                return self

            def __exit__(self, *exc):
                metrics.record(name, self.t.toc())
                return False

        return _Timer()

    def throughput(self, name: str, n_items: float, wall_s: float):
        self.counters[f"{name}_per_s"] = n_items / max(wall_s, 1e-12)

    def summary(self) -> dict:
        out: dict = dict(self.counters)
        for name, vals in self.series.items():
            v = np.asarray(vals)
            out[name] = dict(
                n=len(v), mean_ms=float(v.mean()),
                p50_ms=float(np.percentile(v, 50)),
                p95_ms=float(np.percentile(v, 95)),
                max_ms=float(v.max()),
            )
        return out

    def dumps(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)

    def reset(self):
        self.counters.clear()
        self.series.clear()
