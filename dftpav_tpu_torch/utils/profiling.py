"""Profiling helpers: torch.profiler traces and device timing (the port of
`dftpav_tpu/utils/profiling.py`).

  * `trace(log_dir)` profiles a block with torch.profiler (the card too,
    where there is one) and writes a Chrome trace into `log_dir`;
  * `sync(x)` synchronises through a host readback of a scalar;
  * `device_time_ms` times a callable per call: with CUDA events on CUDA
    tensors, with the host clock around a readback on CPU tensors. (JAX's
    chains calls inside one program to beat a relay's round trip; the card
    needs no such trick, and the signature stays.)
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import torch

from dftpav_tpu_torch.utils.checkpoint import tree_flatten


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block into `log_dir`/trace.json (chrome://tracing,
    Perfetto); yields the profiler, whose key_averages() sums by op."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(x) -> float:
    """Synchronize through a host readback; returns a scalar from x's first
    leaf."""
    leaf = tree_flatten(x)[0]
    if torch.is_tensor(leaf):
        return float(leaf.reshape(-1)[0])
    return float(leaf)


def device_time_ms(fn, args, k: int = 10, reps: int = 3) -> float:
    """Per-call time of `fn(*args)` in ms: the best of `reps` runs of k
    calls, after one warm-up call. On CUDA tensors (the first tensor among
    args decides) between CUDA events; otherwise on the host clock, each
    run ending in a readback of the last result."""
    first = next((a for a in tree_flatten(list(args)) if torch.is_tensor(a)),
                 None)
    on_card = first is not None and first.is_cuda
    sync(fn(*args))
    best = math.inf
    for _ in range(reps):
        if on_card:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(k):
                fn(*args)
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                out = fn(*args)
            sync(out)
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best / k
