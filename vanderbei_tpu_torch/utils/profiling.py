"""Profiling helpers, the port of vanderbei_tpu/utils/profiling.py.

- `trace(dir)`: context manager around torch.profiler (CPU and, where
  there is one, CUDA activity), writing a Chrome trace into dir; the
  profile object it yields has key_averages() and events();
- `busy_share(prof, seconds)`: the union of the CUDA events' intervals
  over a wall time, the device-busy share of PERF.md;
- `time_fn(fn, *args, reps=...)`: best-of-reps wall timing, each rep
  closed by torch.cuda.synchronize so that it times the device work.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_busy_us(prof) -> float:
    """Union of the CUDA events' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def busy_share(prof, seconds: float) -> float:
    """The device-busy share of `seconds` of wall time in a trace."""
    return device_busy_us(prof) / (seconds * 1e6) if seconds > 0 else 0.0


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, reps: int = 3, warmup: int = 1, **kwargs):
    """Best-of-reps wall seconds for fn(*args, **kwargs), each rep ended
    by a device synchronize.  Returns (best_seconds, last_result)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _sync()
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best, result
