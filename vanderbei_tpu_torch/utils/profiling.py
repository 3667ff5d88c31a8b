"""Profiling helpers, the port of vanderbei_tpu/utils/profiling.py.

- `trace(dir)`: context manager around torch.profiler (CPU and, where
  there is one, CUDA activity), writing a Chrome trace into dir; the
  profile object it yields has key_averages() and events();
- `busy_share(prof, seconds)`: the union of the CUDA events' intervals
  over a wall time, the device-busy share of PERF.md, from a
  `device_trace(cuda)`;
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
    """Union of the CUDA events' [start, end) intervals, in us.  It reads
    the profiler's raw events: parsing them into prof.events() builds a
    tree of every event, seconds of host time for one solve's trace.
    prof.profiler.kineto_results is private (checked on torch 2.11); this
    is the one place that reads it."""
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    total, end = 0, float("-inf")
    for lo, hi in spans:
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total / 1e3


def device_trace(cuda: bool):
    """A torch.profiler context that records what busy_share reads: the
    CUDA activity (kernels, copies) of a run on a card, the CPU ops of one
    on the CPU (which has no device time).  A card's run leaves its CPU ops
    out, whose tens of thousands of events the profiler's exit would take
    seconds to process."""
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


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
