"""Reduction of a CUDA-only profiler trace to what the metrics read: the
device's busy time (the union of every CUDA activity's interval, as the
port's utils/profiling.device_busy_us takes it), device time by operation
name, and the idle gaps labelled by what the host was doing.

The trace is kept in memory: `capture()` is a torch.profiler context over
CUDA activity alone (the host's operations, tens of thousands in a window,
would cost seconds to record and parse), and `reduce()` reads its raw
kineto events.  prof.profiler.kineto_results is private (checked on torch
2.11 and 2.13); this module is the one place that reads it.

The host's spans come from the harness's own clock (time.perf_counter_ns).
The device's clock is tied to it by a marker: `mark()` launches one short
spin kernel right after reading the host clock, and the kernel's start in
the trace gives the offset (good to the launch latency, some
microseconds).
"""

from __future__ import annotations

import bisect
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

MARKER = "spin_kernel"
NAME_CHARS = 120


def capture():
    return profile(activities=[ProfilerActivity.CUDA])


def mark(device) -> int:
    """Launch the clock marker on `device`; returns the host clock (ns) read
    just before the launch."""
    torch.cuda.synchronize(device)
    t = time.perf_counter_ns()
    with torch.cuda.device(device):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    return t


def _union(spans):
    """Merged [start, end) intervals of (start, end) pairs."""
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return merged


def _split(spans, starts, lo, hi):
    """[(name, seconds)] of the host interval [lo, hi) (ns) over the host
    spans (name, start, end), in order and not overlapping; time in none
    of them is "between spans"."""
    out = []
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    covered = 0
    while i < len(spans) and spans[i][1] < hi:
        name, a, b = spans[i]
        part = min(b, hi) - max(a, lo)
        if part > 0:
            out.append((name, part / 1e9))
            covered += part
        i += 1
    if hi - lo > covered:
        out.append(("between spans", (hi - lo - covered) / 1e9))
    return out


def reduce(prof, host_mark_ns: int | None, spans=(), top: int = 10) -> dict:
    """{"busy_s", "ops": {name: device seconds}, "device_ops" and
    "idle_gaps" (the top entries as [name, seconds])} of a CUDA-only trace.

    spans: host spans (name, start ns, end ns) on time.perf_counter_ns, in
    order and not overlapping; an idle gap's seconds are split over the
    spans it overlaps, each part named after its span and the device
    operation that ended the gap.  host_mark_ns: mark()'s reading (None: no
    marker in the trace, and the gaps are named after the operation
    alone)."""
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    offset = None
    if host_mark_ns is not None:
        marks = [lo for name, lo, _ in events if MARKER in name]
        if marks:
            offset = min(marks) - host_mark_ns
    ops: dict = {}
    for name, lo, hi in events:
        ops[name] = ops.get(name, 0.0) + (hi - lo) / 1e9
    merged = _union((lo, hi) for _, lo, hi in events)
    busy = sum(hi - lo for lo, hi in merged) / 1e9
    starts = sorted((lo, name) for name, lo, _ in events)
    span_starts = [lo for _, lo, _ in spans]
    gaps: dict = {}
    k = 0
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        while k < len(starts) and starts[k][0] < nxt:
            k += 1
        op = starts[k][1][:60] if k < len(starts) else "?"
        parts = ([("", (nxt - end) / 1e9)] if offset is None else
                 _split(spans, span_starts, end - offset, nxt - offset))
        for where, secs in parts:
            label = f"{where}, before {op}" if where else f"before {op}"
            gaps[label] = gaps.get(label, 0.0) + secs
    rank = lambda d: [[name[:NAME_CHARS], secs] for name, secs in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return dict(busy_s=busy, ops=ops, device_ops=rank(ops),
                idle_gaps=rank(gaps), events=len(events))
