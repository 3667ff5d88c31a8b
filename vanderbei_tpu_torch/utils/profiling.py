"""Profiling helpers, the port of vanderbei_tpu/utils/profiling.py, and
the program's span-and-counter recorder.

- `busy_share(prof, seconds)`: the union of the CUDA events' intervals
  over a wall time, the device-busy share of PERF.md, from a
  `device_trace(cuda)`;
- `recording()`, `span(name, **attrs)`, `spanned(name)`, `count(name, n)`,
  `request(rid)`, `host_read(site, read, *args)`: the recorder (below).

The recorder keeps, in memory, the spans the program opens at its layer
boundaries (solve, canonicalize, pad, upload, stage, fetch; group_by_class,
stack, solve_batch, gather_lanes; normal_matrix, factor, kkt_solve;
graph_capture) and the counters it bumps (h2d_bytes, host_reads, a batch
entry's lanes, canonicalize.structured and canonicalize.dense: an LP built
from its CSC by core/ubtail or densely by canonicalize), each counter
attributed to the innermost open span.  A span's start and end are
time.perf_counter_ns() readings, the clock a caller can tie to a device
trace.  It is off unless a `recording()` is open; off, `span` returns a
shared no-op context, `count` returns and a `spanned` function calls
straight through, each after one test of a module global, making no
record.  No span or counter synchronizes
the device, reads a tensor or launches anything, on or off; the reads
that `host_read` counts are the program's own.
"""

from __future__ import annotations

import contextlib
import functools
import time

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


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


# ---------------------------------------------------------------------------
# the span-and-counter recorder
# ---------------------------------------------------------------------------

_REC = None     # the Recorder of the open recording(), else None (off)
_RID = None     # the id of the innermost open request() scope


class Recorder:
    """What one recording() holds.

    spans: (id, parent id, request id, name, start_ns, end_ns, attrs), one
    per closed span, in the order they closed; the parent is the span open
    around it (None at the top), the request id that of the request()
    scope it opened in (None outside any).  counts: {span id: {counter:
    total}}, each bump under the innermost span open then (None: outside
    every span)."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self._open: list = []
        self._next = 0


class Span:
    """A span that reads the clock whether the recorder is on or off, for
    a caller that needs its own duration (a stage's record): `seconds`
    after it closes.  attrs may be added to before it closes."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_rec", "_id",
                 "_parent", "_rid")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        rec = self._rec = _REC
        if rec is not None:
            self._id = rec._next
            rec._next += 1
            self._parent = rec._open[-1] if rec._open else None
            self._rid = _RID
            rec._open.append(self._id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        rec = self._rec
        if rec is not None:
            rec._open.pop()
            rec.spans.append((self._id, self._parent, self._rid, self.name,
                              self.start_ns, self.end_ns, self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A span named `name` (a context manager), recorded when a recording()
    is open; off, the shared no-op context."""
    if _REC is None:
        return _OFF
    return Span(name, **attrs)


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _REC is None:
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the innermost open span."""
    rec = _REC
    if rec is None:
        return
    key = rec._open[-1] if rec._open else None
    counts = rec.counts.setdefault(key, {})
    counts[name] = counts.get(name, 0) + n


def host_read(site: str, read, *args):
    """read(*args), a read of device values on the host (.tolist(),
    .item(), torch.nonzero's count), counted as one `host_reads` and one
    `host_reads.<site>`."""
    if _REC is not None:
        count("host_reads")
        count("host_reads." + site)
    return read(*args)


@contextlib.contextmanager
def request(rid):
    """A scope whose id every span opened inside it carries."""
    global _RID
    prev, _RID = _RID, rid
    try:
        yield
    finally:
        _RID = prev


@contextlib.contextmanager
def recording():
    """Turn the recorder on; yields the Recorder that holds the spans and
    counts made until the scope closes."""
    global _REC
    prev, rec = _REC, Recorder()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = prev
