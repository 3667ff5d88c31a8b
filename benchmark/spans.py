"""The program's own spans and counters, tied to a device trace, and the
per-layer metrics they give.

The program (vanderbei_tpu_torch.utils.profiling) records, while its
recorder is on, spans (id, parent id, request id, name, start_ns, end_ns,
attrs) on time.perf_counter_ns and counters per span (h2d_bytes,
host_reads and host_reads.<site>, a batch entry's lanes).  This module
reads them as plain data and imports nothing of the program:

    attribute()   each device operation of a CUDA trace to the innermost
                  program span open when the host launched it
    gap_parts(), gap_labels()
                  the device's idle gaps named after the harness span and
                  the innermost program span that cover them
    the metric functions below, each read(run) -> value or None, reading
                  run.program: {"spans", "counts"} and, with a device
                  trace, "device_s" (attribute()'s seconds by span id)

Attribution.  A kernel, copy or graph launch carries the correlation id of
the runtime call that launched it (cudaLaunchKernel, cudaMemcpyAsync,
cudaGraphLaunch, ...); that call's start is on the trace's clock, which
the marker (trace.mark) ties to the host's: host = trace - offset, the
offset taken from the marker's own launch call where the trace has it,
else from the marker kernel's start.  An operation whose launching call is
not in the trace is placed by its own start instead (later than its
launch by the queue ahead of it).  An operation that no program span
covers is "outside program spans"; every operation's time counts once.
"""

from __future__ import annotations

import bisect

from . import roofline, trace

OUTSIDE = "outside program spans"
MARKER = "spin_kernel"


# ---------------------------------------------------------------------------
# the trace: operations, their launches, and the innermost span at a time
# ---------------------------------------------------------------------------

def kineto_events(prof) -> tuple:
    """([(name, start_ns, end_ns, correlation id)] of the CUDA activity,
    {correlation id: start_ns} of the host's runtime and driver calls) of
    a torch.profiler trace kept in memory (its raw kineto events, as
    trace.reduce reads them)."""
    from torch.autograd import DeviceType
    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ops.append((e.name(), e.start_ns(), e.end_ns(),
                        e.correlation_id()))
        elif e.name().startswith("cu"):
            calls.setdefault(e.correlation_id(), e.start_ns())
    return ops, calls


def clock_offset(ops, calls, host_mark_ns: int) -> tuple:
    """(trace clock - host clock in ns, "launch" or "kernel": what the
    offset was read from), from the marker's first launch: its runtime
    call where the trace has one, else its kernel's start."""
    marks = sorted((lo, corr) for name, lo, _, corr in ops if MARKER in name)
    if not marks:
        return None, None
    lo, corr = marks[0]
    if corr in calls:
        return calls[corr] - host_mark_ns, "launch"
    return lo - host_mark_ns, "kernel"


def timeline(spans) -> tuple:
    """(times, ids): from times[i] until times[i + 1], ids[i] is the
    innermost open span (None: none), for spans that nest (one thread's
    spans: a span closes before its parent does)."""
    end = {s[0]: s[5] for s in spans}
    marks: list = []
    stack: list = []

    def mark(t):
        if marks and marks[-1][0] == t:
            marks.pop()
        marks.append((t, stack[-1] if stack else None))
    for sid, _, _, _, lo, hi, _ in sorted(spans,
                                          key=lambda s: (s[4], -s[5])):
        while stack and end[stack[-1]] <= lo:
            t = end[stack.pop()]
            mark(t)
        stack.append(sid)
        mark(lo)
    while stack:
        mark(end[stack.pop()])
    return [t for t, _ in marks], [i for _, i in marks]


def innermost(line, t: int):
    """The innermost span open at host time t on a timeline(), or None."""
    times, ids = line
    k = bisect.bisect_right(times, t) - 1
    return ids[k] if k >= 0 else None


def attribute(ops, calls, offset: int, spans) -> tuple:
    """({span id or None: device seconds}, {"launch": n, "start": n}):
    each operation's time given to the innermost program span open when
    its launching call started (or, without one in the trace, when the
    operation started), mapped onto the host clock by `offset`; None
    holds the operations that no span covers."""
    line = timeline(spans)
    seconds: dict = {}
    how = {"launch": 0, "start": 0}
    for _, lo, hi, corr in ops:
        t = calls.get(corr)
        how["launch" if t is not None else "start"] += 1
        sid = innermost(line, (lo if t is None else t) - offset)
        seconds[sid] = seconds.get(sid, 0.0) + (hi - lo) / 1e9
    return seconds, how


def parts(line, names, lo: int, hi: int) -> list:
    """[(innermost program span's name or None, seconds)] of the host
    interval [lo, hi), in order, on a timeline()."""
    times, ids = line
    out = []
    k = bisect.bisect_right(times, lo) - 1
    t = lo
    while t < hi:
        name = names[ids[k]] if k >= 0 and ids[k] is not None else None
        stop = min(times[k + 1], hi) if k + 1 < len(times) else hi
        if out and out[-1][0] == name:
            out[-1] = (name, out[-1][1] + (stop - t) / 1e9)
        else:
            out.append((name, (stop - t) / 1e9))
        t, k = stop, k + 1
    return out


def idle_gaps(ops) -> list:
    """[(end of a busy stretch, start of the next, the name of the
    operation that starts it, cut as trace.reduce cuts it)] on the
    trace's clock: the gaps that trace.reduce labels."""
    merged = trace._union((lo, hi) for _, lo, hi, _ in ops)
    starts = sorted((lo, name) for name, lo, _, _ in ops)
    gaps, k = [], 0
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        while k < len(starts) and starts[k][0] < nxt:
            k += 1
        gaps.append((end, nxt, starts[k][1][:60] if k < len(starts)
                     else "?"))
    return gaps


def gap_parts(gaps, harness_spans, spans, offset: int):
    """(harness span, innermost program span's name or None, the
    operation that ends the gap, seconds) for each part of each idle gap:
    a gap is split over the harness spans as trace.reduce splits it (the
    time in none of them last, as "between spans"), and each harness
    span's part over the innermost program spans.  gaps: idle_gaps()."""
    line = timeline(spans)
    names = {s[0]: s[3] for s in spans}
    hs = sorted(harness_spans, key=lambda s: s[1])
    starts = [s[1] for s in hs]
    for end, nxt, op in gaps:
        lo, hi = end - offset, nxt - offset
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        covered = 0
        while i < len(hs) and hs[i][1] < hi:
            where, a, b = hs[i]
            a, b = max(a, lo), min(b, hi)
            if b > a:
                covered += b - a
                for prog, secs in parts(line, names, a, b):
                    yield where, prog, op, secs
            i += 1
        if hi - lo > covered:
            yield "between spans", None, op, (hi - lo - covered) / 1e9


def gap_labels(parts_, top: int = 10) -> list:
    """The top [label, seconds] of gap_parts(): "<harness span>, before
    <op>" where no program span covers the part, as trace.reduce labels
    it, and "<harness span> > <program span>, before <op>" where one
    does."""
    out: dict = {}
    for where, prog, op, secs in parts_:
        head = where if prog is None else f"{where} > {prog}"
        label = f"{head}, before {op}"
        out[label] = out.get(label, 0.0) + secs
    return [[k[:trace.NAME_CHARS], v] for k, v in
            sorted(out.items(), key=lambda kv: -kv[1])[:top]]


# ---------------------------------------------------------------------------
# the metrics: each read(run) -> value or None
# ---------------------------------------------------------------------------

def _program(run):
    prog = getattr(run, "program", None)
    return prog if prog and prog.get("spans") else None


def _inside(prog, keep) -> set:
    """Ids of the spans s for which keep(s) holds, and of every span
    inside one."""
    by_id = {s[0]: s for s in prog["spans"]}
    memo: dict = {}

    def test(sid):
        if sid not in memo:
            s = by_id[sid]
            memo[sid] = keep(s) or (s[1] in by_id and test(s[1]))
        return memo[sid]
    return {sid for sid in by_id if test(sid)}


def _within(prog, names) -> set:
    """Ids of the spans named in `names` and of every span inside them."""
    return _inside(prog, lambda s: s[3] in names)


def _count(prog, counter: str, ids=None) -> int:
    return sum(c.get(counter, 0) for sid, c in prog["counts"].items()
               if ids is None or sid in ids)


def _device(prog, ids) -> float | None:
    dev = prog.get("device_s")
    if dev is None:
        return None
    return sum(s for sid, s in dev.items() if sid in ids)


def _lps(run, prog) -> int:
    """The LPs of the requests the recorder saw."""
    rids = {s[2] for s in prog["spans"]}
    return sum(len(rq["shapes"]) for r, rq in enumerate(run.requests)
               if r in rids)


def _stage_iterations(run, prog) -> int:
    """The iterations of every recorded stage (a batch's: its slowest
    lane's; pd's stage, which reads none, its request's most pivots)."""
    its = 0
    for s in prog["spans"]:
        if s[3] != "stage":
            continue
        if "iterations" in s[6]:
            its += int(s[6]["iterations"])
        elif s[2] is not None and s[2] < len(run.requests):
            its += int(max(run.requests[s[2]]["iterations"]))
    return its


def canonicalize_ms_single(run):
    """Mean over the recorded requests of the self time of their
    canonicalize and pad spans, in ms."""
    prog = _program(run)
    if prog is None:
        return None
    child: dict = {}
    for s in prog["spans"]:
        child[s[1]] = child.get(s[1], 0) + s[5] - s[4]
    per: dict = {}
    for s in prog["spans"]:
        if s[3] in ("canonicalize", "pad"):
            per[s[2]] = (per.get(s[2], 0) + s[5] - s[4]
                         - child.get(s[0], 0))
    return 1e-6 * sum(per.values()) / len(per) if per else None


def canonicalize_ms_per_lp_batch(run):
    """The group_by_class and stack spans' seconds over the recorded
    requests' LPs, in ms."""
    prog = _program(run)
    if prog is None:
        return None
    ns = sum(s[5] - s[4] for s in prog["spans"]
             if s[3] in ("group_by_class", "stack"))
    lps = _lps(run, prog)
    return 1e-6 * ns / lps if lps and ns else None


def h2d_mb_per_lp_single(run):
    """Bytes moved host to device (h2d_bytes) over the recorded requests'
    LPs, in MB."""
    prog = _program(run)
    if prog is None:
        return None
    lps = _lps(run, prog)
    return _count(prog, "h2d_bytes") / 1e6 / lps if lps else None


def h2d_mb_per_lp_batch(run):
    """Bytes moved host to device (h2d_bytes) over the lanes the batch
    entries solved on this rank (their `lanes` counter), in MB."""
    prog = _program(run)
    if prog is None:
        return None
    lanes = _count(prog, "lanes")
    return _count(prog, "h2d_bytes") / 1e6 / lanes if lanes else None


def host_reads_per_iter(run):
    """Host reads (host_reads) inside the stage spans over the stages'
    iterations (a batch's: its slowest lane's; pd: pivots)."""
    prog = _program(run)
    if prog is None:
        return None
    its = _stage_iterations(run, prog)
    reads = _count(prog, "host_reads", _within(prog, ["stage"]))
    return reads / its if its else None


def kkt_ms_per_iter(run):
    """Device time of the operations launched inside the factor and
    kkt_solve spans over the stages' iterations, in ms."""
    prog = _program(run)
    if prog is None:
        return None
    secs = _device(prog, _within(prog, ["factor", "kkt_solve"]))
    its = _stage_iterations(run, prog)
    return 1e3 * secs / its if secs and its else None


def normal_matrix_roofline(run):
    """roofline.py's work of the traced requests' f32 assemblies over the
    device time of every operation launched inside a normal_matrix span
    of an f32 stage, in %."""
    prog = _program(run)
    peak = roofline.peaks(getattr(run, "card", ""))
    if prog is None or peak is None:
        return None
    f32 = _inside(prog, lambda s: s[3] == "stage"
                  and s[6].get("precision") == "f32")
    secs = _device(prog, _within(prog, ["normal_matrix"]) & f32)
    if not secs:
        return None
    rids = {s[2] for s in prog["spans"]}
    need = 0.0
    for r, rq in enumerate(run.requests):
        if r not in rids:
            continue
        for (m, n), its in zip(rq["shapes"], rq["f32_iterations"]):
            if its is None:
                return None
            need += its * roofline.assembly_bound_s(m, n, peak)
    return 100.0 * need / secs


def gather_pct(run):
    """Device time of the operations launched inside gather_lanes over the
    recorded requests' latency, in %."""
    prog = _program(run)
    if prog is None:
        return None
    secs = _device(prog, _within(prog, ["gather_lanes"]))
    rids = {s[2] for s in prog["spans"]}
    lat = sum(rq["latency_s"] for r, rq in enumerate(run.requests)
              if r in rids)
    return 100.0 * secs / lat if secs and lat else None


# metric name -> reader, as BENCHMARK.json would name them
METRICS = {
    "canonicalize_ms.single": canonicalize_ms_single,
    "canonicalize_ms_per_lp.batch": canonicalize_ms_per_lp_batch,
    "h2d_mb_per_lp.single": h2d_mb_per_lp_single,
    "h2d_mb_per_lp.batch": h2d_mb_per_lp_batch,
    "host_reads_per_iter.single": host_reads_per_iter,
    "host_reads_per_iter.batch": host_reads_per_iter,
    "kkt_ms_per_iter.single": kkt_ms_per_iter,
    "kkt_ms_per_iter.batch": kkt_ms_per_iter,
    "normal_matrix_roofline.single": normal_matrix_roofline,
    "normal_matrix_roofline.batch": normal_matrix_roofline,
    "gather_pct.dp": gather_pct,
}

# the cells each metric is read in, as BENCHMARK.json would list them
BATCH = ["midcorpus-batch-hsd", "midcorpus-batch-pd",
         "midcorpus-batch-hsd-dp4"]
WORKLOADS = {
    "canonicalize_ms.single": ["pilot87-hsd"],
    "canonicalize_ms_per_lp.batch": BATCH,
    "h2d_mb_per_lp.single": ["pilot87-hsd"],
    "h2d_mb_per_lp.batch": BATCH,
    "host_reads_per_iter.single": ["pilot87-hsd"],
    "host_reads_per_iter.batch": BATCH,
    "kkt_ms_per_iter.single": ["pilot87-hsd"],
    "kkt_ms_per_iter.batch": ["midcorpus-batch-hsd",
                              "midcorpus-batch-hsd-dp4"],
    "normal_matrix_roofline.single": ["pilot87-hsd"],
    "normal_matrix_roofline.batch": ["midcorpus-batch-hsd"],
    "gather_pct.dp": ["midcorpus-batch-hsd-dp4"],
}
