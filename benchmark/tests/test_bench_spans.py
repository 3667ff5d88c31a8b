"""spans.py on synthetic data: device operations attributed to the
program's spans by the correlation id of their launch (and by their start
without one), the idle gaps labelled with program spans, the metric
readers on a synthetic run, and span_probe.py on the tiny benchmark."""

import json
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import roofline, spans, trace

# program spans (id, parent, request, name, start, end, attrs), in ns on
# the host clock; request 0 holds solve [100, 1000) with canonicalize
# [110, 300), stage [400, 900) and in it factor [500, 600), kkt_solve
# [600, 700)
SPANS = [
    (1, 0, 0, "canonicalize", 110, 300, {}),
    (3, 2, 0, "factor", 500, 600, {}),
    (4, 2, 0, "kkt_solve", 600, 700, {}),
    (2, 0, 0, "stage", 400, 900, {"precision": "f32", "iterations": 2}),
    (0, None, 0, "solve", 100, 1000, {}),
]
OFFSET = 10_000          # trace clock = host clock + OFFSET


def op(name, launch, start, end, corr):
    """A device op launched at host time `launch` (None: its launching
    call is not in the trace), running [start, end) on the host clock."""
    call = {} if launch is None else {corr: launch + OFFSET}
    return (name, start + OFFSET, end + OFFSET, corr), call


def events(*made):
    ops, calls = [], {}
    for o, c in made:
        ops.append(o)
        calls.update(c)
    return ops, calls


def test_timeline_innermost():
    line = spans.timeline(SPANS)
    at = lambda t: spans.innermost(line, t)
    assert [at(t) for t in (50, 100, 200, 300, 450, 550, 650, 800, 950,
                            1000, 2000)] == [None, 0, 1, 0, 2, 3, 4, 2, 0,
                                             None, None]


def test_attribution_by_launch_innermost_wins_each_op_once():
    ops, calls = events(
        op("k_factor", 550, 560, 580, 1),       # launched inside factor
        op("k_late", 650, 950, 990, 2),         # launched in kkt_solve,
                                                # runs after the stage
        op("k_stage", 420, 430, 440, 3),        # inside stage only
        op("k_out", 1500, 1510, 1530, 4),       # no program span
        op("k_nolaunch", None, 200, 250, 5))    # placed by its start
    seconds, how = spans.attribute(ops, calls, OFFSET, SPANS)
    assert how == {"launch": 4, "start": 1}
    assert seconds == {3: 20e-9, 4: 40e-9, 2: 10e-9, None: 20e-9,
                       1: 50e-9}
    total = sum((hi - lo) / 1e9 for _, lo, hi, _ in ops)
    assert sum(seconds.values()) == pytest.approx(total, rel=0, abs=1e-18)


def test_clock_offset_prefers_the_markers_launch():
    ops, calls = events(op(spans.MARKER, 5, 40, 45, 9),
                        op(spans.MARKER, 60, 70, 75, 10))
    assert spans.clock_offset(ops, calls, 5) == (OFFSET, "launch")
    assert spans.clock_offset(ops, {}, 5) == (OFFSET + 35, "kernel")
    assert spans.clock_offset([], {}, 5) == (None, None)


class _Event:
    def __init__(self, name, lo, hi, corr, device=DeviceType.CUDA):
        self._v = (name, lo, hi, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def _prof(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def test_kineto_events_pairs_ops_with_their_calls():
    evs = [_Event("k", 30, 40, 7), _Event("cudaLaunchKernel", 10, 12, 7,
                                          DeviceType.CPU),
           _Event("Memcpy HtoD", 50, 60, 8),
           _Event("cudaMemcpyAsync", 45, 47, 8, DeviceType.CPU),
           _Event("aten::add", 1, 2, 7, DeviceType.CPU)]
    ops, calls = spans.kineto_events(_prof(evs))
    assert ops == [("k", 30, 40, 7), ("Memcpy HtoD", 50, 60, 8)]
    assert calls == {7: 10, 8: 45}


def test_gap_labels_keep_todays_label_where_no_program_span_covers():
    # the marker, then busy [0, 10), [600, 610), [2000, 2010) on the host
    # clock; the harness's own spans in host ns
    evs = [_Event("k0", OFFSET + 0, OFFSET + 10, 1),
           _Event("Memcpy HtoD", OFFSET + 600, OFFSET + 610, 2),
           _Event("k2", OFFSET + 2000, OFFSET + 2010, 3),
           _Event(trace.MARKER, OFFSET - 500, OFFSET - 490, 4)]
    harness_spans = [("prepare", -600, 50), ("solve", 50, 1900),
                     ("recover", 1900, 1950)]
    old = trace.reduce(_prof(evs), -500, harness_spans)["idle_gaps"]
    ops, _ = spans.kineto_events(_prof(evs))
    gaps = spans.idle_gaps(ops)
    # no program span: today's labels, letter for letter
    assert spans.gap_labels(spans.gap_parts(gaps, harness_spans, [],
                                            OFFSET)) == old
    # with the program's spans, the solve part splits over them
    labels = dict(spans.gap_labels(spans.gap_parts(gaps, harness_spans,
                                                   SPANS, OFFSET), top=20))
    assert labels == pytest.approx({
        "prepare, before k0": 490e-9,
        "prepare, before Memcpy HtoD": 40e-9,
        "solve, before Memcpy HtoD": 50e-9,
        "solve > solve, before Memcpy HtoD": 110e-9,
        "solve > canonicalize, before Memcpy HtoD": 190e-9,
        "solve > stage, before Memcpy HtoD": 100e-9,
        "solve > factor, before Memcpy HtoD": 100e-9,
        "solve > kkt_solve, before k2": 90e-9,
        "solve > stage, before k2": 200e-9,
        "solve > solve, before k2": 100e-9,
        "solve, before k2": 900e-9,
        "recover, before k2": 50e-9,
        "between spans, before k2": 50e-9}, rel=1e-9)
    assert sum(labels.values()) == pytest.approx(
        sum(s for _, s in old), rel=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_gap_labels_without_program_spans_are_trace_reduce_labels(seed):
    """spans.idle_gaps and gap_parts re-derive trace.reduce's cutting of
    the idle gaps; with no program span their labels and seconds are
    trace.reduce's, on traces of overlapping, touching and equal-start
    operations under harness spans with time between them."""
    rng = random.Random(seed)
    mark = rng.randrange(10**6)
    evs = [_Event(trace.MARKER, mark + OFFSET, mark + OFFSET + 7, 0)]
    t = mark + 100
    for corr in range(1, rng.randrange(20, 60)):
        t += rng.choice([0, 0, 3, 40, 900, 5000])
        lo = t + OFFSET
        evs.append(_Event(rng.choice(["k_a", "k_b", "Memcpy HtoD"]), lo,
                          lo + rng.choice([0, 1, 5, 60, 2000]), corr))
    harness_spans, h = [], mark
    for name in ("prepare", "canonicalize+stack", "solve", "recover") * 4:
        h += rng.choice([0, 10, 700])
        end = h + rng.randrange(1, 6_000)
        harness_spans.append((name, h, end))
        h = end
    ops, _ = spans.kineto_events(_prof(evs))
    parts = list(spans.gap_parts(spans.idle_gaps(ops), harness_spans, [],
                                 OFFSET))
    for top in (10, 1000):
        assert spans.gap_labels(parts, top) == trace.reduce(
            _prof(evs), mark, harness_spans, top)["idle_gaps"]


def _run(prog, requests, card="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(program=prog, requests=requests, card=card)


SINGLE = [dict(latency_s=1.0, shapes=[(100, 200)], f32_iterations=[2],
               iterations=[5])]


def test_single_readers():
    prog = dict(spans=SPANS, counts={
        None: {"h2d_bytes": 1},                  # outside every span
        1: {"h2d_bytes": 2_000_000},
        3: {"host_reads": 3, "host_reads.kkt.retry": 3},
        2: {"host_reads": 1, "host_reads.hsd.loop": 1},
        0: {"host_reads": 5, "host_reads.staged.iter": 5},
    }, device_s={3: 0.002, 4: 0.004, 2: 0.001, None: 0.5})
    run = _run(prog, SINGLE)
    # canonicalize has no children: its 190 ns
    assert spans.canonicalize_ms_single(run) == pytest.approx(190e-6)
    assert spans.h2d_mb_per_lp_single(run) == pytest.approx(2.000001)
    # 4 reads inside the stage, over its 2 iterations
    assert spans.host_reads_per_iter(run) == 2.0
    assert spans.kkt_ms_per_iter(run) == pytest.approx(3.0)
    # the stage's self time is not the assembly's: no normal_matrix span
    assert spans.normal_matrix_roofline(run) is None
    assert spans.gather_pct(run) is None


def test_normal_matrix_roofline_reads_every_op_inside_f32_assemblies():
    nm = [(5, 2, 0, "normal_matrix", 420, 480, {}),
          (7, None, 0, "stage", 2000, 3000, {"precision": "f64",
                                            "iterations": 1}),
          (6, 7, 0, "normal_matrix", 2100, 2200, {})]
    prog = dict(spans=SPANS + nm, counts={},
                device_s={5: 0.001, 6: 0.5, 2: 0.25})
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    need = 2 * roofline.assembly_bound_s(100, 200, peak)
    assert spans.normal_matrix_roofline(_run(prog, SINGLE)) == \
        pytest.approx(100.0 * need / 0.001)
    assert spans.normal_matrix_roofline(_run(prog, SINGLE, "cpu")) is None


def test_batch_readers():
    sp = [(0, None, 0, "group_by_class", 0, 3_000_000, {}),
          (1, 0, 0, "canonicalize", 0, 1_000_000, {}),
          (2, None, 0, "stack", 3_000_000, 4_000_000, {}),
          (3, None, 0, "solve_batch", 5_000_000, 9_000_000, {}),
          (4, 3, 0, "stage", 5_000_000, 8_000_000, {"precision": "f64"}),
          (5, None, 0, "gather_lanes", 8_500_000, 8_900_000, {})]
    prog = dict(spans=sp, counts={3: {"h2d_bytes": 4_000_000, "lanes": 2},
                                  4: {"host_reads": 3}},
                device_s={5: 0.02, 4: 0.1})
    rq = [dict(latency_s=0.5, shapes=[(10, 20)] * 4,
               iterations=[4, 6, 5, 6], f32_iterations=[None] * 4)]
    run = _run(prog, rq)
    assert spans.canonicalize_ms_per_lp_batch(run) == pytest.approx(1.0)
    assert spans.h2d_mb_per_lp_batch(run) == pytest.approx(2.0)
    # pd's stage reads no iterations: its request's most pivots
    assert spans.host_reads_per_iter(run) == pytest.approx(0.5)
    assert spans.gather_pct(run) == pytest.approx(4.0)
    assert spans.kkt_ms_per_iter(run) is None


def test_readers_read_nothing_without_records():
    run = SimpleNamespace(requests=SINGLE, card="NVIDIA H100 80GB HBM3")
    assert all(read(run) is None for read in spans.METRICS.values())
    run.program = dict(spans=[], counts={})
    assert all(read(run) is None for read in spans.METRICS.values())
    assert set(spans.WORKLOADS) == set(spans.METRICS)


@pytest.mark.parametrize("cell", ["pilot87-hsd", "midcorpus-batch-pd"])
def test_probe_on_the_tiny_benchmark(tiny_root, cell):
    """On the CPU (no device trace) the probe reports the program-side
    metrics of its cell and run.py's result beside them."""
    out = subprocess.run(
        [sys.executable, os.path.join(tiny_root, "benchmark",
                                      "span_probe.py"),
         "--workload", cell, "--seed", "4200000017", "--seconds", "0.5",
         "--trace", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=tiny_root,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    prog = result["program"]
    single = cell == "pilot87-hsd"
    want = ({"canonicalize_ms.single", "h2d_mb_per_lp.single",
             "host_reads_per_iter.single"} if single else
            {"canonicalize_ms_per_lp.batch", "h2d_mb_per_lp.batch",
             "host_reads_per_iter.batch"})
    assert set(prog["metrics"]) == want
    # a CPU run moves nothing from the host to a device
    assert prog["metrics"]["h2d_mb_per_lp." + (
        "single" if single else "batch")] == 0
    assert prog["recorded"] == prog["requests"] >= 1
    assert sum(v for k, v in prog["host_reads"].items()
               if k != "host_reads") == prog["host_reads"]["host_reads"]
