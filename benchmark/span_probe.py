"""Run one cell as run.py does, with the program's span-and-counter
recorder on, and print the per-layer metrics that its spans give
(spans.py).

    python3 benchmark/span_probe.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

run.py neither turns the recorder on nor hands its records to the metric
readers; this script does both around harness.run_cell, for rank 0:
Program.run opens request(r) around request r, the recorder is on from
the first request after the warm-up until the profiler stops (with
--trace 0: to the end of the window), and the trace's raw events are
attributed to the program's spans before harness.measure drops them.
Prints run.py's result line with "program" added (the metrics, the device
time by span name, how the operations were placed, the idle gaps labelled
with program spans).  What recording costs: this script against run.py,
both with --trace 0, in turns.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".bench_cache", "cuda")
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "4"

import argparse  # noqa: E402
import json  # noqa: E402


def probe(root: str, workload: str, seed: int, seconds: float, trace: bool,
          device: str, t_process: float) -> tuple:
    """run_cell with the recorder as the module docstring says; returns
    (exit code, the result line with "program", run_cell's lines)."""
    from vanderbei_tpu_torch.utils import profiling
    from benchmark import drivers, harness, spans
    from benchmark import trace as trace_mod

    state = dict(calls=0, scope=None, rec=None, program=None, run=None)

    def stop():
        if state["scope"] is not None:
            state["scope"].__exit__(None, None, None)
            state["scope"] = None

    real_run = drivers.Program.run

    def run(self, lps):
        r = state["calls"] - 1
        state["calls"] += 1
        if r < 0:
            return real_run(self, lps)
        if r == 0:
            state["scope"] = profiling.recording()
            state["rec"] = state["scope"].__enter__()
        with profiling.request(r):
            return real_run(self, lps)

    real_capture = trace_mod.capture

    def capture():
        prof = real_capture()
        exit_ = prof.__exit__

        def stopped(*exc):
            out = exit_(*exc)
            stop()
            return out
        prof.__exit__ = stopped
        return prof

    real_reduce = trace_mod.reduce

    def reduce(prof, host_mark_ns, harness_spans=(), top=10):
        t0 = time.perf_counter()
        out = real_reduce(prof, host_mark_ns, harness_spans, top)
        rec = state["rec"]
        if rec is not None and host_mark_ns is not None:
            ops, calls = spans.kineto_events(prof)
            offset, by = spans.clock_offset(ops, calls, host_mark_ns)
            if offset is not None:
                device_s, how = spans.attribute(ops, calls, offset,
                                                rec.spans)
                names = {s[0]: s[3] for s in rec.spans}
                by_name: dict = {}
                for sid, secs in device_s.items():
                    key = spans.OUTSIDE if sid is None else names[sid]
                    by_name[key] = by_name.get(key, 0.0) + secs
                kernel = spans.clock_offset(ops, {}, host_mark_ns)[0]
                gaps = list(spans.gap_parts(spans.idle_gaps(ops),
                                            harness_spans, rec.spans,
                                            offset))
                idle: dict = {}
                for where, prog, _, secs in gaps:
                    key = f"{where} > {prog}" if prog else where
                    idle[key] = idle.get(key, 0.0) + secs
                state["program"] = dict(
                    device_s=device_s, placed=how, offset_from=by,
                    launch_to_kernel_us=(kernel - offset) / 1e3,
                    ops_s=sum((hi - lo) / 1e9 for _, lo, hi, _ in ops),
                    device_by_span=sorted(by_name.items(),
                                          key=lambda kv: -kv[1]),
                    idle_by_span=sorted(idle.items(), key=lambda kv: -kv[1]),
                    idle_gaps=spans.gap_labels(gaps, top),
                    seconds=time.perf_counter() - t0)
        return out

    class Run(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            state["run"] = self

    patches = [(drivers.Program, "run", run), (trace_mod, "capture", capture),
               (trace_mod, "reduce", reduce), (harness, "Run", Run)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, new in patches:
        setattr(obj, name, new)
    try:
        code, result, lines = harness.run_cell(root, workload, seed, seconds,
                                               trace, device, t_process)
    finally:
        stop()
        for obj, name, old in saved:
            setattr(obj, name, old)
    rec, found = state["rec"], state["program"] or {}
    if result is None or rec is None:
        return code, result, lines
    run_ = state["run"]
    run_.program = dict(spans=rec.spans, counts=rec.counts,
                        device_s=found.get("device_s"))
    metrics = {}
    for name, cells in spans.WORKLOADS.items():
        if workload in cells:
            value = spans.METRICS[name](run_)
            if value is not None:
                metrics[name] = value
    found.pop("device_s", None)
    result["program"] = dict(
        found, metrics=metrics, requests=len(run_.requests),
        recorded=len({s[2] for s in rec.spans}), spans=len(rec.spans),
        host_reads={k: v for k, v in _totals(rec).items()
                    if k.startswith("host_reads")})
    return code, result, lines


def _totals(rec) -> dict:
    tot: dict = {}
    for counts in rec.counts.values():
        for k, v in counts.items():
            tot[k] = tot.get(k, 0) + v
    return tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    code, result, lines = probe(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), args.device, T_PROCESS)
    for line in lines:
        print(line, file=sys.stderr)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
