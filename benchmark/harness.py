"""One run of one cell: set-up, the measured window, the comparison that
decides `correct`, the metrics and the result line.

Everything a cell is made of is found by name from BENCHMARK.json:

    configs       the file its "file" key names
    traffic       <bench>/traffic/<traffic>.json
    cell limits   <bench>/cells/<workload>.json
    metrics       <bench>/metrics/<metric>.py, each with read(run) -> value
                  or None (nothing to read: the metric is left out)

where <bench> is the first of BENCHMARK.json's "paths".  A cell, a traffic
mix, a configuration or a metric is added by adding files and entries.

The window is a closed loop with one caller: a request is handed to the
program as soon as the previous answer is on the host, until `seconds`
have passed; the request that is running then finishes inside the window.
A request's latency runs from handing the program its LPs to the answers
on the host, in the LP's own variables; its data (a fresh b and c) is made
before that, outside the latency.  A cell on several chips runs one rank a
chip (this process is rank 0, the others run worker.py), each solving its
share of every request.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from . import reference, workload as workload_mod
from . import trace as trace_mod

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vanderbei_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    spec: dict
    bench_dir: str

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: its end-to-end ones, or
        with trace its per-layer ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def load_cell(root: str, name: str) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, spec["paths"][0])
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(bench_dir, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(bench_dir, "cells", name + ".json")),
        spec=spec, bench_dir=bench_dir)


def load_reader(bench_dir: str, metric: str):
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "_bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    """What a run leaves for the metrics' readers.

    requests: one dict a request: traced (inside the traced part of the
    window), latency_s, solve_s (the entry's call to
    its outputs on the host), rank_solve_s (per rank: the entry's call to
    the rank's lanes solved), shapes ((m, n) per LP), status and
    iterations (per LP; pd: pivots), f32_iterations (per LP: its
    iterations in f32 stages; None where this rank did not solve it),
    stages (single: each LP's
    Solution.stages; batch: one list of stage records per class).
    trace: None, or the reduced trace of the first rank (trace.reduce) with
    window_s, and "ranks": every rank's busy_s and window_s."""

    setup_s: float
    window_s: float
    requests: list
    card: str
    trace: dict | None = None


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """The other ranks of a run on several chips: worker.py processes, one
    a chip, joined with this process (rank 0) in one process group."""

    def __init__(self, root, cell, seed, seconds, trace, device):
        self.world = cell.chips
        self.port = free_port()
        self.procs = []
        worker = os.path.join(cell.bench_dir, "worker.py")
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, worker, "--root", root, "--workload",
                 cell.name, "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", str(int(trace)), "--rank", str(r), "--world",
                 str(self.world), "--port", str(self.port), "--device",
                 device]))

    def close(self, timeout: float = 60.0) -> list:
        """Wait for every worker (killing those still running after
        timeout); returns their exit codes."""
        deadline = time.monotonic() + timeout
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        return codes


def init_group(rank: int, world: int, port: int, device) -> object:
    """Join the run's process group (nccl on cards, gloo on the CPU) and
    return the ("batch", "model") mesh of model_parallel 1."""
    import torch.distributed as dist
    from vanderbei_tpu_torch.parallel.mesh import make_mesh
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=240))
    return make_mesh(world, model_parallel=1, device_type=device.type)


def rank_device(device: str, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank)
    return device


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_process: float, mesh=None) -> dict:
    """This rank's part of a run: set-up, the window, and what the run
    reports of this rank.  Returns {setup_s, window_s, requests (rank 0:
    with the answers and the LPs they answer), memory_peak_bytes, trace,
    forbidden}."""
    from . import drivers
    cuda = device.type == "cuda"
    work = workload_mod.Workload(cell.config, cell.traffic, seed)
    program = drivers.Program(work, cell.traffic, device, mesh)
    dist = None
    if mesh is not None:
        import torch.distributed as dist
    # the warm-up request: every shape of the cell's traffic, the kernel
    # built and loaded, the libraries' handles made, pd's graph captured
    program.run(program.lps(-1, work.request(-1)))
    program.sync()
    if dist is not None:
        dist.barrier()
    program.spans.clear()
    requests = []
    # the trace covers the window's first trace_seconds (by default all of
    # it), to the end of the request running then: a profiler's stop takes
    # time in proportion to the events, and a pd window holds millions
    trace_s = float(cell.traffic.get("trace_seconds", seconds))
    prof = trace_mod.capture() if (trace and cuda) else None
    host_mark = None
    if prof is not None:
        prof.__enter__()
        host_mark = trace_mod.mark(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    traced_s = stop_s = None
    r = 0
    while True:
        elapsed = time.perf_counter() - t_window
        go, tracing = elapsed < seconds, elapsed < trace_s
        if dist is not None:
            flag = torch.tensor([int(go), int(tracing)], device=device)
            dist.broadcast(flag, src=0)
            go, tracing = bool(flag[0]), bool(flag[1])
        if prof is not None and traced_s is None and not (go and tracing):
            program.sync()
            traced_s = time.perf_counter() - t_window
            t0 = time.perf_counter()
            prof.__exit__(None, None, None)
            stop_s = time.perf_counter() - t0
        if not go:
            break
        ns = time.perf_counter_ns()
        nats = work.request(r)
        lps = program.lps(r, nats)
        program.spans.append(("prepare", ns, time.perf_counter_ns()))
        if dist is not None:
            dist.barrier()
        t0 = time.perf_counter()
        out = program.run(lps)
        latency = time.perf_counter() - t0
        rec = dict(latency_s=latency, solve_s=out["solve_s"],
                   rank_solve_s=[out.get("rank_solve_s", out["solve_s"])],
                   shapes=[nat.shape for nat in nats],
                   iterations=out["iterations"],
                   f32_iterations=out["f32_iterations"],
                   stages=out["stages"],
                   traced=prof is not None and traced_s is None)
        if out["answers"] is not None:
            rec.update(answers=out["answers"], lps=nats,
                       status=[a[0] for a in out["answers"]])
        requests.append(rec)
        r += 1
    program.sync()
    window_s = time.perf_counter() - t_window
    reduced = None
    if prof is not None:
        t0 = time.perf_counter()
        reduced = trace_mod.reduce(prof, host_mark, program.spans)
        reduced.update(window_s=traced_s, stop_s=stop_s,
                       reduce_s=time.perf_counter() - t0)
        del prof
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(setup_s=setup_s, window_s=window_s, requests=requests,
                memory_peak_bytes=peak, trace=reduced,
                forbidden=forbidden_modules())


def decide(cell: Cell, requests: list, device) -> tuple:
    """(correct, {name: (value, limit)} of the numbers compared, the
    judge's numbers, the reference's seconds) over every LP the window
    returned."""
    lps = [lp for rq in requests for lp in rq["lps"]]
    answers = [a for rq in requests for a in rq["answers"]]
    t0 = time.perf_counter()
    numbers = reference.judge(lps, answers, device)
    seconds = time.perf_counter() - t0
    checks = {name: (numbers[name], limit)
              for name, limit in cell.limits["limits"].items()}
    ok = bool(requests) and all(v <= lim for v, lim in checks.values())
    return ok, checks, numbers, seconds


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_process: float) -> tuple:
    """Run one cell once; returns (exit code, result line or None, the
    check lines for standard error)."""
    cell = load_cell(root, name)
    dev = rank_device(device, 0)
    ranks = mesh = None
    try:
        if cell.chips > 1:
            ranks = Ranks(root, cell, seed, seconds, trace, device)
            mesh = init_group(0, cell.chips, ranks.port, dev)
        mine = measure(cell, seed, seconds, trace, dev, t_process, mesh)
        parts = [mine]
        if mesh is not None:
            import torch.distributed as dist
            parts = [None] * cell.chips
            dist.all_gather_object(parts, _portable(mine))
            parts[0] = mine
            dist.destroy_process_group()
    finally:
        codes = ranks.close() if ranks is not None else []
    if any(codes):
        print(f"benchmark: a rank exited with {codes}", file=sys.stderr)
        return 1, None, []
    requests = mine["requests"]
    for k, rec in enumerate(requests):
        rec["rank_solve_s"] = [p["requests"][k]["rank_solve_s"][0]
                               for p in parts]
    correct, checks, numbers, ref_s = decide(cell, requests, dev)
    run = Run(setup_s=mine["setup_s"], window_s=mine["window_s"],
              requests=requests,
              card=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
              trace=mine["trace"])
    if run.trace is not None:
        run.trace["ranks"] = [dict(busy_s=p["trace"]["busy_s"],
                                   window_s=p["trace"]["window_s"])
                              for p in parts]
    metrics = {}
    for entry in cell.metrics(trace):
        value = load_reader(cell.bench_dir, entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = dict(value=float(value),
                                          unit=entry["unit"])
    found = sorted(set(forbidden_modules()).union(
        *(p["forbidden"] for p in parts)))
    if found:
        print(f"benchmark: modules loaded that a run may not load: {found}",
              file=sys.stderr)
        return 3, None, []
    n_lps = sum(len(rq["status"]) for rq in requests)
    failed = sum(int(s) != 0 for rq in requests for s in rq["status"])
    deviceinfo = dict(platform="gpu" if dev.type == "cuda" else "cpu",
                      kind=run.card, count=cell.chips,
                      memory_peak_bytes=max(p["memory_peak_bytes"]
                                            for p in parts))
    result = dict(correct=correct, attempted=n_lps, failed=failed,
                  metrics=metrics, device=deviceinfo)
    if run.trace is not None:
        ranks_t = run.trace["ranks"]
        deviceinfo["busy_s"] = sum(t["busy_s"] for t in ranks_t) / len(ranks_t)
        deviceinfo["window_s"] = run.trace["window_s"]
        result["breakdown"] = dict(device_ops=run.trace["device_ops"],
                                   idle_gaps=run.trace["idle_gaps"])
    result["checks"] = {k: dict(value=v, limit=lim)
                        for k, (v, lim) in checks.items()}
    lines = [f"{k} (not compared): {numbers[k]!r}"
             for k in reference.REPORTED if k not in checks]
    lines.append(f"reference: {n_lps} LPs in {ref_s:.1f} s")
    lat = sorted(rq["latency_s"] for rq in requests)
    lines.append(f"latency: {len(lat)} requests, min {lat[0]:.4f} quartiles "
                 + " ".join(f"{q:.4f}" for q in np.percentile(lat, [25, 50, 75]))
                 + f" max {lat[-1]:.4f} s")
    if run.trace is not None:
        lines.append(f"trace: {run.trace['events']} device events over "
                     f"{run.trace['window_s']:.1f} s, profiler stop "
                     f"{run.trace['stop_s']:.1f} s, reduction "
                     f"{run.trace['reduce_s']:.1f} s")
    lines += [f"check {k}: {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}"
              for k, (v, lim) in checks.items()]
    lines.append(f"correct {correct}")
    return 0, result, lines


def worker_main(root: str, name: str, seed: int, seconds: float,
                trace: bool, device: str, rank: int, world: int, port: int,
                t_process: float) -> int:
    """Rank `rank` (> 0) of a run on several chips: its part of every
    request, sent to rank 0 when the window has closed."""
    import torch.distributed as dist
    cell = load_cell(root, name)
    dev = rank_device(device, rank)
    mesh = init_group(rank, world, port, dev)
    mine = measure(cell, seed, seconds, trace, dev, t_process, mesh)
    dist.all_gather_object([None] * world, _portable(mine))
    dist.destroy_process_group()
    return 0


def _portable(part: dict) -> dict:
    """A rank's part without its answers and LPs, to send to rank 0."""
    return dict(part, requests=[
        {k: v for k, v in rq.items() if k not in ("answers", "lps")}
        for rq in part["requests"]])
