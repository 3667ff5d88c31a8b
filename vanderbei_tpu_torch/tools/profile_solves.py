"""Warm solves and one torch.profiler trace per method on the card.

    python3 chip_smoke.py            # writes the MPS files
    python3 vanderbei_tpu_torch/tools/profile_solves.py [--out FILE]

hsd on the smoke LP and intpt on its ranged twin, then the batched classes
of chip_smoke.py's phases 10-12 (hsd, intpt, pd; all MPS files under
vanderbei_tpu_torch/_build/smoke): three timed runs each, then a fourth
under torch.profiler (utils/profiling.trace).  Prints solve_time_s (one
LP) or the wall (a class), the per-stage split, the kernel's launches,
device time (the sum of the CUDA events and their union), the
device-busy share, and the top kernels and aten ops; --out also writes
the tables to FILE.
"""

import argparse
import glob
import os
import re
import sys
import time

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import vanderbei_tpu_torch as vtt  # noqa: E402
from vanderbei_tpu_torch.ops import syrk  # noqa: E402
from vanderbei_tpu_torch.parallel import batch as pb  # noqa: E402
from vanderbei_tpu_torch.utils import profiling  # noqa: E402

SMOKE = os.path.join(syrk.BUILD_DIR, "smoke")


def dev_time(evt, self_=True):
    """An event's (self) device time in us, under either torch's name."""
    for name in (("self_device_time_total", "self_cuda_time_total") if self_
                 else ("device_time_total", "cuda_time_total")):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def timed(fn):
    """(seconds on the host clock to the device's end, fn's result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profile_runs(label, fn, describe):
    """Three timed runs of fn and one profiled; describe(out, seconds) ->
    (text, the seconds the busy share is taken of).  Returns the tables'
    text."""
    for i in range(3):
        syrk.reset_counts()
        wall, out = timed(fn)
        print(f"{label} run {i}: {describe(out, wall)[0]}; launches "
              f"{syrk.launch_count()} {dict(syrk.route_launches)}",
              flush=True)
    syrk.reset_counts()
    with profiling.trace(os.path.join(SMOKE, "trace-" + label)) as prof:
        wall, out = timed(fn)
    text, secs = describe(out, wall)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.end - e.time_range.start for e in events)
    union = profiling.device_busy_us(prof)
    print(f"{label} profiled run: {text}, launches {syrk.launch_count()}; "
          f"device events {len(events)}, sum {total / 1e3:.3f} ms, union "
          f"{union / 1e3:.3f} ms, busy {union / 1e6 / secs:.1%}",
          flush=True)
    avgs = prof.key_averages()
    kern = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                  key=dev_time, reverse=True)
    lines = [f"== {label}: kernels by self device time"]
    for a in kern[:15]:
        lines.append(f"{dev_time(a) / 1e3:10.3f} ms "
                     f"{dev_time(a) / total:6.1%} {a.count:6d}x  "
                     f"{a.key[:110]}")
    ops = sorted((a for a in avgs if a.device_type == DeviceType.CPU
                  and a.key.startswith("aten::")),
                 key=lambda a: dev_time(a, self_=False), reverse=True)
    lines.append(f"== {label}: aten ops by device time (incl. children)")
    for a in ops[:12]:
        lines.append(f"{dev_time(a, False) / 1e3:10.3f} ms {a.count:6d}x  "
                     f"{a.key}")
    text = "\n".join(lines)
    print(text, flush=True)
    return text


def run(path, method):
    """One LP through vtt.solve; the busy share is of solve_time_s."""
    lp = vtt.read_mps(path)

    def describe(sol, wall):
        st = "; ".join(f"{s['precision']} {s['iterations']} it "
                       f"{s['seconds']:.4f} s" for s in sol.stages)
        return (f"status {sol.status} obj {sol.primal_obj!r} it "
                f"{sol.iterations} solve_time_s {sol.solve_time_s:.4f} wall "
                f"{wall:.4f} [{st}]", sol.solve_time_s)

    return profile_runs(method, lambda: vtt.solve(lp, method=method,
                                                  device="cuda"), describe)


def run_batch(method):
    """chip_smoke.py's batched class of `method` (its b<method>*.mps) as
    that phase solves it; the busy share is of the wall."""
    paths = sorted(glob.glob(os.path.join(SMOKE, f"b{method}*.mps")),
                   key=lambda p: int(re.findall(r"(\d+)\.mps$", p)[0]))
    cfg = vtt.SolverConfig()
    classes, _ = pb.group_by_class(
        [vtt.read_mps(p) for p in paths], granularity=512,
        use_ub_structure=(method == "hsd"), scale=cfg.scale)
    (key, entries), = classes.items()
    if key[0] == "s":
        A, b, c, ub = pb.stack_class_structured(entries, *key[1:])
    else:
        A, b, c = pb.stack_class(entries, *key)
        ub = None
    stages = []

    def solve():
        stages.clear()
        if method == "hsd":
            return pb.solve_batch_hsd(A, b, c, ub=ub, stages=stages)
        if method == "intpt":
            return pb.solve_batch_intpt(A, b, c, div_detect=cfg.div_detect,
                                        stages=stages)
        return pb.solve_batch_pd(A, b, c, refresh_every=cfg.refresh_every,
                                 seed=cfg.seed)

    def describe(out, wall):
        st = "; ".join(f"{s['precision']} max {int(s['iterations'].max())} "
                       f"sum {int(s['iterations'].sum())} it "
                       f"{s['seconds']:.4f} s" for s in stages)
        return (f"class {key} x{len(entries)}: statuses "
                f"{out[0].tolist()} iterations {out[5].tolist()} wall "
                f"{wall:.4f} s, {len(entries) / wall:.2f} lanes/s [{st}]",
                wall)

    return profile_runs(f"batch-{method}", solve, describe)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the tables here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solves: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    text = "\n".join([run(os.path.join(SMOKE, "rand2000.mps"), "hsd"),
                      run(os.path.join(SMOKE, "rand2000r.mps"), "intpt")]
                     + [run_batch(m) for m in ("hsd", "intpt", "pd")])
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
