"""Warm solves and one torch.profiler trace per method on the card.

    python3 chip_smoke.py            # writes the MPS files
    python3 vanderbei_tpu_torch/tools/profile_solves.py [--out FILE]

hsd on the smoke LP and intpt on its ranged twin (both under
vanderbei_tpu_torch/_build/smoke): three timed solves each, then a fourth
under torch.profiler.  Prints solve_time_s, the per-stage split, the
kernel's launches, device time (the sum of the CUDA events and their
union), the device-busy share of solve_time_s, and the top kernels and
aten ops; --out also writes the tables to FILE.
"""

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import vanderbei_tpu_torch as vtt  # noqa: E402
from vanderbei_tpu_torch.ops import syrk  # noqa: E402

SMOKE = os.path.join(syrk.BUILD_DIR, "smoke")


def dev_time(evt, self_=True):
    """An event's (self) device time in us, under either torch's name."""
    for name in (("self_device_time_total", "self_cuda_time_total") if self_
                 else ("device_time_total", "cuda_time_total")):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def run(path, method):
    """Three timed solves and one profiled; returns the tables' text."""
    lp = vtt.read_mps(path)
    for i in range(3):
        syrk.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = vtt.solve(lp, method=method, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = "; ".join(f"{s['precision']} {s['iterations']} it "
                       f"{s['seconds']:.4f} s" for s in sol.stages)
        print(f"{method} solve {i}: status {sol.status} obj "
              f"{sol.primal_obj!r} it {sol.iterations} solve_time_s "
              f"{sol.solve_time_s:.4f} wall {wall:.4f} [{st}] launches "
              f"{syrk.launch_count()} {dict(syrk.route_launches)}",
              flush=True)
    syrk.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sol = vtt.solve(lp, method=method, device="cuda")
        torch.cuda.synchronize()
    ivals = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    total = sum(b - a for a, b in ivals)
    union = union_us(ivals)
    print(f"{method} profiled solve: solve_time_s {sol.solve_time_s:.4f}, "
          f"launches {syrk.launch_count()}; device events {len(ivals)}, sum "
          f"{total / 1e3:.3f} ms, union {union / 1e3:.3f} ms, busy "
          f"{union / 1e6 / sol.solve_time_s:.1%} of solve_time_s",
          flush=True)
    avgs = prof.key_averages()
    kern = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                  key=dev_time, reverse=True)
    lines = [f"== {method}: kernels by self device time"]
    for a in kern[:15]:
        lines.append(f"{dev_time(a) / 1e3:10.3f} ms "
                     f"{dev_time(a) / total:6.1%} {a.count:6d}x  "
                     f"{a.key[:110]}")
    ops = sorted((a for a in avgs if a.device_type == DeviceType.CPU
                  and a.key.startswith("aten::")),
                 key=lambda a: dev_time(a, self_=False), reverse=True)
    lines.append(f"== {method}: aten ops by device time (incl. children)")
    for a in ops[:12]:
        lines.append(f"{dev_time(a, False) / 1e3:10.3f} ms {a.count:6d}x  "
                     f"{a.key}")
    text = "\n".join(lines)
    print(text, flush=True)
    return text


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the tables here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solves: no CUDA device", file=sys.stderr)
        return 2
    text = "\n".join([run(os.path.join(SMOKE, "rand2000.mps"), "hsd"),
                      run(os.path.join(SMOKE, "rand2000r.mps"), "intpt")])
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
