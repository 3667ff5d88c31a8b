"""Warm solves of one MPS file with the package of two source trees, in
alternating processes on the card.

    python3 vanderbei_tpu_torch/tools/ab_solve.py MPS TREE_A TREE_B \\
        [--pairs 10] [--reps 5] [--method hsd]

Pair i runs one process per tree, A then B for even i and B then A for odd
i, so neither tree always runs first.  Each process imports
vanderbei_tpu_torch from its tree, solves MPS with --method (hsd by
default) reps + 1 times and keeps the warm solves' solve_time_s (the first
solve, which carries the kernel build and the cuBLAS/cuSOLVER set-up, is
left out).  Prints one JSON line per process, then a JSON summary: per
tree the median of every warm solve and of the process medians, and for
each pair B's process median over A's.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def worker(tree, mps, reps, method):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import vanderbei_tpu_torch as vtt
    if not os.path.dirname(vtt.__file__).startswith(tree):
        raise RuntimeError(f"imported {vtt.__file__}, not from {tree}")
    lp = vtt.read_mps(mps)
    times, walls, runs = [], [], set()
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = vtt.solve(lp, method=method, device="cuda")
        torch.cuda.synchronize()
        if i:
            times.append(sol.solve_time_s)
            walls.append(time.perf_counter() - t0)
        runs.add((sol.status, sol.iterations))
    print(json.dumps({"tree": tree, "status_iterations": sorted(runs),
                      "solve_time_s": times, "wall_s": walls,
                      "median_solve_time_s": statistics.median(times)}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mps")
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--method", default="hsd")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    mps = os.path.abspath(args.mps)
    a, b = os.path.abspath(args.tree_a), os.path.abspath(args.tree_b)
    if args.worker:
        return worker(a, mps, args.reps, args.method)

    runs = {a: [], b: []}
    ratios = []
    for i in range(args.pairs):
        pair = {}
        for tree in ((a, b) if i % 2 == 0 else (b, a)):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), mps, tree, tree,
                 "--reps", str(args.reps), "--method", args.method,
                 "--worker"],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec["pair"] = i
            print(json.dumps(rec), flush=True)
            runs[tree].append(rec)
            pair[tree] = rec["median_solve_time_s"]
        ratios.append(pair[b] / pair[a])
    outcomes = {tuple(o) for rs in runs.values() for r in rs
                for o in r["status_iterations"]}
    summary = {"mps": mps, "method": args.method, "pairs": args.pairs,
               "reps": args.reps,
               "status_iterations": sorted(outcomes)}
    for key, tree in (("a", a), ("b", b)):
        summary[key] = {
            "tree": tree,
            "median_of_all": statistics.median(
                t for r in runs[tree] for t in r["solve_time_s"]),
            "median_of_process_medians": statistics.median(
                r["median_solve_time_s"] for r in runs[tree])}
    summary["b_over_a_by_pair"] = ratios
    summary["b_over_a_median"] = statistics.median(ratios)
    summary["pairs_b_slower"] = sum(r > 1.0 for r in ratios)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
