"""The control of a cell's comparison: the reference put in the program's
place, computed in float32 (TF32 off), one step below the float64 that the
configurations state.  Its answers go through the same judge as a run's,
and the cell's limits must fail them.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 --requests N

makes, for each seed, the first N requests of the cell (as a run makes
them), answers every LP with the float32 reference (status OPTIMAL where it
converged to its own float32 tolerance, else ITERATION_LIMIT), judges them
and prints one JSON line: the seed, the numbers compared, and whether the
cell's limits pass them.  The benchmark's own runs never run it.  It needs
a CUDA device unless --device cpu is given.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402


def control_numbers(cell, seed: int, requests: int, device) -> dict:
    """The judged numbers of the float32 control on a cell's first
    `requests` requests of `seed`."""
    import torch
    from benchmark import reference, workload
    work = workload.Workload(cell.config, cell.traffic, seed)
    lps = [lp for r in range(requests) for lp in work.request(r)]
    t0 = time.perf_counter()
    solved = reference.reference_solve(lps, device, dtype=torch.float32)
    seconds = time.perf_counter() - t0
    answers = [(0 if conv else 5, obj, x) for x, obj, conv in solved]
    numbers = reference.judge(lps, answers, device)
    numbers.update(seed=seed, lps=len(lps), control_seconds=seconds)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cell, seed, args.requests, device)
        numbers["fails_limits"] = any(
            numbers[k] > lim for k, lim in cell.limits["limits"].items())
        print(json.dumps(numbers), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
