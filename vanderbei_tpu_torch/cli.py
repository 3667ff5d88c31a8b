"""Command-line driver, the port of vanderbei_tpu/cli.py: read an MPS file,
solve on the chosen device, print the status message and write `<name>.out`.

    python -m vanderbei_tpu_torch problem.mps --method hsd --device cuda
"""

from __future__ import annotations

import argparse
import sys

from .core.config import SolverConfig
from .core.status import status_message
from .io.mps import read_mps
from .io.writer import write_sol
from .models.registry import solve, SOLVERS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vanderbei_tpu_torch")
    p.add_argument("mps", nargs="+", help="MPS input file(s)")
    p.add_argument("--method", default="hsd", choices=sorted(SOLVERS))
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default cuda; there is "
                        "no fallback, pass cpu explicitly)")
    p.add_argument("--max-iter", type=int, default=0)
    p.add_argument("--out", default=None, help="solution output path")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--free-vars", default="reject",
                   choices=("reject", "split"),
                   help="free (l=-inf) variables: 'reject' matches the "
                        "reference (status 3); 'split' solves them")
    p.add_argument("--precision", default=None,
                   choices=("auto", "mixed", "f32factor", "f64"),
                   help="precision ladder (default: auto)")
    p.add_argument("--time-limit", type=float, default=None,
                   help="wall-clock budget in seconds (TIMLIM)")
    args = p.parse_args(argv)

    if args.verbose:
        print("\t+-------------------------------------------------+\n"
              "\t   vanderbei_tpu_torch : PyTorch/CUDA LP framework \n"
              "\t+-------------------------------------------------+")

    lp = read_mps(args.mps)
    if args.verbose:
        print(f"m = {lp.m},n = {lp.n},nz = {lp.nz}")

    cfg = SolverConfig(method=args.method, max_iter=args.max_iter,
                       verbose=args.verbose, free_vars=args.free_vars)
    if args.precision:
        cfg = cfg.with_(precision=args.precision)
    if args.time_limit is not None:
        cfg = cfg.with_(time_limit=args.time_limit)
    sol = solve(lp, method=args.method, config=cfg, device=args.device)
    print(status_message(sol.status))
    if args.verbose:
        print(f"primal objective: {sol.primal_obj:.15e}")
        print(f"dual   objective: {sol.dual_obj:.15e}")
        print(f"iterations: {sol.iterations}   "
              f"solve time: {sol.solve_time_s:.3f}s")
        for st in sol.stages:
            print(f"stage {st['precision']}: iterations {st['iterations']}, "
                  f"{st['seconds']:.3f} s"
                  + (", paused at the stage boundary" if st["paused"]
                     else ""))
    write_sol(lp, sol, args.out or (lp.name + ".out"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
