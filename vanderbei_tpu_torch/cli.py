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
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the simplex perturbations")
    p.add_argument("--out", default=None, help="solution output path")
    p.add_argument("--no-out", action="store_true")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--free-vars", default="reject",
                   choices=("reject", "split"),
                   help="free (l=-inf) variables: 'reject' matches the "
                        "reference (status 3); 'split' solves them")
    p.add_argument("--precision", default=None,
                   choices=("auto", "mixed", "f32factor", "f64", "dd"),
                   help="precision ladder (default: auto); 'dd' is the "
                        "QuadPrec-equivalent compensated mode")
    p.add_argument("--time-limit", type=float, default=None,
                   help="wall-clock budget in seconds (TIMLIM)")
    p.add_argument("--metrics", default=None, metavar="CSV",
                   help="write the per-iteration metrics table (hsd/hsdls "
                        "only) to this CSV path")
    args = p.parse_args(argv)
    if args.metrics and args.method not in ("hsd", "hsdls"):
        p.error("--metrics requires --method hsd or hsdls "
                "(the table instruments the HSD loop)")

    if args.verbose:
        print("\t+-------------------------------------------------+\n"
              "\t   vanderbei_tpu_torch : PyTorch/CUDA LP framework \n"
              "\t+-------------------------------------------------+")

    lp = read_mps(args.mps)
    if args.verbose:
        print(f"m = {lp.m},n = {lp.n},nz = {lp.nz}")

    cfg = SolverConfig(method=args.method, max_iter=args.max_iter,
                       seed=args.seed, verbose=args.verbose,
                       free_vars=args.free_vars)
    if args.precision:
        cfg = cfg.with_(precision=args.precision)
    if args.time_limit is not None:
        cfg = cfg.with_(time_limit=args.time_limit)
    sol = solve(lp, method=args.method, config=cfg, device=args.device)
    if args.metrics:
        _write_metrics_csv(lp, cfg, args.metrics, args.device,
                           long_step=(args.method == "hsdls"))
        if args.verbose:
            print(f"metrics table -> {args.metrics}")
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
    if not args.no_out:
        write_sol(lp, sol, args.out or (lp.name + ".out"))
    return 0


def _write_metrics_csv(lp, cfg: SolverConfig, path: str, device,
                       long_step: bool = False) -> None:
    """Run hsd.solve_canon_metrics on the same problem configuration as the
    reported solve (cfg's scaling, free-variable policy and dtype; the
    dense, un-paused f64 system, as vanderbei_tpu's CLI does) and write
    its table: one row per iteration, numbers as %.9e."""
    import torch
    from .core.canonicalize import canonicalize
    from .models import hsd

    canon = canonicalize(lp, dtype=cfg.dtype, free_vars=cfg.free_vars,
                         scale=cfg.scale)
    to = lambda a: torch.from_numpy(a).to(device, torch.float64)
    max_iter = cfg.max_iter or (hsd.DEFAULT_MAX_ITER_LS if long_step
                                else hsd.DEFAULT_MAX_ITER)
    _, rows = hsd.solve_canon_metrics(
        to(canon.A), to(canon.b), to(canon.c), canon.f,
        max_iter=max_iter, eps=cfg.hsd_eps, long_step=long_step,
        beta=cfg.beta, step_factor=cfg.hsd_step_factor,
        epsdiag=cfg.epsdiag, refine_tol=cfg.refine_tol,
        max_refine=cfg.max_refine,
        compensated=(cfg.precision == "dd"))
    cols = list(hsd.METRICS)
    with open(path, "w") as fp:
        fp.write("iter," + ",".join(cols) + "\n")
        for i in range(len(rows["mu"])):
            fp.write(f"{i}," + ",".join(f"{rows[k][i]:.9e}" for k in cols)
                     + "\n")


if __name__ == "__main__":
    sys.exit(main())
