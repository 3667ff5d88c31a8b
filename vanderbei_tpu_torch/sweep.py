"""Crash-isolated corpus sweep driver, the port of vanderbei_tpu/sweep.py.

A sticky CUDA error (an illegal address, a failed launch) poisons the
process that owns the context, and every later solve in it fails.  This
driver runs the evaluate sweep in CHUNKED SUBPROCESSES: a crash costs only
its chunk, which is then retried one problem per process so that only the
true offender records an error.

    python -m vanderbei_tpu_torch.sweep --method hsd --out evaluate/t1
    python -m vanderbei_tpu_torch.sweep --batch --device cpu --out DIR

The child is `vanderbei_tpu_torch.evaluate`, whose incremental
README/records writer merges each chunk into the results tree; arguments
this driver does not know (--batch, --device, ...) pass through to it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run_chunk(names, method, out_dir, time_limit, extra, timeout_s):
    cmd = [sys.executable, "-m", "vanderbei_tpu_torch.evaluate",
           "--method", method, "--names", *names]
    if out_dir:
        cmd += ["--out", out_dir]
    if time_limit:
        cmd += ["--time-limit", str(time_limit)]
    cmd += extra
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), timeout=timeout_s)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        rc = -9
    return rc, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vanderbei_tpu_torch.sweep")
    p.add_argument("--method", default="hsd")
    p.add_argument("--out", default=None)
    p.add_argument("--names", nargs="*", default=None)
    p.add_argument("--chunk", type=int, default=8,
                   help="problems per subprocess")
    p.add_argument("--time-limit", type=float, default=None)
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="hard wall per chunk subprocess")
    p.add_argument("--max-rows", type=int, default=None)
    p.add_argument("--max-cols", type=int, default=None)
    p.add_argument("--parallel", type=int, default=1,
                   help="concurrent chunk subprocesses (they share the "
                        "card)")
    args, extra = p.parse_known_args(argv)

    from .io import netlib
    names = args.names or netlib.available_problems(
        max_rows=args.max_rows, max_cols=args.max_cols)

    chunks = [names[i:i + args.chunk]
              for i in range(0, len(names), args.chunk)]
    failed = []
    if args.parallel > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=args.parallel) as ex:
            futs = {ex.submit(run_chunk, chunk, args.method, args.out,
                              args.time_limit, extra, args.timeout): chunk
                    for chunk in chunks}
            for fut, chunk in futs.items():
                rc, secs = fut.result()
                print(f"[sweep] chunk rc={rc} ({secs:.0f}s): "
                      f"{' '.join(chunk)}", flush=True)
                if rc != 0:
                    failed.extend(chunk)
    else:
        for ci, chunk in enumerate(chunks):
            rc, secs = run_chunk(chunk, args.method, args.out,
                                 args.time_limit, extra, args.timeout)
            print(f"[sweep] chunk {ci + 1}/{len(chunks)} rc={rc} "
                  f"({secs:.0f}s): {' '.join(chunk)}", flush=True)
            if rc != 0:
                failed.extend(chunk)
    # crashed chunks: isolate the offender one problem per process
    for name in failed:
        rc, secs = run_chunk([name], args.method, args.out,
                             args.time_limit, extra, args.timeout)
        print(f"[sweep] retry {name} rc={rc} ({secs:.0f}s)", flush=True)

    # repair pass: any error row in the merged records gets one fresh
    # single-problem process (a poisoned process can write error rows
    # inside an rc=0 chunk); a tree that stays majority-error FAILS the
    # sweep, so that it is not taken for results
    if args.out:
        rec_path = os.path.join(args.out, "netlib", args.method,
                                "records.json")

        def error_rows():
            if not os.path.exists(rec_path):
                return []
            with open(rec_path) as fp:
                return [r["name"] for r in json.load(fp)
                        if r["status"] < 0 and r["name"] in names]

        for name in error_rows():
            rc, secs = run_chunk([name], args.method, args.out,
                                 args.time_limit, extra, args.timeout)
            print(f"[sweep] repair {name} rc={rc} ({secs:.0f}s)",
                  flush=True)
        still = error_rows()
        if len(still) > 0.5 * max(1, len(names)):
            print(f"[sweep] FAILED: {len(still)}/{len(names)} rows "
                  f"are error rows after repair — tree is NOT valid "
                  f"results: {' '.join(still[:10])}...", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
