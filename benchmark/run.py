"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, benchmark/ and the
program (vanderbei_tpu_torch).  Needs as many CUDA devices as the cell's
"chips"; without them it exits 2 and prints no result.  The last line of
standard output is the result (JSON); the last lines of standard error are
the numbers compared, each beside its limit.  Exit codes: 0 a result was
printed (correct or not), 2 too few CUDA devices, 3 a forbidden module
(jax, jaxlib, flax, vanderbei_tpu) was loaded, 1 anything else.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the script's own folder would shadow standard modules (trace, ...)
sys.path[0] = ROOT
# the build and kernel caches live in the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".bench_cache", "cuda")
# few host threads a process, the same in every run: a card's host is
# shared, and thread pools that fill it make runs spread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "4"

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    chips = harness.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    code, result, lines = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", T_PROCESS)
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
