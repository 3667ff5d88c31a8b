"""A rank (> 0) of a benchmark run on several chips; run.py starts one a
chip beside itself (rank 0).

    python benchmark/worker.py --root R --workload W --seed N --seconds S
        --trace T --rank r --world w --port p --device cuda|cpu
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".bench_cache", "cuda")
# few host threads a process, the same in every run: a card's host is
# shared, and thread pools that fill it make runs spread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "4"

import argparse  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name in ("root", "workload", "device"):
        ap.add_argument("--" + name, required=True)
    for name in ("seed", "trace", "rank", "world", "port"):
        ap.add_argument("--" + name, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from benchmark import harness
    return harness.worker_main(args.root, args.workload, args.seed,
                               args.seconds, bool(args.trace), args.device,
                               args.rank, args.world, args.port, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
