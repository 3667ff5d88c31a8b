"""Data-parallel scaling of the batched HSD solve over a mesh's "batch"
ranks, the port of scripts/multichip_scaling.py.

    python3 vanderbei_tpu_torch/tools/multichip_scaling.py --ranks N [--out F]

Times one size class solved by parallel/batch.solve_batch_hsd (a) on one
card and (b) over the "batch" dim of make_mesh(N) (model_parallel=1: each
rank solves B / N lanes with all their columns), one rank per card under
nccl (parallel/distributed.run_ranks).  The class is generated, so no
corpus is needed: chip_smoke.py phase 10's 16 LPs random_bounded_lp(560 +
4j, 1100 + 9j, seed=j), grouped as the batched corpus sweep groups them
(granularity 512, the UbTail structure) into one class ("s", 1024, 1536,
1536).

Each way runs once to warm up on the class as made, then REPS times, each
rep on A jiggled by a factor 1 + 1e-9 (rep + 1), with the results fetched
to the host; the median rep is reported.  The single runs are rank 0's,
on its card, while the other ranks wait; a sharded rep is timed on rank 0
from a barrier to the gathered class (shard_batch, the solve,
gather_lanes).  One more sharded rep runs under torch.profiler for each
rank's device-busy share.

Prints one JSON line: n_ranks, backend, card (name and power limit, as
nvidia-smi gives them), batch, class, t_single_s, t_sharded_s,
overhead_frac = (t_sharded - t_single) / t_single, reps_single_s and
reps_sharded_s (every timed rep, for the spread), all_lanes_optimal,
launches (the kernel's, by shape and layout, on each rank in the first
sharded run) and busy (each rank's device-busy share); and writes it to
--out when given.  Exits 1 if a lane is not OPTIMAL or the sharded
statuses or iterations differ from the single run's of the same rep.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from vanderbei_tpu_torch.core.config import SolverConfig  # noqa: E402
from vanderbei_tpu_torch.ops import syrk  # noqa: E402
from vanderbei_tpu_torch.parallel import batch as pb  # noqa: E402
from vanderbei_tpu_torch.parallel.distributed import run_ranks  # noqa: E402
from vanderbei_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from vanderbei_tpu_torch.utils.profiling import (  # noqa: E402
    busy_share, device_trace)
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp  # noqa: E402

REPS = 3
PHASE10 = [(560 + 4 * j, 1100 + 9 * j, j) for j in range(16)]


def generated_class(dims=PHASE10, granularity=512):
    """The one size class of random_bounded_lp(m, n, seed) for each (m, n,
    seed) of dims, grouped with the UbTail structure: (key, (A, b, c,
    ub))."""
    cfg = SolverConfig()
    lps = [random_bounded_lp(m, n, seed=seed) for m, n, seed in dims]
    classes, aborted = pb.group_by_class(
        lps, granularity=granularity, use_ub_structure=True,
        scale=cfg.scale, free_vars=cfg.free_vars)
    if aborted or len(classes) != 1:
        raise ValueError(f"not one class: {sorted(classes)}, aborted "
                         f"{aborted}")
    (key, entries), = classes.items()
    return key, pb.stack_class_structured(entries, *key[1:])


def scaling_rank(rank, world, device, make_class=generated_class,
                 class_args=()):
    """One rank's runs: the single ones (rank 0 only) and the sharded ones,
    each a record of its label, seconds, statuses and iterations (the
    whole class, on the host); a sharded record also has the rank's kernel
    launches by (shape, layout) and its f32-stage iterations; then the
    rank's device-busy share in a profiled sharded rep."""
    key, (A, b, c, ub) = make_class(*class_args)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: 0)
    mesh = make_mesh(world, model_parallel=1, device_type=device.type)
    corrector = SolverConfig().hsd_corrector

    def single(A_):
        out = pb.solve_batch_hsd(A_, b, c, ub=ub, corrector=corrector,
                                 device=device)
        return out[0], out[5], []

    def sharded(A_):
        A_k, b_k, c_k, i_k, w_k = pb.shard_batch([A_, b, c, ub.idx2, ub.w2],
                                                 mesh)
        stages = []
        out = pb.solve_batch_hsd(A_k, b_k, c_k, ub=pb.UbTail(i_k, w_k),
                                 corrector=corrector, device=device,
                                 stages=stages, mesh=mesh)
        st, _, it = pb.gather_lanes([out[0], out[1], out[5]], mesh)
        return st, it, stages

    def run(solve, label, A_):
        syrk.reset_counts()
        sync()
        t0 = time.perf_counter()
        st, it, stages = solve(A_)
        st, it = st.cpu().numpy(), it.cpu().numpy()
        secs = time.perf_counter() - t0
        f32 = [int(s["iterations"].max()) for s in stages
               if s["precision"] == "f32"]
        return dict(label=label, seconds=secs, status=st, iters=it,
                    launches=dict(syrk.launch_shapes), f32_iters=sum(f32))

    # run 0 warms up on the class as made, runs 1..REPS are the timed reps
    jiggled = lambda i: A if i == 0 else A * (1.0 + 1e-9 * i)
    out = dict(key=key, single=[], sharded=[])
    if rank == 0:
        out["single"] = [run(single, i, jiggled(i))
                         for i in range(REPS + 1)]
    for i in range(REPS + 1):
        A_ = jiggled(i)
        dist.barrier()
        out["sharded"].append(run(sharded, i, A_))
    dist.barrier()
    with device_trace(cuda) as prof:
        rec = run(sharded, "profiled", A_)
    out["busy"] = busy_share(prof, rec["seconds"])
    return out


def measure(world, backend, device, make_class=generated_class,
            class_args=(), timeout_s=600.0):
    """scaling_rank on `world` ranks (run_ranks): their records, in rank
    order."""
    return run_ranks(scaling_rank, world, backend, device,
                     timeout_s=timeout_s, args=(make_class, class_args))


def summary(results, backend, card):
    """(the JSON line's record, the faults found) from measure()'s
    results."""
    single, sharded = results[0]["single"], results[0]["sharded"]
    faults = []
    for s, p in zip(single, sharded):
        if not (np.array_equal(s["status"], p["status"])
                and np.array_equal(s["iters"], p["iters"])):
            faults.append(f"run {s['label']}: sharded statuses "
                          f"{p['status'].tolist()} and iterations "
                          f"{p['iters'].tolist()} differ from the single "
                          f"run's {s['status'].tolist()}, "
                          f"{s['iters'].tolist()}")
    optimal = all(np.all(r["status"] == 0) for r in single + sharded)
    if not optimal:
        faults.append("a lane is not OPTIMAL")
    reps_single = [r["seconds"] for r in single[1:]]
    reps_sharded = [r["seconds"] for r in sharded[1:]]
    t_single, t_sharded = map(float, (np.median(reps_single),
                                      np.median(reps_sharded)))
    line = dict(
        n_ranks=len(results), backend=backend, card=card,
        batch=int(single[0]["status"].shape[0]),
        **{"class": list(results[0]["key"])},
        t_single_s=t_single, t_sharded_s=t_sharded,
        overhead_frac=(t_sharded - t_single) / t_single,
        reps_single_s=reps_single, reps_sharded_s=reps_sharded,
        all_lanes_optimal=optimal,
        launches=[{f"{shape} {layout}": n for (shape, layout), n in
                   r["sharded"][0]["launches"].items()} for r in results],
        busy=[r["busy"] for r in results])
    return line, faults


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("multichip_scaling: no CUDA device", file=sys.stderr)
        return 2
    results = measure(args.ranks, "nccl", "cuda")
    line, faults = summary(results, "nccl", card_line())
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    for fault in faults:
        print(f"multichip_scaling: {fault}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
