"""Solve one LP tensor-parallel over several ranks and hold it against the
single-card solve.

    python3 vanderbei_tpu_torch/tools/mesh_solve.py [FILE.mps] --ranks 4

--ranks N spawns N ranks (parallel/distributed.run_ranks), rank r on card
r, under nccl.  Each rank solves the LP (FILE.mps, or chip_smoke.py's
phase-4 LP, random_bounded_lp(2000, 4000, seed=0), made in memory) with
solve(lp, mesh=make_mesh(N, model_parallel=N)) twice, cold then warm; then
this process solves it on card 0 alone, cold then warm.  Prints a line per
solve: status, objective and its distance from the single solve,
iterations, wall, the all-reduces, bytes and all-reduce share of the wall
per iteration, and the kernel's launches by shape on each rank.  Exits 1
if a tensor-parallel solve is not OPTIMAL, its ranks disagree, or it is
more than 1e-9 from the single solve or 2 iterations off it.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import vanderbei_tpu_torch as vtt  # noqa: E402
from vanderbei_tpu_torch.ops import syrk  # noqa: E402
from vanderbei_tpu_torch.parallel.distributed import run_ranks  # noqa: E402
from vanderbei_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp  # noqa: E402


def load(mps):
    return (vtt.read_mps(mps) if mps
            else random_bounded_lp(2000, 4000, density=0.02, seed=0))


def timed_solves(solve):
    """Two solves, cold then warm: [(Solution, seconds, launches by
    shape)]."""
    out = []
    for _ in range(2):
        syrk.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve()
        torch.cuda.synchronize()
        out.append((sol, time.perf_counter() - t0, dict(syrk.launch_shapes)))
    return out


def rank_solves(rank, world, device, mps):
    lp = load(mps)
    mesh = make_mesh(world, model_parallel=world)
    return [(dict(status=s.status, obj=s.primal_obj, iterations=s.iterations,
                  stages=s.stages), secs, shapes)
            for s, secs, shapes in timed_solves(
                lambda: vtt.solve(lp, device=device, mesh=mesh))]


def traffic(stages, iterations):
    calls = sum(s["all_reduces"] for s in stages)
    nbytes = sum(s["all_reduce_bytes"] for s in stages)
    share = (sum(s["all_reduce_seconds"] for s in stages)
             / sum(s["seconds"] for s in stages))
    return (f"{calls / iterations:.1f} all-reduces, "
            f"{nbytes / iterations / 1e6:.3f} MB an iteration, "
            f"{100 * share:.1f} % of the wall in them")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mps", nargs="?")
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_solve: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    ranks = run_ranks(rank_solves, args.ranks, "nccl", "cuda",
                      timeout_s=args.timeout, args=(args.mps,))
    t_ranks = time.perf_counter() - t0
    lp = load(args.mps)
    single = timed_solves(lambda: vtt.solve(lp, device="cuda:0"))
    ref = single[1][0]
    card = torch.cuda.get_device_name(0)
    print(f"mesh_solve: {lp.name} {lp.m} x {lp.n}; {card}, "
          f"{torch.cuda.device_count()} cards; {args.ranks} ranks under "
          f"nccl, one a card (spawn to end {t_ranks:.2f} s)",
          flush=True)
    for (sol, secs, shapes), label in zip(single, ("cold", "warm")):
        print(f"single {label}: status {sol.status} obj {sol.primal_obj!r} "
              f"{sol.iterations} iterations {secs:.3f} s launches {shapes}",
              flush=True)
    ok = True
    for i, label in enumerate(("cold", "warm")):
        runs = [r[i] for r in ranks]
        sol = runs[0][0]
        agree = len({(s["status"], s["obj"], s["iterations"])
                     for s, _, _ in runs}) == 1
        rel = abs(sol["obj"] - ref.primal_obj) / max(1.0, abs(ref.primal_obj))
        print(f"mesh {label}: status {sol['status']} obj {sol['obj']!r} rel "
              f"{rel:.3e} to the single solve, {sol['iterations']} "
              f"iterations, ranks agree {agree}; wall by rank "
              f"{[round(secs, 3) for _, secs, _ in runs]} s; "
              f"{traffic(sol['stages'], sol['iterations'])}; launches by "
              f"rank {[shapes for _, _, shapes in runs]}", flush=True)
        ok = ok and (agree and sol["status"] == 0 and rel <= 1e-9
                     and abs(sol["iterations"] - ref.iterations) <= 2)
    print(f"mesh_solve: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
