"""Rank functions of tests/test_torch_mesh*.py, run by
vanderbei_tpu_torch.parallel.distributed.run_ranks on CPU ranks (gloo).

They import torch and the port only: each spawned rank imports this
module, so it stays free of JAX.  Each returns numpy arrays and Python
values, which the tests compare with the JAX package in the parent.
"""

import numpy as np
import torch

import vanderbei_tpu_torch as vtt
from vanderbei_tpu_torch.core.builder import LPBuilder
from vanderbei_tpu_torch.parallel import batch as tb
from vanderbei_tpu_torch.parallel.distributed import (
    ColumnShards, place_column_sharded, sharded_kkt_solve,
    sharded_normal_matrix)
from vanderbei_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                               replicated)

# the tensor-parallel solves: LP, method, precision
LP_KINDS = ("dense", "ub")
METHODS = ("hsd", "hsdls")
PRECISIONS = ("f64", "mixed")
SOLVE_CASES = [(k, m, p) for k in LP_KINDS for m in METHODS
               for p in PRECISIONS]
NON_HSD = ("intpt", "pd", "twophase")
TIME_LIMIT_CASES = {"loop": dict(precision="f64"),
                    "retry": dict(precision="mixed", max_iter=1)}


def tp_lp(kind="dense", n=128, m=24, seed=7):
    """The wide LP of __graft_entry__.dryrun_multichip (m x n, positive
    rows, a bounded max); kind "ub" puts an upper bound of 2 on every
    column, which makes the solve take the UbTail path."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.5, 1.5, n)
    A = rng.uniform(0.1, 1.0, size=(m, n))
    bld = LPBuilder("tp")
    for j in range(n):
        kw = {"upper": 2.0} if kind == "ub" else {}
        bld.var(f"x{j}", obj=-float(rng.uniform(0.1, 1.0)), **kw)
    for i in range(m):
        bld.constraint(f"r{i}", {f"x{j}": float(A[i, j]) for j in range(n)},
                       hi=float(A[i] @ x0 + 1.0))
    return bld.build()


def kkt_operands(m=24, n=64, seed=0):
    """The system of tests/test_parallel.py's sharded KKT test."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    D = rng.uniform(0.5, 2.0, n)
    E = rng.uniform(0.5, 2.0, m)
    ry = rng.normal(size=m)
    rx = rng.normal(size=n)
    return A, D, E, ry, rx


def _summary(sol):
    return dict(status=sol.status, iterations=sol.iterations,
                obj=sol.primal_obj, x=sol.x, stages=sol.stages)


def tp_rank(rank, world, device):
    """Everything one spawn of the tensor-parallel tests checks."""
    torch.set_num_threads(1)
    out = {}
    out["layouts"] = {
        mp: make_mesh(world, model_parallel=mp,
                      device_type="cpu").mesh.tolist()
        for mp in range(1, world + 1) if world % mp == 0}
    try:
        make_mesh(world, model_parallel=3, device_type="cpu")
    except ValueError as e:
        out["indivisible"] = str(e)
    mesh = make_mesh(world, model_parallel=world, device_type="cpu")

    A, D, E, ry, rx = (torch.from_numpy(a) for a in kkt_operands())
    cols = ColumnShards.split(mesh.get_group("model"), A.shape[1])
    A_k, D_k, rx_k = place_column_sharded(A, D, rx, cols)
    out["normal"] = sharded_normal_matrix(A_k, 1.0 / D_k, E, cols).numpy()
    dy, dx = sharded_kkt_solve(A_k, E, D_k, ry, rx_k, cols)
    out["kkt"] = (dy.numpy(), cols.gather(dx).numpy())

    for kind, method, precision in SOLVE_CASES:
        sol = vtt.solve(tp_lp(kind), method=method,
                        config=vtt.SolverConfig(precision=precision),
                        device=device, mesh=mesh)
        out[kind, method, precision] = _summary(sol)
    # 127 columns do not split over 2 or 4 ranks: padded with zero columns
    sol = vtt.solve(tp_lp(n=127), pad_to=1, device=device, mesh=mesh)
    out["uneven"] = _summary(sol)

    # a time limit that has passed on rank 0 alone: in the loop (f64), and
    # at the warm-started polish's retry test (mixed, max_iter 1)
    for where, kw in TIME_LIMIT_CASES.items():
        cfg = vtt.SolverConfig(time_limit=1e-9 if rank == 0 else 1e6, **kw)
        out["time_limit", where] = _summary(
            vtt.solve(tp_lp(), config=cfg, device=device, mesh=mesh))

    for method in NON_HSD:
        try:
            vtt.solve(tp_lp(), method=method, device=device, mesh=mesh)
        except ValueError as e:
            out[method] = str(e)
    try:
        vtt.solve(tp_lp(), config=vtt.SolverConfig(precision="dd"),
                  device=device, mesh=mesh)
    except ValueError as e:
        out["dd"] = str(e)
    return out


def raise_on_rank_1(rank, world, device):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.ones(1))
    return rank


def hang(rank, world, device):
    """Every rank sleeps past the run's time limit."""
    import time
    time.sleep(600)


def batch_class(kind):
    """An 8-lane size class of each kind: "dense" raw stacked arrays (the
    data of tests/test_parallel.py's sharded batch test, 24 x 64), or
    "structured" seeded bounded LPs grouped as the corpus sweep groups
    them, one UbTail class ("s", 64, 128, 128).  Returns (A, b, c, ub)."""
    if kind == "dense":
        rng = np.random.default_rng(0)
        B, m, n = 8, 24, 64
        A = rng.normal(size=(B, m, n))
        x0 = rng.uniform(1, 2, size=(B, n))
        b = np.einsum("bmn,bn->bm", A, x0) + 1.0
        c = -rng.uniform(0.1, 1.0, size=(B, n))
        return A, b, c, None
    from vanderbei_tpu_torch.utils.randlp import random_bounded_lp
    lps = [random_bounded_lp(30 + j, 70 + 2 * j, density=0.1, seed=j)
           for j in range(8)]
    classes, aborted = tb.group_by_class(
        lps, granularity=64, use_ub_structure=True, scale="geometric",
        free_vars="split")
    (key, entries), = classes.items()
    assert key == ("s", 64, 128, 128) and not aborted, (key, aborted)
    return tb.stack_class_structured(entries, *key[1:])


def batch_rank(rank, world, device):
    """shard_batch + solve_batch_hsd + gather_lanes on a (2, 2) mesh, for
    both classes; also the rank's blocks and batch_sharding/replicated."""
    torch.set_num_threads(1)
    mesh = make_mesh(world, model_parallel=2, device_type="cpu")
    out = {"coords": (mesh.get_local_rank("batch"),
                      mesh.get_local_rank("model"))}
    for kind in ("dense", "structured"):
        A, b, c, ub = batch_class(kind)
        arrays = [A, b, c] + ([] if ub is None else [ub.idx2, ub.w2])
        blocks = tb.shard_batch(arrays, mesh, model_axis_dims=(2, None, 1))
        out[kind, "blocks"] = blocks
        A_k, b_k, c_k = blocks[:3]
        ub_k = None if ub is None else tb.UbTail(*blocks[3:])
        res = tb.solve_batch_hsd(A_k, b_k, c_k, ub=ub_k, device=device,
                                 mesh=mesh)
        out[kind] = [t.numpy() for t in tb.gather_lanes(res, mesh)]
    lanes = torch.arange(8.0)
    out["batch_sharding"] = batch_sharding(mesh, lanes).numpy()
    out["replicated"] = replicated(mesh, torch.full((3,), float(rank))
                                   ).numpy()
    return out
