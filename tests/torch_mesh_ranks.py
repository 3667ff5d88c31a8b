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
from vanderbei_tpu_torch.ops import quad
from vanderbei_tpu_torch.parallel import batch as tb
from vanderbei_tpu_torch.parallel.distributed import (
    ColumnShards, column_shard, place_column_sharded, sharded_kkt_solve,
    sharded_normal_matrix)
from vanderbei_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                               replicated)

# the tensor-parallel solves: LP, method, precision
LP_KINDS = ("dense", "ub")
METHODS = ("hsd", "hsdls")
PRECISIONS = ("f64", "mixed", "dd")
SOLVE_CASES = [(k, m, p) for k in LP_KINDS for m in METHODS
               for p in PRECISIONS]
NON_HSD = ("intpt", "pd", "twophase")
TIME_LIMIT_CASES = {"loop": dict(precision="f64"),
                    "retry": dict(precision="mixed", max_iter=1)}
# the sharded batches: case -> (class kind, solve_batch_hsd keywords)
BATCH_CASES = {"dense": ("dense", {}), "structured": ("structured", {}),
               "dense-dd": ("dense", dict(precision="f64",
                                          compensated=True))}


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
    return out


def cancellation_operands():
    """Rows of A (4 x 16), a stack of two right-hand sides X (16 x 2) and
    two lanes of a dot product (a, b, each 2 x 16) whose large terms
    cancel between the ranks of a 2- or 4-way split of the 16 columns.
    Every term, product error and partial sum is a short dyadic number, so
    a compensated reduction gives the exact sum in any order: on one
    device and on column shards alike.  In rows 0-2 and both lanes a large
    term shares its rank with small ones, whose sum its rounded partial
    loses: summed over the ranks, those come out wrong in any order."""
    n = 16
    A = np.zeros((4, n))
    A[0, [0, 1, 14, 15]] = [1e16, 0.5, 0.5, -1e16]             # 1
    A[1, [0, 3, 8, 12]] = [2.0 ** 60, 3.0, -2.0 ** 60, -1.25]   # 1.75
    A[2, [2, 3, 12, 13]] = [2.0 ** 55, 0.25, 0.125, -2.0 ** 55]  # 0.375
    A[3] = np.arange(1.0, n + 1)                                # 136
    X = np.stack([np.ones(n), np.full(n, 2.0)], axis=1)
    e = 1.0 + 2.0 ** -30       # e * e = 1 + 2^-29 + 2^-60 rounds
    a, b = np.zeros((2, n)), np.zeros((2, n))
    a[0, [0, 15]], b[0, [0, 15]] = [e, -(1.0 + 2.0 ** -29)], [e, 1.0]
    a[1, [4, 5, 11]], b[1, [4, 5, 11]] = [1e16, 1.5, -1e16], 1.0
    return A, X, a, b


def dd_sum_rank(rank, world, device):
    """The cancellation operands' compensated products on this rank's
    columns completed by ColumnShards.sum2, beside the rounded per-rank
    products summed by ColumnShards.sum, and the bytes each carried."""
    torch.set_num_threads(1)
    mesh = make_mesh(world, model_parallel=world, device_type="cpu")
    A, X, a, b = (torch.from_numpy(t) for t in cancellation_operands())
    cols = ColumnShards.split(mesh.get_group("model"), A.shape[1])
    A_k, a_k, b_k = (column_shard(t, cols) for t in (A, a, b))
    X_k = column_shard(X.mT, cols).mT
    sharded = cols.sum2(quad.matvec2_dd(A_k, X_k),
                        quad.matvec2_dd(A_k, X_k[:, 0]),
                        quad.dot2_dd(a_k, b_k))
    counts2 = cols.counts()
    rounded = cols.sum(quad.matvec2(A_k, X_k), quad.matvec2(A_k, X_k[:, 0]),
                       quad.dot2(a_k, b_k))
    return dict(sharded=[t.numpy() for t in sharded],
                rounded=[t.numpy() for t in rounded],
                sum2=counts2, sum=cols.counts(since=counts2))


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
    each of BATCH_CASES (with the all-reduces of its stages by method);
    also the rank's blocks and batch_sharding/replicated."""
    torch.set_num_threads(1)
    mesh = make_mesh(world, model_parallel=2, device_type="cpu")
    out = {"coords": (mesh.get_local_rank("batch"),
                      mesh.get_local_rank("model"))}
    for case, (kind, kw) in BATCH_CASES.items():
        A, b, c, ub = batch_class(kind)
        arrays = [A, b, c] + ([] if ub is None else [ub.idx2, ub.w2])
        blocks = tb.shard_batch(arrays, mesh, model_axis_dims=(2, None, 1))
        out[kind, "blocks"] = blocks
        A_k, b_k, c_k = blocks[:3]
        ub_k = None if ub is None else tb.UbTail(*blocks[3:])
        stages = []
        res = tb.solve_batch_hsd(A_k, b_k, c_k, ub=ub_k, device=device,
                                 mesh=mesh, stages=stages, **kw)
        out[case] = [t.numpy() for t in tb.gather_lanes(res, mesh)]
        out[case, "stages"] = stages
    lanes = torch.arange(8.0)
    out["batch_sharding"] = batch_sharding(mesh, lanes).numpy()
    out["replicated"] = replicated(mesh, torch.full((3,), float(rank))
                                   ).numpy()
    return out
