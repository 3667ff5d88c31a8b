"""Model-parallel (single large LP) building blocks over torch.distributed,
the port of vanderbei_tpu/parallel/distributed.py.

With A's COLUMNS split over the "model" ranks (rank k holds the contiguous
block A_k = A[:, lo:hi] and the matching slices of every n-vector), the
normal matrix of the primal form decomposes into per-rank partial products

    M = E + sum_k A_k D_k^-1 A_k'

formed locally (the hand-written scaled-SYRK kernel in the f32 stage) and
summed by one all-reduce; E is added once, after the sum.  The m x m
factor and the triangular solves then run replicated on every rank, while
all A-sized work (the SYRK, A'y, Ax) stays on the rank's own columns.
Where the JAX package lets GSPMD place the collectives, here they are
explicit: ColumnShards carries the "model" group and the rank's column
range, and its sum/max/min/all reduce a tensor over the group; sum2
completes compensated ("dd") partial sums without rounding them first.
Only all_reduce (SUM, MIN, MAX) and broadcast are used, the two collectives
that gloo also runs on CUDA tensors, so several ranks can share one card
under gloo while one rank per card runs under nccl; the caller picks the
backend.

run_ranks starts the SPMD ranks (spawned processes, one process group)
for the tests and chip_smoke.py.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
import torch
import torch.distributed as dist

from ..ops import kkt, syrk
from ..ops.quad import DD, _tree


class ColumnShards:
    """This rank's share of A's columns: the "model" process group, the
    column range [lo, hi) of the global n, and the owner map of the UbTail
    rows (set by tail()).  Every reduction over the column dim of a
    sharded solve goes through it; `ops` counts the all-reduces it issued
    by method (sum, sum2, max, min, all, any), `nbytes` and `seconds` the
    bytes they carried and the host time spent in them (for a blocking
    backend such as gloo, waiting for the device work before each one
    included)."""

    def __init__(self, group, lo: int, hi: int, n: int):
        self.group, self.lo, self.hi, self.n = group, lo, hi, n
        self.own = None
        self.nbytes = 0
        self.seconds = 0.0
        self.ops = dict.fromkeys(OPS, 0)

    @classmethod
    def split(cls, group, n: int) -> "ColumnShards":
        """Equal contiguous blocks of n columns over the ranks of `group`,
        in rank order."""
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if n % size:
            raise ValueError(f"{n} columns do not split over {size} ranks; "
                             "pad them to a multiple first")
        width = n // size
        return cls(group, rank * width, (rank + 1) * width, n)

    def _all_reduce(self, flat, op, name):
        t0 = time.perf_counter()
        dist.all_reduce(flat, op=op, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.ops[name] += 1
        self.nbytes += flat.numel() * flat.element_size()

    def _reduce(self, parts, op, name):
        """All-reduce the parts (tensors of one dtype) in one collective;
        returns new tensors of their shapes (a single part: one tensor)."""
        flat = _flat(parts)
        self._all_reduce(flat, op, name)
        return _unflat(flat, parts)

    def counts(self, since=None) -> dict:
        """The counters as a record (all_reduces, all_reduce_bytes,
        all_reduce_seconds, and all_reduces_<op> by method), less those
        of an earlier record `since`."""
        now = dict(all_reduces=sum(self.ops.values()),
                   all_reduce_bytes=self.nbytes,
                   all_reduce_seconds=self.seconds,
                   **{f"all_reduces_{k}": v for k, v in self.ops.items()})
        return now if since is None else {k: v - since[k]
                                          for k, v in now.items()}

    def sum(self, *parts):
        """Sum of every rank's partial sums."""
        return self._reduce(parts, dist.ReduceOp.SUM, "sum")

    def sum2(self, *parts: DD):
        """The compensated sum of every rank's unrounded partial sums (the
        *_dd forms of ops/quad), rounded once: as if the whole column range
        were reduced in twice the working precision.

        Neither the rounded partials nor the hi and lo words summed apart
        keep the cancellation between the ranks.  So each rank writes its
        (hi, lo) words into its own slot of a zero (world, 2, total)
        buffer, one SUM all-reduce fills it exactly (each slot has one
        writer, the other ranks add zeros), and every rank adds the slots
        with quad's dd_add tree over the rank dim, in rank order, and
        rounds hi + lo once: every rank holds the same bits."""
        world = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        hi = _flat([p.hi for p in parts])
        buf = hi.new_zeros(world, 2, hi.numel())
        buf[rank, 0] = hi
        buf[rank, 1] = _flat([p.lo for p in parts])
        self._all_reduce(buf, dist.ReduceOp.SUM, "sum2")
        s = _tree(buf[:, 0], buf[:, 1], 0)
        return _unflat(s.hi + s.lo, [p.hi for p in parts])

    def max(self, *parts):
        return self._reduce(parts, dist.ReduceOp.MAX, "max")

    def min(self, *parts):
        return self._reduce(parts, dist.ReduceOp.MIN, "min")

    def all(self, flag):
        """A boolean tensor true where it is true on every rank."""
        return self._reduce((flag.to(torch.int32),), dist.ReduceOp.MIN,
                            "all") > 0

    def any(self, flag):
        return self._reduce((flag.to(torch.int32),), dist.ReduceOp.MAX,
                            "any") > 0

    def tail(self, ub):
        """This rank's UbTail: each tail row whose column it owns, at its
        local index; every other row gets weight 0 (and local index 0), so
        a product over the tail rows is a partial sum that sum() completes
        and a scatter into the columns touches only owned ones.  Padding
        rows (weight 0, column 0) belong to the owner of column 0."""
        idx = ub.idx2.to(torch.int64)
        self.own = (idx >= self.lo) & (idx < self.hi)
        return type(ub)(torch.where(self.own, idx - self.lo, 0),
                        torch.where(self.own, ub.w2, 0.0))

    def gather(self, v):
        """The full (..., n) vector from each rank's (..., hi - lo) block."""
        full = v.new_zeros(*v.shape[:-1], self.n)
        full[..., self.lo:self.hi] = v
        return self.sum(full)


OPS = ("sum", "sum2", "max", "min", "all", "any")


def _flat(parts):
    """The parts (tensors of one dtype) as one new flat tensor."""
    return (parts[0].reshape(-1).clone() if len(parts) == 1
            else torch.cat([p.reshape(-1) for p in parts]))


def _unflat(flat, parts):
    """flat split into tensors of the parts' shapes (a single part: one
    tensor)."""
    out = [t.view(p.shape) for t, p in
           zip(flat.split([p.numel() for p in parts]), parts)]
    return out[0] if len(out) == 1 else out


def model_size(mesh) -> int:
    """The number of "model" ranks of a mesh: the ways its columns split."""
    return dist.get_world_size(mesh.get_group("model"))


def column_shard(a, cols: ColumnShards):
    """A contiguous copy of a[..., lo:hi] (a tensor or a numpy array)."""
    block = a[..., cols.lo:cols.hi]
    if isinstance(block, torch.Tensor):
        return block.contiguous().clone()
    return block.copy(order="C")


def place_column_sharded(A, D, rhs_x, cols: ColumnShards):
    """This rank's blocks of the column-sharded operands of
    sharded_kkt_solve."""
    return tuple(column_shard(a, cols) for a in (A, D, rhs_x))


def sharded_normal_matrix(A, Dinv, E, cols: ColumnShards, f32=None):
    """M = diag(E) + A diag(Dinv) A' from this rank's columns A (..., m,
    hi - lo) and Dinv (..., hi - lo); M comes back whole on every rank.

    ops/kkt.normal_matrix: the rank's partial product is formed with e = 0,
    summed over the group by one all-reduce, and diag(E) is added once
    after the sum.  f32 (by default: A is float32) forms the partial
    product with ops/syrk's scaled_syrk, the hand-written kernel on a CUDA
    tensor; otherwise it is torch.matmul in A's dtype."""
    if f32 is None:
        f32 = A.dtype == torch.float32
    return kkt.normal_matrix(A, E, None, f32, dinv=Dinv, cols=cols)


def sharded_kkt_solve(A, E, D, rhs_y, rhs_x, cols: ColumnShards,
                      epsdiag: float = 1.0e-14):
    """One distributed primal-form KKT solve, factor and substitution, no
    refinement: A (m, hi - lo), D and rhs_x this rank's columns, E and
    rhs_y whole.  Returns dy (whole on every rank) and dx (this rank's
    columns)."""
    fac = kkt.kkt_factor(A, E, D, epsdiag, cols=cols)
    return kkt.kkt_solve(A, E, D, fac, rhs_y, rhs_x, epsdiag=epsdiag,
                         max_refine=0, cols=cols)


def _rank_main(fn, rank, world, backend, device, timeout_s, store, out,
               args):
    # the result or the error goes out before the process group is torn
    # down, which may wait on a peer stuck in a collective
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # gloo's sockets stay on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        value = fn(rank, world, device, *args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.put((rank, True, value))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, backend: str, device,
              timeout_s: float = 300.0, args: tuple = ()):
    """Run fn(rank, world, device, *args) on `world` SPMD ranks: spawned
    processes (CUDA cannot be used in forked ones) joined in one process
    group of `backend` through a file store in a fresh temporary
    directory.  fn must be importable by name and return a picklable host
    value (no CUDA tensor).

    device: "cpu", a CUDA device for every rank ("cuda:0": several ranks on
    one card, under gloo), or "cuda" for rank r on card r (one rank per
    card, under nccl).  The scaled-SYRK kernel is built here, once, before
    the ranks load it.

    A rank that raises, dies, or has not finished after timeout_s seconds
    (which also bounds every collective) fails the run: the other ranks
    are killed and RuntimeError is raised.  Returns fn's values in rank
    order.  The kernel's launch counters (ops/syrk) are each rank's own: a
    rank function that reports them returns them in its value."""
    device = torch.device(device)
    per_rank = device.type == "cuda" and device.index is None
    if device.type == "cuda":
        syrk.build()
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world, backend,
                  f"cuda:{r}" if per_rank else str(device), timeout_s,
                  os.path.join(tmp, "store"), out, args))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = sorted(set(range(world)) - set(results))
                    raise RuntimeError(f"run_ranks: ranks {late} did not "
                                       f"finish within {timeout_s} s")
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    # a rank always reports before it exits with code 0
                    dead = [r for r, p in enumerate(procs)
                            if r not in results
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"run_ranks: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and sent no result")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} raised:\n"
                                       f"{payload}")
                results[rank] = payload
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]
