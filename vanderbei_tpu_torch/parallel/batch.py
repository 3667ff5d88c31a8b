"""Instance batching over padded size classes, the port of
vanderbei_tpu/parallel/batch.py.

Problems are grouped into size classes (padded-dim buckets), each class
canonicalized with benign padding (core/canonicalize.py) and stacked into
(B, M, N) tensors, then solved by ONE batch-first loop over the whole
class: the solvers' per-lane masks freeze a lane once it is decided, and
the loop runs until every lane has stopped.  In the f32 sprint the normal
matrices of all B lanes are formed by one launch of the scaled-SYRK
kernel per iteration.

The batched IPMs run the single-LP path's precision ladder, lane by lane
(models/staged.py).

The stacked classes are numpy arrays; the solvers move them to the device
with torch.from_numpy(...).to(device).  Every solver takes `device`,
"cuda" by default, and raises when CUDA is absent.

On a ("batch", "model") mesh (parallel/mesh.py) each rank takes its block
of a class with shard_batch: its lanes over "batch" and, where asked, its
columns over "model"; solve_batch_hsd(..., mesh=) then solves those lanes
with the columns split over the rank's "model" group, and gather_lanes
assembles the whole class on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import ubtail
from ..core.config import SolverConfig
from ..core.status import Status
from ..models import hsd as _hsd
from ..models import intpt as _intpt
from ..models import simplex as _simplex
from ..models import staged
from ..models.registry import resolve_device
from ..ops.kkt import UbTail
from ..utils.checkpoint import to_device
from ..utils.profiling import count, span, spanned
from .distributed import ColumnShards, model_size
from .mesh import batch_sharding, block


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def size_class(canon_m: int, n: int, granularity: int = 128) -> tuple:
    """Bucket key: dims rounded up to the granularity."""
    return (_round_up(canon_m, granularity), _round_up(n, granularity))


def class_key(canon, granularity: int, use_ub_structure: bool) -> tuple:
    """The class a CanonLP buckets into: ("s", M1, N, K) for a structured
    problem (head dims and tail count, rounded up), ("d", M, N) for the
    rest, or the legacy dense-only key (M, N) without use_ub_structure."""
    ru = lambda d: _round_up(d, granularity)
    if use_ub_structure and ubtail._hsd_structure_applies(canon):
        k = len(canon.ub_cols)
        return ("s", ru(canon.m - k), ru(canon.n), ru(k))
    if use_ub_structure:
        return ("d", ru(canon.m), ru(canon.n))
    return (ru(canon.m), ru(canon.n))


@spanned("group_by_class")
def group_by_class(lps, granularity: int = 128,
                   use_ub_structure: bool = False, scale: str = "none",
                   free_vars: str = "reject"):
    """Canonicalize each LP and bucket by padded shape (class_key).  With
    use_ub_structure an LP that takes the UbTail structure is built
    straight from its CSC (core/ubtail.py, a UbCanon without a dense A).

    Returns ({key: [(index, CanonLP), ...]} over the input order, and
    [(index, status)] of the LPs whose canonicalization aborts, e.g. on a
    free variable under free_vars="reject")."""
    classes: dict = {}
    aborted = []
    for idx, lp in enumerate(lps):
        canon = ubtail.canonical(lp, use_ub_structure, scale=scale,
                                 free_vars=free_vars)
        if canon.status != int(Status.RUNNING):
            aborted.append((idx, canon.status))
            continue
        key = class_key(canon, granularity, use_ub_structure)
        classes.setdefault(key, []).append((idx, canon))
    return classes, aborted


@spanned("stack")
def stack_class(entries, mp: int, np_: int, dtype=np.float64):
    """Stack a size class's canonical problems into (B, mp, np_) arrays."""
    B = len(entries)
    A = np.zeros((B, mp, np_), dtype=dtype)
    b = np.ones((B, mp), dtype=dtype)
    c = np.zeros((B, np_), dtype=dtype)
    for k, (_, canon) in enumerate(entries):
        m, n = canon.m, canon.n
        A[k, :m, :n] = canon.A[:m, :n]
        b[k, :m] = canon.b[:m]
        c[k, :n] = canon.c[:n]
    return A, b, c


@spanned("stack")
def stack_class_structured(entries, M1: int, N: int, K: int,
                           dtype=np.float64):
    """Stack a STRUCTURED size class: head A1 (B, M1, N), b (B, M1+K),
    c (B, N) plus the batched UbTail (idx2, w2 each (B, K); w2 = 0 marks
    padding tail rows).  Each lane's operands are written into its slice
    (core/ubtail.fill), from a UbCanon's triples or a dense CanonLP."""
    B = len(entries)
    A1 = np.zeros((B, M1, N), dtype=dtype)
    b = np.ones((B, M1 + K), dtype=dtype)
    c = np.zeros((B, N), dtype=dtype)
    idx2 = np.zeros((B, K), dtype=np.int32)
    w2 = np.zeros((B, K), dtype=dtype)
    for j, (_, canon) in enumerate(entries):
        assert ubtail._hsd_structure_applies(canon), \
            "structured class entry lost its structure"
        ubtail.fill(canon, A1[j], b[j], c[j], idx2[j], w2[j])
    return A1, b, c, UbTail(idx2, w2)


def shard_batch(arrays, mesh, model_axis_dims=()):
    """This rank's block of stacked (B, ...) arrays (numpy or tensors): its
    lanes over the mesh's "batch" dim and, for each array i whose
    model_axis_dims[i] is a dim (not None), its contiguous share of that
    dim over "model", e.g. A's columns: shard_batch([A, b, c], mesh,
    model_axis_dims=(2, None, 1)).  Returns contiguous copies."""
    out = []
    for i, arr in enumerate(arrays):
        part = batch_sharding(mesh, arr)
        dim = model_axis_dims[i] if i < len(model_axis_dims) else None
        if dim is not None:
            part = block(mesh, part, "model", dim)
        out.append(part.contiguous().clone()
                   if isinstance(part, torch.Tensor) else part.copy())
    return out


@spanned("gather_lanes")
def gather_lanes(arrays, mesh):
    """The whole class on every rank from each rank's lanes (the outputs
    of solve_batch_hsd under `mesh`): one all-reduce over "batch" per
    array."""
    group = mesh.get_group("batch")
    size, pos = dist.get_world_size(group), mesh.get_local_rank("batch")
    out = []
    for t in arrays:
        B = t.shape[0]
        full = t.new_zeros(B * size, *t.shape[1:])
        full[pos * B:(pos + 1) * B] = t
        dist.all_reduce(full, group=group)
        out.append(full)
    return out


def _upload(arrays, device):
    """The arrays on the device, in f64."""
    with span("upload"):
        return [to_device(v, device, torch.float64) for v in arrays]


@spanned("solve_batch")
def solve_batch_hsd(A, b, c, *,
                    ub: UbTail | None = None,
                    max_iter: int = 200,
                    eps: float = 1.0e-12,
                    step_factor: float = 0.95,
                    long_step: bool = False,
                    beta: float = 0.80,
                    epsdiag: float = 1.0e-14,
                    refine_tol: float = 1.0e-10,
                    max_refine: int = 4,
                    precision: str = "mixed",
                    corrector: str = "mehrotra",
                    compensated: bool = False,
                    stage1_mu: float = 1.0e-4,
                    device="cuda",
                    stages: list | None = None,
                    mesh=None):
    """Two-stage batched HSD over a stacked class A (B, mp, np_).

    ub: batched UbTail (idx2, w2 each (B, K)); A then holds only head rows
    and b spans (B, mp + K), and each lane takes the Schur-eliminated
    structured KKT path (stack_class_structured builds these).
    precision: "mixed" (f32 sprint, f64 polish), "f32factor" (f64 data,
    f32 factor) or "f64"; compensated applies to the f64 stage.  stages,
    if given, receives one record per stage (models/staged.timed:
    per-lane iterations).

    mesh: the class is this rank's block of it (shard_batch): A and c hold
    its columns of the "model" dim, which the solve splits over the rank's
    "model" group, and ub its lanes with their global column indices.
    Called on every rank; returns this rank's lanes with all their columns
    (gather_lanes assembles the class).  compensated sums the columns
    across the "model" ranks compensated (ColumnShards.sum2); a "model"
    group of one rank holds every column and reduces nothing.

    Returns (status, x, y, w, z, iterations), each batched over B, on
    `device`."""
    count("lanes", len(A))
    device = resolve_device(device)
    A, b, c = _upload((A, b, c), device)
    cols = None
    if mesh is not None and model_size(mesh) > 1:
        cols = ColumnShards.split(mesh.get_group("model"),
                                  A.shape[-1] * model_size(mesh))

    def mk_args(dtype):
        u = ub
        if ub is not None:
            with span("upload"):
                u = UbTail(to_device(ub.idx2, device, torch.int64),
                           to_device(ub.w2, device, dtype))
        return (A.to(dtype), b.to(dtype), c.to(dtype),
                u if cols is None or u is None else cols.tail(u))

    def run_stage(args, st, pause, factor_dtype, sprint):
        A_, b_, c_, ub_ = args
        return _hsd._hsd_loop(
            A_, b_, c_, 0.0, st, max_iter=max_iter, eps=eps,
            step_factor=step_factor, beta=beta,
            **staged.tolerances(epsdiag, refine_tol, sprint),
            long_step=long_step, max_refine=max_refine, corrector=corrector,
            pause_mu=pause, factor_dtype=factor_dtype,
            compensated=compensated and not sprint, ub=ub_, cols=cols)

    extra = 0 if ub is None else np.shape(ub.idx2)[-1]
    out, _, _ = staged.ladder(
        precision, run_stage,
        lambda args: _hsd.init_state(args[0], extra_rows=extra), mk_args,
        stage1_mu, _hsd.cast_state, stages=stages, cols=cols,
        factor_dtype=torch.float32 if precision == "f32factor" else None)
    status, x, y, w, z, iters = _hsd.finish_state(out, max_iter)
    if cols is not None:
        x, z = cols.gather(x), cols.gather(z)
    return status, x, y, w, z, iters


@spanned("solve_batch")
def solve_batch_intpt(A, b, c, *,
                      max_iter: int = 200,
                      eps: float = 1.0e-6,
                      delta: float = 0.02,
                      step_factor: float = 0.9,
                      epsdiag: float = 1.0e-14,
                      refine_tol: float = 1.0e-10,
                      max_refine: int = 4,
                      precision: str = "mixed",
                      stage1_gap: float = 1.0e-2,
                      gap_floor: float = 1.0e-2,
                      div_detect: bool = True,
                      device="cuda",
                      stages: list | None = None):
    """Two-stage batched path-following IPM over a stacked class (no Q).

    Stage 1 runs every lane in f32 until its duality gap crosses
    stage1_gap * (mp + np_), with the divergence certificate off; stage 2
    resumes in f64 to the reference tolerance (intpt.c:30), with the
    certificate as div_detect says (the JAX package's batched path always
    has it on).  m > n classes take the dual form, whose f32 normal
    matrices the kernel forms from the strided view A' (B, np_, mp).

    Returns (status, x, y, w, z, iterations), each batched over B."""
    count("lanes", len(A))
    device = resolve_device(device)
    A, b, c = _upload((A, b, c), device)
    B, mp, np_ = A.shape

    def run_stage(args, st, pause, factor_dtype, sprint):
        return _intpt._intpt_loop(
            *args, 0.0, None, st, max_iter=max_iter, eps=eps, delta=delta,
            step_factor=step_factor,
            **staged.tolerances(epsdiag, refine_tol, sprint),
            pause_gap=pause, div_detect=div_detect and not sprint,
            gap_floor=gap_floor, max_refine=max_refine,
            factor_dtype=factor_dtype)

    out, _, _ = staged.ladder(
        precision, run_stage, lambda args: _intpt.init_state(args[0]),
        lambda dtype: (A.to(dtype), b.to(dtype), c.to(dtype)),
        stage1_gap * (mp + np_), _intpt.cast_state, stages=stages)
    return _intpt.finish_state(out, max_iter)


@spanned("solve_batch")
def solve_batch_pd(A, b, c, *, max_iter: int = 20000,
                   refresh_every: int = 64, seed: int = 0, draws=None,
                   device="cuda"):
    """Batched parametric self-dual simplex over a stacked class: every
    lane pivots on [A | I] at once; finished lanes keep their state until
    the slowest converges.  draws: per-lane (u_x (B, mp), u_y (B, np_)),
    e.g. the JAX package's per-lane key draws; by default
    simplex.perturbation_draws of the seed.

    Returns (status, x, y, w, z, pivots), each batched over B."""
    count("lanes", len(A))
    device = resolve_device(device)
    A, b, c = _upload((A, b, c), device)
    B, mp, np_ = A.shape
    eye = torch.eye(mp, dtype=A.dtype, device=device).expand(B, mp, mp)
    Afull = torch.cat([A, eye], dim=-1)
    cfull = torch.cat([c, torch.zeros(B, mp, dtype=A.dtype, device=device)],
                      dim=-1)
    u_x, u_y = _upload(
        draws if draws is not None else _simplex.perturbation_draws(
            SolverConfig(seed=seed), mp, np_, lanes=(B,)), device)
    with span("stage", precision="f64"):
        return _simplex._pd_loop(Afull, b, cfull, u_x, u_y,
                                 max_iter=max_iter,
                                 refresh_every=refresh_every)
