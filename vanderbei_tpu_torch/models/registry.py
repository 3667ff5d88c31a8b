"""Solver registry and top-level solve(), the port of
vanderbei_tpu/models/registry.py.  Methods, chosen at run time:

    intpt    - path-following primal-dual IPM, also QPs  (src/ipo/intpt.c)
    hsd      - homogeneous self-dual (default)           (src/ipo/hsd.c)
    hsdls    - HSD long-step                             (src/ipo/hsdls.c)
    pd       - parametric self-dual simplex              (src/simpo/pd.c)
    twophase - two-phase simplex                         (src/simpo/2phase.c)

The IPMs run the precision ladder of models/staged.py (cfg.precision
"auto" -> "mixed" once the factored dimension is >= cfg.mixed_min_dim);
"dd" is one f64 stage whose residuals and inner products are compensated
(ops/quad).  Canonical dims pad to the JAX package's size classes so that
both packages iterate on the same system.

A SUBOPTIMAL hsd/hsdls verdict is retried unscaled, then cross-checked
with intpt; an LP with a QUADS section is routed to intpt.

solve(lp, mesh=...) is the tensor-parallel path of one large LP (the JAX
package's _place_tp): every rank of the mesh calls it (SPMD), A's (or the
UbTail head's) columns and c are split over the mesh's "model" ranks, the
rest is whole on every rank, and the same HSD loop runs with explicit
collectives (parallel/distributed.py), at every precision: under "dd"
the column sums are compensated across the ranks (ColumnShards.sum2).
Each rank returns the same full Solution.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import ubtail
from ..core.canonicalize import pad_canon, recover_solution, CanonLP
from ..core.config import SolverConfig
from ..core.lp import LP, Solution
from ..core.status import Status
from ..core.ubtail import size_class
from ..parallel.distributed import (ColumnShards, column_shard,
                                    model_size)
from ..utils.checkpoint import operands_from_canon, to_device
from ..utils.profiling import host_read, span, spanned
from . import hsd as _hsd
from . import intpt as _intpt
from . import simplex as _simplex
from . import staged


def resolve_device(device) -> torch.device:
    """torch.device(device); "cuda" raises when no CUDA device is present
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                           "available; pass device='cpu' explicitly")
    return device


def _run_ladder(solver_mod, run_stage, init_for, mk_args, pause: float,
                cfg: SolverConfig, shape, max_iter: int, stages: list,
                cols: ColumnShards | None = None):
    """models/staged.ladder for one LP, its run_stage given cfg's time
    limit as a `deadline` keyword, then, where a warm-started polish
    exhausted max_iter before the deadline, one clean f64 retry: the f32
    sprint can wander on degenerate problems.  `shape` is always the
    global one.  Returns the final state."""
    precision = staged.resolve_precision(cfg, shape)
    deadline = (None if not np.isfinite(cfg.time_limit)
                else time.monotonic() + cfg.time_limit)
    run = lambda *args: run_stage(*args, deadline=deadline)
    # the XL f32-factor override applies only to the auto/mixed ladder: an
    # explicit f64 request means a full f64 factor
    factor_dtype = (torch.float32
                    if (precision == "f32factor"
                        or (cfg.precision in ("auto", "mixed")
                            and (min(shape) >= cfg.xl_f32factor_dim
                                 or shape[0] * shape[1]
                                 >= cfg.xl_f32factor_elems)))
                    else None)
    state, args64, ok = staged.ladder(
        precision, run, init_for, mk_args, pause, solver_mod.cast_state,
        factor_dtype=factor_dtype, stages=stages, cols=cols)
    if (ok is not None
            and host_read("staged.retry", (
                ok & (state.status == int(Status.RUNNING))
                & (state.iter >= max_iter)).item)
            and (deadline is None
                 or not _hsd.past_deadline(deadline, state.x, cols))):
        state = staged.timed(
            stages, stages[-1]["precision"] + " retry",
            lambda s: run(args64, s, 0.0, factor_dtype, False),
            init_for(args64), cols)
    return state


def _solve_hsd(canon: CanonLP, cfg: SolverConfig, device, stages: list,
               long_step: bool = False, mesh=None):
    max_iter = cfg.max_iter or (
        _hsd.DEFAULT_MAX_ITER_LS if long_step else _hsd.DEFAULT_MAX_ITER)
    trace = cfg.verbose >= 2
    if trace:
        print(_hsd.HSD_BANNER, flush=True)

    # under a mesh the columns split evenly over the "model" ranks: the
    # head's size class pads up to a multiple of them (zero columns, c = 0)
    # as solve() pads a dense canon
    N = (None if mesh is None
         else -(-size_class(canon.n) // model_size(mesh)) * model_size(mesh))
    with span("pad"):
        struct = (ubtail._hsd_structured_operands(canon, N=N)
                  if cfg.use_ub_structure else None)
    cols = None
    source = canon if struct is None else struct
    shape = (canon.A.shape if struct is None
             else (struct["M1"], struct["A1"].shape[1]))
    if mesh is not None:
        cols = ColumnShards.split(mesh.get_group("model"), shape[1])
        source = (dataclasses.replace(canon, A=column_shard(canon.A, cols),
                                      c=column_shard(canon.c, cols))
                  if struct is None else
                  dict(struct, A1=column_shard(struct["A1"], cols),
                       c=column_shard(struct["c"], cols)))

    def operands(dtype):
        A, b, c, ub = operands_from_canon(source, device, dtype)
        if cols is not None and ub is not None:
            ub = cols.tail(ub)
        return A, b, c, ub

    def run_stage(args, init, pause, factor_dtype, sprint, deadline):
        A, b, c, ub = args
        return _hsd._hsd_loop(
            A, b, c, canon.f, init, max_iter=max_iter, eps=cfg.hsd_eps,
            step_factor=cfg.hsd_step_factor, long_step=long_step,
            beta=cfg.beta, gap_tol=cfg.epssol, feas_tol=cfg.epssol,
            **staged.tolerances(cfg.epsdiag, cfg.refine_tol, sprint),
            max_refine=cfg.max_refine, trace=trace,
            factor_dtype=factor_dtype, pause_mu=pause,
            compensated=(cfg.precision == "dd" and not sprint),
            corrector=cfg.hsd_corrector, ub=ub, deadline=deadline, cols=cols)

    def init_for(args):
        ub = args[3]
        return _hsd.init_state(
            args[0], extra_rows=0 if ub is None else ub.idx2.shape[0])

    state = _run_ladder(_hsd, run_stage, init_for, operands, cfg.stage1_mu,
                        cfg, shape, max_iter, stages, cols)
    status, x, y, w, z, iters = _hsd.finish_state(state, max_iter)
    if cols is not None:
        x, z = cols.gather(x), cols.gather(z)
    if struct is not None:
        # reassemble canonical row order [head m1 | ub tail k] from the
        # padded [M1 | K] layout
        m1, k, M1 = struct["m1"], struct["k"], struct["M1"]
        y = torch.cat([y[:m1], y[M1:M1 + k]])
        w = torch.cat([w[:m1], w[M1:M1 + k]])
    return _fetch(status, x, y, w, z, iters)


@spanned("fetch")
def _fetch(status, x, y, w, z, iters):
    """A solve's outputs on the host."""
    host = lambda t: t.cpu().numpy()
    return int(status), host(x), host(y), host(w), host(z), int(iters)


def _solve_intpt(canon: CanonLP, cfg: SolverConfig, device, stages: list):
    max_iter = cfg.max_iter or _intpt.DEFAULT_MAX_ITER
    trace = cfg.verbose >= 2
    if trace:
        print(_intpt.INTPT_BANNER, flush=True)

    def mk(dtype):
        A, b, c, _ = operands_from_canon(canon, device, dtype)
        if canon.Q is None:
            return A, b, c, None
        with span("upload"):
            return A, b, c, to_device(canon.Q, device, dtype)

    def run_stage(args, init, pause, factor_dtype, sprint, deadline):
        A, b, c, Q = args
        # the f32 sprint's late roundoff jitter can fake the divergence
        # certificate
        return _intpt._intpt_loop(
            A, b, c, canon.f, Q, init, max_iter=max_iter, eps=cfg.ipm_eps,
            delta=cfg.delta, step_factor=cfg.step_factor,
            **staged.tolerances(cfg.epsdiag, cfg.refine_tol, sprint),
            max_refine=cfg.max_refine, trace=trace,
            factor_dtype=factor_dtype, pause_gap=pause,
            div_detect=(not sprint) and cfg.div_detect,
            # gap-stop floor: 1e-2 under equilibration (the scaled
            # objective sits near unit scale), 1.0 unscaled, as
            # vanderbei_tpu's _solve_intpt
            gap_floor=1.0e-2 if cfg.scale != "none" else 1.0,
            deadline=deadline)

    # the stage boundary is on the duality gap: stage1_mu * (n + m) keeps
    # it proportional to the mu the gap corresponds to
    knob = cfg.stage1_mu * sum(canon.A.shape)
    state = _run_ladder(_intpt, run_stage,
                        lambda args: _intpt.init_state(args[0]), mk, knob,
                        cfg, canon.A.shape, max_iter, stages)
    status, x, y, w, z, iters = _intpt.finish_state(state, max_iter)
    return _fetch(status, x, y, w, z, iters)


SOLVERS = {
    "intpt": _solve_intpt,
    "hsd": _solve_hsd,
    "hsdls": lambda canon, cfg, device, stages, **kw: _solve_hsd(
        canon, cfg, device, stages, long_step=True, **kw),
    "pd": _simplex.solve_canon_pd,
    "twophase": _simplex.solve_canon_twophase,
}


def get_solver(method: str):
    try:
        return SOLVERS[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; available: {sorted(SOLVERS)}")


def _pad(canon: CanonLP, pad_to, structured: bool = False) -> CanonLP:
    if canon.A is None:
        # a UbCanon: _solve_hsd pads its head and tail itself
        return canon
    if pad_to == "auto" and not structured:
        return pad_canon(canon, size_class(canon.m), size_class(canon.n))
    if isinstance(pad_to, int) and pad_to != 1:
        return pad_canon(canon, -(-canon.m // pad_to) * pad_to,
                         -(-canon.n // pad_to) * pad_to)
    return canon


@spanned("solve")
def solve(lp: LP, method: str = "hsd", config: SolverConfig | None = None,
          pad_to: int | str = "auto", device="cuda", mesh=None) -> Solution:
    """Canonicalize and solve an LP on `device` (the analogue of solvelp,
    solve.c:28).  device is explicit: "cuda" (the default) raises when no
    CUDA device is present; pass "cpu" to run the plain torch versions.

    pad_to: "auto" pads canonical dims to the size classes, as the JAX
    package does; an int pads to that multiple (1 = exact dims).

    mesh: a DeviceMesh with a "model" dim (parallel/mesh.make_mesh), to
    solve this one LP tensor-parallel: called on every rank of the mesh,
    each with its own device, it splits the columns over the "model" ranks
    (padded with zero columns to a multiple of them) and returns the same
    Solution on every rank.  The hsd family only, every precision ("dd"
    compensates its column sums across the ranks), and no quality retries
    (as the JAX package's mesh path).  Every rank passes
    the same config; a finite time limit stops them all at the iteration
    where it has passed on any.
    """
    device = resolve_device(device)
    cfg = config or SolverConfig()
    cfg = cfg.with_(method=method).apply_lp_params(lp)
    if lp.qnz and method != "intpt":
        # the reference's shipped solvers ignore Q; route quadratic
        # objectives to the QP-capable path-following solver instead
        if cfg.verbose:
            print(f"QUADS present: routing method {method!r} -> 'intpt' "
                  "(QP-capable)", flush=True)
        method = "intpt"
    solver = get_solver(method)
    hsd_family = method in ("hsd", "hsdls")
    if mesh is not None and not hsd_family:
        raise ValueError(
            f"mesh (tensor-parallel) solve supports the hsd family, "
            f"not {method!r}")
    # the UbTail path is built straight from the CSC (core/ubtail.py):
    # a UbCanon carries no dense A, and its operands are padded in
    # _solve_hsd
    structured = hsd_family and cfg.use_ub_structure
    canon = ubtail.canonical(lp, structured, scale=cfg.scale,
                             free_vars=cfg.free_vars, dtype=cfg.dtype)
    if canon.status != int(Status.RUNNING):
        n, m0 = lp.n, lp.m
        return Solution(status=canon.status, x=np.zeros(n), y=np.zeros(m0),
                        w=np.zeros(m0), z=np.zeros(n), primal_obj=0.0,
                        dual_obj=0.0, stages=[])
    with span("pad"):
        canon = _pad(canon, pad_to)
        kw = {}
        if mesh is not None:
            kw["mesh"] = mesh
            size = model_size(mesh)
            if canon.A is not None and canon.n % size:
                canon = pad_canon(canon, canon.m, -(-canon.n // size) * size)
    stages: list = []
    t0 = time.perf_counter()
    status, x, y, w, z, iters = solver(canon, cfg, device, stages, **kw)
    if (hsd_family and mesh is None and cfg.quality_retries
            and status == int(Status.SUBOPTIMAL) and cfg.scale != "none"):
        # the quality gate flagged a converged-but-poor point: re-solve
        # UNSCALED (the equilibration can steer a few instances to a
        # perturbed optimum); keep the retry only if it is OPTIMAL
        if cfg.verbose:
            print("hsd suboptimal: retrying unscaled", flush=True)
        canon2 = ubtail.canonical(lp, structured, scale="none",
                                  free_vars=cfg.free_vars, dtype=cfg.dtype)
        with span("pad"):
            canon2 = _pad(canon2, pad_to)
        st2, x2, y2, w2, z2, it2 = solver(canon2, cfg.with_(scale="none"),
                                          device, stages)
        if st2 == int(Status.OPTIMAL):
            status, x, y, w, z = st2, x2, y2, w2, z2
            iters = iters + it2
            canon = canon2
    if (hsd_family and mesh is None and cfg.quality_retries
            and status == int(Status.SUBOPTIMAL)
            and canon.m * canon.n <= 100_000_000):
        # second retry: cross-check with the path-following solver, which
        # stops on residuals and so can be trusted where the HSD embedding
        # degenerated; it has no UbTail elimination, hence the size gate
        if cfg.verbose:
            print("hsd suboptimal (phi collapse): falling back to intpt",
                  flush=True)
        dense = canon
        if dense.A is None:
            # the one reader of the dense canonical A on the UbTail path
            dense = _pad(ubtail.canonical(lp, False, scale=cfg.scale,
                                          free_vars=cfg.free_vars,
                                          dtype=cfg.dtype),
                         pad_to, structured=True)
        st2, x2, y2, w2, z2, it2 = _solve_intpt(dense, cfg, device, stages)
        if st2 == int(Status.OPTIMAL):
            status, x, y, w, z = st2, x2, y2, w2, z2
            iters = iters + it2
    if status == int(Status.RUNNING):
        # a TIMLIM deadline stop leaves the internal RUNNING sentinel
        status = int(Status.ITERATION_LIMIT)
    elapsed = time.perf_counter() - t0
    x, y, w, z, pobj, dobj, b_canon = recover_solution(canon, x, y, w, z)
    return Solution(status=int(status), x=x, y=y, w=w, z=z,
                    primal_obj=pobj, dual_obj=dobj, iterations=int(iters),
                    solve_time_s=elapsed, b_canon=b_canon, stages=stages)
