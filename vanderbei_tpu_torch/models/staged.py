"""The f32 -> f64 precision ladder of the IPMs (hsd, hsdls, intpt), one
for a single LP (models/registry) and a stacked class (parallel/batch): a
single LP is the case with no lanes.

At precision "mixed" an f32 sprint, normal matrices through the scaled-
SYRK kernel, runs until every lane's mu (hsd) or duality gap (intpt)
reaches the stage boundary; a lane whose sprint diverged (x or phi
non-finite, or stopped SUBOPTIMAL by the finite-iterate guard) restarts
clean, the others are cast to f64, and the f64 polish runs to the
reference tolerance (hsd.c:24).  Every other precision is the polish
alone, from the clean start.
"""

from __future__ import annotations

import torch

from ..core.config import SolverConfig
from ..core.status import Status
from ..ops.kkt import where_lanes
from ..utils.profiling import Span, host_read


def resolve_precision(cfg: SolverConfig, shape) -> str:
    """"auto" -> "mixed" only where the f32 sprint pays (big factored dim);
    small problems run f64 direct."""
    if cfg.precision != "auto":
        return cfg.precision
    return "mixed" if min(shape) >= cfg.mixed_min_dim else "f64"


def tolerances(epsdiag: float, refine_tol: float, sprint: bool) -> dict:
    """A stage's KKT diagonal floor and refinement target: the f32 sprint
    cannot reach f64 refinement targets, so it raises them to 1e-8 and
    1e-4 at least."""
    if sprint:
        epsdiag, refine_tol = max(epsdiag, 1e-8), max(refine_tol, 1e-4)
    return dict(epsdiag=epsdiag, refine_tol=refine_tol)


def timed(stages: list | None, label: str, run, state, cols=None):
    """Run one stage, run(state) -> (state, paused), inside a `stage` span,
    and append its record to `stages`: precision (the label), iterations
    (an int for one LP, per lane for a class; read once, at the end),
    seconds, paused and, under column shards `cols`, the all-reduces of
    ColumnShards.counts.  With stages None nothing is read or kept."""
    with Span("stage", precision=label) as sp:
        it0 = state.iter
        count0 = None if cols is None else cols.counts()
        state, paused = run(state)
        if stages is None:
            return state
        its = host_read("staged.stage", (state.iter - it0).cpu).numpy()
        sp.attrs["iterations"] = int(its.max())
    stages.append(dict(precision=label,
                       iterations=int(its) if its.ndim == 0 else its,
                       seconds=sp.seconds, paused=paused))
    if cols is not None:
        stages[-1].update(cols.counts(since=count0))
    return state


def ladder(precision: str, run_stage, init_for, mk_args, pause: float,
           cast_state, *, factor_dtype=None, stages: list | None = None,
           cols=None):
    """The stages of an IPM solve at a resolved `precision`: mk_args(dtype)
    builds a stage's operands, init_for(args) the clean start on them, and
    run_stage(args, state, pause, factor_dtype, sprint) -> (state, paused)
    runs the caller's loop from `state`: the sprint to the stage boundary
    `pause`, or the polish (pause 0.0) with an f64 factor (factor_dtype
    None, label "f64") or an f32 one ("f64-data/f32-factor").  cols: the
    column shards of the state's x, if any, over which `ok` is agreed.
    Returns (the polish's state, its f64 operands, ok: per lane, whether
    the polish started from the sprint's state; None without a sprint)."""
    ok = None
    if precision == "mixed":
        args32 = mk_args(torch.float32)
        sprint = timed(stages, "f32",
                       lambda s: run_stage(args32, s, pause, None, True),
                       init_for(args32), cols)
        ok = torch.isfinite(sprint.x).all(-1)
        if cols is not None:
            ok = cols.all(ok)
        if hasattr(sprint, "phi"):
            ok = ok & torch.isfinite(sprint.phi)
        ok = ok & (sprint.status != int(Status.SUBOPTIMAL))
    args64 = mk_args(torch.float64)
    state = init_for(args64)
    if ok is not None:
        state = where_lanes(ok, cast_state(sprint, torch.float64), state)
    label = "f64" if factor_dtype is None else "f64-data/f32-factor"
    state = timed(stages, label,
                  lambda s: run_stage(args64, s, 0.0, factor_dtype, False),
                  state, cols)
    return state, args64, ok
