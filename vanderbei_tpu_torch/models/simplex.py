"""Dense revised simplex solvers on torch tensors, the port of
vanderbei_tpu/models/simplex.py.

- "pd": the parametric self-dual simplex (src/simpo/pd.c:69-464): random
  perturbations xbar_B, ybar_N lifted by the row/column norms (pd.c:179-201)
  define a homotopy in mu; each pivot finds the largest mu forcing a pivot
  and makes a dual- or primal-driven pivot with the perturbation-aware
  ratio test (pd.c:530-554).
- "twophase": a dual-simplex Phase I driving out negative basic primals,
  then a primal-simplex Phase II (src/simpo/2phase.c:69-516).

The basis inverse is kept explicitly as a dense m x m matrix, updated by a
rank-1 product-form pivot, and refactored every cfg.refresh_every pivots
with torch.linalg.inv; a refactor also re-derives every iterate vector from
the fresh inverse, so product-form drift cannot fake a late verdict.

pd is batch-first: one body pivots every lane of a stacked size class
(B, m, N) at once, with per-lane argmax/argmin choices, column gathers, a
rank-1 B^-1 update and basis swaps by scatter; a lane that has finished
keeps its state.  The single LP is the batch of one.  The host reads one
flag, "some lane still runs", per refresh_every pivots, where the refactor
runs; the pivots between no-op in finished lanes, as the JAX package's
chunked loop under vmap does.  On a CUDA device a pivot is one replay of
a CUDA graph of the body.  twophase has no batched path (neither has
the JAX package's) and decides each pivot on the host.  The perturbations
are uniform draws from a torch.Generator seeded with cfg.seed, drawn on
the CPU so every device gets the same run; a caller may pass its own
draws instead (the tests pass the JAX package's).  cfg.time_limit
(TIMLIM) is checked after every pivot, in both methods.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import SolverConfig
from ..core.status import Status
from ..ops.kkt import where_lanes
from ..utils.checkpoint import to_device
from ..utils.graphs import capture, copy_into
from ..utils.profiling import host_read

EPS1 = 1.0e-8       # pivot eligibility (pd.c:39)
EPS2 = 1.0e-12      # perturbation positivity floor (pd.c:40)
EPS3 = 1.0e-10      # mu optimality cutoff (pd.c:41)

_RUNNING = int(Status.RUNNING)

SIMPLEX_BANNER = (
    "---------------------------------------------------------------------------\n"
    "          |   Primal      |        |\n"
    "  Iter    |  Obj Value    |   mu   |\n"
    "- - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - -")


def _trace_row(it, obj, mu):
    """Host printer for one pivot row (pd.c:417-418 format)."""
    print(f"{int(it):8d}   {float(obj):14.7e} {float(mu):9.2e}", flush=True)


class PdState(NamedTuple):
    """pd's state, one lane per LP of a batch, all on the device."""
    Binv: torch.Tensor       # (B, m, m) explicit basis inverse
    basics: torch.Tensor     # (B, m) int64 column ids in [0, N)
    nonbasics: torch.Tensor  # (B, n) int64 column ids
    x_B: torch.Tensor        # (B, m)
    xbar_B: torch.Tensor     # (B, m)
    y_N: torch.Tensor        # (B, n)
    ybar_N: torch.Tensor     # (B, n)
    iter: torch.Tensor       # (B,) int64
    status: torch.Tensor     # (B,) int64


class TpState(NamedTuple):
    """twophase's state, laid out as PdState's without the perturbations."""
    Binv: torch.Tensor
    basics: torch.Tensor
    nonbasics: torch.Tensor
    x_B: torch.Tensor
    y_N: torch.Tensor
    iter: int
    status: int


def _refresh_binv(Afull, basics):
    """B^-1 from scratch (the dense 'refactor'), in the data dtype."""
    return torch.linalg.inv(Afull[:, basics])


def _reduced_costs(Afull, Binv, basics, nonbasics, cvec):
    """z_N(cvec) = (cvec_B B^-1 A)_N - cvec_N at the current basis — what
    btsolve + Nt_times_y regenerate from a fresh LU (2phase.c:331-350)."""
    v = cvec[basics] @ Binv
    return (v @ Afull - cvec)[nonbasics]


def _pivot_binv(Binv, dx_B, col_out: int):
    """Product-form update of B^-1 after basis column col_out is replaced
    by the entering column a_j (for which dx_B = B^-1 a_j)."""
    row = Binv[col_out, :] / dx_B[col_out]
    Binv = Binv - torch.outer(dx_B, row)
    Binv[col_out, :] = row
    return Binv


def _masked_argmin(vals, mask):
    """Index of the smallest vals[..., i] with mask[..., i] along the last
    dim, -1 where no entry is masked; still on the device."""
    masked = torch.where(mask, vals, torch.full_like(vals, float("inf")))
    return torch.where(mask.any(-1), torch.argmin(masked, -1), -1)


def _dy_nonbasic(Afull, Binv, nonbasics, col_out: int):
    """dy_N = -((B^-1)_{col_out,:} A_full) at the nonbasic columns — the
    dense fusion of btsolve + Nt_times_y (pd.c:258-265)."""
    return (-Binv[col_out, :] @ Afull)[nonbasics]


def _column(Afull, ids, pos: int):
    """Column ids[pos] of Afull, gathered on the device (no host read)."""
    return Afull.index_select(1, ids[pos:pos + 1])[:, 0]


def _swap(basics, nonbasics, col_in: int, col_out: int):
    """Exchange basics[col_out] and nonbasics[col_in] (new tensors)."""
    basics, nonbasics = basics.clone(), nonbasics.clone()
    enter = nonbasics[col_in].clone()
    nonbasics[col_in] = basics[col_out]
    basics[col_out] = enter
    return basics, nonbasics


def _run(cond, body, refresh, state, refresh_every: int, deadline):
    """Pivot while cond(state), refactoring after every refresh_every
    pivots while the solve still runs (vanderbei_tpu's _chunked_loop:
    refresh_every guarded pivots, then one refactor if still running).
    Returns (state, timed_out)."""
    k = 0
    while cond(state):
        state = body(state)
        k += 1
        if k % refresh_every == 0 and cond(state):
            state = refresh(state)
        if deadline is not None and time.monotonic() > deadline:
            return state, True
    return state, False


def _graph_step(body, state):
    """Capture body (state -> new state, no host reads) as one CUDA graph
    that reads a static copy of state and writes its result back into it
    (utils/graphs.capture, whose warm-up runs body alone).  Returns (the
    static state, step), step(static) replaying the graph."""
    static = type(state)(*(t.clone() for t in state))
    replay = capture(lambda s: copy_into(s, body(s)), static, warm=body)

    def step(s):
        replay()
        return s

    return static, step


def _reduced_costs_b(Afull, Binv, basics, nonbasics, cvec):
    """_reduced_costs lane by lane: Afull (B, m, N), cvec (B, N)."""
    v = (cvec.gather(-1, basics)[:, None, :] @ Binv)
    return ((v @ Afull)[:, 0] - cvec).gather(-1, nonbasics)


def _transcribe(basics, nonbasics, x_B, y_N, n: int):
    """(x, y, w, z) from the final basis (pd.c:431-445); the vectors may
    carry a leading batch dim."""
    N = basics.shape[-1] + nonbasics.shape[-1]
    x_full = torch.zeros(*x_B.shape[:-1], N, dtype=x_B.dtype,
                         device=x_B.device)
    x_full = x_full.scatter(-1, basics, x_B)
    y_full = torch.zeros_like(x_full).scatter(-1, nonbasics, y_N)
    return (x_full[..., :n], y_full[..., n:], x_full[..., n:],
            y_full[..., :n])


# ---------------------------------------------------------------------------
# parametric self-dual (pd.c)
# ---------------------------------------------------------------------------

def _at(v, idx):
    """v[k, idx[k]] for each lane k: v (B, d), idx (B,)."""
    return v.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def _set_at(v, idx, val):
    """v with v[k, idx[k]] = val[k] for each lane k."""
    return v.scatter(-1, idx.unsqueeze(-1), val.unsqueeze(-1))


def _pd_loop(Afull, b, c, u_x, u_y, *, max_iter: int, refresh_every: int,
             trace: bool = False, deadline: float | None = None):
    """Run pd on [A | I] x = b, max c'x, for every lane of Afull (B, m, N),
    b (B, m), c (B, N).  u_x (B, m) and u_y (B, n) are the U[0,1) draws of
    the perturbations xbar = u_x + rscale and ybar = u_y + cscale
    (pd.c:193-200).  trace prints lane 0's pivots.

    Returns (status, x, y, w, z, pivots), each batched over B."""
    B, m, N = Afull.shape
    n = N - m
    dev, dtype = Afull.device, Afull.dtype
    A0 = Afull[..., :n]
    # row/col 2-norms over the structural columns (pd.c:179-187)
    xbar = u_x + torch.sqrt(torch.sum(A0 * A0, dim=-1))
    ybar = u_y + torch.sqrt(torch.sum(A0 * A0, dim=-2))
    # x_B = B^-1 b, xbar_B = B^-1 xbar, y_N = z_N(c), ybar_N = z_N(cbar)
    # hold at every basis; the refactor recomputes them from these
    cbar = torch.cat([-ybar, torch.zeros(B, m, dtype=dtype, device=dev)], -1)
    i64 = lambda v: torch.full((B,), v, dtype=torch.int64, device=dev)
    arange = lambda lo, hi: torch.arange(lo, hi, device=dev).expand(B, -1)

    state = PdState(
        Binv=torch.eye(m, dtype=dtype, device=dev).expand(B, m, m).clone(),
        basics=arange(n, N).clone(), nonbasics=arange(0, n).clone(),
        x_B=b.clone(), xbar_B=xbar, y_N=-c[..., :n], ybar_N=ybar,
        iter=i64(0), status=i64(_RUNNING))
    neg_inf = torch.full((), float("-inf"), dtype=dtype, device=dev)

    def running(s: PdState):
        return (s.status == _RUNNING) & (s.iter < max_iter)

    def column(s: PdState, pos):
        """Column nonbasics[pos] of Afull per lane, (B, m)."""
        j = _at(s.nonbasics, pos)
        return Afull.gather(-1, j[:, None, None].expand(B, m, 1))[..., 0]

    def dy_nonbasic(s: PdState, pos):
        """dy_N = -((B^-1)_{pos,:} A_full) at the nonbasic columns, per
        lane (the dense fusion of btsolve + Nt_times_y, pd.c:258-265)."""
        row = s.Binv.gather(-2, pos[:, None, None].expand(B, 1, m))
        return (-row @ Afull)[:, 0].gather(-1, s.nonbasics)

    def body(s: PdState) -> PdState:
        run = running(s)
        # STEP 1: largest mu forcing a pivot (pd.c:224-247)
        cand_d = torch.where(s.ybar_N > EPS2, -s.y_N / s.ybar_N, neg_inf)
        cand_p = torch.where(s.xbar_B > EPS2, -s.x_B / s.xbar_B, neg_inf)
        jd, ip = torch.argmax(cand_d, -1), torch.argmax(cand_p, -1)
        vd, vp = _at(cand_d, jd), _at(cand_p, ip)
        mu = torch.maximum(vd, vp)
        if trace and bool(run[0]):
            _trace_row(s.iter[0], _at(c, s.basics)[0] @ s.x_B[0], mu[0])
        optimal = mu <= EPS3
        primal = vp > vd     # strict, as in pd.c:237-241
        # primal scan: basis slot ip leaves, the entrant from the dual
        # ratio test (pd.c:249-292); dual scan: nonbasic slot jd enters,
        # the leaver from the primal ratio test (pd.c:294-338)
        dy_p = dy_nonbasic(s, ip)
        col_in_p = _masked_argmin((s.y_N + mu[:, None] * s.ybar_N) / dy_p,
                                  dy_p > EPS1)
        dx_d = (s.Binv @ column(s, jd)[..., None])[..., 0]
        col_out_d = _masked_argmin((s.x_B + mu[:, None] * s.xbar_B) / dx_d,
                                   dx_d > EPS1)
        col_in = torch.where(primal, col_in_p, jd)
        col_out = torch.where(primal, ip, col_out_d)
        failed = (col_in < 0) | (col_out < 0)
        ci, co = col_in.clamp_min(0), col_out.clamp_min(0)
        dx_B = (s.Binv @ column(s, ci)[..., None])[..., 0]
        dy_N = dy_nonbasic(s, co)

        piv = _at(dx_B, co)
        t, tbar = _at(s.x_B, co) / piv, _at(s.xbar_B, co) / piv
        dpiv = _at(dy_N, ci)
        sv, sbar = _at(s.y_N, ci) / dpiv, _at(s.ybar_N, ci) / dpiv
        y_N = _set_at(s.y_N - sv[:, None] * dy_N, ci, sv)
        ybar_N = _set_at(s.ybar_N - sbar[:, None] * dy_N, ci, sbar)
        x_B = _set_at(s.x_B - t[:, None] * dx_B, co, t)
        xbar_B = _set_at(s.xbar_B - tbar[:, None] * dx_B, co, tbar)
        basics = _set_at(s.basics, co, _at(s.nonbasics, ci))
        nonbasics = _set_at(s.nonbasics, ci, _at(s.basics, co))
        # product-form update of B^-1 (see _pivot_binv), lane by lane
        rows = co[:, None, None].expand(B, 1, m)
        row = s.Binv.gather(-2, rows) / piv[:, None, None]
        Binv = (s.Binv - dx_B[..., None] * row).scatter(-2, rows, row)
        pivoted = PdState(Binv, basics, nonbasics, x_B, xbar_B, y_N, ybar_N,
                          s.iter, s.status)

        fail = torch.where(primal, int(Status.PRIMAL_INFEASIBLE),
                           int(Status.PRIMAL_UNBOUNDED))
        status = torch.where(optimal, int(Status.OPTIMAL),
                             torch.where(failed, fail, s.status))
        out = where_lanes(run & ~optimal & ~failed, pivoted, s)
        return out._replace(iter=torch.where(run, s.iter + 1, s.iter),
                            status=torch.where(run, status, s.status))

    def refresh(s: PdState) -> PdState:
        """True refactor of the running lanes: a fresh B^-1 AND the
        iterates re-derived from it."""
        Bmat = Afull.gather(-1, s.basics[:, None, :].expand(B, m, m))
        if dev.type == "cpu":
            # MKL's batched LU (getrf over a batch, on several threads)
            # fails on some hosts ("DLASWP parameter 6"): lane by lane
            Binv = torch.stack([torch.linalg.inv_ex(Bl)[0] for Bl in Bmat])
        else:
            Binv = torch.linalg.inv_ex(Bmat)[0]
        mvb = lambda v: (Binv @ v[..., None])[..., 0]
        fresh = s._replace(
            Binv=Binv, x_B=mvb(b), xbar_B=mvb(xbar),
            y_N=_reduced_costs_b(Afull, Binv, s.basics, s.nonbasics, c),
            ybar_N=_reduced_costs_b(Afull, Binv, s.basics, s.nonbasics,
                                    cbar))
        return where_lanes(running(s), fresh, s)

    # on the card one pivot is one CUDA graph replay: the body's ~100
    # small kernels launched eagerly would bound the loop on the host
    if dev.type == "cuda" and not trace:
        state, step = _graph_step(body, state)
        put = copy_into
    else:
        step, put = body, lambda old, new: new
    # refresh_every guarded pivots, then one refactor of the running
    # lanes and one read of the loop flag (vanderbei_tpu's _chunked_loop)
    k = 0
    while True:
        if k % refresh_every == 0:
            if k:
                state = put(state, refresh(state))
            if not bool(host_read("pd.loop", running(state).any().item)):
                break
        state = step(state)
        k += 1
        if deadline is not None and time.monotonic() > deadline:
            break
    out = state
    status = torch.where(out.status == _RUNNING, int(Status.ITERATION_LIMIT),
                         out.status)
    return (status, *_transcribe(out.basics, out.nonbasics, out.x_B, out.y_N,
                                 n), out.iter)


# ---------------------------------------------------------------------------
# two-phase (2phase.c)
# ---------------------------------------------------------------------------

def _tp_pivot(Afull, s: TpState, col_in: int, col_out: int, dy_N, dx_B):
    """Shared pivot/update of both phases (2phase.c:266-316)."""
    t = s.x_B[col_out] / dx_B[col_out]
    sv = s.y_N[col_in] / dy_N[col_in]
    y_N = s.y_N - sv * dy_N
    x_B = s.x_B - t * dx_B
    y_N[col_in] = sv
    x_B[col_out] = t
    basics, nonbasics = _swap(s.basics, s.nonbasics, col_in, col_out)
    return TpState(_pivot_binv(s.Binv, dx_B, col_out), basics, nonbasics,
                   x_B, y_N, s.iter + 1, s.status)


def _twophase_loop(Afull, b, c, u_y, *, max_iter: int, refresh_every: int,
                   trace: bool = False, deadline: float | None = None):
    """Run twophase on [A | I] x = b, max c'x.  u_y (n,) is the U[0,1) draw
    of the dual-feasible start y_N = max(c, 1) + u_y (2phase.c:168-173).

    Returns (status, x, y, w, z, pivots)."""
    m, N = Afull.shape
    n = N - m
    dev, dtype = Afull.device, Afull.dtype
    y0 = torch.clamp_min(c[:n], 1.0) + u_y
    # Phase I runs with the implicit objective ctilde whose reduced costs
    # at the slack basis are y0; its refactors re-derive y_N from it
    ctilde = torch.cat([-y0, torch.zeros(m, dtype=dtype, device=dev)])
    state = TpState(
        Binv=torch.eye(m, dtype=dtype, device=dev),
        basics=torch.arange(n, N, device=dev),
        nonbasics=torch.arange(0, n, device=dev),
        x_B=b.clone(), y_N=y0, iter=0, status=_RUNNING)
    done = False      # the phase found no pivot left

    def cond(s: TpState):
        return s.status == _RUNNING and not done and s.iter < max_iter

    def phase1_body(s: TpState) -> TpState:
        nonlocal done
        if trace:
            _trace_row(s.iter, c[s.basics] @ s.x_B, float("nan"))
        # STEP 1: most negative basic primal (pick_neg, 2phase.c:616-629)
        col_out = torch.argmin(s.x_B)
        if bool(host_read("twophase.test", (s.x_B[col_out] >= -EPS2).item)):
            done = True
            return s._replace(iter=s.iter + 1)
        col_out = host_read("twophase.pick", col_out.item)
        dy_N = _dy_nonbasic(Afull, s.Binv, s.nonbasics, col_out)
        col_in = host_read("twophase.pick",
                           _masked_argmin(s.y_N / dy_N, dy_N > EPS1).item)
        if col_in < 0:
            return s._replace(status=int(Status.PRIMAL_INFEASIBLE),
                              iter=s.iter + 1)
        dx_B = s.Binv @ _column(Afull, s.nonbasics, col_in)
        return _tp_pivot(Afull, s, col_in, col_out, dy_N, dx_B)

    def phase2_body(s: TpState) -> TpState:
        nonlocal done
        if trace:
            _trace_row(s.iter, c[s.basics] @ s.x_B, float("nan"))
        # STEP 1: most negative nonbasic dual (2phase.c:370)
        col_in = torch.argmin(s.y_N)
        if bool(host_read("twophase.test", (s.y_N[col_in] >= -EPS2).item)):
            done = True
            return s._replace(status=int(Status.OPTIMAL), iter=s.iter + 1)
        col_in = host_read("twophase.pick", col_in.item)
        dx_B = s.Binv @ _column(Afull, s.nonbasics, col_in)
        col_out = host_read("twophase.pick",
                            _masked_argmin(s.x_B / dx_B, dx_B > EPS1).item)
        if col_out < 0:
            return s._replace(status=int(Status.PRIMAL_UNBOUNDED),
                              iter=s.iter + 1)
        dy_N = _dy_nonbasic(Afull, s.Binv, s.nonbasics, col_out)
        return _tp_pivot(Afull, s, col_in, col_out, dy_N, dx_B)

    def refresh_with(cvec):
        def refresh(s: TpState) -> TpState:
            Binv = _refresh_binv(Afull, s.basics)
            return s._replace(
                Binv=Binv, x_B=Binv @ b,
                y_N=_reduced_costs(Afull, Binv, s.basics, s.nonbasics, cvec))
        return refresh

    s, timed_out = _run(cond, phase1_body, refresh_with(ctilde), state,
                        refresh_every, deadline)
    if s.status == _RUNNING:
        # objective restoration (2phase.c:331-350)
        s = s._replace(y_N=_reduced_costs(Afull, s.Binv, s.basics,
                                          s.nonbasics, c))
        done = False
        if not timed_out:
            s, _ = _run(cond, phase2_body, refresh_with(c), s,
                        refresh_every, deadline)
    status = (int(Status.ITERATION_LIMIT) if s.status == _RUNNING
              else s.status)
    return (status, *_transcribe(s.basics, s.nonbasics, s.x_B, s.y_N, n),
            s.iter)


# ---------------------------------------------------------------------------
# canonical-form entry points
# ---------------------------------------------------------------------------

def _prepare(canon, cfg: SolverConfig, device):
    """[A | I], b and c (slack columns cost 0) on the device."""
    up = lambda a: to_device(np.asarray(a, cfg.dtype), device,
                             _torch_dtype(cfg.dtype))
    A = up(canon.A)
    m = A.shape[0]
    Afull = torch.cat([A, torch.eye(m, dtype=A.dtype, device=device)], dim=1)
    b = up(canon.b)
    c = torch.cat([up(canon.c), torch.zeros(m, dtype=A.dtype, device=device)])
    return Afull, b, c


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def perturbation_draws(cfg: SolverConfig, m: int, n: int, lanes=()):
    """The U[0,1) draws (u_x (*lanes, m), u_y (*lanes, n)) of the pd
    perturbations, from a CPU torch.Generator seeded with cfg.seed;
    twophase uses u_y."""
    gen = torch.Generator().manual_seed(int(cfg.seed))
    dtype = _torch_dtype(cfg.dtype)
    u_x = torch.rand(*lanes, m, generator=gen, dtype=dtype)
    u_y = torch.rand(*lanes, n, generator=gen, dtype=dtype)
    return u_x, u_y


def _draw_to(u, like):
    """A draw (tensor or array) as a tensor of like's dtype and device: a
    copy (a JAX draw's array is read-only)."""
    return to_device(np.array(u), like.device, like.dtype)


def _deadline(cfg: SolverConfig):
    return (None if not np.isfinite(cfg.time_limit)
            else time.monotonic() + cfg.time_limit)


def _finish(out, t0, stages: list):
    status, x, y, w, z, iters = out
    stages.append(dict(precision="f64", iterations=iters,
                       seconds=time.perf_counter() - t0, paused=False))
    host = lambda t: t.cpu().numpy()
    return status, host(x), host(y), host(w), host(z), iters


def solve_canon_pd(canon, cfg: SolverConfig, device, stages: list,
                   draws=None):
    """pd on a CanonLP.  draws: (u_x, u_y) to use instead of
    perturbation_draws(cfg, ...), e.g. another package's."""
    t0 = time.perf_counter()
    deadline = _deadline(cfg)
    Afull, b, c = _prepare(canon, cfg, device)
    m, n = canon.A.shape
    u_x, u_y = draws if draws is not None else perturbation_draws(cfg, m, n)
    if cfg.verbose >= 2:
        print(SIMPLEX_BANNER, flush=True)
    one = lambda t: t.unsqueeze(0)      # the batch of one
    status, x, y, w, z, iters = _pd_loop(
        one(Afull), one(b), one(c), one(_draw_to(u_x, Afull)),
        one(_draw_to(u_y, Afull)),
        max_iter=cfg.max_iter or cfg.simplex_max_iter,
        refresh_every=cfg.refresh_every, trace=cfg.verbose >= 2,
        deadline=deadline)
    out = (int(status[0]), x[0], y[0], w[0], z[0], int(iters[0]))
    return _finish(out, t0, stages)


def solve_canon_twophase(canon, cfg: SolverConfig, device, stages: list,
                         draws=None):
    """twophase on a CanonLP.  draws: (u_x, u_y) as for solve_canon_pd;
    only u_y is used."""
    t0 = time.perf_counter()
    deadline = _deadline(cfg)
    Afull, b, c = _prepare(canon, cfg, device)
    m, n = canon.A.shape
    u_y = (draws if draws is not None else perturbation_draws(cfg, m, n))[1]
    if cfg.verbose >= 2:
        print(SIMPLEX_BANNER, flush=True)
    out = _twophase_loop(
        Afull, b, c, _draw_to(u_y, Afull),
        max_iter=cfg.max_iter or cfg.simplex_max_iter,
        refresh_every=cfg.refresh_every, trace=cfg.verbose >= 2,
        deadline=deadline)
    return _finish(out, t0, stages)
