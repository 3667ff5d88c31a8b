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

The pivot loop runs on the host: each pivot reads its choices (the
entering and leaving positions) back from the device, the vectors stay
there.  The perturbations are uniform draws from a torch.Generator seeded
with cfg.seed, drawn on the CPU so every device gets the same run; a caller
may pass its own draws instead (the tests pass the JAX package's).
cfg.time_limit (TIMLIM) is checked after every pivot, in both methods.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import SolverConfig
from ..core.status import Status

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
    """pd's state.  The vectors live on the device; iter and status are
    host ints, since the host decides every pivot."""
    Binv: torch.Tensor       # (m, m) explicit basis inverse
    basics: torch.Tensor     # (m,) int64 column ids in [0, N)
    nonbasics: torch.Tensor  # (n,) int64 column ids
    x_B: torch.Tensor        # (m,)
    xbar_B: torch.Tensor     # (m,)
    y_N: torch.Tensor        # (n,)
    ybar_N: torch.Tensor     # (n,)
    iter: int
    status: int


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
    """(index, value) of the smallest vals[i] with mask[i]; the index is
    -1 where no entry is masked.  Two 0-d tensors, still on the device."""
    masked = torch.where(mask, vals, torch.full_like(vals, float("inf")))
    idx = torch.argmin(masked)
    return torch.where(mask.any(), idx, -1), masked[idx]


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


def _transcribe(basics, nonbasics, x_B, y_N, n: int):
    """(x, y, w, z) from the final basis (pd.c:431-445)."""
    N = basics.shape[0] + nonbasics.shape[0]
    x_full = torch.zeros(N, dtype=x_B.dtype, device=x_B.device)
    y_full = torch.zeros_like(x_full)
    x_full[basics] = x_B
    y_full[nonbasics] = y_N
    return x_full[:n], y_full[n:], x_full[n:], y_full[:n]


# ---------------------------------------------------------------------------
# parametric self-dual (pd.c)
# ---------------------------------------------------------------------------

def _pd_loop(Afull, b, c, u_x, u_y, *, max_iter: int, refresh_every: int,
             trace: bool = False, deadline: float | None = None):
    """Run pd on [A | I] x = b, max c'x.  u_x (m,) and u_y (n,) are the
    U[0,1) draws of the perturbations xbar = u_x + rscale and
    ybar = u_y + cscale (pd.c:193-200).

    Returns (status, x, y, w, z, pivots)."""
    m, N = Afull.shape
    n = N - m
    dev, dtype = Afull.device, Afull.dtype
    A0 = Afull[:, :n]
    # row/col 2-norms over the structural columns (pd.c:179-187)
    xbar = u_x + torch.sqrt(torch.sum(A0 * A0, dim=1))
    ybar = u_y + torch.sqrt(torch.sum(A0 * A0, dim=0))
    # x_B = B^-1 b, xbar_B = B^-1 xbar, y_N = z_N(c), ybar_N = z_N(cbar)
    # hold at every basis; the refactor recomputes them from these
    cbar = torch.cat([-ybar, torch.zeros(m, dtype=dtype, device=dev)])

    state = PdState(
        Binv=torch.eye(m, dtype=dtype, device=dev),
        basics=torch.arange(n, N, device=dev),
        nonbasics=torch.arange(0, n, device=dev),
        x_B=b.clone(), xbar_B=xbar, y_N=-c[:n], ybar_N=ybar,
        iter=0, status=_RUNNING)
    neg_inf = torch.full((), float("-inf"), dtype=dtype, device=dev)

    def cond(s: PdState):
        return s.status == _RUNNING and s.iter < max_iter

    def body(s: PdState) -> PdState:
        # STEP 1: largest mu forcing a pivot (pd.c:224-247)
        cand_d = torch.where(s.ybar_N > EPS2, -s.y_N / s.ybar_N, neg_inf)
        cand_p = torch.where(s.xbar_B > EPS2, -s.x_B / s.xbar_B, neg_inf)
        jd, ip = torch.argmax(cand_d), torch.argmax(cand_p)
        vd, vp, jd, ip = torch.stack([cand_d[jd], cand_p[ip],
                                      jd.to(dtype), ip.to(dtype)]).tolist()
        jd, ip = int(jd), int(ip)
        mu = max(vd, vp)
        if trace:
            _trace_row(s.iter, c[s.basics] @ s.x_B, mu)
        if mu <= EPS3:
            return s._replace(status=int(Status.OPTIMAL), iter=s.iter + 1)

        if vp > vd:      # strict, as in pd.c:237-241
            # primal scan won: basis slot ip leaves; the entrant comes
            # from the dual ratio test (pd.c:249-292)
            col_out = ip
            dy_N = _dy_nonbasic(Afull, s.Binv, s.nonbasics, col_out)
            col_in = int(_masked_argmin((s.y_N + mu * s.ybar_N) / dy_N,
                                        dy_N > EPS1)[0])
            dx_B = (None if col_in < 0 else
                    s.Binv @ _column(Afull, s.nonbasics, col_in))
            fail = int(Status.PRIMAL_INFEASIBLE)
        else:
            # dual scan won: nonbasic slot jd enters; the leaver comes
            # from the primal ratio test (pd.c:294-338)
            col_in = jd
            dx_B = s.Binv @ _column(Afull, s.nonbasics, col_in)
            col_out = int(_masked_argmin((s.x_B + mu * s.xbar_B) / dx_B,
                                         dx_B > EPS1)[0])
            dy_N = (None if col_out < 0 else
                    _dy_nonbasic(Afull, s.Binv, s.nonbasics, col_out))
            fail = int(Status.PRIMAL_UNBOUNDED)
        if col_in < 0 or col_out < 0:
            return s._replace(status=fail, iter=s.iter + 1)

        t = s.x_B[col_out] / dx_B[col_out]
        tbar = s.xbar_B[col_out] / dx_B[col_out]
        sv = s.y_N[col_in] / dy_N[col_in]
        sbar = s.ybar_N[col_in] / dy_N[col_in]
        y_N = s.y_N - sv * dy_N
        ybar_N = s.ybar_N - sbar * dy_N
        x_B = s.x_B - t * dx_B
        xbar_B = s.xbar_B - tbar * dx_B
        y_N[col_in], ybar_N[col_in] = sv, sbar
        x_B[col_out], xbar_B[col_out] = t, tbar
        basics, nonbasics = _swap(s.basics, s.nonbasics, col_in, col_out)
        return PdState(_pivot_binv(s.Binv, dx_B, col_out), basics, nonbasics,
                       x_B, xbar_B, y_N, ybar_N, s.iter + 1, s.status)

    def refresh(s: PdState) -> PdState:
        """True refactor: a fresh B^-1 AND the iterates re-derived from it."""
        Binv = _refresh_binv(Afull, s.basics)
        return s._replace(
            Binv=Binv, x_B=Binv @ b, xbar_B=Binv @ xbar,
            y_N=_reduced_costs(Afull, Binv, s.basics, s.nonbasics, c),
            ybar_N=_reduced_costs(Afull, Binv, s.basics, s.nonbasics, cbar))

    out, _ = _run(cond, body, refresh, state, refresh_every, deadline)
    status = (int(Status.ITERATION_LIMIT) if out.status == _RUNNING
              else out.status)
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
        if bool((s.x_B[col_out] >= -EPS2).item()):
            done = True
            return s._replace(iter=s.iter + 1)
        col_out = int(col_out)
        dy_N = _dy_nonbasic(Afull, s.Binv, s.nonbasics, col_out)
        col_in = int(_masked_argmin(s.y_N / dy_N, dy_N > EPS1)[0])
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
        if bool((s.y_N[col_in] >= -EPS2).item()):
            done = True
            return s._replace(status=int(Status.OPTIMAL), iter=s.iter + 1)
        col_in = int(col_in)
        dx_B = s.Binv @ _column(Afull, s.nonbasics, col_in)
        col_out = int(_masked_argmin(s.x_B / dx_B, dx_B > EPS1)[0])
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
    A = torch.from_numpy(np.asarray(canon.A, cfg.dtype)).to(device)
    m = A.shape[0]
    Afull = torch.cat([A, torch.eye(m, dtype=A.dtype, device=device)], dim=1)
    b = torch.from_numpy(np.asarray(canon.b, cfg.dtype)).to(device)
    c = torch.cat([torch.from_numpy(np.asarray(canon.c, cfg.dtype)).to(device),
                   torch.zeros(m, dtype=A.dtype, device=device)])
    return Afull, b, c


def perturbation_draws(cfg: SolverConfig, m: int, n: int):
    """The U[0,1) draws (u_x (m,), u_y (n,)) of the pd perturbations, from
    a CPU torch.Generator seeded with cfg.seed; twophase uses u_y."""
    gen = torch.Generator().manual_seed(int(cfg.seed))
    dtype = torch.from_numpy(np.zeros(0, cfg.dtype)).dtype
    u_x = torch.rand(m, generator=gen, dtype=dtype)
    u_y = torch.rand(n, generator=gen, dtype=dtype)
    return u_x, u_y


def _draw_to(u, like):
    """A draw (tensor or array) as a tensor of like's dtype and device."""
    return torch.tensor(np.asarray(u), dtype=like.dtype, device=like.device)


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
    out = _pd_loop(Afull, b, c, _draw_to(u_x, Afull), _draw_to(u_y, Afull),
                   max_iter=cfg.max_iter or cfg.simplex_max_iter,
                   refresh_every=cfg.refresh_every, trace=cfg.verbose >= 2,
                   deadline=deadline)
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
