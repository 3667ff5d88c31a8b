"""Homogeneous self-dual interior-point method on torch tensors, the port
of vanderbei_tpu/models/hsd.py.

"hsd" is the reference ipo's default method (src/ipo/hsd.c:27-311) with a
Mehrotra predictor-corrector by default or the reference's alternating
delta=0/1 scheme; "hsdls" is the long-step variant (src/ipo/hsdls.c) with
its beta-neighbourhood quadratic linesearch.  Each iteration does one KKT
factorization and solves the f- and g-systems through it, combined by the
dphi formula (hsd.c:230-238).

Batch-first: A may be (..., m, n) with every state field carrying the same
leading dims, one LP per lane of a stacked size class (parallel/batch.py);
the single-LP solve is the case with none.  The loop runs on the host and
reads one pair of flags per iteration, some lane live (the JAX package's
while_loop under vmap) and some live lane undecided (the stop test runs
before the read, so an iteration with nothing to step skips the KKT
work).  The step is computed for every lane and kept only where the lane
is live and undecided (the JAX lax.cond under vmap is such a select); the
KKT layer reads its own retry and refinement flags.
Everything else, including the stall detector, the quality gate and the
finite-iterate guard, stays on the device as per-lane tensor arithmetic.

Column shards (cols, parallel/distributed.ColumnShards): the state's x and
z, like c and A, hold this rank's columns; y, w, phi and psi are whole on
every rank.  The n-space inner products of one block of the iteration are
stacked into one SUM all-reduce, the ratio tests' maxima over n into one
MAX (MIN for the long step's linesearch), Ax is a partial sum completed
with the residual block's dots, and the finite-iterate guard is agreed
over the group; mu's denominators take the global n.  So every rank holds
the same status, step and flags, and every host read agrees.  Under
precision "dd" the n-space sums are compensated across the ranks too
(ColumnShards.sum2); the pause test's mu after the loop (_mu) is a plain
sum with or without it, as the JAX package's is.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..core.status import Status
from ..ops.kkt import (dot as _dot, kkt_factor, kkt_solve, local,
                       mv as _mv, next_reg, UbTail, tail_matvec,
                       tail_rmatvec, where_lanes)
from ..ops.quad import DD, dot2, dot2_dd, matvec2, matvec2_dd
from ..utils.graphs import capture, copy_into
from ..utils.profiling import count, host_read

DEFAULT_MAX_ITER = 200      # hsd.c:25
DEFAULT_MAX_ITER_LS = 600   # hsdls.c:25
STALL_LIMIT = 15            # consecutive non-improving iterations -> stop

_RUNNING = int(Status.RUNNING)
_OPTIMAL = int(Status.OPTIMAL)
_SUBOPTIMAL = int(Status.SUBOPTIMAL)

HSD_BANNER = (
    "--------------------------------------------------------------------------\n"
    "         |           Primal          |            Dual           |       |\n"
    "  Iter   |  Obj Value       Infeas   |  Obj Value       Infeas   |  mu   |\n"
    "- - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - ")


def _trace_row(it, pobj, normr, dobj, norms, mu):
    """Host-side printer for one iteration row (hsd.c:206-208 format)."""
    print(f"{int(it):8d}   {float(pobj):14.7e}  {float(normr):8.1e}    "
          f"{float(dobj):14.7e}  {float(norms):8.1e}  {float(mu):8.1e}",
          flush=True)


class HsdState(NamedTuple):
    """Solver state; field names match vanderbei_tpu.models.hsd.HsdState
    (and so the npz checkpoints).  Vectors are (..., dim), the scalars
    (...,), one per lane; iter, status and stall are int64."""
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    phi: torch.Tensor
    psi: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    reg: torch.Tensor       # sticky Tikhonov level of the KKT factor
    mu_best: torch.Tensor   # stall detector: best mu seen ...
    stall: torch.Tensor     # ... and consecutive non-improving iterations


class _Decision(NamedTuple):
    """The first half of an iteration: its residuals and stop test."""
    mu: torch.Tensor
    delta: torch.Tensor
    primal_obj: torch.Tensor
    dual_obj: torch.Tensor
    rho: torch.Tensor
    sigma: torch.Tensor
    new_status: torch.Tensor
    mu_best: torch.Tensor
    stall: torch.Tensor


def _hsd_linesearch(v, dv, s, ds, beta, delta, mu):
    """Largest theta keeping (v+t*dv)(s+t*ds) inside the beta-neighbourhood:
    the quadratic-root case analysis of hsdls.c:296-336, elementwise; +inf
    where any step is admissible."""
    a = dv * ds
    b = s * dv + v * ds + (1.0 - beta) * (1.0 - delta) * mu
    c = v * s - (1.0 - beta) * mu
    d = b * b - 4.0 * a * c
    sqrt_d = torch.sqrt(torch.clamp_min(d, 0.0))
    inf = float("inf")

    lin = -c / b                                    # a == 0
    stable = 2.0 * c / (-b + sqrt_d)                # root avoiding cancellation
    classic = (-b - sqrt_d) / (2.0 * a)

    pos_a = torch.where(b < 0.0, torch.where(d >= 0.0, stable, inf), inf)
    neg_a = torch.where(b < 0.0, stable, classic)
    return torch.where(a == 0.0, lin, torch.where(a > 0.0, pos_a, neg_a))


def init_state(A, extra_rows: int = 0) -> HsdState:
    """All-ones homogeneous start (hsd.c:98-109) for A (..., m, n);
    extra_rows counts the implicit ub-tail rows (y/w span the full
    canonical row space)."""
    *lead, m, n = A.shape
    m = m + extra_rows
    kw = dict(dtype=A.dtype, device=A.device)
    i64 = lambda v: torch.full(lead, v, dtype=torch.int64, device=A.device)
    return HsdState(torch.ones(*lead, n, **kw), torch.ones(*lead, n, **kw),
                    torch.ones(*lead, m, **kw), torch.ones(*lead, m, **kw),
                    torch.ones(lead, **kw), torch.ones(lead, **kw),
                    i64(0), i64(_RUNNING), torch.zeros(lead, **kw),
                    torch.full(lead, float("inf"), **kw), i64(0))


def cast_state(state: HsdState, dtype) -> HsdState:
    """Move a paused state between precision stages.  The sticky factor
    regularization resets (it is calibrated to the old precision's
    roundoff) and so does the stall counter."""
    return HsdState(
        *(leaf.to(dtype) for leaf in state[:6]),
        state.iter, state.status, torch.zeros_like(state.reg, dtype=dtype),
        state.mu_best.to(dtype), torch.zeros_like(state.stall))


def _max(*ts):
    out = ts[0]
    for t in ts[1:]:
        out = torch.maximum(out, t)
    return out


def make_step(A, b, c, *,
              eps=1.0e-12,
              step_factor=0.95,
              beta=0.80,
              epsdiag=1.0e-14,
              refine_tol=1.0e-10,
              gap_tol=1.0e-6,
              feas_tol=1.0e-6,
              long_step: bool = False,
              max_refine: int = 8,
              trace: bool = False,
              f=0.0,
              factor_dtype=None,
              compensated: bool = False,
              corrector: str = "mehrotra",
              ub: UbTail | None = None,
              cols=None):
    """Build the single-iteration step function, as
    vanderbei_tpu.models.hsd.make_step: body(state) -> state does one KKT
    factorization, the f/g solves, the ratio test or linesearch and the
    update.  body.decide(state) is its first half, the residuals and the
    stop test; body(state, live, pre, step) takes that decision ready-made
    (pre), keeps the old state in the lanes outside `live` (the JAX
    while_loop under vmap), and skips the KKT work when step is False
    (the caller has read that no live lane is undecided).  Every lane
    steps otherwise, and a decided lane keeps its old iterate (the JAX
    lax.cond under vmap).

    compensated=True is precision "dd": the residual products and the
    inner products go through quad.matvec2 / quad.dot2 (twice the working
    precision), and so do the KKT refinement residuals.  cols: column
    shards (module docstring), with ub the rank's own tail
    (ColumnShards.tail); with compensated, each n-space sum (a dot over
    the rank's columns, Ax) is left unrounded (quad's *_dd forms) and
    completed by ColumnShards.sum2, while the m-space dots, whole on every
    rank, and A'y, column-local, stay local."""
    m, n = A.shape[-2:]
    if ub is not None:
        m = m + ub.idx2.shape[-1]    # y/w span the implicit tail rows too
    if cols is None:
        nsum = nmax = nmin = nall = local
    else:
        nsum, nmax, nmin, nall = cols.sum, cols.max, cols.min, cols.all
        n = cols.n
    dtype = A.dtype
    dev = A.device
    knob = lambda v: torch.full((), v, dtype=dtype, device=dev)
    eps, step_factor, beta = knob(eps), knob(step_factor), knob(beta)
    gap_tol, feas_tol, f = knob(gap_tol), knob(feas_tol), knob(f)
    one = knob(1.0)
    # with lanes, every per-lane scalar is kept as (..., 1), so that it
    # broadcasts against the lane's vectors; a single LP keeps 0-d scalars
    batched = A.dim() > 2
    col = (lambda t: t.unsqueeze(-1)) if batched else (lambda t: t)
    row = (lambda t: t.squeeze(-1)) if batched else (lambda t: t)
    dot0 = dot2 if compensated else _dot
    dot = lambda a, b: col(dot0(a, b))
    vmax = lambda t: t.amax(dim=-1, keepdim=batched)
    vmin = lambda t: t.amin(dim=-1, keepdim=batched)
    base_mv = matvec2 if compensated else _mv
    # the n-space sums: ndot and mv give this rank's partial sums and
    # nsum completes them (under cols with compensated: unrounded, by sum2)
    ndot, row_mv = dot, base_mv
    if compensated and cols is not None:
        nsum = cols.sum2
        ndot = lambda a, b: DD(*(col(t) for t in dot2_dd(a, b)))
        row_mv = matvec2_dd
    if ub is not None:
        mv = lambda M, v: tail_matvec(M, ub, v, row_mv)
        mvT = lambda M, v: tail_rmatvec(M, ub, v, base_mv)
    else:
        mv = row_mv
        mvT = lambda M, v: base_mv(M.mT, v)

    def decide(s: HsdState) -> _Decision:
        x, z, y, w = s.x, s.z, s.y, s.w
        phi, psi = col(s.phi), col(s.psi)

        # the n-space sums of the residual block, in one reduction
        sigma = -mvT(A, y) + c * phi + z
        zx, primal_obj, ss, cc, xs, ax = nsum(
            ndot(z, x), ndot(c, x), ndot(sigma, sigma), ndot(c, c),
            ndot(x, sigma), mv(A, x))
        mu = (zx + dot(w, y) + phi * psi) / (n + m + 1)
        if long_step:
            delta = 2.0 * (1.0 - beta)                       # hsdls.c:113
        else:
            delta = torch.where(col(s.iter) % 2 == 0, 0.0, one)  # hsd.c:138

        dual_obj = dot(b, y)

        # infeasibilities (hsd.c:182-198), before the stop test
        rho = ax - b * phi + w              # (m,) incl. implicit tail rows

        # stopping rule (hsd.c:155-176 / hsdls.c:134-154) plus the quality
        # gate on the de-homogenized point (see vanderbei_tpu's make_step)
        converged = mu < eps
        opt_test = phi > eps if long_step else phi > psi
        scale = 1.0 + torch.abs(primal_obj) / phi
        gap_rel = (dual_obj - primal_obj) / phi / scale
        comp_rel = (zx + dot(w, y)) / (phi * phi) / scale
        pinf_rel = torch.sqrt(dot(rho, rho)) / phi / (1.0 + torch.sqrt(dot(b, b)))
        dinf_rel = torch.sqrt(ss) / phi / (1.0 + torch.sqrt(cc))
        perr = torch.abs(dot(y, rho)) / (phi * phi) / scale
        derr = torch.abs(xs) / (phi * phi) / scale
        good = ((gap_rel <= gap_tol) & (comp_rel <= gap_tol)
                & (pinf_rel <= feas_tol) & (dinf_rel <= feas_tol)
                & (perr <= 10.0 * gap_tol) & (derr <= 10.0 * gap_tol))
        fallback = _SUBOPTIMAL if long_step else int(Status.DUAL_INFEASIBLE)
        final = torch.where(
            opt_test,
            torch.where(good, _OPTIMAL, _SUBOPTIMAL),
            torch.where(dual_obj < 0.0, int(Status.PRIMAL_INFEASIBLE),
                        torch.where(primal_obj > 0.0,
                                    int(Status.DUAL_INFEASIBLE), fallback)))
        # stall detector: STALL_LIMIT iterations without a 10% mu gain stop
        # the solve; near the stop tolerance the quality-gated verdict holds
        improved = mu < 0.9 * col(s.mu_best)
        stall2 = torch.where(improved, 0, col(s.stall) + 1)
        mu_best2 = torch.minimum(col(s.mu_best), mu)
        stalled = stall2 >= STALL_LIMIT
        mu_small = mu < torch.maximum(eps * 1.0e3, knob(1.0e-9))
        new_status = torch.where(
            converged | (stalled & mu_small), final,
            torch.where(stalled, _SUBOPTIMAL, _RUNNING))
        return _Decision(mu, delta, primal_obj, dual_obj, rho, sigma,
                         new_status, mu_best2, stall2)

    def advance(s: HsdState, pre: _Decision, stepping, passes=None):
        """The step from s: the new (x, z, y, w, phi, psi, reg).  stepping:
        the lanes that step (None: all of them).  passes: the read-free
        form, a single factor at the sticky level and that many masked
        refinement passes a solve (kkt_factor's retry=False, kkt_solve's
        passes), which returns besides the steps the form with reads would
        take further: (a factor retry is due, a solve wants a pass
        more)."""
        x, z, y, w = s.x, s.z, s.y, s.w
        phi, psi = col(s.phi), col(s.psi)
        mu, delta, primal_obj, dual_obj, rho, sigma = pre[:6]
        D = z / x
        E = w / y
        fac = kkt_factor(A, E, D, epsdiag, factor_dtype=factor_dtype,
                         ub=ub, reg0=s.reg, active=stepping, cols=cols,
                         retry=passes is None)
        more = []

        def solve(ry, rx):
            out = kkt_solve(
                A, E, D, fac, ry, rx, epsdiag=epsdiag, refine_tol=refine_tol,
                max_refine=max_refine, compensated=compensated, ub=ub,
                active=stepping, cols=cols, passes=passes)
            if passes is None:
                return out
            more.append(out[2])
            return out[:2]

        def directions(dlt, so_x, so_y, so_phi, gy, gx, fy, fx):
            """Fold a (delta, second-order) Newton system through the
            shared f/g combination (hsd.c:230-238)."""
            cfx, cgx = nsum(ndot(c, fx), ndot(c, gx))
            dphi = ((cfx - dot(b, fy)
                     + (-(1.0 - dlt) * (dual_obj - primal_obj + psi)
                        + psi - dlt * mu / phi + so_phi / phi))
                    / (cgx - dot(b, gy) - psi / phi))
            dx = fx - gx * dphi
            dy = fy - gy * dphi
            dz = dlt * mu / x - z - D * dx - so_x / x
            dw = dlt * mu / y - w - E * dy - so_y / y
            dpsi = dlt * mu / phi - psi - (psi / phi) * dphi - so_phi / phi
            return dx, dy, dz, dw, dphi, dpsi

        def f_rhs(dlt, so_x, so_y):
            rho_rhs = -(1.0 - dlt) * rho + w - dlt * mu / y + so_y / y
            sigma_rhs = -(1.0 - dlt) * sigma + z - dlt * mu / x + so_x / x
            return rho_rhs, sigma_rhs

        zero_x = torch.zeros_like(x)
        zero_y = torch.zeros_like(y)
        zero_s = torch.zeros_like(phi)

        if corrector == "mehrotra" and not long_step:
            # predictor: affine f-system and the g-system in one
            # 2-column solve through the factor
            r_aff, s_aff = f_rhs(0.0, zero_x, zero_y)
            sy, sx = solve(torch.stack([r_aff, -b], dim=-1),
                           torch.stack([-s_aff, -c], dim=-1))
            fy, gy = sy[..., 0], sy[..., 1]
            fx, gx = sx[..., 0], sx[..., 1]
            dx_a, dy_a, dz_a, dw_a, dphi_a, dpsi_a = directions(
                0.0, zero_x, zero_y, zero_s, gy, gx, fy, fx)

            # full affine step to the boundary -> adaptive centering
            t_a = _max(*nmax(vmax(-dx_a / x), vmax(-dz_a / z)),
                       vmax(-dy_a / y), vmax(-dw_a / w),
                       -dphi_a / phi, -dpsi_a / psi)
            th_a = torch.where(t_a > 0.0, torch.minimum(1.0 / t_a, one),
                               one)
            mu_aff = (nsum(ndot(z + th_a * dz_a, x + th_a * dx_a))
                      + dot(w + th_a * dw_a, y + th_a * dy_a)
                      + (phi + th_a * dphi_a) * (psi + th_a * dpsi_a)
                      ) / (n + m + 1)
            sig = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)

            # corrector: second-order products (Mehrotra's
            # sigma*mu - dX_a dZ_a right-hand side)
            so_x, so_y = dx_a * dz_a, dy_a * dw_a
            so_phi = dphi_a * dpsi_a
            r_c, s_c = f_rhs(sig, so_x, so_y)
            cy, cx = solve(r_c.unsqueeze(-1), -s_c.unsqueeze(-1))
            dx, dy, dz, dw, dphi, dpsi = directions(
                sig, so_x, so_y, so_phi, gy, gx, cy[..., 0], cx[..., 0])
        else:
            rho_rhs, sigma_rhs = f_rhs(delta, zero_x, zero_y)
            sy, sx = solve(torch.stack([rho_rhs, -b], dim=-1),
                           torch.stack([-sigma_rhs, -c], dim=-1))
            fy, gy = sy[..., 0], sy[..., 1]
            fx, gx = sx[..., 0], sx[..., 1]
            dx, dy, dz, dw, dphi, dpsi = directions(
                delta, zero_x, zero_y, zero_s, gy, gx, fy, fx)

        if long_step:
            theta = torch.minimum(
                nmin(vmin(_hsd_linesearch(x, dx, z, dz, beta, delta, mu))),
                vmin(_hsd_linesearch(y, dy, w, dw, beta, delta, mu)))
            theta = torch.minimum(theta, _hsd_linesearch(
                phi, dphi, psi, dpsi, beta, delta, mu))
            theta = torch.minimum(theta, one)
            theta = torch.where(theta < 1.0, theta * 0.9999, theta)
        else:
            t = _max(*nmax(vmax(-dx / x), vmax(-dz / z)),
                     vmax(-dy / y), vmax(-dw / w),
                     -dphi / phi, -dpsi / psi)
            theta = torch.where(t > 0.0,
                                torch.minimum(step_factor / t, one), one)

        new = (x + theta * dx, z + theta * dz,
               y + theta * dy, w + theta * dw,
               phi + theta * dphi, psi + theta * dpsi,
               col(fac.reg.to(dtype)))
        if passes is None:
            return new
        return new, (fac.bad & (fac.reg < 1.0e-2), torch.stack(more).any())

    def unchanged(s: HsdState):
        """advance's tuple for a lane that does not step."""
        return (s.x, s.z, s.y, s.w, col(s.phi), col(s.psi), col(s.reg))

    def finish(s: HsdState, pre: _Decision, new) -> HsdState:
        """The next state from the step's (x, z, y, w, phi, psi, reg)."""
        x, z, y, w = s.x, s.z, s.y, s.w
        phi, psi = col(s.phi), col(s.psi)
        x2, z2, y2, w2, phi2, psi2, reg2 = new

        # numerical-failure guard: a step with any non-finite value keeps
        # the last finite iterate and stops SUBOPTIMAL (hsdls.c:151)
        fin = lambda t: torch.isfinite(t).all(dim=-1, keepdim=batched)
        ok = (torch.isfinite(phi2) & torch.isfinite(psi2)
              & nall(fin(x2) & fin(z2)) & fin(y2) & fin(w2))

        def pick(new, prev):
            return torch.where(ok, new, prev)

        return HsdState(pick(x2, x), pick(z2, z), pick(y2, y),
                        pick(w2, w), *(row(t) for t in (
                            pick(phi2, phi), pick(psi2, psi), col(s.iter) + 1,
                            torch.where(ok, pre.new_status, _SUBOPTIMAL),
                            reg2, pre.mu_best, pre.stall)))

    def body(s: HsdState, live=None, pre=None, step=None) -> HsdState:
        pre = decide(s) if pre is None else pre

        if trace:
            phi = col(s.phi)
            _trace_row(s.iter, pre.primal_obj / phi + f,
                       torch.sqrt(dot(pre.rho, pre.rho)) / phi,
                       pre.dual_obj / phi + f,
                       torch.sqrt(nsum(ndot(pre.sigma, pre.sigma))) / phi,
                       pre.mu)

        # the lanes whose step is kept: live and still undecided (all of
        # them, when the caller has read that a single LP steps)
        known = bool(step) and not batched
        stepping = None if known else row(pre.new_status == _RUNNING)
        if live is not None:
            stepping = stepping & live

        if step is False:
            new = unchanged(s)
        elif known:
            new = advance(s, pre, stepping)
        else:
            go = col(stepping)
            new = tuple(torch.where(go, a, b) for a, b in
                        zip(advance(s, pre, stepping), unchanged(s)))
        out = finish(s, pre, new)
        return out if live is None else where_lanes(live, out, s)

    def speculate(s: HsdState, max_iter: int, pause, passes: int):
        """One iteration of a single LP that reads nothing on the host (the
        body of the CUDA graph _hsd_loop replays): the loop's live test,
        the step in advance's read-free form, kept only where the LP steps
        as body keeps it, and the flags [live, retry, refine, live next]:
        retry where the LP steps and its factor failed below the last
        Tikhonov level (body would refactor at next_reg of it), refine
        where it steps and a solve wanted a refinement pass more, live
        next the loop's live test on the new state.  The new state is
        body(s, None, decide(s), step) bit for bit where neither retry
        nor refine is set."""
        pre = decide(s)
        live = (s.status == _RUNNING) & (s.iter < max_iter) & (pre.mu > pause)
        stepping = live & (pre.new_status == _RUNNING)
        new, (retry, refine) = advance(s, pre, None, passes)
        out = finish(s, pre, tuple(torch.where(stepping, a, b) for a, b in
                                   zip(new, unchanged(s))))
        live_next = ((out.status == _RUNNING) & (out.iter < max_iter)
                     & (_mu(out, n + m + 1) > pause))
        return out, torch.stack([live, stepping & retry, stepping & refine,
                                 live_next])

    body.decide = decide
    body.speculate = speculate
    return body


def _mu(s: HsdState, n_total: int, nsum=local):
    return (nsum(_dot(s.z, s.x)) + _dot(s.w, s.y) + s.phi * s.psi) / n_total


def past_deadline(deadline: float, like, cols=None) -> bool:
    """Whether the time.monotonic() `deadline` has passed.  Under column
    shards the ranks agree, in one all-reduce on like's device: it has
    passed on all of them once it has on any, so they stop together."""
    late = time.monotonic() > deadline
    if cols is None:
        return late
    flag = cols.any(torch.tensor(late, device=like.device))
    return bool(host_read("deadline", flag.item))


# A single LP's iteration replays as a CUDA graph, cached by operand
# layout and knobs (_iteration).  REFINE_PASSES: the refinement passes a
# solve makes in each graph of an iteration, tried in turn while a solve
# asks for a pass more, then the eager body.  Two graphs, because a pass
# costs more than the iterations that need it save: on a PILOT87-sized LP
# on an H100, a pass is 1.6 ms of an f32 replay's 5.7 ms and 2.1 ms of an
# f64 one's 8.0, and about one iteration in six asks for one (PERF.md).
# GRAPH_CACHE: how many layouts keep their graphs, the least recently
# used dropped first.
REFINE_PASSES = (0, 1)
GRAPH_CACHE = 4
_GRAPHS: OrderedDict = OrderedDict()


class _Iteration(NamedTuple):
    """A captured iteration: the static operands (A, b, c and the tail's
    idx2, w2) and state that the graphs read, make_step's body on them,
    and a replay() -> (the new state, the flags of body.speculate) for
    each entry of REFINE_PASSES."""
    operands: tuple
    state: HsdState
    body: object
    replays: tuple


def _graph_engages(A, cols, compensated, trace, on_iter) -> bool:
    """Whether _hsd_loop replays a graph an iteration: one LP (a 2-D A) on
    a CUDA device, on the plain path (no column shards, no compensated
    sums, no trace rows, no per-iteration callback)."""
    return (A.device.type == "cuda" and A.dim() == 2 and cols is None
            and not compensated and not trace and on_iter is None)


def _iteration(A, b, c, ub, init: HsdState, max_iter: int, pause_mu: float,
               knobs: dict) -> _Iteration:
    """The cached graphs of one iteration on operands of this layout with
    these knobs, their static operands and state loaded with (A, b, c,
    ub) and init; captured (each counted as hsd.graph.captures) on a
    miss."""
    args = (A, b, c) + (() if ub is None else tuple(ub))
    key = (tuple((t.shape, t.dtype, t.device) for t in args + tuple(init)),
           max_iter, pause_mu, tuple(sorted(knobs.items())))
    it = _GRAPHS.pop(key, None)
    if it is None:
        operands = tuple(t.clone() for t in args)
        state = HsdState(*(t.clone() for t in init))
        sA, sb, sc, *tail = operands
        body = make_step(sA, sb, sc, ub=UbTail(*tail) if tail else None,
                         **knobs)
        pause = torch.full((), pause_mu, dtype=A.dtype, device=A.device)
        replays = []
        for passes in REFINE_PASSES:
            count("hsd.graph.captures")
            replays.append(capture(body.speculate, state, max_iter, pause,
                                   passes, device=A.device))
        it = _Iteration(operands, state, body, tuple(replays))
    else:
        copy_into(it.operands, args)
        copy_into(it.state, init)
    _GRAPHS[key] = it
    while len(_GRAPHS) > GRAPH_CACHE:
        _GRAPHS.popitem(last=False)
    return it


def _replayed(it: _Iteration, factor_dtype):
    """One iteration of a single LP from it.state by its graphs, as the
    eager body takes it: the first graph's replay, again from the next
    Tikhonov level while a factor retry is due (hsd.graph.retries), the
    next graph while a solve asks for a refinement pass more, and the
    eager body after the last (hsd.graph.redos).  Every replay that runs
    a live iteration counts as hsd.graph.replays and reads its flags once
    (host_read site hsd.graph).  Returns (the new state, or None where the
    loop's live test fails; the live test on the new state, or True where
    it is not known)."""
    state = it.state
    for replay in it.replays:
        retry = True
        while retry:
            out, flags = replay()
            live, retry, refine, live_next = host_read("hsd.graph",
                                                       flags.tolist)
            if not live:
                return None, False
            count("hsd.graph.replays")
            if retry:
                # kkt_factor's escalation, a level a replay: the tries
                # that failed leave nothing behind but the level
                count("hsd.graph.retries")
                state.reg.copy_(next_reg(state.reg.to(factor_dtype)))
        if not refine:
            return out, live_next
    count("hsd.graph.redos")
    return it.body(state, None, it.body.decide(state), True), True


def _hsd_loop(A, b, c, f, init: HsdState, *,
              max_iter, eps, step_factor, beta, epsdiag, refine_tol,
              pause_mu,
              gap_tol=1.0e-6,
              feas_tol=1.0e-6,
              long_step: bool = False,
              max_refine: int = 8,
              trace: bool = False,
              factor_dtype=None,
              compensated: bool = False,
              corrector: str = "mehrotra",
              ub: UbTail | None = None,
              deadline: float | None = None,
              on_iter=None,
              cols=None):
    """Run from `init` until the status is decided, max_iter is reached,
    mu falls to `pause_mu` (a stage boundary; 0.0 = run to convergence) or
    the time.monotonic() `deadline` passes (checked after each iteration;
    under cols, on any rank: past_deadline).  on_iter(state), if given,
    sees the state before each step.  cols: the column shards of A, c and
    the state's x and z (make_step).

    Each lane stops on its own; the loop runs while any lane runs.  One
    LP on a CUDA device (_graph_engages) takes each iteration from cached
    CUDA graphs of body.speculate, replayed as _replayed says, so every
    iterate is the eager loop's.
    Returns (state, paused): the state NOT de-homogenized, and whether
    every lane stopped because mu reached pause_mu with its solve still
    running.
    """
    knobs = dict(eps=eps, step_factor=step_factor, beta=beta,
                 epsdiag=epsdiag, refine_tol=refine_tol, gap_tol=gap_tol,
                 feas_tol=feas_tol, long_step=long_step,
                 max_refine=max_refine, factor_dtype=factor_dtype,
                 corrector=corrector)
    it = None
    if _graph_engages(A, cols, compensated, trace, on_iter):
        # f enters only the trace rows, which the graph path never prints
        it = _iteration(A, b, c, ub, init, max_iter, pause_mu, knobs)
        body, state = it.body, it.state
    else:
        body = make_step(A, b, c, trace=trace, f=f, compensated=compensated,
                         ub=ub, cols=cols, **knobs)
        state = init
    m, n = A.shape[-2:]
    if ub is not None:
        m = m + ub.idx2.shape[-1]
    if cols is not None:
        n = cols.n
    pause = torch.full((), pause_mu, dtype=A.dtype, device=A.device)
    while True:
        if it is not None:
            out, live_next = _replayed(it, factor_dtype or A.dtype)
            if out is None:
                break
            copy_into(state, out)
        else:
            # the stop test of this iteration goes into the loop's one
            # read: whether any lane is live, and whether any live lane
            # steps
            pre = body.decide(state)
            live = ((state.status == _RUNNING) & (state.iter < max_iter)
                    & (pre.mu.reshape(state.status.shape) > pause))
            stepping = live & (pre.new_status == _RUNNING).reshape(
                live.shape)
            any_live, any_step = host_read(
                "hsd.loop", torch.stack([live.any(), stepping.any()]).tolist)
            if not any_live:
                break
            if on_iter is not None:
                on_iter(state)
            # a single LP steps only when live: no lanes to keep
            state = body(state, live if live.dim() else None, pre, any_step)
        if deadline is not None and past_deadline(deadline, A, cols):
            break
        if it is not None and not live_next:
            # the next iteration's live test fails (the graph ran it on
            # the state it returned): stop as the eager loop would
            break
    if it is not None:
        # the static state is the graph's: hand the caller its own copy
        state = HsdState(*(t.clone() for t in state))
    mu = _mu(state, n + m + 1, local if cols is None else cols.sum)
    paused = bool(host_read("hsd.pause", (
        (state.status == _RUNNING) & (state.iter < max_iter)
        & (mu <= pause)).all().item))
    return state, paused


def finish_state(state: HsdState, max_iter):
    """Status plus the de-homogenized (x, y, w, z) (hsd.c:277-284)."""
    status = torch.where(
        (state.status == _RUNNING) & (state.iter >= max_iter),
        int(Status.ITERATION_LIMIT), state.status)
    phi = state.phi.unsqueeze(-1)
    return (status, state.x / phi, state.y / phi, state.w / phi,
            state.z / phi, state.iter)


def solve_canon(A, b, c, f, *,
                max_iter: int = DEFAULT_MAX_ITER,
                eps: float = 1.0e-12,
                step_factor: float = 0.95,
                long_step: bool = False,
                beta: float = 0.80,
                epsdiag: float = 1.0e-14,
                refine_tol: float = 1.0e-10,
                gap_tol: float = 1.0e-6,
                feas_tol: float = 1.0e-6,
                max_refine: int = 8,
                trace: bool = False,
                factor_dtype=None,
                pause_mu: float = 0.0,
                compensated: bool = False,
                corrector: str = "mehrotra",
                ub: UbTail | None = None,
                init: HsdState | None = None,
                on_iter=None):
    """Solve max c'x, Ax <= b, x >= 0 via the HSD embedding.

    ub: implicit singleton tail rows (A holds only the head rows; b spans
    head + tail).  factor_dtype: None = A's dtype, torch.float32 = f32
    factor with data-precision refinement.  pause_mu > 0 pauses once
    mu <= pause_mu (status stays RUNNING); resume with `init=`.
    on_iter(state) sees the state before each step.

    Returns (status, x, y, w, z, iterations, state); x, y, w, z
    de-homogenized.
    """
    if init is None:
        init = init_state(A, extra_rows=0 if ub is None else ub.idx2.shape[0])
    out, _ = _hsd_loop(A, b, c, f, init,
                       max_iter=max_iter, eps=eps, step_factor=step_factor,
                       beta=beta, epsdiag=epsdiag, refine_tol=refine_tol,
                       gap_tol=gap_tol, feas_tol=feas_tol,
                       pause_mu=pause_mu, long_step=long_step,
                       max_refine=max_refine, trace=trace,
                       factor_dtype=factor_dtype, compensated=compensated,
                       corrector=corrector, ub=ub, on_iter=on_iter)
    status, x, y, w, z, iters = finish_state(out, max_iter)
    return status, x, y, w, z, iters, out


METRICS = ("mu", "primal_obj", "dual_obj", "primal_infeas", "dual_infeas")


def solve_canon_metrics(A, b, c, f, *, ub: UbTail | None = None, **kw):
    """solve_canon (same keywords) plus one metrics row per iteration (the
    structured counterpart of the reference's trace, hsd.c:206-209),
    computed from the state before the step as vanderbei_tpu's
    _hsd_scan_metrics does.  The loop stops at the decided status instead
    of scanning no-op iterations to max_iter, so every row is a valid one.

    Returns ((status, x, y, w, z, iterations, state), rows), rows a dict
    of (iterations,) float64 numpy arrays keyed by METRICS.
    """
    n_total = sum(A.shape) + 1 + (0 if ub is None else ub.idx2.shape[0])
    rows = []

    def record(s: HsdState):
        if ub is None:
            ax, aty = A @ s.x, A.mT @ s.y
        else:
            ax, aty = tail_matvec(A, ub, s.x), tail_rmatvec(A, ub, s.y)
        rho = ax - b * s.phi + s.w
        sigma = -aty + c * s.phi + s.z
        rows.append(torch.stack([
            _mu(s, n_total),
            (c @ s.x) / s.phi + f,
            (b @ s.y) / s.phi + f,
            torch.sqrt(rho @ rho) / s.phi,
            torch.sqrt(sigma @ sigma) / s.phi]))

    out = solve_canon(A, b, c, f, ub=ub, on_iter=record, **kw)
    table = (torch.stack(rows).to(torch.float64).cpu().numpy() if rows
             else np.zeros((0, len(METRICS))))
    return out, {k: table[:, i] for i, k in enumerate(METRICS)}
