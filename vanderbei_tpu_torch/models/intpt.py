"""Path-following primal-dual interior-point method on torch tensors, the
port of vanderbei_tpu/models/intpt.py.

The reference's ipo METHOD=intpt (src/ipo/intpt.c:33-261): max c'x - x'Qx/2
s.t. Ax + w = b, x, w, y, z > 0; fixed centering delta = 0.02, step factor
0.9, divergence-based infeasibility detection, EPS = 1e-6, MAX_ITER = 200.
A PSD Q (the QUADS extension) enters the stationarity residual and the
dual-form KKT system.

Batch-first like models/hsd.py: A (..., m, n) with per-lane state, the
single LP the case with no leading dims.  The loop runs on the host and
reads one pair of flags per iteration (some lane live, some live lane
undecided: the stop test runs before the read); every lane steps and
keeps the step only where it is live and undecided.  The ratio test, the
stop test, the divergence certificate and the finite-iterate guard stay
per-lane tensor arithmetic.  The solve can pause at a duality-gap
threshold and resume from the state, which is how the f32 -> f64 ladder
and the checkpoints work.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..core.status import Status
from ..ops.kkt import dot as _dot, kkt_factor, kkt_solve, mv, where_lanes
from ..utils.profiling import host_read

DEFAULT_MAX_ITER = 200      # intpt.c:31

_RUNNING = int(Status.RUNNING)

INTPT_BANNER = (
    "------------------------------------------------------------------\n"
    "         |           Primal          |            Dual           |\n"
    "  Iter   |  Obj Value       Infeas   |  Obj Value       Infeas   |\n"
    "- - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - - ")


def _trace_row(it, pobj, normr, dobj, norms):
    """Host-side printer for one iteration row (intpt.c:163-164 format)."""
    print(f"{int(it):8d}   {float(pobj):14.7e}  {float(normr):8.1e}    "
          f"{float(dobj):14.7e}  {float(norms):8.1e} ", flush=True)


class IntptState(NamedTuple):
    """Solver state; field names match vanderbei_tpu.models.intpt's (and so
    the npz checkpoints).  Vectors are (..., dim), the scalars (...,), one
    per lane; iter and status are int64."""
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    normr0: torch.Tensor    # previous iteration's residual norms, for the
    norms0: torch.Tensor    # divergence certificate
    reg: torch.Tensor       # sticky Tikhonov level of the KKT factor


def init_state(A) -> IntptState:
    """1000-start (intpt.c:98-106) for A (..., m, n)."""
    *lead, m, n = A.shape
    kw = dict(dtype=A.dtype, device=A.device)
    inf = torch.full(lead, float("inf"), **kw)
    i64 = lambda v: torch.full(lead, v, dtype=torch.int64, device=A.device)
    return IntptState(torch.full((*lead, n), 1000.0, **kw),
                      torch.full((*lead, n), 1000.0, **kw),
                      torch.full((*lead, m), 1000.0, **kw),
                      torch.full((*lead, m), 1000.0, **kw),
                      i64(0), i64(_RUNNING), inf, inf.clone(),
                      torch.zeros(lead, **kw))


def cast_state(state: IntptState, dtype) -> IntptState:
    """Move a paused state between precision stages; the sticky factor
    regularization resets (it is calibrated to the old precision)."""
    return IntptState(
        *(leaf.to(dtype) for leaf in state[:4]),
        state.iter, state.status,
        state.normr0.to(dtype), state.norms0.to(dtype),
        torch.zeros_like(state.reg, dtype=dtype))


def _ratio_step(x, dx, z, dz, y, dy, w, dw, r):
    """theta = min(r / max_i(-d/v), 1) over all four vectors of each lane
    (intpt.c:211-220), as (..., 1)."""
    vmax = lambda t: t.amax(dim=-1, keepdim=True)
    t = torch.maximum(vmax(-dx / x), vmax(-dz / z))
    t = torch.maximum(t, vmax(-dy / y))
    t = torch.maximum(t, vmax(-dw / w))
    return torch.where(t > 0.0, torch.clamp_max(r / t, 1.0),
                       torch.ones_like(t))


def _gap(s: IntptState):
    return _dot(s.z, s.x) + _dot(s.y, s.w)


def _intpt_loop(A, b, c, f, Q, init: IntptState, *,
                max_iter, eps, delta, step_factor, epsdiag, refine_tol,
                pause_gap, div_detect, gap_floor=1.0,
                max_refine: int = 8,
                trace: bool = False,
                factor_dtype=None,
                deadline: float | None = None):
    """Run from `init` until the status is decided, max_iter is reached,
    the duality gap falls to `pause_gap` (a stage boundary; 0.0 = run to
    the end) or the time.monotonic() `deadline` passes (checked after each
    iteration).  Q is None for an LP.

    Returns (state, paused): paused means the loop stopped at the gap
    boundary with the solve still running.
    """
    m, n = A.shape[-2:]
    dtype, dev = A.dtype, A.device
    knob = lambda v: torch.full((), v, dtype=dtype, device=dev)
    eps, delta, r = knob(eps), knob(delta), knob(step_factor)
    gap_floor, pause = knob(gap_floor), knob(pause_gap)
    # with lanes, every per-lane scalar is kept as (..., 1), so that it
    # broadcasts against the lane's vectors; a single LP keeps 0-d scalars
    batched = A.dim() > 2
    col = (lambda t: t.unsqueeze(-1)) if batched else (lambda t: t)
    row = (lambda t: t.squeeze(-1)) if batched else (lambda t: t)
    dot = lambda a, b: col(_dot(a, b))
    norm_b = torch.sqrt(dot(b, b))
    norm_c = torch.sqrt(dot(c, c))

    def decide(s: IntptState):
        """The residuals and the stop test of s."""
        x, z, y, w = s.x, s.z, s.y, s.w
        rho = b - mv(A, x) - w               # primal infeasibility
        normr = torch.sqrt(dot(rho, rho))
        sigma = c - mv(A.mT, y) + z          # dual infeasibility
        if Q is not None:
            sigma = sigma - mv(Q, x)         # QP stationarity: c-Qx-A'y+z
        norms = torch.sqrt(dot(sigma, sigma))
        gamma = dot(z, x) + dot(y, w)        # duality gap
        # residuals relative to ||b||, ||c|| and the gap relative to the
        # objective's magnitude, floored at gap_floor (the reference tests
        # them absolutely, intpt.c:152-158; see vanderbei_tpu's intpt)
        optimal = ((normr < eps * (1.0 + norm_b))
                   & (norms < eps * (1.0 + norm_c))
                   & (gamma <= eps * torch.maximum(gap_floor,
                                                   torch.abs(dot(c, x)))))
        # the divergence certificate the reference marks "(unreliable)"
        # (intpt.c:175-182), only while the residual is above tolerance,
        # and not at all in the f32 sprint (div_detect off)
        p_infeas = ((normr > 10.0 * col(s.normr0)) & (normr > eps)
                    & div_detect)
        d_infeas = ((norms > 10.0 * col(s.norms0)) & (norms > eps)
                    & div_detect)
        new_status = torch.where(
            optimal, int(Status.OPTIMAL),
            torch.where(p_infeas, int(Status.PRIMAL_INFEASIBLE),
                        torch.where(d_infeas, int(Status.DUAL_INFEASIBLE),
                                    _RUNNING)))
        return rho, normr, sigma, norms, gamma, new_status

    def body(s: IntptState, live, pre, step) -> IntptState:
        """One iteration from the decision pre = decide(s); every lane
        steps unless step is False, the lanes live and undecided keep it."""
        x, z, y, w = s.x, s.z, s.y, s.w
        rho, normr, sigma, norms, gamma, new_status = pre
        if trace:
            pobj = dot(c, x) + f
            if Q is not None:
                pobj = pobj - 0.5 * dot(x, mv(Q, x))
            _trace_row(s.iter, pobj, normr, dot(b, y) + f, norms)

        # the lanes whose step is kept: live and still undecided (all of
        # them, when the caller has read that a single LP steps)
        known = step and not batched
        stepping = None if known else row(new_status == _RUNNING)
        if live is not None:
            stepping = stepping & live
        x2, z2, y2, w2, reg2 = x, z, y, w, s.reg
        if step:
            mu = delta * gamma / (n + m)
            D = z / x
            E = w / y
            L = kkt_factor(A, E, D, epsdiag, Q=Q, factor_dtype=factor_dtype,
                           reg0=s.reg, active=stepping)
            rhs_x = sigma - z + mu / x
            rhs_y = rho + w - mu / y
            dy, dx = kkt_solve(A, E, D, L, rhs_y, rhs_x, Q=Q,
                               epsdiag=epsdiag, refine_tol=refine_tol,
                               max_refine=max_refine, active=stepping)
            dz = mu / x - z - D * dx
            dw = mu / y - w - E * dy
            theta = _ratio_step(x, dx, z, dz, y, dy, w, dw, r)
            if known:
                theta = theta.squeeze(-1)
                x2, z2 = x + theta * dx, z + theta * dz
                y2, w2 = y + theta * dy, w + theta * dw
                reg2 = L.reg.to(dtype)
            else:
                go = col(stepping)
                x2, z2, y2, w2 = (torch.where(go, v + theta * dv, v)
                                  for v, dv in ((x, dx), (z, dz), (y, dy),
                                                (w, dw)))
                reg2 = torch.where(stepping, L.reg.to(dtype), s.reg)

        # numerical-failure guard: keep the last finite iterate and stop
        # SUBOPTIMAL rather than carry NaN into the verdict
        fin = lambda t: torch.isfinite(t).all(dim=-1, keepdim=batched)
        ok = fin(x2) & fin(z2) & fin(y2) & fin(w2)

        def pick(new, old):
            return torch.where(ok, new, old)

        out = IntptState(
            pick(x2, x), pick(z2, z), pick(y2, y), pick(w2, w), s.iter + 1,
            row(torch.where(ok, new_status, int(Status.SUBOPTIMAL))),
            row(normr), row(norms), reg2)
        return out if live is None else where_lanes(live, out, s)

    state = init
    while True:
        # the stop test of this iteration goes into the loop's one read:
        # whether any lane is live, and whether any live lane steps
        pre = decide(state)
        live = ((state.status == _RUNNING) & (state.iter < max_iter)
                & (_gap(state) > pause))
        stepping = live & (pre[-1] == _RUNNING).reshape(live.shape)
        any_live, any_step = host_read(
            "intpt.loop", torch.stack([live.any(), stepping.any()]).tolist)
        if not any_live:
            break
        # a single LP steps only when live: no lanes to keep
        state = body(state, live if live.dim() else None, pre, any_step)
        if deadline is not None and time.monotonic() > deadline:
            break
    paused = bool(host_read("intpt.pause", (
        (state.status == _RUNNING) & (state.iter < max_iter)
        & (_gap(state) <= pause)).all().item))
    return state, paused


def finish_state(state: IntptState, max_iter):
    status = torch.where(
        (state.status == _RUNNING) & (state.iter >= max_iter),
        int(Status.ITERATION_LIMIT), state.status)
    return status, state.x, state.y, state.w, state.z, state.iter


def solve_canon(A, b, c, f, *,
                Q=None,
                max_iter: int = DEFAULT_MAX_ITER,
                eps: float = 1.0e-6,
                delta: float = 0.02,
                step_factor: float = 0.9,
                epsdiag: float = 1.0e-14,
                refine_tol: float = 1.0e-10,
                max_refine: int = 8,
                trace: bool = False,
                factor_dtype=None,
                pause_gap: float = 0.0,
                div_detect: bool = True,
                gap_floor: float = 1.0,
                init: IntptState | None = None):
    """Solve max c'x - x'Qx/2, Ax <= b, x >= 0 (dense canonical); Q=None is
    the pure LP.  pause_gap > 0 pauses once the duality gap is <= pause_gap
    (status stays RUNNING); resume with `init=`.

    Returns (status, x, y, w, z, iterations, state).
    """
    if init is None:
        init = init_state(A)
    out, _ = _intpt_loop(A, b, c, f, Q, init,
                         max_iter=max_iter, eps=eps, delta=delta,
                         step_factor=step_factor, epsdiag=epsdiag,
                         refine_tol=refine_tol, pause_gap=pause_gap,
                         div_detect=div_detect, gap_floor=gap_floor,
                         max_refine=max_refine, trace=trace,
                         factor_dtype=factor_dtype)
    status, x, y, w, z, iters = finish_state(out, max_iter)
    return status, x, y, w, z, iters, out
