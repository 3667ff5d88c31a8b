"""Dense reduced-KKT engine on torch tensors, the port of
vanderbei_tpu/ops/kkt.py.

The quasi-definite augmented system K = [[-E, A], [A', D]] (reference
ldlt.c:189-200) is reduced to SPD normal equations and Cholesky-factored:

    primal form (m <= n):  (E + A D^-1 A') dy = A D^-1 rx - ry
                           dx = D^-1 (rx - A' dy)
    dual   form (m >  n):  (D + Q + A' E^-1 A) dx = rx + A' E^-1 ry
                           dy = E^-1 (A dx - ry)

The normal matrix is Jacobi-scaled to unit diagonal, factored with a
Tikhonov retry that escalates while the factor fails (the reference's
epsdiag escalation, ldlt.c:293-306), and solves are refined against the
unclamped E, D until the residual stops halving, reverting a last
correction that made it worse (ldlt.c:411-416).

Batch-first: every operand may carry leading dims, A (..., m, n) with
E (..., m), D (..., n), one LP per lane (a stacked size class).  The
retry and the refinement decide per lane, as the JAX package's while_loops
do under vmap: the retry refactors only the lanes whose factor failed, the
refinement updates only the lanes still refining.  A lane outside the
`active` mask (a lane whose step the caller discards) drives neither loop.
The single-LP path is the case with no leading dims.

Every f32 normal matrix is formed by ops/syrk.scaled_syrk, the hand-written
Hopper kernel on a CUDA tensor, in one launch for the whole batch.  The
f64 product, the Cholesky factor (cholesky_ex, whose `info` joins the
NaN/Inf scan), the triangular solves and the matvecs stay torch.matmul /
torch.linalg.  Each factor retry and each refinement pass reads one flag
on the host; with retry=False (kkt_factor) or a fixed number of passes
(kkt_solve) they read nothing and report instead, on the device, what a
read would have found (models/hsd.py's CUDA-graph iteration).  The
recorder's spans (utils/profiling.py): `normal_matrix` around the
assembly, `factor` around its scaling and the Cholesky with its retries,
`kkt_solve` around a refined solve.

Column shards (cols, a parallel/distributed.ColumnShards): A and every
n-vector hold only this rank's columns, m-vectors are whole on every rank,
and each reduction over the column dim goes through the "model" group: the
normal matrix is the all-reduced sum of the ranks' partial products
(normal_matrix), a row-space product A @ v is a
partial sum completed by an all-reduce, A' @ y stays local, and the
refinement's residual maxima are all-reduced (MAX); a compensated ("dd")
residual's A @ v is left unrounded on each rank and completed by
ColumnShards.sum2, which keeps the cancellation between the ranks.  The
UbTail is the rank's own (ColumnShards.tail): tail rows of columns it does
not own weigh 0, so a gather from the columns into the tail rows is a
partial sum too.  Every flag the host reads (factor retry, refinement) is
one the group agrees on.  Only the primal form decomposes over column
shards: with cols, a system the dual form would take (m > n, or a Q)
raises ValueError.
cols=None is the single-device path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import host_read, span, spanned
from .quad import DD, matvec2, matvec2_dd
from .syrk import scaled_syrk


def use_primal_form(m: int, n: int, has_q: bool) -> bool:
    return (m <= n) and not has_q


def mv(A, x):
    """A @ x for x a vector (..., n) or a stack of columns (..., n, k)."""
    if x.dim() == 1 or x.dim() == A.dim():
        return A @ x
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def dot(a, b):
    """Inner product along the last dim, one per lane (torch.dot, one
    kernel, on a single vector)."""
    return torch.dot(a, b) if a.dim() == 1 else torch.linalg.vecdot(a, b)


def lanes(mask, like):
    """A per-lane mask (...) shaped to broadcast against `like`."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def local(*parts):
    """The reduction over the column dim of an unsharded operand: none;
    returns its argument (several: the tuple)."""
    return parts[0] if len(parts) == 1 else parts


def where_lanes(mask, new, old):
    """Per-lane select of two solver states (NamedTuples of tensors)."""
    return type(new)(*(torch.where(lanes(mask, a), a, b)
                       for a, b in zip(new, old)))


class UbTail(NamedTuple):
    """Canonical tail rows that are singleton upper-bound rows
    (w2[i] * x[idx2[i]] <= b2[i]) or padding (w2[i] = 0).  Their block of
    the normal equations is diagonal, so the factor Schur-eliminates them
    and only the m1 x m1 head is factored (see vanderbei_tpu.ops.kkt)."""
    idx2: torch.Tensor   # (..., k) int64 column index per tail row
    w2: torch.Tensor     # (..., k) coefficient per tail row (0 = padding)


def _take(v, idx):
    """v's entries (rows, for a stack v (..., n, k)) at idx (..., K)."""
    if idx.dim() == 1:
        return v[idx]
    if v.dim() == idx.dim():
        return torch.gather(v, -1, idx)
    return torch.gather(v, -2, idx.unsqueeze(-1).expand(*idx.shape,
                                                         v.shape[-1]))


def _add_at(v, idx, src):
    """v with src added at idx (rows, for a stack), duplicates summed."""
    if idx.dim() == 1:
        return v.index_add(0, idx, src)
    if v.dim() == idx.dim():
        return v.scatter_add(-1, idx, src)
    return v.scatter_add(-2, idx.unsqueeze(-1).expand_as(src), src)


def _w2(ub: UbTail, v, stack: bool):
    return ub.w2.unsqueeze(-1) if stack else ub.w2


def tail_matvec(A1, ub: UbTail, x, mv=mv):
    """[A1; S] @ x where S are the ub/padding tail rows; x is (..., n) or
    (..., n, k).  mv(M, v) forms the head product (quad.matvec2 in
    compensated mode; where it returns an unrounded quad.DD, so does
    this: the tail's single products, exact, carry a zero lo word)."""
    stack = x.dim() == A1.dim()
    dim = -2 if stack else -1
    head = mv(A1, x)
    tail = _w2(ub, x, stack) * _take(x, ub.idx2)
    if isinstance(head, DD):
        return DD(torch.cat([head.hi, tail], dim=dim),
                  torch.cat([head.lo, torch.zeros_like(tail)], dim=dim))
    return torch.cat([head, tail], dim=dim)


def tail_rmatvec(A1, ub: UbTail, y, mv=mv):
    """[A1; S]' @ y.  Duplicate indices sum (padding rows all point at
    column 0 with weight 0)."""
    m1 = A1.shape[-2]
    stack = y.dim() == A1.dim()
    head, tail = ((y[..., :m1, :], y[..., m1:, :]) if stack
                  else (y[..., :m1], y[..., m1:]))
    return _add_at(mv(A1.mT, head), ub.idx2, _w2(ub, y, stack) * tail)


class KKTFactor(NamedTuple):
    """Lower Cholesky factor L of Ms = S M S, S = diag(s) = diag(M)^-1/2.

    L may be lower precision than the data; solves cast through L.dtype
    and refinement recovers the rest.  g2 is the Schur-eliminated tail
    diagonal (UbTail path), reg the Tikhonov level each lane's factor
    ended at, bad the lanes whose factor failed there."""
    L: torch.Tensor
    s: torch.Tensor
    g2: torch.Tensor = None
    reg: torch.Tensor = None
    bad: torch.Tensor = None


def _cholesky(Mr):
    """(L, bad): bad per matrix, a failed factor or a non-finite L."""
    L, info = torch.linalg.cholesky_ex(Mr)
    bad = (info != 0) | ~torch.isfinite(L).flatten(-2).all(dim=-1)
    return L, bad


@spanned("normal_matrix")
def normal_matrix(A, Ec, Dc, f32_path: bool, Q=None, dinv=None, cols=None):
    """The reduced normal matrix from the clamped Ec, Dc: the primal form's
    E + A diag(dinv) A' (dinv = 1/Dc unless given, as the UbTail head's
    reduced column weights are) or the dual form's D + Q + A' E^-1 A.
    f32_path forms it with scaled_syrk in float32, else with torch.matmul
    in A's dtype.

    Under column shards (the primal form only) each rank forms its partial
    product with e = 0, the group sums them, and diag(E) is added once
    after the sum."""
    m, n = A.shape[-2:]
    # a shard's own width does not choose the form: kkt_factor checked
    # the global one
    primal = cols is not None or use_primal_form(m, n, Q is not None)
    f32 = torch.float32
    diag = torch.diag_embed
    Ep = Ec if cols is None else torch.zeros_like(Ec)
    if dinv is not None:
        if f32_path:
            M = scaled_syrk(A.to(f32), dinv.to(f32), Ep.to(f32))
        else:
            M = (A * dinv.unsqueeze(-2)) @ A.mT + diag(Ep)
    elif f32_path:
        if primal:
            M = scaled_syrk(A.to(f32), (1.0 / Dc).to(f32), Ep.to(f32))
        else:
            # A' as a strided view: the kernel reads it in place
            M = scaled_syrk(A.mT.to(f32), (1.0 / Ec).to(f32), Dc.to(f32))
            if Q is not None:
                M = M + Q.to(M.dtype)
    elif primal:
        M = (A / Dc.unsqueeze(-2)) @ A.mT
        M = M + diag(Ep)
    else:
        M = (A.mT / Ec.unsqueeze(-2)) @ A
        M = M + diag(Dc)
        if Q is not None:
            M = M + Q
    if cols is not None:
        M = cols.sum(M) + diag(Ec.to(M.dtype))
    return M


def next_reg(reg):
    """The Tikhonov level a failed factor retries at, in the factor's
    precision (reg's dtype): the floor after 0, then 100 times the last."""
    floor = 1.0e-14 if reg.dtype == torch.float64 else 1.0e-7
    return torch.where(reg == 0.0, torch.full_like(reg, floor), reg * 100.0)


def kkt_factor(A, E, D, epsdiag, Q=None, factor_dtype=None,
               ub: UbTail | None = None, reg0=None, active=None,
               cols=None, retry: bool = True) -> KKTFactor:
    """Cholesky-factor the reduced normal-equations matrix.

    E, D are clamped below by epsdiag (ldlt.c:235-236).  reg0 (one level
    per lane) seeds the Tikhonov escalation with the level the previous
    iteration's factor needed (sticky, like the reference's epsdiag).
    active: a per-lane mask; lanes outside it do not retry.  cols: column
    shards (module docstring); the primal form only.  retry=False factors
    once at reg0 and reads nothing: where the factor is `bad` and its
    level below 1e-2, the escalation would have refactored at
    next_reg(level), and a factor from that level is the one it gives."""
    m, n = A.shape[-2:]
    nsum, nany = (local, local) if cols is None else (cols.sum, cols.any)
    if cols is not None and (Q is not None or not use_primal_form(
            m, cols.n, False)):
        raise ValueError(f"column shards need the primal form: m={m}, "
                         f"n={cols.n}, Q given: {Q is not None}")
    Ec = E.clamp_min(epsdiag)        # clamp_min propagates NaN, as
    Dc = D.clamp_min(epsdiag)        # jnp.maximum does
    g2 = None
    if ub is not None:
        # Schur-eliminate the singleton ub tail: factor only the m1 x m1
        # head with harmonically reduced column weights (see UbTail)
        assert Q is None, "ub tail structure requires the primal (LP) form"
        m1 = m
        E1, E2 = Ec[..., :m1], Ec[..., m1:]
        Dinv = 1.0 / Dc
        d2 = ub.w2 * ub.w2 * _take(Dinv, ub.idx2)   # (shards: partial)
        g2 = E2 + nsum(d2)
        corr = d2 * _take(Dinv, ub.idx2) / g2    # exactly 0 on padding rows
        Dt = _add_at(Dinv, ub.idx2, -corr)       # = 1/(D_j + w^2/E2)
        Ec = E1
    f32_path = (factor_dtype == torch.float32
                or (A.dtype == torch.float32 and factor_dtype is None))
    M = normal_matrix(A, Ec, Dc, f32_path, Q=Q,
                      dinv=Dt if ub is not None else None, cols=cols)

    with span("factor"):
        # the scaling vector stays at DATA precision: solves multiply
        # through it, and truncating it would cap refinement at factor
        # accuracy
        d = torch.diagonal(M, dim1=-2, dim2=-1).to(A.dtype)
        tiny = 1e-300 if A.dtype == torch.float64 else 1e-30
        s = torch.rsqrt(d.clamp_min(tiny))
        s_m = s.to(M.dtype)
        Ms = M * s_m.unsqueeze(-1) * s_m.unsqueeze(-2)
        if factor_dtype is not None:
            Ms = Ms.to(factor_dtype)
        # factor the symmetric part, as jnp.linalg.cholesky does
        Ms = (Ms + Ms.mT) / 2
        eye = torch.eye(Ms.shape[-1], dtype=Ms.dtype, device=Ms.device)
        # the escalation ladder runs in the factor's precision, like the
        # JAX loop's carried scalar: floor, then x100 per retry, stop at
        # >= 1e-2
        lead = Ms.shape[:-2]
        reg = torch.as_tensor(0.0 if reg0 is None else reg0, dtype=Ms.dtype,
                              device=Ms.device).expand(lead).clone()
        L, bad = _cholesky(Ms + reg[..., None, None] * eye)
        bad = nany(bad)
        # retry lane by lane (a single LP is one lane): refactor the lanes
        # whose factor failed, each at its own next level
        L, bad, reg = L.reshape(-1, *L.shape[-2:]), bad.reshape(-1), \
            reg.reshape(-1)
        Mf = Ms.reshape(-1, *Ms.shape[-2:])
        retry_ok = reg < 1.0e-2 if active is None else (
            active.expand(lead).reshape(-1) & (reg < 1.0e-2))
        while retry:
            again = host_read("kkt.retry", torch.nonzero,
                              bad & retry_ok).squeeze(-1)
            if again.numel() == 0:
                break
            r = next_reg(reg[again])
            Lr, badr = _cholesky(Mf[again] + r[:, None, None] * eye)
            reg[again], L[again], bad[again] = r, Lr, nany(badr)
            retry_ok[again] = r < 1.0e-2
        L, bad, reg = L.reshape(Ms.shape), bad.reshape(lead), reg.reshape(lead)
        # a factor that never succeeded is all NaN, as the JAX factor is:
        # the step's finite-iterate guard then stops that lane
        L = torch.where(lanes(bad, L), float("nan"), L)
        return KKTFactor(L, s, g2, reg, bad)


def _scaled_cho_solve(fac: KKTFactor, t):
    """Solve M u = t through the scaled factor: u = S Ms^-1 S t; t is
    (..., m, k)."""
    s = fac.s.unsqueeze(-1)
    u = torch.cholesky_solve((s * t).to(fac.L.dtype), fac.L)
    return s * u.to(fac.s.dtype)


def _raw_solve(A, Ec, Dc, fac: KKTFactor, ry, rx, Q=None, ub=None,
               cols=None):
    """One forward/backward pass: K [dy; dx] = [ry; rx] via the factor.
    ry: (..., m, k), rx: (..., n, k) column-stacked right-hand sides."""
    m, n = A.shape[-2:]
    nsum = local if cols is None else cols.sum
    col = lambda v: v.unsqueeze(-1)
    if ub is not None:
        # Schur path: solve the m1 head, back out the diagonal tail
        m1 = m
        Dinv = col(1.0 / Dc)
        g2 = col(fac.g2)
        w2 = col(ub.w2)
        rxD = rx * Dinv
        t2 = nsum(w2 * _take(rxD, ub.idx2)) - ry[..., m1:, :]
        fold = _add_at(rxD, ub.idx2, -w2 * _take(Dinv, ub.idx2) * t2 / g2)
        t1 = nsum(A @ fold) - ry[..., :m1, :]
        dy1 = _scaled_cho_solve(fac, t1)
        aty = A.mT @ dy1
        dy2 = (t2 - nsum(w2 * _take(Dinv, ub.idx2) * _take(aty, ub.idx2))
               ) / g2
        dx = (rx - aty - _add_at(torch.zeros_like(rx), ub.idx2, w2 * dy2)
              ) * Dinv
        return torch.cat([dy1, dy2], dim=-2), dx
    if cols is not None or use_primal_form(m, n, Q is not None):
        t = nsum(A @ (rx / col(Dc))) - ry
        dy = _scaled_cho_solve(fac, t)
        dx = (rx - A.mT @ dy) / col(Dc)
    else:
        t = rx + A.mT @ (ry / col(Ec))
        dx = _scaled_cho_solve(fac, t)
        dy = (A @ dx - ry) / col(Ec)
    return dy, dx


@spanned("kkt_solve")
def kkt_solve(A, E, D, L: KKTFactor, rhs_y, rhs_x, *, Q=None,
              epsdiag=1.0e-14, refine_tol=1.0e-10, max_refine: int = 8,
              compensated: bool = False, ub: UbTail | None = None,
              active=None, cols=None, passes: int | None = None):
    """Solve [[-E, A], [A', D+Q]] [dy; dx] = [rhs_y; rhs_x] with refinement.

    Residuals use the TRUE (unclamped) E, D while the factor used the
    clamped ones (ldlt.c:389-398).  rhs may be vectors (..., dim) or
    stacks (..., dim, k).  Each lane refines until its own residual meets
    the target or stops halving; lanes outside `active` do not refine.
    compensated=True forms the refinement residuals' products with
    quad.matvec2 (twice the working precision, the QuadPrec analogue), so
    refinement can go below the plain products' roundoff floor.  cols:
    column shards (module docstring); with compensated, the head product
    of the residual's row block is a partial sum left unrounded
    (quad.matvec2_dd) and completed by ColumnShards.sum2.

    passes (a single LP): make at most that many refinement passes (and
    no more than max_refine), each taken or not on the device as its
    refinement test says, with no host read; returns (dy, dx, more), more
    whether the test still asked for a pass after them.  Every value
    equals that of the refinement with reads whenever more is False."""
    nsum, nmax = (local, local) if cols is None else (cols.sum, cols.max)
    Ec = E.clamp_min(epsdiag)
    Dc = D.clamp_min(epsdiag)
    single = rhs_y.dim() == E.dim()
    if single:
        rhs_y = rhs_y.unsqueeze(-1)
        rhs_x = rhs_x.unsqueeze(-1)
    base_mv = matvec2 if compensated else mv
    # the row-block product A @ dx, a partial sum over the columns, and the
    # reduction that completes it
    row_mv, row_sum = base_mv, nsum
    if compensated and cols is not None:
        row_mv, row_sum = matvec2_dd, cols.sum2
    if ub is not None:
        mv_ = lambda M, v: tail_matvec(M, ub, v, row_mv)
        mvT = lambda M, v: tail_rmatvec(M, ub, v, base_mv)
    else:
        mv_ = row_mv
        mvT = lambda M, v: base_mv(M.mT, v)
    col = lambda v: v.unsqueeze(-1)

    def residual(dy, dx):
        r1 = rhs_y + col(E) * dy - row_sum(mv_(A, dx))
        r2 = rhs_x - mvT(A, dy) - col(D) * dx
        if Q is not None:
            r2 = r2 - base_mv(Q, dx)
        return r1, r2

    def amax(t):
        return t.abs().amax(dim=(-2, -1))

    def max_resid(r1, r2):
        return torch.maximum(amax(r1), nmax(amax(r2)))

    dy, dx = _raw_solve(A, Ec, Dc, L, rhs_y, rhs_x, Q, ub=ub, cols=cols)
    maxbc = torch.maximum(amax(rhs_y), nmax(amax(rhs_x))) + 1.0
    # the residual of the current (dy, dx), kept for the next pass
    r1, r2 = residual(dy, dx)
    maxrs = max_resid(r1, r2)
    # a lane that stopped refining stays stopped (its maxrs, oldmaxrs no
    # longer change), so every refining lane has made the same number of
    # passes, and one that never refined keeps oldmaxrs = inf
    oldmaxrs = torch.full_like(maxrs, float("inf"))
    ey = ex = None

    def asks():
        """The refinement test: the lanes a pass would still improve."""
        go = (maxrs > refine_tol * maxbc) & (maxrs < 0.5 * oldmaxrs)
        return go if active is None else go & active

    for _ in range(max_refine if passes is None
                   else min(passes, max_refine)):
        go = asks()
        if passes is None and not bool(host_read("kkt.refine",
                                                 go.any().item)):
            break
        cy, cx = _raw_solve(A, Ec, Dc, L, r1, r2, Q, ub=ub, cols=cols)
        if passes is not None:
            # a pass the test refuses leaves the solution, its residual
            # and the revert state as they were
            ey, ex = ((cy, cx) if ey is None else
                      (torch.where(go, cy, ey), torch.where(go, cx, ex)))
            oldmaxrs = torch.where(go, maxrs, oldmaxrs)
            dy = torch.where(go, dy + cy, dy)
            dx = torch.where(go, dx + cx, dx)
            r1, r2 = residual(dy, dx)
            maxrs = torch.where(go, max_resid(r1, r2), maxrs)
        elif go.dim():
            # lanes that stopped refining keep their solution and their
            # last correction (for the revert below)
            g = lanes(go, dy)
            cy, cx = torch.where(g, cy, 0.0), torch.where(g, cx, 0.0)
            ey, ex = ((cy, cx) if ey is None else
                      (torch.where(g, cy, ey), torch.where(g, cx, ex)))
            oldmaxrs = torch.where(go, maxrs, oldmaxrs)
            dy, dx = dy + cy, dx + cx
            r1, r2 = residual(dy, dx)
            maxrs = torch.where(go, max_resid(r1, r2), maxrs)
        else:
            ey, ex, oldmaxrs = cy, cx, maxrs
            dy, dx = dy + cy, dx + cx
            r1, r2 = residual(dy, dx)
            maxrs = max_resid(r1, r2)

    # revert the last correction if it made the residual worse (ldlt.c:413-416)
    if ey is not None:
        worse = lanes(maxrs > oldmaxrs, dy)
        dy = torch.where(worse, dy - ey, dy)
        dx = torch.where(worse, dx - ex, dx)
    if single:
        dy = dy.squeeze(-1)
        dx = dx.squeeze(-1)
    if passes is None:
        return dy, dx
    return dy, dx, asks() & (passes < max_refine)
