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

Every f32 normal matrix is formed by ops/syrk.scaled_syrk, the hand-written
Hopper kernel on a CUDA tensor.  The f64 product, the Cholesky factor
(cholesky_ex, whose `info` joins the NaN/Inf scan), the triangular solves
and the matvecs stay torch.matmul / torch.linalg.  The factor's retry and
each refinement pass read one flag on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .quad import matvec2
from .syrk import scaled_syrk


def use_primal_form(m: int, n: int, has_q: bool) -> bool:
    return (m <= n) and not has_q


class UbTail(NamedTuple):
    """Canonical tail rows that are singleton upper-bound rows
    (w2[i] * x[idx2[i]] <= b2[i]) or padding (w2[i] = 0).  Their block of
    the normal equations is diagonal, so the factor Schur-eliminates them
    and only the m1 x m1 head is factored (see vanderbei_tpu.ops.kkt)."""
    idx2: torch.Tensor   # (k,) int64 column index per tail row
    w2: torch.Tensor     # (k,) coefficient per tail row (0 = padding)


def _w2(ub: UbTail, v: torch.Tensor) -> torch.Tensor:
    return ub.w2 if v.dim() == 1 else ub.w2[:, None]


def tail_matvec(A1, ub: UbTail, x, mv=torch.matmul):
    """[A1; S] @ x where S are the ub/padding tail rows; x is (n,) or (n, k).
    mv(M, v) forms the head product (quad.matvec2 in compensated mode)."""
    return torch.cat([mv(A1, x), _w2(ub, x) * x[ub.idx2]])


def tail_rmatvec(A1, ub: UbTail, y, mv=torch.matmul):
    """[A1; S]' @ y.  index_add sums duplicate indices (padding rows all
    point at column 0 with weight 0)."""
    m1 = A1.shape[0]
    return mv(A1.mT, y[:m1]).index_add_(0, ub.idx2, _w2(ub, y) * y[m1:])


class KKTFactor(NamedTuple):
    """Lower Cholesky factor L of Ms = S M S, S = diag(s) = diag(M)^-1/2.

    L may be lower precision than the data; solves cast through L.dtype
    and refinement recovers the rest.  g2 is the Schur-eliminated tail
    diagonal (UbTail path), reg the Tikhonov level the factor ended at."""
    L: torch.Tensor
    s: torch.Tensor
    g2: torch.Tensor = None
    reg: torch.Tensor = None


def _cholesky(Mr):
    L, info = torch.linalg.cholesky_ex(Mr)
    bad = bool(((info != 0) | ~torch.isfinite(L).all()).item())
    return L, info, bad


def kkt_factor(A, E, D, epsdiag, Q=None, factor_dtype=None,
               ub: UbTail | None = None, reg0=None) -> KKTFactor:
    """Cholesky-factor the reduced normal-equations matrix.

    E, D are clamped below by epsdiag (ldlt.c:235-236).  reg0 seeds the
    Tikhonov escalation with the level the previous iteration's factor
    needed (sticky, like the reference's epsdiag)."""
    m, n = A.shape
    Ec = E.clamp_min(epsdiag)        # clamp_min propagates NaN, as
    Dc = D.clamp_min(epsdiag)        # jnp.maximum does
    g2 = None
    if ub is not None:
        # Schur-eliminate the singleton ub tail: factor only the m1 x m1
        # head with harmonically reduced column weights (see UbTail)
        assert Q is None, "ub tail structure requires the primal (LP) form"
        m1 = m
        E1, E2 = Ec[:m1], Ec[m1:]
        Dinv = 1.0 / Dc
        d2 = ub.w2 * ub.w2 * Dinv[ub.idx2]
        g2 = E2 + d2
        corr = d2 * Dinv[ub.idx2] / g2       # exactly 0 on padding rows
        Dt = Dinv.index_add(0, ub.idx2, -corr)   # = 1/(D_j + w^2/E2)
        Ec = E1
    f32_path = (factor_dtype == torch.float32
                or (A.dtype == torch.float32 and factor_dtype is None))
    f32 = torch.float32
    if ub is not None:
        if f32_path:
            M = scaled_syrk(A.to(f32), Dt.to(f32), Ec.to(f32))
        else:
            M = (A * Dt[None, :]) @ A.mT + torch.diag(Ec)
    elif f32_path:
        if use_primal_form(m, n, Q is not None):
            M = scaled_syrk(A.to(f32), (1.0 / Dc).to(f32), Ec.to(f32))
        else:
            # A' as a strided view: the kernel reads it in place
            M = scaled_syrk(A.mT.to(f32), (1.0 / Ec).to(f32), Dc.to(f32))
            if Q is not None:
                M = M + Q.to(M.dtype)
    elif use_primal_form(m, n, Q is not None):
        M = (A / Dc[None, :]) @ A.mT
        M = M + torch.diag(Ec)
    else:
        M = (A.mT / Ec[None, :]) @ A
        M = M + torch.diag(Dc)
        if Q is not None:
            M = M + Q

    # the scaling vector stays at DATA precision: solves multiply through
    # it, and truncating it would cap refinement at factor accuracy
    d = torch.diagonal(M).to(A.dtype)
    tiny = 1e-300 if A.dtype == torch.float64 else 1e-30
    s = torch.rsqrt(d.clamp_min(tiny))
    s_m = s.to(M.dtype)
    Ms = M * s_m[:, None] * s_m[None, :]
    if factor_dtype is not None:
        Ms = Ms.to(factor_dtype)
    # factor the symmetric part, as jnp.linalg.cholesky does
    Ms = (Ms + Ms.mT) / 2
    eye = torch.eye(Ms.shape[0], dtype=Ms.dtype, device=Ms.device)
    # the escalation ladder runs in the factor's precision, like the JAX
    # loop's carried scalar: floor, then x100 per retry, stop at >= 1e-2
    dt = np.float64 if Ms.dtype == torch.float64 else np.float32
    floor = dt(1.0e-14 if Ms.dtype == torch.float64 else 1.0e-7)
    reg = dt(0.0) if reg0 is None else dt(float(reg0))
    L, info, bad = _cholesky(Ms + float(reg) * eye)
    while bad and reg < dt(1.0e-2):
        reg = floor if reg == 0.0 else dt(reg * dt(100.0))
        L, info, bad = _cholesky(Ms + float(reg) * eye)
    if bad:
        # a factor that never succeeded is all NaN, as the JAX factor is:
        # the step's finite-iterate guard then stops the solve
        L = torch.full_like(L, float("nan"))
    return KKTFactor(L, s, g2, torch.full((), float(reg), dtype=Ms.dtype,
                                          device=Ms.device))


def _scaled_cho_solve(fac: KKTFactor, t):
    """Solve M u = t through the scaled factor: u = S Ms^-1 S t; t is (m, k)."""
    st = (fac.s[:, None] * t).to(fac.L.dtype)
    u = torch.cholesky_solve(st, fac.L)
    return fac.s[:, None] * u.to(fac.s.dtype)


def _raw_solve(A, Ec, Dc, fac: KKTFactor, ry, rx, Q=None, ub=None):
    """One forward/backward pass: K [dy; dx] = [ry; rx] via the factor.
    ry: (m, k), rx: (n, k) column-stacked right-hand sides."""
    m, n = A.shape
    if ub is not None:
        # Schur path: solve the m1 head, back out the diagonal tail
        m1 = m
        Dinv = (1.0 / Dc)[:, None]
        g2 = fac.g2[:, None]
        w2 = ub.w2[:, None]
        rxD = rx * Dinv
        t2 = w2 * rxD[ub.idx2] - ry[m1:]
        fold = rxD.index_add(0, ub.idx2, -w2 * Dinv[ub.idx2] * t2 / g2)
        t1 = A @ fold - ry[:m1]
        dy1 = _scaled_cho_solve(fac, t1)
        aty = A.mT @ dy1
        dy2 = (t2 - w2 * Dinv[ub.idx2] * aty[ub.idx2]) / g2
        dx = (rx - aty - torch.zeros_like(rx).index_add_(0, ub.idx2, w2 * dy2)
              ) * Dinv
        return torch.cat([dy1, dy2]), dx
    if use_primal_form(m, n, Q is not None):
        t = A @ (rx / Dc[:, None]) - ry
        dy = _scaled_cho_solve(fac, t)
        dx = (rx - A.mT @ dy) / Dc[:, None]
    else:
        t = rx + A.mT @ (ry / Ec[:, None])
        dx = _scaled_cho_solve(fac, t)
        dy = (A @ dx - ry) / Ec[:, None]
    return dy, dx


def kkt_solve(A, E, D, L: KKTFactor, rhs_y, rhs_x, *, Q=None,
              epsdiag=1.0e-14, refine_tol=1.0e-10, max_refine: int = 8,
              compensated: bool = False, ub: UbTail | None = None):
    """Solve [[-E, A], [A', D+Q]] [dy; dx] = [rhs_y; rhs_x] with refinement.

    Residuals use the TRUE (unclamped) E, D while the factor used the
    clamped ones (ldlt.c:389-398).  rhs may be vectors or (dim, k).
    compensated=True forms the refinement residuals' products with
    quad.matvec2 (twice the working precision, the QuadPrec analogue), so
    refinement can go below the plain products' roundoff floor."""
    Ec = E.clamp_min(epsdiag)
    Dc = D.clamp_min(epsdiag)
    single = rhs_y.dim() == 1
    if single:
        rhs_y = rhs_y[:, None]
        rhs_x = rhs_x[:, None]
    base_mv = matvec2 if compensated else torch.matmul
    if ub is not None:
        mv = lambda M, v: tail_matvec(M, ub, v, base_mv)
        mvT = lambda M, v: tail_rmatvec(M, ub, v, base_mv)
    else:
        mv = base_mv
        mvT = lambda M, v: base_mv(M.mT, v)

    def residual(dy, dx):
        r1 = rhs_y + E[:, None] * dy - mv(A, dx)
        r2 = rhs_x - mvT(A, dy) - D[:, None] * dx
        if Q is not None:
            r2 = r2 - base_mv(Q, dx)
        return r1, r2

    def max_resid(dy, dx):
        r1, r2 = residual(dy, dx)
        return torch.maximum(r1.abs().max(), r2.abs().max())

    dy, dx = _raw_solve(A, Ec, Dc, L, rhs_y, rhs_x, Q, ub=ub)
    maxbc = torch.maximum(rhs_y.abs().max(), rhs_x.abs().max()) + 1.0
    maxrs = max_resid(dy, dx)
    oldmaxrs = float("inf")
    ey = ex = None
    it = 0
    while it < max_refine and bool(((maxrs > refine_tol * maxbc)
                                    & (maxrs < 0.5 * oldmaxrs)).item()):
        r1, r2 = residual(dy, dx)
        ey, ex = _raw_solve(A, Ec, Dc, L, r1, r2, Q, ub=ub)
        dy, dx = dy + ey, dx + ex
        oldmaxrs, maxrs = maxrs, max_resid(dy, dx)
        it += 1

    # revert the last correction if it made the residual worse (ldlt.c:413-416)
    if it > 0 and bool((maxrs > oldmaxrs).item()):
        dy = dy - ey
        dx = dx - ex
    if single:
        dy = dy[:, 0]
        dx = dx[:, 0]
    return dy, dx
