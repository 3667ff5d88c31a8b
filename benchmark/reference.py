"""The plain reference of an LP solve, and the comparison that decides a
run's `correct`.

`solve` is a dense primal-dual interior-point method, Mehrotra's
predictor-corrector with the upper bounds held as such (x + t = u, t a
variable of its own), in
plain torch, batched over LPs of one shape.  It shares no code with the
port: the port runs the homogeneous self-dual method on its own
canonical form (rows split, equalities doubled, an f32 sprint, its own
kernel), this one works on the natural form

    min c'x,  A[:n_eq] x = b[:n_eq],  A[n_eq:] x + w = b[n_eq:],
    0 <= x <= u,  w >= 0

in one precision throughout, with a Cholesky factor of the normal matrix
A diag(theta) A' + diag(0, theta_w) each iteration.

`judge` holds the program's answers (status, objective, point, in the LP's
own variables) against the LPs as the benchmark made them and against this
solver's, and returns each number compared beside its limit.
"""

from __future__ import annotations

import numpy as np
import torch

# each lane stops once its relative primal and dual residuals and its
# relative duality gap are all below TOL (float64; float32 gets TOL32).
# Near the end the normal matrix's condition grows without bound and the
# residuals stall or grow again, so the solver keeps each lane's best
# iterate (the least of the largest of the three) and a lane that never
# reaches TOL counts as solved if its best is below ten times it.
TOL64 = 1.0e-9
TOL32 = 1.0e-5
STEP = 0.995
# the numbers judge() returns
REPORTED = ("not_optimal", "feas_rel", "obj_rel", "x_rel", "ref_unsolved")
# bytes of A in one batched call of the reference
CHUNK_BYTES = 2 << 30


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    return (v[..., None, :] @ A)[..., 0, :]


def _max_step(v, dv):
    """Largest a <= 1 with v + a dv >= 0, per lane (v > 0)."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return ratio.amin(-1).clamp(max=1.0)


def solve(A, b, c, u, n_eq: int, dtype=torch.float64, tol: float | None = None,
          max_iter: int = 100):
    """Solve a batch of LPs (A (B, m, n), b (B, m), c (B, n), u (B, n), the
    first n_eq rows equalities, the rest <=) in `dtype` on A's device.

    Returns (x (B, n) float64, objective (B,) float64, converged (B,) bool,
    iterations (B,) int64), on the host as numpy arrays: each lane's best
    iterate (see TOL64)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _solve(A, b, c, u, n_eq, dtype,
                      tol if tol is not None
                      else (TOL64 if dtype == torch.float64 else TOL32),
                      max_iter)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _solve(A, b, c, u, n_eq, dtype, tol, max_iter):
    A, b, c, u = (t.to(dtype) for t in (A, b, c, u))
    B, m, n = A.shape
    le = slice(n_eq, m)
    x = u / 2
    t = u - x
    w = (b[:, le] - _mv(A[:, le], x)).clamp(min=1.0)
    y = torch.zeros_like(b)
    zx, sx, zw = torch.ones_like(x), torch.ones_like(x), torch.ones_like(w)
    bnorm = 1 + b.abs().amax(-1)
    cnorm = 1 + c.abs().amax(-1)
    unorm = 1 + u.abs().amax(-1)
    ncomp = 2 * n + (m - n_eq)
    done = torch.zeros(B, dtype=torch.bool, device=A.device)
    iters = torch.zeros(B, dtype=torch.int64, device=A.device)
    best = torch.full((B,), float("inf"), dtype=dtype, device=A.device)
    best_x = x.clone()
    eye = torch.eye(m, dtype=dtype, device=A.device)
    tiny = torch.finfo(dtype).tiny
    for _ in range(max_iter):
        rp = b - _mv(A, x)
        rp[:, le] -= w
        ru = u - x - t
        rdx = c - _mtv(A, y) - zx + sx
        rdw = -y[:, le] - zw
        pobj = (c * x).sum(-1)
        dobj = (b * y).sum(-1) - (u * sx).sum(-1)
        merit = torch.stack([
            rp.abs().amax(-1) / bnorm, ru.abs().amax(-1) / unorm,
            torch.maximum(rdx.abs().amax(-1), rdw.abs().amax(-1)) / cnorm,
            (pobj - dobj).abs() / (1 + pobj.abs())]).amax(0)
        merit = torch.where(torch.isfinite(merit), merit, float("inf"))
        better = ~done & (merit < best)
        best = torch.where(better, merit, best)
        best_x = torch.where(better[:, None], x, best_x)
        done |= merit < tol
        if bool(done.all()):
            break
        iters += (~done).to(torch.int64)
        mu = (((x * zx).sum(-1) + (t * sx).sum(-1) + (w * zw).sum(-1))
              / ncomp).clamp(min=tiny)
        thx = 1 / (zx / x + sx / t)
        thw = w / zw
        M = (A * thx[:, None, :]) @ A.mT
        M[:, le, le] += torch.diag_embed(thw)
        scale = M.diagonal(dim1=-2, dim2=-1).amax(-1)[:, None, None]
        for reg in (0.0, 1e-12, 1e-9, 1e-6):
            L, info = torch.linalg.cholesky_ex(M + reg * scale * eye)
            if not bool(info.any()):
                break

        def newton(rxz, rzw, rts):
            # dt = ru - dx, so t's complementarity gives
            # ds = (rts - s ru + s dx) / t
            rts = rts - sx * ru
            rhox = rdx - rxz / x + rts / t
            rhow = rdw - rzw / w
            rhs = rp + _mv(A, thx * rhox)
            rhs[:, le] += thw * rhow
            dy = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            dx = thx * (_mtv(A, dy) - rhox)
            dw = thw * (dy[:, le] - rhow)
            return (dx, ru - dx, dw, dy, (rxz - zx * dx) / x,
                    (rzw - zw * dw) / w, (rts + sx * dx) / t)

        def steps(d, eta):
            dx, dt, dw, _, dzx, dzw, dsx = d
            ap = torch.minimum(torch.minimum(_max_step(x, dx),
                                             _max_step(t, dt)),
                               _max_step(w, dw))
            ad = torch.minimum(torch.minimum(_max_step(zx, dzx),
                                             _max_step(zw, dzw)),
                               _max_step(sx, dsx))
            return (eta * ap).clamp(max=1.0), (eta * ad).clamp(max=1.0)

        aff = newton(-x * zx, -w * zw, -t * sx)
        ap, ad = steps(aff, 1.0)
        dx, dt, dw, _, dzx, dzw, dsx = aff
        P, D = ap[:, None], ad[:, None]
        mu_aff = (((x + P * dx) * (zx + D * dzx)).sum(-1)
                  + ((t + P * dt) * (sx + D * dsx)).sum(-1)
                  + ((w + P * dw) * (zw + D * dzw)).sum(-1)) / ncomp
        sm = ((mu_aff / mu).clamp(0.0, 1.0) ** 3 * mu)[:, None]
        cor = newton(sm - x * zx - dx * dzx, sm - w * zw - dw * dzw,
                     sm - t * sx - dt * dsx)
        ap, ad = steps(cor, STEP)
        dx, dt, dw, dy, dzx, dzw, dsx = cor
        # a lane that is done, or whose step is not finite, stays put
        ok = ~done & torch.isfinite(ap) & torch.isfinite(ad)
        for d in cor:
            ok &= torch.isfinite(d).all(-1)
        P = torch.where(ok, ap, 0.0)[:, None]
        D = torch.where(ok, ad, 0.0)[:, None]
        fin = lambda d: torch.where(ok[:, None], d, 0.0)
        x, t, w = x + P * fin(dx), t + P * fin(dt), w + P * fin(dw)
        y, zx = y + D * fin(dy), zx + D * fin(dzx)
        zw, sx = zw + D * fin(dzw), sx + D * fin(dsx)
    host = lambda v: v.to(torch.float64).cpu().numpy()
    return (host(best_x), host((c * best_x).sum(-1)),
            (best < 10 * tol).cpu().numpy(), iters.cpu().numpy())


def feasibility(lp, x) -> float:
    """The largest violation by x of lp's rows, relative to 1 + max|b|, or
    of its bounds, relative to 1 + max u (numpy, float64)."""
    Ax = lp.A @ x
    rows = np.concatenate([np.abs(Ax[:lp.n_eq] - lp.b[:lp.n_eq]),
                           np.maximum(Ax[lp.n_eq:] - lp.b[lp.n_eq:], 0.0)])
    bounds = np.maximum(np.maximum(-x, x - lp.u), 0.0)
    return max(float(rows.max(initial=0.0)) / (1 + np.abs(lp.b).max()),
               float(bounds.max(initial=0.0)) / (1 + lp.u.max()))


def reference_solve(lps, device, dtype=torch.float64):
    """solve() over a list of NaturalLP, grouped by shape and chunked to
    CHUNK_BYTES of A: [(x, objective, converged)] in the list's order."""
    out = [None] * len(lps)
    groups: dict = {}
    for i, lp in enumerate(lps):
        groups.setdefault((lp.shape, lp.n_eq), []).append(i)
    for ((m, n), n_eq), idx in groups.items():
        per = max(1, CHUNK_BYTES // (m * n * 8))
        for lo in range(0, len(idx), per):
            part = idx[lo:lo + per]
            stack = lambda f: torch.from_numpy(
                np.stack([f(lps[i]) for i in part])).to(device)
            x, obj, conv, _ = solve(stack(lambda p: p.A), stack(lambda p: p.b),
                                    stack(lambda p: p.c), stack(lambda p: p.u),
                                    n_eq, dtype=dtype)
            for k, i in enumerate(part):
                out[i] = (x[k], float(obj[k]), bool(conv[k]))
    return out


def _num(v) -> float:
    """v as a float, a NaN read as +inf so that it fails every limit."""
    v = float(v)
    return float("inf") if np.isnan(v) else v


def judge(lps, answers, device):
    """Hold the program's answers to the LPs they solve.

    lps: NaturalLP per answer; answers: (status, objective, x) per LP, x in
    the LP's own variables.  Every LP is held to OPTIMAL, to its rows and
    bounds, and its objective (as reported, and as c'x) and point to the
    reference's.

    Returns {name: value}: not_optimal (count), feas_rel, obj_rel, x_rel
    (the worst over the LPs) and ref_unsolved (LPs on which the reference
    did not converge)."""
    not_optimal = sum(int(st) != 0 for st, _, _ in answers)
    feas = max((_num(feasibility(lp, np.asarray(a[2], np.float64)))
                for lp, a in zip(lps, answers)), default=0.0)
    obj_rel = x_rel = 0.0
    unsolved = 0
    for i, (xr, objr, conv) in enumerate(reference_solve(lps, device)):
        if not conv:
            unsolved += 1
            continue
        _, obj, x = answers[i]
        x = np.asarray(x, np.float64)
        scale = max(1.0, abs(objr))
        obj_rel = max(obj_rel, _num(abs(obj - objr) / scale),
                      _num(abs(float(lps[i].c @ x) - objr) / scale))
        x_rel = max(x_rel, _num(np.abs(x - xr).max()
                                / max(1.0, float(np.abs(xr).max()))))
    return dict(not_optimal=not_optimal, feas_rel=feas, obj_rel=obj_rel,
                x_rel=x_rel, ref_unsolved=unsolved)
