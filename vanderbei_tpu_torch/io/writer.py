"""Solution and LP writers (a copy of vanderbei_tpu/io/writer.py; the
tests hold the outputs byte-equal).

write_sol mirrors the reference's writesol (src/common/iolp.c:976-1045):
COLUMNS section (index, label, primal value, reduced cost, bounds, OB flag)
and ROWS section (index, label, dual value, row activity, rhs, range, OB
flag), ending with ENDOUT.  Like the reference, the ROWS section reports in
the canonicalized row space for the first m0 rows (the reference's solvelp
rewrites lp->A/b in place before writesol reads them).

write_lp re-emits the problem as MPS including the QUADS extension
(reference writelp iolp.c:840-974).
"""

from __future__ import annotations

import numpy as np

from ..core.lp import LP, INF
from ..core.status import Status


def _e(v: float) -> str:
    return f"{v:11.4e}"


def _fit12(v: float) -> str:
    """Format a value to fit the reader's 12-char fixed column [25:36]."""
    s = f"{v:.12g}"
    if len(s) > 12:
        s = f"{v:.6e}"
    if len(s) > 12:
        s = f"{v:.4e}"
    return s


def write_sol(lp: LP, sol, path: str) -> None:
    m, n = lp.m, lp.n
    eps = lp.inftol * 1.2
    x, z, y = sol.x, sol.z, sol.y
    l, u = lp.l, lp.u

    # row activity from the ORIGINAL A (the reference computes it from the
    # canonicalized A whose first m rows are the negated originals; we report
    # the same numbers: rowact = -(Ax), rhs = -b for rows that were negated)
    A = lp.dense_A()
    act = A @ x[:n]
    b_canon = sol.b_canon if sol.b_canon is not None else -lp.b
    rowact = -act  # canonical first-m rows are negated originals

    with open(path, "w") as fp:
        fp.write("COLUMNS SECTION\n")
        fp.write("   index       label  primal_val reduced_cst"
                 "    lower_bd    upper_bd   OB_flag\n")
        for j in range(n):
            lab = lp.collab[j] if j < len(lp.collab) else str(j)
            lo = l[j] if l is not None else 0.0
            up = u[j] if u is not None else INF
            line = f"{j:8d}  {lab:>10s} {_e(x[j])} {_e(z[j])}"
            line += f" {_e(lo)}" if lo > -INF else "   -Infinity"
            line += f" {_e(up)}" if up < INF else "    Infinity"
            if x[j] < lo - eps or x[j] > up + eps:
                line += "      OB"
            fp.write(line + "\n")
        fp.write("ROWS SECTION\n")
        fp.write("   index       label    dual_val  row_actvty"
                 " rght_hnd_sd       range   OB_flag\n")
        r = lp.r if lp.r is not None else np.full(m, INF)
        for i in range(m):
            lab = lp.rowlab[i] if i < len(lp.rowlab) else str(i)
            bi = b_canon[i] if i < len(b_canon) else -lp.b[i]
            yi = y[i] if i < len(y) else 0.0
            line = f"{i:8d}  {lab:>10s} {_e(yi)} {_e(rowact[i])} {_e(bi)}"
            line += f" {_e(r[i])}" if r[i] < INF else "    Infinity"
            hi = bi + r[i] if r[i] < INF else INF
            if rowact[i] < bi - eps or rowact[i] > hi + eps:
                line += "     OB"
            fp.write(line + "\n")
        fp.write("ENDOUT\n")


def write_lp(lp: LP, path: str) -> None:
    """Re-emit the LP as MPS (reference writelp iolp.c:840-974).

    Rows are written as G rows (the post-parse internal convention is
    b <= Ax <= b+r), with RANGES entries for finite r and an E row when
    r == 0.
    """
    m, n = lp.m, lp.n
    A = lp.dense_A()
    with open(path, "w") as fp:
        if lp.maximize:
            fp.write("MAX\n")
        fp.write(f"NAME          {lp.name}\n")
        fp.write("ROWS\n")
        fp.write(" N  obj\n")
        for i in range(m):
            typ = "E" if lp.r[i] == 0.0 else "G"
            fp.write(f" {typ}  {lp.rowlab[i]}\n")
        fp.write("COLUMNS\n")
        for j in range(n):
            lab = lp.collab[j]
            if lp.c[j] != 0.0:
                fp.write(f"    {lab:<8s}  {'obj':<8s}  {_fit12(lp.c[j])}\n")
            for i in range(m):
                if A[i, j] != 0.0:
                    fp.write(f"    {lab:<8s}  {lp.rowlab[i]:<8s}  "
                             f"{_fit12(A[i, j])}\n")
        fp.write("RHS\n")
        for i in range(m):
            if lp.b[i] != 0.0:
                fp.write(f"    rhs       {lp.rowlab[i]:<8s}  {_fit12(lp.b[i])}\n")
        if np.any(np.isfinite(lp.r) & (lp.r != 0.0)):
            fp.write("RANGES\n")
            for i in range(m):
                if np.isfinite(lp.r[i]) and lp.r[i] != 0.0:
                    fp.write(f"    rng       {lp.rowlab[i]:<8s}  "
                             f"{_fit12(lp.r[i])}\n")
        has_bounds = np.any(lp.l != 0.0) or np.any(np.isfinite(lp.u))
        if has_bounds:
            fp.write("BOUNDS\n")
            for j in range(n):
                if np.isneginf(lp.l[j]):
                    if np.isinf(lp.u[j]):
                        # FR, not MI: the reader's MI quirk would set u to
                        # the previous lower bound
                        fp.write(f" FR bnd       {lp.collab[j]}\n")
                        continue
                    fp.write(f" MI bnd       {lp.collab[j]}\n")
                elif lp.l[j] != 0.0:
                    fp.write(f" LO bnd       {lp.collab[j]:<8s}  "
                             f"{_fit12(lp.l[j])}\n")
                if np.isfinite(lp.u[j]):
                    fp.write(f" UP bnd       {lp.collab[j]:<8s}  "
                             f"{_fit12(lp.u[j])}\n")
        if lp.qnz:
            fp.write("QUADS\n")
            for j in range(n):
                for k in range(lp.kQ[j], lp.kQ[j + 1]):
                    i = lp.iQ[k]
                    if i >= j:  # lower triangle only, like writelp
                        fp.write(f"    {lp.collab[j]:<8s}  "
                                 f"{lp.collab[i]:<8s}  {_fit12(lp.Q[k])}\n")
        fp.write("ENDATA\n")
