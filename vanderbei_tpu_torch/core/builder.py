"""Programmatic model builder (a copy of vanderbei_tpu/core/builder.py; the
tests hold the two to equal LPs).

The reference's second front end is the vendored AMPL solver library
(src/amplsolver + common/amplio.c) reading .nl files.  The TPU framework
replaces that surface with a direct Python builder (SURVEY.md section 7:
"AMPL front end -> dropped; MPS + a Python-dict model builder API
instead"): named rows/columns, ranges, bounds, and quadratic terms, with
the same post-build semantics as the MPS reader (b <= Ax <= b+r form).

    lpb = LPBuilder(name="diet", maximize=False)
    lpb.var("x1", lower=0, obj=2.0)
    lpb.var("x2", lower=0, upper=4, obj=3.0)
    lpb.constraint("protein", {"x1": 1.0, "x2": 2.0}, lo=10)        # >=
    lpb.constraint("budget",  {"x1": 3.0, "x2": 1.0}, hi=15)        # <=
    lpb.constraint("mix",     {"x1": 1.0, "x2": -1.0}, lo=0, hi=2)  # range
    lp = lpb.build()
"""

from __future__ import annotations

import numpy as np

from .lp import LP, INF, VAR_REAL, VAR_INTEGER


class LPBuilder:
    def __init__(self, name: str = "model", maximize: bool = False):
        self.name = name
        self.maximize = maximize
        self._cols: dict[str, int] = {}
        self._rows: dict[str, int] = {}
        self._obj: list[float] = []
        self._lower: list[float] = []
        self._upper: list[float] = []
        self._integer: list[bool] = []
        self._entries: list[list] = []       # per-col [(row, coef)]
        self._row_lo: list[float] = []
        self._row_hi: list[float] = []
        self._rowlab: list[str] = []
        self._quad: dict[tuple, float] = {}

    # -- variables --------------------------------------------------------
    def var(self, name: str, lower: float = 0.0, upper: float = INF,
            obj: float = 0.0, integer: bool = False) -> "LPBuilder":
        if name in self._cols:
            raise ValueError(f"duplicate variable {name!r}")
        self._cols[name] = len(self._obj)
        self._obj.append(float(obj))
        self._lower.append(float(lower))
        self._upper.append(float(upper))
        self._integer.append(bool(integer))
        self._entries.append([])
        return self

    # -- constraints ------------------------------------------------------
    def constraint(self, name: str, coefs: dict, lo: float = -INF,
                   hi: float = INF) -> "LPBuilder":
        """lo <= sum coefs[v]*v <= hi; equality when lo == hi."""
        if name in self._rows:
            raise ValueError(f"duplicate constraint {name!r}")
        if lo == -INF and hi == INF:
            raise ValueError(f"constraint {name!r} has no bound")
        i = len(self._rowlab)
        self._rows[name] = i
        self._rowlab.append(name)
        self._row_lo.append(float(lo))
        self._row_hi.append(float(hi))
        for v, coef in coefs.items():
            if v not in self._cols:
                raise KeyError(f"unknown variable {v!r} in {name!r}")
            self._entries[self._cols[v]].append((i, float(coef)))
        return self

    # -- quadratic objective ---------------------------------------------
    def quad(self, v1: str, v2: str, coef: float) -> "LPBuilder":
        """Add coef * v1 * v2 to the 1/2 x'Qx objective term (symmetric)."""
        j1, j2 = self._cols[v1], self._cols[v2]
        key = (min(j1, j2), max(j1, j2))
        self._quad[key] = self._quad.get(key, 0.0) + float(coef)
        return self

    # -- build ------------------------------------------------------------
    def build(self) -> LP:
        n = len(self._obj)
        m = len(self._rowlab)
        # rows to b <= Ax <= b+r: a lo-only row is (lo, inf); hi-only is
        # encoded by negation exactly like the MPS reader negates L rows
        A_vals, iA, kA = [], [], [0]
        neg = [self._row_lo[i] == -INF for i in range(m)]
        b = np.zeros(m)
        r = np.zeros(m)
        for i in range(m):
            if neg[i]:                       # hi only: -a'x >= -hi
                b[i] = -self._row_hi[i]
                r[i] = INF
            else:
                b[i] = self._row_lo[i]
                r[i] = (self._row_hi[i] - self._row_lo[i]
                        if self._row_hi[i] < INF else INF)
        for j in range(n):
            for (i, coef) in self._entries[j]:
                A_vals.append(-coef if neg[i] else coef)
                iA.append(i)
            kA.append(len(A_vals))

        # symmetric Q from the triangular dict
        qcols = [[] for _ in range(n)]
        for (j1, j2), coef in self._quad.items():
            qcols[j2].append((j1, coef))
            if j1 != j2:
                qcols[j1].append((j2, coef))
        Q_vals, iQ, kQ = [], [], [0]
        for j in range(n):
            for (i, coef) in sorted(qcols[j]):
                iQ.append(i)
                Q_vals.append(coef)
            kQ.append(len(Q_vals))

        return LP(
            name=self.name, m=m, n=n,
            A=np.asarray(A_vals, np.float64),
            iA=np.asarray(iA, np.int64),
            kA=np.asarray(kA, np.int64),
            b=b, c=np.asarray(self._obj, np.float64), f=0.0,
            r=r,
            l=np.asarray(self._lower, np.float64),
            u=np.asarray(self._upper, np.float64),
            Q=np.asarray(Q_vals, np.float64),
            iQ=np.asarray(iQ, np.int64),
            kQ=np.asarray(kQ, np.int64),
            qnz=len(Q_vals),
            varsgn=np.asarray(
                [VAR_INTEGER if f else VAR_REAL for f in self._integer],
                np.int64),
            rowlab=list(self._rowlab),
            collab=list(self._cols),
            maximize=self.maximize,
        )
