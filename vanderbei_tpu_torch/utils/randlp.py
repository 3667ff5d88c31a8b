"""Seeded random bounded LPs, the workload of chip_smoke.py and the tests.

    min c'x  s.t.  A_eq x = b_eq,  A_le x <= b_le,  0 <= x <= u

A has N(0,1) entries at the given density, u ~ U[1, 3], c ~ N(0, 1); the
right-hand sides come from an interior point x0 = U[0.2, 0.8] * u, with a
slack of U[0.1, 1] on the <= rows, so the LP is feasible and, being boxed,
bounded.  The first m // 10 rows are equalities.  At m = 2000, n = 4000 it
has the scale of the larger netlib instances (PILOT87 is 2030 x 4883).

random_bounded_qp adds a sparse positive definite Q to such an LP, for
min c'x + x'Qx/2: a diagonal U[10, 20] and a tridiagonal band U[-4, 4],
so Q is strictly diagonally dominant.  (With a tenth of that curvature
intpt's f64 stage certifies these QPs dual infeasible by its divergence
test, in both packages.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.lp import LP, INF


def random_bounded_lp(m: int, n: int, density: float = 0.02,
                      seed: int = 0) -> LP:
    rng = np.random.default_rng(seed)
    n_eq = m // 10
    A = np.where(rng.random((m, n)) < density,
                 rng.standard_normal((m, n)), 0.0)
    u = rng.uniform(1.0, 3.0, n)
    c = rng.standard_normal(n)
    x0 = rng.uniform(0.2, 0.8, n) * u
    slack = rng.uniform(0.1, 1.0, m - n_eq)
    # the LP container's rows read b <= Ax <= b + r: equality rows have
    # r = 0, and a <= row is stored negated (-a'x >= -b_le), as the MPS
    # reader stores L rows
    b = A @ x0
    b[n_eq:] = -(b[n_eq:] + slack)
    A[n_eq:] = -A[n_eq:]
    r = np.where(np.arange(m) < n_eq, 0.0, INF)
    cols, rows = np.nonzero(A.T)          # column-major order for CSC
    kA = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=n))])
    return LP(
        name=f"RAND{m}", m=m, n=n,
        A=A.T[cols, rows], iA=rows.astype(np.int64), kA=kA.astype(np.int64),
        b=b, c=c, f=0.0, r=r, l=np.zeros(n), u=u,
        Q=np.zeros(0), iQ=np.zeros(0, np.int64), kQ=np.zeros(n + 1, np.int64),
        qnz=0, varsgn=np.ones(n, np.int64),
        rowlab=[f"R{i}" for i in range(m)],
        collab=[f"C{j}" for j in range(n)],
    )


def random_bounded_qp(m: int, n: int, density: float = 0.02,
                      seed: int = 0) -> LP:
    lp = random_bounded_lp(m, n, density=density, seed=seed)
    rng = np.random.default_rng(seed + 1)
    diag = rng.uniform(10.0, 20.0, n)
    band = rng.uniform(-4.0, 4.0, n - 1)     # Q[j, j+1] = Q[j+1, j]
    # full symmetric storage in CSC, rows ascending in each column
    iQ, Q, kQ = [], [], [0]
    for j in range(n):
        for i, v in ((j - 1, band[j - 1] if j else 0.0), (j, diag[j]),
                     (j + 1, band[j] if j + 1 < n else 0.0)):
            if 0 <= i < n:
                iQ.append(i)
                Q.append(v)
        kQ.append(len(Q))
    return dataclasses.replace(
        lp, name=f"RANDQ{m}", Q=np.asarray(Q), iQ=np.asarray(iQ, np.int64),
        kQ=np.asarray(kQ, np.int64), qnz=len(Q))
