"""Problem containers (a copy of vanderbei_tpu/core/lp.py; `Solution`
adds the per-stage record `stages`).

``LP`` is the host-side problem description produced by the MPS reader —
the semantic mirror of the reference's LP struct (src/common/lp.h:34-117):

    optimize c'x + f    s.t.  b <= Ax <= b + r,   l <= x <= u

with an optional symmetric quadratic term Q (the QUADS MPS extension).  The
constraint matrix is kept in CSC triplet arrays on the host; device solvers
consume dense padded views built by ``core.canonicalize``.

``Solution`` carries the primal/dual vectors the reference's solver() ABI
returns (x, y, w, z — e.g. src/ipo/hsd.c:27-29) plus objectives and status.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INF = float("inf")

# varsgn markers (reference iolp.c:423,566-576)
VAR_REAL = 1
VAR_INTEGER = 2
VAR_SEMICONT = 3


@dataclasses.dataclass
class LP:
    """Host-side LP/QP problem in the reference's pre-canonical form."""

    name: str = ""
    m: int = 0                      # rows (constraints)
    n: int = 0                      # cols (variables)
    # CSC storage of A (m x n): A[kA[j]:kA[j+1]] are column j's values,
    # iA[kA[j]:kA[j+1]] the row indices.
    A: np.ndarray = None
    iA: np.ndarray = None
    kA: np.ndarray = None
    b: np.ndarray = None            # rhs (m,)
    c: np.ndarray = None            # objective (n,)
    f: float = 0.0                  # objective constant shift
    r: np.ndarray = None            # ranges: b <= Ax <= b+r (m,), inf allowed
    l: np.ndarray = None            # lower bounds (n,)
    u: np.ndarray = None            # upper bounds (n,)
    # Symmetric quadratic objective term, CSC (QUADS extension, iolp.c:583-645)
    Q: np.ndarray = None
    iQ: np.ndarray = None
    kQ: np.ndarray = None
    qnz: int = 0
    varsgn: np.ndarray = None       # per-var: VAR_REAL/INTEGER/SEMICONT
    rowlab: list = dataclasses.field(default_factory=list)
    collab: list = dataclasses.field(default_factory=list)
    maximize: bool = False          # MAX keyword (reference max = -1)
    # solver/IO parameters parsed from MPS header keywords (iolp.c:167-183)
    # or set by the caller; defaults mirror openlp (iolp.c:59-106).
    inftol: float = 1.0e-5
    sf_req: int = 8
    verbose: int = 2
    itnlim: int = 200
    timlim: float = INF
    obj_name: str = ""
    rhs_name: str = ""
    ranges_name: str = ""
    bounds_name: str = ""
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def nz(self) -> int:
        return 0 if self.A is None else len(self.A)

    def dense_A(self) -> np.ndarray:
        """Densify CSC A into an (m, n) float64 array (duplicates summed)."""
        out = np.zeros((self.m, self.n), dtype=np.float64)
        for j in range(self.n):
            lo, hi = self.kA[j], self.kA[j + 1]
            np.add.at(out[:, j], self.iA[lo:hi], self.A[lo:hi])
        return out

    def dense_Q(self) -> Optional[np.ndarray]:
        if self.qnz == 0 or self.Q is None:
            return None
        out = np.zeros((self.n, self.n), dtype=np.float64)
        for j in range(self.n):
            lo, hi = self.kQ[j], self.kQ[j + 1]
            np.add.at(out[:, j], self.iQ[lo:hi], self.Q[lo:hi])
        return out


@dataclasses.dataclass
class Solution:
    """Result of a solve, in the ORIGINAL problem's coordinates.

    Mirrors what solvelp leaves in the reference LP struct after the
    solver returns (solve.c:237-256): x/z over original columns, y/w over
    the canonicalized rows (first m0 rows printed by writesol).
    """

    status: int
    x: np.ndarray                   # primal values (n,)
    y: np.ndarray                   # dual values for the first m0 rows
    w: np.ndarray                   # primal slacks for canonical rows
    z: np.ndarray                   # reduced costs (n,)
    primal_obj: float
    dual_obj: float
    iterations: int = 0
    solve_time_s: float = 0.0
    # canonical-space b (negated originals) for writesol's OB check
    b_canon: np.ndarray = None
    # one dict per precision stage the solve ran, in order: precision,
    # iterations, seconds, paused (see models/staged.timed)
    stages: list = None

    @property
    def objective(self) -> float:
        return self.primal_obj
