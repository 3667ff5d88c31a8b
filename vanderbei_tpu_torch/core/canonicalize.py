"""Standard-form canonicalization (a numpy-only copy of
vanderbei_tpu/core/canonicalize.py; the tests hold the two array-for-array
equal).

Re-implements the algebra of the reference's solvelp (src/common/solve.c:28-258)
as pure array transforms producing a *dense* canonical LP:

    maximize  c'x + f~      s.t.  A~ x <= b~,   x >= 0

built from the general form  opt c'x + f,  b <= Ax <= b+r,  l <= x <= u  by:

1. reject l_j = -inf  ->  Status.DUAL_UNBOUNDED (3), exactly as the
   reference does (solve.c:79-87 returns 3; the evaluate tables' "dual
   unbounded" rows for free-variable netlib instances come from here).
2. shift x <- x - l (solve.c:101-112): u -= l, b -= A l, f += c'l.
3. every row becomes  -A_i x <= -b_i ; rows with finite range additionally
   append  A_i x <= b_i + r_i  (solve.c:117-147; equality rows have r=0 so
   they become an inequality pair).
4. each finite upper bound appends a row  x_j <= u_j  (solve.c:152-174).
5. min problems are negated to max (solve.c:202-205).

The canonical row order matches the reference exactly: the m0 negated
original rows, then the appended range rows (in original row order), then
the upper-bound rows (in column order).  This makes y/w/b indexable the same
way writesol indexes them.

The dense matrix is materialized padded to the requested multiple; `m`/`n`
carry the true sizes and the padding is benign (zero rows with b=1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .lp import LP, INF
from .status import Status


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass
class CanonLP:
    """Dense canonical LP: maximize c'x + f s.t. Ax <= b, x >= 0 (padded)."""

    A: np.ndarray            # (mp, np_) dense, rows/cols beyond (m, n) zero
    b: np.ndarray            # (mp,)   padding rows get b = 1 (benign)
    c: np.ndarray            # (np_,)  padding cols get c = 0
    f: float
    m: int                   # true canonical row count
    n: int                   # true column count (n_orig + split mirrors)
    m0: int                  # original row count (pre range/ub expansion)
    maximize: bool           # original problem sense
    l: np.ndarray            # original lower bounds (n_orig,) for un-shift
    range_rows: np.ndarray   # original row idx of each appended range row
    ub_cols: np.ndarray      # column idx of each appended upper-bound row
    status: int = int(Status.RUNNING)   # set when canonicalization aborts
    # free-variable splitting (free_vars="split"): column j in free_cols has
    # a mirror at n_orig + k carrying -A_j, -c_j; x_j = x+_j - x-_k
    n_orig: int = 0
    free_cols: np.ndarray = None
    # quadratic objective (QUADS extension): internal form is
    # max c'x - x'Qx/2 + f with Q PSD; None for pure LPs
    Q: np.ndarray = None
    # geometric equilibration (scale="geometric"): the solver sees
    # A' = diag(row_scale) A diag(col_scale), b' = row_scale*b,
    # c' = col_scale*c; recover_solution unscales.  None = unscaled.
    row_scale: np.ndarray = None
    col_scale: np.ndarray = None
    # rhs/objective normalization (scale="geometric"): after equilibration
    # the solver additionally sees b/b_scale and c/c_scale (power-of-two
    # scalars ~ their inf-norms).  The HSD embedding initializes every
    # variable at 1 (hsd.c:98-109); with ||b|| ~ 1e8 (AGG-class) that
    # mismatch makes phi collapse ahead of feasibility and a 1e-9 rhs
    # perturbation can leave the returned point 1e-5 off (measured on
    # jiggled AGG2: st7/8.6e-6 raw vs st0/1.2e-9 normalized).  Pure
    # reparametrization: x = b_scale*x~, y = c_scale*y~, undone on recovery.
    b_scale: float = 1.0
    c_scale: float = 1.0

    @property
    def obj_scale(self) -> float:
        """Canonical objective c~'x~ times this = unnormalized c'x."""
        return self.b_scale * self.c_scale

    @property
    def mp(self) -> int:
        return self.A.shape[0]

    @property
    def np_(self) -> int:
        return self.A.shape[1]


def _geometric_equilibrate(A, m, n, passes=4):
    """Row/column geometric-mean equilibration scales for A[:m, :n].

    The reference solves netlib UNSCALED and pays for it: on NESM/SCRS8/
    GANGES-class problems (coefficient spreads of 1e6+) its achieved
    objectives miss the published optima by ~1e-6 relative.  Equilibration
    is the standard fix; it commutes exactly with the canonical form
    (x >= 0 is preserved by positive column scales) and is undone in
    recover_solution, so the user-visible problem is unchanged.
    """
    # Operate on the NONZERO triples only: the dense formulation built
    # four full (m, n) temporaries per pass (2.2 s of host time per
    # KEN-07 canonicalization, paid every bench rep); the max/min over a
    # row's positive entries equals the max/min over its nonzero
    # magnitudes, so segment reductions over the COO values are exact.
    rr, cc = np.nonzero(A[:m, :n])
    av = np.abs(A[rr, cc])
    r = np.ones(m)
    s = np.ones(n)

    def seg_scale(w, idx, size):
        mx = np.zeros(size)
        np.maximum.at(mx, idx, w)
        mn = np.full(size, np.inf)
        np.minimum.at(mn, idx, w)
        ok = (mx > 0) & np.isfinite(mn)
        prod = np.where(ok, mx * np.where(np.isfinite(mn), mn, 1.0), 1.0)
        return np.where(ok, 1.0 / np.sqrt(prod), 1.0)

    for _ in range(passes):
        r = r * seg_scale(av * r[rr] * s[cc], rr, m)
        s = s * seg_scale(av * r[rr] * s[cc], cc, n)
    # snap to powers of two: exactly representable, no rounding injected
    r = np.exp2(np.round(np.log2(np.where(r > 0, r, 1.0))))
    s = np.exp2(np.round(np.log2(np.where(s > 0, s, 1.0))))
    return r, s


def canon_dims(lp: LP, free_vars: str = "reject"):
    """(m_canon, n_canon, status) WITHOUT building the dense canonical
    arrays — the same arithmetic as canonicalize steps 1-4 on the bound
    vectors only.  Partitioning a sweep by size class needs just the dims;
    materializing an XL instance's dense form (KEN-11: ~6 GB) twice per
    sweep was the dominant startup cost.
    """
    m, n = lp.m, lp.n
    r = lp.r if lp.r is not None else np.zeros(m)
    l = np.asarray(lp.l if lp.l is not None else np.zeros(n),
                   dtype=np.float64)
    u = np.asarray(lp.u if lp.u is not None else np.full(n, INF),
                   dtype=np.float64)
    free = np.isneginf(l)
    if free.any() and free_vars == "reject":
        return 0, n, int(Status.DUAL_UNBOUNDED)
    u_shift = np.where(np.isfinite(u), u - np.where(free, 0.0, l), u)
    m_canon = (m + int(np.isfinite(r).sum())
               + int(np.isfinite(u_shift).sum()))
    n_canon = n + int(free.sum())
    return m_canon, n_canon, int(Status.RUNNING)


def canonicalize(lp: LP, pad_to: int = 1, dtype=np.float64,
                 free_vars: str = "reject",
                 pad_rows_to: int | None = None,
                 pad_cols_to: int | None = None,
                 scale: str = "none") -> CanonLP:
    """Build the dense canonical form (reference solvelp solve.c:28-205).

    pad_to: round padded dims up to this multiple (use 8/128 for TPU tiles,
    or a size-class bound for batching).  pad_rows_to / pad_cols_to instead
    pad to an absolute target dim (size-class padding; must be >= the
    canonical dims).

    free_vars: what to do with l_j = -inf columns.
      "reject" — the reference's behavior (solve.c:79-87 returns status 3,
                 which is why the evaluate tables show "dual unbounded" for
                 the free-variable netlib instances);
      "split"  — x_j = x+ - x-: append a mirrored column with -A_j, -c_j,
                 making those instances actually solvable.
    """
    m, n = lp.m, lp.n
    r = lp.r if lp.r is not None else np.zeros(m)
    l = np.array(lp.l if lp.l is not None else np.zeros(n), dtype=np.float64)
    u = np.array(lp.u if lp.u is not None else np.full(n, INF),
                 dtype=np.float64)
    b = np.array(lp.b, dtype=np.float64, copy=True)
    c = np.array(lp.c, dtype=np.float64, copy=True)
    f = float(lp.f)

    A = lp.dense_A()

    # 1. infinite lower bounds (solve.c:79-87 -> status 3) or split
    free_cols = np.nonzero(np.isneginf(l))[0]
    if len(free_cols) and free_vars == "reject":
        return CanonLP(
            A=np.zeros((0, n)), b=np.zeros(0), c=c, f=f, m=0, n=n, m0=m,
            maximize=lp.maximize, l=np.where(np.isneginf(l), 0.0, l),
            range_rows=np.zeros(0, np.int64), ub_cols=np.zeros(0, np.int64),
            status=int(Status.DUAL_UNBOUNDED), n_orig=n,
            free_cols=np.zeros(0, np.int64),
        )
    l = np.where(np.isneginf(l), 0.0, l)        # split columns shift by 0

    # 2. shift lower bounds to zero (and fold Q's cross terms into c:
    #    (x+l)'Q(x+l)/2 = x'Qx/2 + l'Qx + l'Ql/2, objective opt c'x + x'Qx/2)
    Qd = lp.dense_Q()
    u_shift = np.where(np.isfinite(u), u - l, u)
    b = b - A @ l
    f = f + float(c @ l)
    if Qd is not None:
        c = c + Qd @ l
        f = f + 0.5 * float(l @ Qd @ l)

    # 3. all rows to "<=": negate originals; ranged rows append the upper side
    range_rows = np.nonzero(np.isfinite(r))[0]
    # 4. finite upper bounds append singleton rows
    ub_cols = np.nonzero(np.isfinite(u_shift))[0]

    n_ext = n + len(free_cols)
    m_canon = m + len(range_rows) + len(ub_cols)
    mp = _round_up(max(m_canon, 1), pad_to)
    npad = _round_up(max(n_ext, 1), pad_to)
    if pad_rows_to is not None:
        if pad_rows_to < m_canon:
            raise ValueError(f"pad_rows_to={pad_rows_to} < canonical m={m_canon}")
        mp = pad_rows_to
    if pad_cols_to is not None:
        if pad_cols_to < n_ext:
            raise ValueError(f"pad_cols_to={pad_cols_to} < canonical n={n_ext}")
        npad = pad_cols_to

    Ac = np.zeros((mp, npad), dtype=dtype)
    bc = np.ones(mp, dtype=dtype)          # benign padding rows: 0'x <= 1
    cc = np.zeros(npad, dtype=dtype)

    Ac[:m, :n] = -A
    bc[:m] = -b
    Ac[m:m + len(range_rows), :n] = A[range_rows, :]
    bc[m:m + len(range_rows)] = b[range_rows] + r[range_rows]
    for k, j in enumerate(ub_cols):
        Ac[m + len(range_rows) + k, j] = 1.0
        bc[m + len(range_rows) + k] = u_shift[j]
    bc[m_canon:] = 1.0

    # 5. min -> max
    sign = 1.0 if lp.maximize else -1.0
    cc[:n] = sign * c
    f = sign * f

    # 6. mirrored columns for split free variables: -A_j, -c_j, and -1 in
    # any upper-bound row of the original (bound applies to x+ - x-)
    for k, j in enumerate(free_cols):
        jm = n + k
        Ac[:m_canon, jm] = -Ac[:m_canon, j]
        cc[jm] = -cc[j]

    # 7. quadratic term in internal max form: max c'x - x'Qx/2, so
    # Q~ = +Q for min problems, -Q for max (reference ldlt.c:253-257 adds
    # -max*Q to K's upper-left block with max = +1 min / -1 max)
    Qc = None
    if Qd is not None and lp.qnz:
        Qc = np.zeros((npad, npad), dtype=dtype)
        Qc[:n, :n] = (Qd if not lp.maximize else -Qd)
        for k, j in enumerate(free_cols):
            jm = n + k
            Qc[jm, :n_ext] = -Qc[j, :n_ext]
            Qc[:n_ext, jm] = -Qc[:n_ext, j]
            Qc[jm, jm] = Qc[j, j]

    row_scale = col_scale = None
    if scale == "geometric":
        r, s = _geometric_equilibrate(Ac, m_canon, n_ext)
        row_scale = np.ones(mp)
        col_scale = np.ones(npad)
        row_scale[:m_canon] = r
        col_scale[:n_ext] = s
        Ac *= row_scale[:, None] * col_scale[None, :]
        bc *= row_scale
        cc *= col_scale
        if Qc is not None:
            Qc *= col_scale[:, None] * col_scale[None, :]

    b_scale = c_scale = 1.0
    if scale == "geometric":
        # normalize ||b||,||c|| to ~1 (power-of-two scalars: exact):
        # x = b_scale*x~ makes the all-ones HSD start well-centered
        bmax = float(np.abs(bc[:m_canon]).max()) if m_canon else 0.0
        cmax = float(np.abs(cc[:n_ext]).max()) if n_ext else 0.0
        if bmax > 0:
            b_scale = float(np.exp2(np.round(np.log2(bmax))))
            bc[:m_canon] /= b_scale
        if cmax > 0:
            c_scale = float(np.exp2(np.round(np.log2(cmax))))
            cc[:n_ext] /= c_scale
        if Qc is not None and (b_scale != 1.0 or c_scale != 1.0):
            # objective term x'Qx/2 = b_scale*c_scale * x~'Q~x~/2 needs
            # Q~ = Q * b_scale/c_scale
            Qc *= b_scale / c_scale

    return CanonLP(
        A=Ac, b=bc, c=cc, f=f, m=m_canon, n=n_ext, m0=m,
        maximize=lp.maximize, l=l,
        range_rows=range_rows.astype(np.int64),
        ub_cols=ub_cols.astype(np.int64),
        status=int(Status.RUNNING), n_orig=n,
        free_cols=free_cols.astype(np.int64), Q=Qc,
        row_scale=row_scale, col_scale=col_scale,
        b_scale=b_scale, c_scale=c_scale,
    )


def pad_canon(canon: CanonLP, pad_rows_to: int, pad_cols_to: int) -> CanonLP:
    """Re-pad an already-canonicalized form to absolute padded dims.

    Cheaper than re-running canonicalize when only the padding target
    changed (size-class padding decided after the exact dims are known).
    Padding is benign: zero rows with b = 1, zero cost columns.
    """
    m, n = canon.m, canon.n
    if pad_rows_to < m or pad_cols_to < n:
        raise ValueError(f"pad target ({pad_rows_to},{pad_cols_to}) < "
                         f"canonical dims ({m},{n})")
    dtype = canon.A.dtype
    A = np.zeros((pad_rows_to, pad_cols_to), dtype=dtype)
    A[:m, :n] = canon.A[:m, :n]
    b = np.ones(pad_rows_to, dtype=dtype)
    b[:m] = canon.b[:m]
    c = np.zeros(pad_cols_to, dtype=dtype)
    c[:n] = canon.c[:n]
    Q = None
    if canon.Q is not None:
        Q = np.zeros((pad_cols_to, pad_cols_to), dtype=dtype)
        Q[:n, :n] = canon.Q[:n, :n]
    row_scale = col_scale = None
    if canon.row_scale is not None:
        row_scale = np.ones(pad_rows_to)
        row_scale[:m] = canon.row_scale[:m]
        col_scale = np.ones(pad_cols_to)
        col_scale[:n] = canon.col_scale[:n]
    return dataclasses.replace(canon, A=A, b=b, c=c, Q=Q,
                               row_scale=row_scale, col_scale=col_scale)


def recover_solution(canon: CanonLP, x, y, w, z):
    """Map canonical-space solver output back to original coordinates.

    Mirrors solvelp's postlude (solve.c:242-256): un-shift x by l and negate
    duals for min problems.  Objectives are reported in the ORIGINAL sense:
    the canonical (solver-view) objective c~'x~ + f~ is the negated original
    objective for min problems — the value the reference's iteration logs and
    evaluate/ tables print (hsd.c:206-208 prints primal_obj/phi + f) — so
    primal_obj = sign * (c~'x~ + f~) with sign = -1 for min.

    Returns (x, y, w, z, primal_obj, dual_obj, b_canon) with y/w/b_canon over
    the canonical rows (the first m0 of which correspond, negated, to the
    original rows — the space writesol reports in).
    """
    n, m = canon.n, canon.m
    x_canon = np.asarray(x, dtype=np.float64)[:n]
    y = np.asarray(y, dtype=np.float64)[:m]
    w = np.asarray(w, dtype=np.float64)[:m]
    z = np.asarray(z, dtype=np.float64)[:n]
    sign = 1.0 if canon.maximize else -1.0
    quad = 0.0
    if canon.Q is not None:
        quad = 0.5 * float(x_canon @ canon.Q[:n, :n] @ x_canon)
    # row/col equilibration leaves c'x invariant; the b/c normalization
    # scales the canonical objective by obj_scale = b_scale*c_scale
    primal_obj = sign * (canon.obj_scale
                         * (float(canon.c[:n] @ x_canon) - quad) + canon.f)
    # QP (Dorn) dual objective: b'y - x'Qx/2
    dual_obj = sign * (canon.obj_scale
                       * (float(canon.b[:m] @ y) - quad) + canon.f)
    b_unscaled = np.asarray(canon.b[:m], dtype=np.float64) * canon.b_scale
    # undo the b/c normalization: x = b_scale x~, w = b_scale w~,
    # y = c_scale y~, z = c_scale z~
    x_canon = canon.b_scale * x_canon
    w = canon.b_scale * w
    y = canon.c_scale * y
    z = canon.c_scale * z
    if canon.row_scale is not None:
        # undo the equilibration: x = S x', y = R y', w = w'/R, z = z'/S
        r = canon.row_scale[:m]
        s = canon.col_scale[:n]
        x_canon = s * x_canon
        y = r * y
        w = w / r
        z = z / s
        b_unscaled = b_unscaled / r
    # fold split free-variable mirrors back: x_j = x+ - x-
    n0 = canon.n_orig or n
    x_base = x_canon[:n0].copy()
    z_base = z[:n0].copy()
    if canon.free_cols is not None and len(canon.free_cols):
        nf = len(canon.free_cols)
        x_base[canon.free_cols] -= x_canon[n0:n0 + nf]
        z_base[canon.free_cols] -= z[n0:n0 + nf]
    x_out = x_base + canon.l
    y_out = y if canon.maximize else -y
    return x_out, y_out, w, z_base, primal_obj, dual_obj, b_unscaled
