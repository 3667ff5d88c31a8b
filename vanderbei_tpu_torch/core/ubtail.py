"""The UbTail operands of the hsd family built straight from an LP's CSC
arrays: no dense canonical A, no upper-bound rows.

The structured hsd path (ops/kkt.UbTail) solves on a head A1 (the m0
negated original rows and the appended range rows, padded to (M1, N)) and
a tail of singleton upper-bound rows given as column indices idx2 and
weights w2 (K each).  core/canonicalize.canonicalize builds the whole
dense canonical form first, upper-bound rows included, and the padded
operands are then cut out of it; here the same numbers come from the
nonzeros alone:

1. CSC duplicates summed in CSC order (as LP.dense_A's np.add.at), zero
   entries dropped;
2. the original rows negated, the range rows' copies appended, the split
   free columns' mirrors appended (-A_j), all as triples;
3. geometric equilibration over the head's triples plus the k unit
   singletons of the tail: the same segment max/min, passes and
   power-of-two snap as canonicalize._geometric_equilibrate, which reads
   the same nonzeros out of the dense form;
4. b and c normalized by powers of two, w2 = row_scale[tail] *
   col_scale[ub_cols].

Every step is elementwise or an order-free segment max/min, so the padded
operands are bitwise those of canonicalize + _hsd_structured_operands
(the empty entries' signed zeros included), as long as every lower bound
is 0; a finite nonzero lower bound shifts b by A l, which the dense form
computes with a BLAS matvec and this module with a sum over the
nonzeros, so b may then differ in its last bits.

`canonical` picks the builder from what the LP shows (no Q, a finite
upper bound, no split free column with one, head rows <= columns: the
conditions of _hsd_structure_applies, read off the bound vectors) and
falls back to canonicalize for everything else.  On either form,
_hsd_structure_applies decides whether an LP takes the tail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.profiling import count, span
from .canonicalize import CanonLP, canonicalize
from .lp import LP, INF
from .status import Status


@dataclasses.dataclass
class UbCanon(CanonLP):
    """A CanonLP built by `build`: A is None.  b, c, the scales and the
    index vectors are those canonicalize gives (b over all m canonical
    rows, the tail's last); `head` holds the scaled head A1[:m1, :n] as
    (rows, cols, vals) without its zeros, `w2` the tail's k weights."""

    head: tuple = None
    w2: np.ndarray = None


def _bounds(lp: LP):
    """(l with free columns at 0, u shifted by l, the free columns), as
    canonicalize computes them."""
    l = np.array(lp.l if lp.l is not None else np.zeros(lp.n),
                 dtype=np.float64)
    u = np.array(lp.u if lp.u is not None else np.full(lp.n, INF),
                 dtype=np.float64)
    free_cols = np.nonzero(np.isneginf(l))[0]
    l = np.where(np.isneginf(l), 0.0, l)
    return l, np.where(np.isfinite(u), u - l, u), free_cols


def applies(lp: LP, free_vars: str = "reject") -> bool:
    """Whether canonicalize(lp) would take the UbTail structure
    (_hsd_structure_applies) and not abort."""
    if lp.qnz and lp.Q is not None:
        return False
    _, u_shift, free_cols = _bounds(lp)
    if len(free_cols) and free_vars == "reject":
        return False
    ub = np.isfinite(u_shift)
    if not ub.any() or ub[free_cols].any():
        return False
    r = lp.r if lp.r is not None else np.zeros(lp.m)
    return lp.m + int(np.isfinite(r).sum()) <= lp.n + len(free_cols)


def _entries(lp: LP):
    """A's nonzeros as (rows, cols, vals), duplicates summed in CSC order
    as LP.dense_A sums them."""
    kA = np.asarray(lp.kA, dtype=np.int64)
    lo, hi = int(kA[0]), int(kA[lp.n])
    rows = np.asarray(lp.iA[lo:hi], dtype=np.int64)
    cols = np.repeat(np.arange(lp.n), np.diff(kA[:lp.n + 1]))
    vals = np.asarray(lp.A[lo:hi], dtype=np.float64)
    key = cols * lp.m + rows
    if len(key) > 1 and not (np.diff(key) > 0).all():
        key, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(len(key))
        np.add.at(summed, inv, vals)
        rows, cols, vals = key % lp.m, key // lp.m, summed
    else:
        vals = vals + 0.0        # dense_A's sum starts at +0.0
    keep = vals != 0
    return rows[keep], cols[keep], vals[keep]


def _equilibrate(rr, cc, av, m, n, passes=4):
    """Row and column scales of canonicalize._geometric_equilibrate, from
    the nonzeros' magnitudes av at (rr, cc) of an (m, n) matrix."""
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
    r = np.exp2(np.round(np.log2(np.where(r > 0, r, 1.0))))
    s = np.exp2(np.round(np.log2(np.where(s > 0, s, 1.0))))
    return r, s


def build(lp: LP, scale: str = "none", free_vars: str = "reject",
          dtype=np.float64) -> UbCanon:
    """The UbCanon of an LP for which applies(lp, free_vars) holds, equal
    field for field to canonicalize(lp, pad_to=1, dtype=dtype,
    free_vars=free_vars, scale=scale) but for A."""
    m, n = lp.m, lp.n
    ranges = np.asarray(lp.r if lp.r is not None else np.zeros(m))
    b = np.array(lp.b, dtype=np.float64, copy=True)
    c = np.array(lp.c, dtype=np.float64, copy=True)
    l, u_shift, free_cols = _bounds(lp)
    rows, cols, vals = _entries(lp)
    if l.any():
        b = b - np.bincount(rows, weights=vals * l[cols], minlength=m)
    f = float(lp.f) + float(c @ l)

    range_rows = np.nonzero(np.isfinite(ranges))[0]
    ub_cols = np.nonzero(np.isfinite(u_shift))[0]
    k, nf = len(ub_cols), len(free_cols)
    m1, n_ext = m + len(range_rows), n + nf
    m_canon = m1 + k

    # the head: -A, then A's range rows, then -A_j of each free column j
    at = np.full(m, -1)
    at[range_rows] = np.arange(len(range_rows))
    ranged = at[rows] >= 0
    hr = np.concatenate([rows, m + at[rows[ranged]]])
    hc = np.concatenate([cols, cols[ranged]])
    hv = np.concatenate([-vals, vals[ranged]])
    if nf:
        at = np.full(n, -1)
        at[free_cols] = np.arange(nf)
        mirror = at[hc] >= 0
        hr = np.concatenate([hr, hr[mirror]])
        hc = np.concatenate([hc, n + at[hc[mirror]]])
        hv = np.concatenate([hv, -hv[mirror]])
    hv = hv.astype(dtype)
    keep = hv != 0
    hr, hc, hv = hr[keep], hc[keep], hv[keep]

    bc = np.empty(m_canon, dtype=dtype)
    bc[:m] = -b
    bc[m:m1] = b[range_rows] + ranges[range_rows]
    bc[m1:] = u_shift[ub_cols]
    sign = 1.0 if lp.maximize else -1.0
    cc = np.empty(n_ext, dtype=dtype)
    cc[:n] = sign * c
    cc[n:] = -cc[free_cols]
    f = sign * f
    w2 = np.ones(k, dtype=dtype)

    row_scale = col_scale = None
    b_scale = c_scale = 1.0
    if scale == "geometric":
        tail = np.arange(m1, m_canon)
        row_scale, col_scale = _equilibrate(
            np.concatenate([hr, tail]), np.concatenate([hc, ub_cols]),
            np.abs(np.concatenate([hv, w2])), m_canon, n_ext)
        hv *= row_scale[hr] * col_scale[hc]
        w2 *= row_scale[tail] * col_scale[ub_cols]
        bc *= row_scale
        cc *= col_scale
        bmax = float(np.abs(bc).max())
        cmax = float(np.abs(cc).max()) if n_ext else 0.0
        if bmax > 0:
            b_scale = float(np.exp2(np.round(np.log2(bmax))))
            bc /= b_scale
        if cmax > 0:
            c_scale = float(np.exp2(np.round(np.log2(cmax))))
            cc /= c_scale

    return UbCanon(
        A=None, b=bc, c=cc, f=f, m=m_canon, n=n_ext, m0=m,
        maximize=lp.maximize, l=l, range_rows=range_rows.astype(np.int64),
        ub_cols=ub_cols.astype(np.int64), status=int(Status.RUNNING),
        n_orig=n, free_cols=free_cols.astype(np.int64),
        row_scale=row_scale, col_scale=col_scale, b_scale=b_scale,
        c_scale=c_scale, head=(hr, hc, hv), w2=w2)


def canonical(lp: LP, structured: bool, scale: str = "none",
              free_vars: str = "reject", dtype=np.float64) -> CanonLP:
    """The canonical form of lp inside a `canonicalize` span: build(lp)
    where `structured` (the hsd family on its UbTail path) and the
    structure applies, else canonicalize(lp, pad_to=1); the counters
    canonicalize.structured and canonicalize.dense say which."""
    with span("canonicalize"):
        if structured and applies(lp, free_vars):
            count("canonicalize.structured")
            return build(lp, scale=scale, free_vars=free_vars, dtype=dtype)
        count("canonicalize.dense")
        return canonicalize(lp, pad_to=1, dtype=dtype, free_vars=free_vars,
                            scale=scale)


def fill(canon: CanonLP, A1, b, c, idx2, w2) -> None:
    """Write a structured canon's UbTail operands into padded arrays that
    hold zeros (A1 (M1, N), c (N), idx2 and w2 (K)) and ones (b (M1 + K)):
    one LP's, or one lane of a stacked class.  A dense CanonLP's are cut
    out of its A; a UbCanon's are scattered from its triples over the
    signed zeros that canonicalize's -A leaves in the empty entries."""
    k = len(canon.ub_cols)
    m1, n, M1 = canon.m - k, canon.n, A1.shape[0]
    if isinstance(canon, UbCanon):
        m0, n0 = canon.m0, canon.n_orig
        A1[:m0, :n0] = -0.0
        A1[m0:m1, n0:n] = -0.0
        rows, cols, vals = canon.head
        A1[rows, cols] = vals
        w2[:k] = canon.w2
    else:
        A1[:m1, :n] = canon.A[:m1, :n]
        w2[:k] = canon.A[np.arange(m1, m1 + k), canon.ub_cols]
    b[:m1] = canon.b[:m1]
    b[M1:M1 + k] = canon.b[m1:m1 + k]
    c[:n] = canon.c[:n]
    idx2[:k] = canon.ub_cols


def size_class(dim: int, floor: int = 256) -> int:
    """Padded size class for dim: powers of two up to 2048, then multiples
    of 512 (vanderbei_tpu.models.registry.size_class)."""
    if dim > 2048:
        return ((dim + 511) // 512) * 512
    c = floor
    while c < dim:
        c *= 2
    return c


def _hsd_structure_applies(canon: CanonLP) -> bool:
    k = len(canon.ub_cols)
    if not (k > 0 and canon.Q is None and (canon.m - k) <= canon.n):
        return False
    # a split free variable with a finite upper bound mirrors -1 into its
    # ub row, so that tail row is NOT a singleton: fall back to dense
    if canon.free_cols is not None and len(canon.free_cols):
        if np.intersect1d(canon.free_cols, canon.ub_cols).size:
            return False
    return True


def _hsd_structured_operands(canon: CanonLP, M1: int | None = None,
                             K: int | None = None, N: int | None = None):
    """Split the canonical rows into [general head | singleton ub tail],
    each padded to its own size class, for the Schur-eliminated KKT path
    (ops/kkt.UbTail), from a dense CanonLP or a UbCanon.
    Returns None when the structure doesn't apply."""
    if not _hsd_structure_applies(canon):
        return None
    k = len(canon.ub_cols)
    m1 = canon.m - k
    n = canon.n
    M1 = M1 if M1 is not None else size_class(m1)
    K = K if K is not None else size_class(k)
    N = N if N is not None else size_class(n)
    dtype = canon.b.dtype
    A1 = np.zeros((M1, N), dtype=dtype)
    b = np.ones(M1 + K, dtype=dtype)
    c = np.zeros(N, dtype=dtype)
    idx2 = np.zeros(K, dtype=np.int32)
    w2 = np.zeros(K, dtype=dtype)
    fill(canon, A1, b, c, idx2, w2)
    return dict(A1=A1, b=b, c=c, idx2=idx2, w2=w2, m1=m1, k=k, M1=M1, K=K)
