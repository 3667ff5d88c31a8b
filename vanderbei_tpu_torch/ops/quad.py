"""Double-double ("Quad") arithmetic by error-free transforms on torch
tensors, the port of vanderbei_tpu/ops/quad.py.

The reference's QuadPrec mode (src/Quad/Quad.{h,c}: Knuth two-sum,
Dekker-split products) becomes a (hi, lo) pair carried through elementwise
tensor ops, at f64 (about 32 significant digits) or f32.  No FMA is
assumed: products use the Dekker split.

Every step is its own torch op, in the order written.  An error-free
transform breaks if a product and a sum are contracted into one FMA or
reassociated, so this module uses no `alpha=` argument, no
`addcmul`/`addcdiv`, and must never run under `torch.compile`, which may
fuse the steps.  Separate eager kernels round each result to the dtype.

Compensated reductions (dot2, sum2, matvec2) are as accurate as evaluating
in twice the working precision, then rounding once; their pairwise trees
are the JAX package's, so the two agree to the last bit or so.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DD(NamedTuple):
    """Unevaluated sum hi + lo with |lo| <= ulp(hi)/2."""
    hi: torch.Tensor
    lo: torch.Tensor


def _split_const(dtype) -> float:
    # 2^s + 1 with s = ceil(p/2): 27 for f64 (Quad.c's 134217729), 12 for f32
    if dtype == torch.float64:
        return 134217729.0
    if dtype == torch.float32:
        return 4097.0
    raise ValueError(f"unsupported dtype {dtype}")


def two_sum(a, b):
    """Error-free a+b (Knuth): returns (s, err) with s+err == a+b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a+b assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Dekker split of a into high/low halves (Quad.c multstep)."""
    c = _split_const(a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free a*b: returns (p, err) with p+err == a*b exactly."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# --- DD arithmetic -------------------------------------------------------

def dd(x) -> DD:
    x = torch.as_tensor(x)
    return DD(x, torch.zeros_like(x))


def dd_add(x: DD, y: DD) -> DD:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    hi, lo = fast_two_sum(s, e)
    return DD(hi, lo)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    hi, lo = fast_two_sum(p, e)
    return DD(hi, lo)


def dd_div(x: DD, y: DD) -> DD:
    q1 = x.hi / y.hi
    r = dd_sub(x, dd_mul(dd(q1), y))
    q2 = r.hi / y.hi
    r = dd_sub(r, dd_mul(dd(q2), y))
    q3 = r.hi / y.hi
    hi, lo = fast_two_sum(q1, q2)
    return dd_add(DD(hi, lo), dd(q3))


def _pad_pow2(t, dim: int):
    """Zero-pad dimension `dim` (>= 0) of t up to a power of two."""
    n = t.shape[dim]
    width = 1 << max(0, (n - 1).bit_length())
    if width == n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, width - n]
    return torch.nn.functional.pad(t, pad)


def _tree(hi, lo, dim: int) -> DD:
    """Pairwise dd_add reduction of (hi, lo) along dim (>= 0), halving a
    power-of-two width until one entry is left (log depth)."""
    hi, lo = _pad_pow2(hi, dim), _pad_pow2(lo, dim)
    while hi.shape[dim] > 1:
        half = hi.shape[dim] // 2
        s = dd_add(DD(hi.narrow(dim, 0, half), lo.narrow(dim, 0, half)),
                   DD(hi.narrow(dim, half, half), lo.narrow(dim, half, half)))
        hi, lo = s.hi, s.lo
    return DD(hi.select(dim, 0), lo.select(dim, 0))


def dd_sum(x: DD) -> DD:
    """Tree-reduce all elements of a DD array with dd_add."""
    return _tree(x.hi.reshape(-1), x.lo.reshape(-1), 0)


# --- compensated reductions (work in single words, DD internally) --------
#
# The *_dd forms stop before the final rounding: their (hi, lo) is a
# partial sum that a cross-rank reduction (parallel/distributed.py
# ColumnShards.sum2) can finish without losing the cancellation between
# the ranks; dot2/matvec2 are those forms rounded once, hi + lo.

def dot2_dd(a, b) -> DD:
    """The compensated dot product along the last dim, unrounded."""
    p, e = two_prod(a, b)
    return _tree(p, e, p.dim() - 1)


def dot2(a, b) -> torch.Tensor:
    """Compensated dot product along the last dim (one per lane of a
    batch): as if computed in 2x working precision then rounded
    (Ogita-Rump-Oishi Dot2, vectorized as a tree)."""
    s = dot2_dd(a, b)
    return s.hi + s.lo


def matvec2_dd(A, x) -> DD:
    """The compensated A @ x of matvec2, unrounded."""
    if x.dim() < A.dim():
        return dot2_dd(A, x.unsqueeze(-2))
    cols = [dot2_dd(A, x[..., j].unsqueeze(-2)) for j in range(x.shape[-1])]
    return DD(torch.stack([s.hi for s in cols], dim=-1),
              torch.stack([s.lo for s in cols], dim=-1))


def matvec2(A, x) -> torch.Tensor:
    """Compensated A @ x: every row evaluated as if in 2x working
    precision, then rounded once (row-wise Dot2), the port's counterpart
    of the reference's QuadPrec residual kernels.

    A is (..., m, n); x is (..., n) or (..., n, k).  A (..., n, k)
    right-hand side is done one column at a time, what the JAX package's
    vmap over columns computes, so the working memory is that of one
    column: the product and error planes
    and the split's temporaries, about six (rows, n) planes at peak.  At
    the smoke LP's f64 head (2560 x 4096, 84 MB a plane) that is about
    0.5 GB; a (rows, n, k) broadcast would take k times as much.
    """
    s = matvec2_dd(A, x)
    return s.hi + s.lo


def sum2(a) -> torch.Tensor:
    """Compensated sum of an array."""
    s = dd_sum(dd(a))
    return s.hi + s.lo


def norm2sq(a) -> torch.Tensor:
    return dot2(a, a)
