"""The UbTail operands built straight from the CSC (core/ubtail.py) against
slices of the dense canonical form (core/canonicalize.canonicalize, the
copy the host tests hold equal to the JAX package's).

For every LP: ubtail.applies says what _hsd_structure_applies says of the
dense form; where it holds, every CanonLP field but A is bitwise equal,
so are the padded operands (A1, b, c, idx2, w2, signed zeros included)
and recover_solution's outputs.  Where a lower bound is finite and
nonzero, b is shifted by A l, a BLAS matvec in the dense form and a sum
over the nonzeros here: b and what reads it are then held to 4 ulps.
"""

import dataclasses

import numpy as np
import pytest

from tests.test_mps import row
from tests.test_torch_host import TEXTS
from vanderbei_tpu_torch.core import ubtail
from vanderbei_tpu_torch.core.builder import LPBuilder
from vanderbei_tpu_torch.core.canonicalize import (CanonLP, canonicalize,
                                                   recover_solution)
from vanderbei_tpu_torch.core.status import Status
from vanderbei_tpu_torch.core.ubtail import (_hsd_structure_applies,
                                             _hsd_structured_operands,
                                             size_class)
from vanderbei_tpu_torch.io.mps import read_mps
from vanderbei_tpu_torch.io.writer import write_lp
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

ULPS = 4


def _csc(A):
    cols, rows = np.nonzero(A.T)
    kA = np.concatenate([[0], np.cumsum(np.bincount(cols,
                                                    minlength=A.shape[1]))])
    return A.T[cols, rows], rows.astype(np.int64), kA.astype(np.int64)


def _general(seed, maximize=False, lower=False, free=False, ranged=True,
             m=14, n=30):
    """Equality, ranged and one-sided rows, finite upper bounds on most
    columns; lower: finite nonzero lower bounds; free: free columns
    without upper bounds."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.3, rng.normal(size=(m, n)), 0.0)
    vals, iA, kA = _csc(A)
    r = rng.choice([0.0, np.inf, 2.5] if ranged else [np.inf], m)
    u = np.where(rng.random(n) < 0.8, rng.uniform(1.0, 4.0, n), np.inf)
    l = np.where(rng.random(n) < 0.5, rng.uniform(-2.0, 0.5, n), 0.0) \
        if lower else np.zeros(n)
    u = np.where(np.isfinite(u), l + u, u)
    if free:
        l = np.where(np.isinf(u) & (rng.random(n) < 0.7), -np.inf, l)
    return dataclasses.replace(
        random_bounded_lp(m, n, seed=seed), A=vals, iA=iA, kA=kA,
        b=rng.normal(size=m), c=rng.normal(size=n), f=0.25, r=r, l=l, u=u,
        maximize=maximize)


def _messy_csc(seed):
    """A random LP whose CSC holds duplicates (some cancelling), explicit
    zeros of both signs and rows out of order within a column."""
    lp = _general(seed, m=20, n=40)
    rng = np.random.default_rng(seed + 100)
    cols = np.repeat(np.arange(lp.n), np.diff(lp.kA))
    vals, rows = list(lp.A), list(lp.iA)
    cols = list(cols)
    for j in rng.choice(lp.n, 12, replace=False):
        i = int(rng.integers(lp.m))
        a = float(rng.normal())
        vals += [a, -a if j % 3 == 0 else 0.3 * a, 0.0, -0.0]
        rows += [i, i, int(rng.integers(lp.m)), int(rng.integers(lp.m))]
        cols += [j, j, j, j]
    order = np.argsort(np.asarray(cols), kind="stable")
    cols = np.asarray(cols)[order]
    kA = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=lp.n))])
    vals, rows = np.asarray(vals)[order], np.asarray(rows)[order]
    for j in range(0, lp.n, 5):          # reverse some columns' rows
        rows[kA[j]:kA[j + 1]] = rows[kA[j]:kA[j + 1]][::-1].copy()
        vals[kA[j]:kA[j + 1]] = vals[kA[j]:kA[j + 1]][::-1].copy()
    return dataclasses.replace(lp, A=vals, iA=rows.astype(np.int64),
                               kA=kA.astype(np.int64))


def _diet():
    lpb = LPBuilder(name="diet")
    lpb.var("x1", obj=2.0, upper=8.0)
    lpb.var("x2", upper=4.0, obj=3.0)
    lpb.var("x3", obj=1.0)
    lpb.constraint("protein", {"x1": 1.0, "x2": 2.0, "x3": 1.0}, lo=10.0)
    lpb.constraint("mix", {"x1": 1.0, "x3": -1.0}, lo=0.0, hi=2.0)
    return lpb.build()


def _builder_free(with_ub):
    lpb = LPBuilder("free", maximize=True)
    lpb.var("x", lower=-np.inf, upper=3.0 if with_ub else np.inf, obj=-1.0)
    lpb.var("y", upper=5.0, obj=1.0)
    lpb.var("z", lower=1.0, upper=6.0, obj=0.5)
    lpb.constraint("r1", {"x": 1.0, "y": 1.0}, lo=-2.0, hi=4.0)
    lpb.constraint("r2", {"x": -1.0, "z": 2.0}, hi=7.0)
    return lpb.build()


# an MPS text that takes the structure: MAX, a ranged, an equality and
# a <= row over four columns, upper, fixed, shifted and free bounds
BOXED = [
    "MAX", "NAME          BOXED", "ROWS", row("N", "obj"), row("G", "g1"),
    row("E", "e1"), row("L", "l1"), "COLUMNS",
    row("", "a", "obj", 1.0, "g1", 2.0), row("", "a", "e1", 1.0),
    row("", "b", "obj", -1.0, "g1", 1.0), row("", "b", "l1", 3.0),
    row("", "c", "obj", 2.0, "e1", -1.0), row("", "c", "l1", 1.0),
    row("", "d", "obj", 0.5, "g1", -1.0), row("", "d", "l1", 2.0),
    row("", "e", "obj", 1.5, "e1", 1.0),
    "RHS", row("", "rhs", "g1", 1.0, "e1", 2.0), row("", "rhs", "l1", 9.0),
    "RANGES", row("", "rng", "g1", 4.0),
    "BOUNDS", row("UP", "bnd", "a", 4.0), row("UP", "bnd", "b", 3.0),
    row("FX", "bnd", "c", 1.5), row("LO", "bnd", "d", 1.0),
    row("UP", "bnd", "d", 5.0), row("FR", "bnd", "e"), "ENDATA"]


def _mps(tmp_path, key):
    p = tmp_path / f"{key}.mps"
    p.write_text("\n".join(BOXED if key == "boxed" else TEXTS[key]) + "\n")
    return read_mps(str(p), engine="python")


def _round_trip(tmp_path, engine):
    """A random LP written as MPS and read back."""
    p = tmp_path / "rand.mps"
    write_lp(_general(13, m=12, n=25), str(p))
    return read_mps(str(p), engine=engine)


# name -> (lp maker taking tmp_path, free_vars); each checked at both scales
CASES = {
    **{f"mps-{key}-{fv}": (lambda t, key=key: _mps(t, key), fv)
       for key in [*sorted(TEXTS), "boxed"] for fv in ("reject", "split")},
    "mps-written-python": (lambda t: _round_trip(t, "python"), "reject"),
    "mps-written-native": (lambda t: _round_trip(t, "native"), "reject"),
    "builder-diet": (lambda t: _diet(), "reject"),
    "builder-free-no-ub": (lambda t: _builder_free(False), "split"),
    "builder-free-ub": (lambda t: _builder_free(True), "split"),
    "builder-free-reject": (lambda t: _builder_free(False), "reject"),
    "random-min": (lambda t: _general(1), "reject"),
    "random-max": (lambda t: _general(2, maximize=True), "reject"),
    "random-le-rows": (lambda t: _general(3, ranged=False), "reject"),
    "random-free-split": (lambda t: _general(4, free=True), "split"),
    "random-free-split-max": (lambda t: _general(5, maximize=True,
                                                 free=True), "split"),
    "random-lower-bounds": (lambda t: _general(6, lower=True), "reject"),
    "random-lower-free": (lambda t: _general(7, lower=True, free=True),
                          "split"),
    "random-too-many-rows": (lambda t: _general(8, m=30, n=32), "reject"),
    "random-no-ub": (lambda t: dataclasses.replace(
        _general(9), u=np.full(30, np.inf)), "reject"),
    "messy-csc": (lambda t: _messy_csc(10), "reject"),
    "messy-csc-max": (lambda t: dataclasses.replace(
        _messy_csc(11), maximize=True), "split"),
}
# the cases where the dense form does not take the structure (or aborts):
# no finite upper bound, more head rows than columns, a free column with
# an upper bound, a free column rejected, a QUADS section
FALLS_BACK = {
    "builder-free-reject", "builder-free-ub", "random-no-ub",
    "random-too-many-rows", "mps-boxed-reject",
    *(f"mps-{key}-{fv}" for key in TEXTS for fv in ("reject", "split"))}


def _same(a, b, name, ulps=None):
    """Bitwise equal (dtype, shape, bytes); to `ulps` where given."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    if ulps is None:
        assert a.tobytes() == b.tobytes(), name
    else:
        np.testing.assert_array_max_ulp(a, b, maxulp=ulps)


def _check(lp, scale, free_vars, N=None):
    """Hold the builder to the dense form on one LP; returns whether the
    structure applied."""
    dense = canonicalize(lp, pad_to=1, free_vars=free_vars, scale=scale)
    applies = (dense.status == int(Status.RUNNING)
               and _hsd_structure_applies(dense))
    assert ubtail.applies(lp, free_vars) == applies
    if not applies:
        return False
    got = ubtail.build(lp, scale=scale, free_vars=free_vars)
    assert isinstance(got, ubtail.UbCanon) and got.A is None
    shifted = bool(np.any(got.l))
    ulps = ULPS if shifted else None
    for f in dataclasses.fields(CanonLP):
        want, have = getattr(dense, f.name), getattr(got, f.name)
        if f.name == "A":
            continue
        if isinstance(want, np.ndarray) or isinstance(have, np.ndarray):
            _same(want, have, f.name, ulps if f.name == "b" else None)
        else:
            assert want == have, f.name
    assert np.all(got.head[2] != 0)
    want, have = (_hsd_structured_operands(dense, N=N),
                  _hsd_structured_operands(got, N=N))
    assert want.keys() == have.keys()
    for key in want:
        _same(want[key], have[key], key, ulps if key == "b" else None)
    rng = np.random.default_rng(lp.m * 1000 + lp.n)
    x, z = rng.random(got.n), rng.random(got.n)
    y, w = rng.random(got.m), rng.random(got.m)
    for i, (a, b) in enumerate(zip(recover_solution(dense, x, y, w, z),
                                   recover_solution(got, x, y, w, z))):
        if shifted and i in (5, 6):       # dual_obj and b_canon read b
            np.testing.assert_allclose(a, b, rtol=ULPS * 2.0 ** -52 * 8)
        else:
            _same(a, b, f"recover_solution[{i}]")
    return True


@pytest.mark.parametrize("scale", ["geometric", "none"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_builder_equals_dense_form(tmp_path, name, scale):
    make, free_vars = CASES[name]
    applied = _check(make(tmp_path), scale, free_vars)
    assert applied == (name not in FALLS_BACK)


@pytest.mark.parametrize("ranks", [2, 3])
def test_mesh_column_padding(ranks):
    """The head's columns padded to a multiple of the mesh's model ranks,
    as _solve_hsd pads them under a mesh."""
    lp = _general(12, m=20, n=50)
    N = -(-size_class(lp.n) // ranks) * ranks
    assert _check(lp, "geometric", "reject", N=N)


@pytest.mark.parametrize("shape", ["pilot87", "class"])
def test_benchmark_shapes(shape):
    """PILOT87's 2030 x 4883, and the batch cells' class of 16 lanes
    (560 + 4j) x (1100 + 9j) padded to the class's (1024, 1536, 1536)."""
    if shape == "pilot87":
        assert _check(random_bounded_lp(2030, 4883, seed=87), "geometric",
                      "reject")
        return
    for j in range(16):
        lp = random_bounded_lp(560 + 4 * j, 1100 + 9 * j, seed=j)
        dense = canonicalize(lp, scale="geometric")
        got = ubtail.build(lp, scale="geometric")
        for key, a in _hsd_structured_operands(dense, 1024, 1536,
                                               1536).items():
            _same(a, _hsd_structured_operands(got, 1024, 1536, 1536)[key],
                  key)
