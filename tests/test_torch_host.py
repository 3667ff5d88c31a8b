"""The port's numpy host layers against vanderbei_tpu's: the MPS readers,
the model builder, canonicalize, the writers and the checkpoints must give
equal output (arrays exactly equal, files byte-equal) on the same inputs."""

import dataclasses
import os

import numpy as np
import pytest

from tests.test_mps import row, simple_lines
from vanderbei_tpu.core import builder as jbuilder
from vanderbei_tpu.core import canonicalize as jcanon
from vanderbei_tpu.core import lp as jlp
from vanderbei_tpu.io import mps as jmps
from vanderbei_tpu.io import writer as jwriter
from vanderbei_tpu_torch import native as tnative
from vanderbei_tpu_torch.core import builder as tbuilder
from vanderbei_tpu_torch.core import canonicalize as tcanon
from vanderbei_tpu_torch.core import lp as tlp
from vanderbei_tpu_torch.io import mps as tmps
from vanderbei_tpu_torch.io import writer as twriter
from vanderbei_tpu_torch.utils import checkpoint as tcheckpoint
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

TEXTS = {
    "simple": simple_lines(),
    "header": [
        "MAX", "SIGFIG        6", "INFTOL        1e-7", "ITNLIM        500",
        "NAME          K", "ROWS", row("N", "obj"), row("G", "r1"),
        "COLUMNS", row("", "x", "obj", 1.0, "r1", 1.0),
        "RHS", row("", "rhs", "r1", 2.0), "ENDATA"],
    "bounds": [
        "NAME          B", "ROWS", row("N", "obj"), row("G", "r"), "COLUMNS",
        *(row("", v, "obj", 1.0, "r", 1.0) for v in "abcdef"),
        "RHS", "BOUNDS", row("FX", "BND", "a", 3.0), row("FR", "BND", "b"),
        row("MI", "BND", "c"), row("BV", "BND", "d"),
        row("LI", "BND", "e", 2.0), row("SC", "BND", "f", 9.0), "ENDATA"],
    "ranges": [
        "NAME          R", "ROWS", row("N", "obj"), row("G", "r1"),
        row("L", "r2"), "COLUMNS", row("", "x", "obj", 1.0, "r1", 1.0),
        row("", "x", "r2", 1.0), row("", "MARKER1", "'MARKER'", "", "", ""),
        row("", "y", "obj", 1.0, "r1", 2.0),
        row("", "MARKER2", "'MARKER'", "", "", ""),
        row("", "z", "obj", 1.0, "r2", 1.0),
        "RHS", row("", "rhs", "r1", 1.0, "r2", 5.0),
        "RANGES", row("", "rng", "r1", 2.0), "ENDATA"],
    "quads": [
        "NAME          Q", "ROWS", row("N", "obj"), row("G", "r"), "COLUMNS",
        row("", "x", "obj", 1.0, "r", 1.0), row("", "y", "obj", 1.0, "r", 1.0),
        "RHS", row("", "rhs", "r", 1.0), "QUADS", row("", "x", "x", 2.0),
        row("", "x", "y", 1.0), row("", "y", "y", 4.0), "ENDATA"],
    "two_n_rows": [
        "NAME          N2", "ROWS", row("N", "obj1"), row("N", "obj2"),
        row("G", "r"), "COLUMNS", row("", "x", "obj1", 5.0, "obj2", 7.0),
        row("", "x", "r", 1.0), "RHS", "ENDATA"],
}


def _write(tmp_path, key):
    p = tmp_path / f"{key}.mps"
    p.write_text("\n".join(TEXTS[key]) + "\n")
    return str(p)


def _assert_same(a, b):
    """Field-by-field equality of two dataclass instances."""
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)][:len(dataclasses.fields(a))]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name


def _jax_lp(lp):
    return jlp.LP(**{f.name: getattr(lp, f.name)
                     for f in dataclasses.fields(jlp.LP)})


def _general_lp(seed):
    """A random LP using every row and bound kind: ranges, equalities,
    shifted and free lower bounds, finite upper bounds, MAX sense."""
    rng = np.random.default_rng(seed)
    m, n = 12, 18
    A = np.where(rng.random((m, n)) < 0.4, rng.normal(size=(m, n)), 0.0)
    cols, rows = np.nonzero(A.T)
    kA = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=n))])
    r = rng.choice([0.0, np.inf, 2.5], m)
    l = rng.choice([0.0, -1.5, -np.inf], n)
    u = np.where(rng.random(n) < 0.5, 4.0, np.inf)
    return tlp.LP(name="GEN", m=m, n=n, A=A.T[cols, rows],
                  iA=rows.astype(np.int64), kA=kA.astype(np.int64),
                  b=rng.normal(size=m), c=rng.normal(size=n), f=0.5,
                  r=r, l=l, u=u, rowlab=[f"R{i}" for i in range(m)],
                  collab=[f"C{j}" for j in range(n)], maximize=True)


@pytest.mark.parametrize("key", sorted(TEXTS))
def test_read_mps_equal(tmp_path, key):
    path = _write(tmp_path, key)
    _assert_same(jmps.read_mps(path, engine="python"),
                 tmps.read_mps(path, engine="python"))


def _lps(tmp_path):
    for key in sorted(TEXTS):
        yield key, tmps.read_mps(_write(tmp_path, key))
    yield "bounded", random_bounded_lp(30, 60, seed=1)
    for seed in (0, 1):
        yield f"general{seed}", _general_lp(seed)


@pytest.mark.parametrize("scale", ["none", "geometric"])
@pytest.mark.parametrize("free_vars", ["reject", "split"])
@pytest.mark.parametrize("pad_to", [1, 8])
def test_canonicalize_equal(tmp_path, scale, free_vars, pad_to):
    for key, lp in _lps(tmp_path):
        want = jcanon.canonicalize(_jax_lp(lp), pad_to=pad_to,
                                   free_vars=free_vars, scale=scale)
        got = tcanon.canonicalize(lp, pad_to=pad_to, free_vars=free_vars,
                                  scale=scale)
        _assert_same(want, got)
        if got.status == -1:
            got_p = tcanon.pad_canon(got, got.mp + 3, got.np_ + 5)
            _assert_same(jcanon.pad_canon(want, want.mp + 3, want.np_ + 5),
                         got_p)


def test_write_lp_byte_equal(tmp_path):
    for key, lp in _lps(tmp_path):
        a, b = tmp_path / f"{key}.j.mps", tmp_path / f"{key}.t.mps"
        jwriter.write_lp(_jax_lp(lp), str(a))
        twriter.write_lp(lp, str(b))
        assert a.read_bytes() == b.read_bytes(), key


def test_write_sol_byte_equal(tmp_path):
    rng = np.random.default_rng(9)
    for key, lp in _lps(tmp_path):
        canon = tcanon.canonicalize(lp, free_vars="split")
        vecs = dict(x=rng.normal(size=lp.n), z=rng.normal(size=lp.n),
                    y=rng.normal(size=canon.m), w=rng.normal(size=canon.m),
                    b_canon=rng.normal(size=canon.m))
        kw = dict(status=0, primal_obj=1.0, dual_obj=1.0, **vecs)
        a, b = tmp_path / f"{key}.j.out", tmp_path / f"{key}.t.out"
        jwriter.write_sol(_jax_lp(lp), jlp.Solution(**kw), str(a))
        twriter.write_sol(lp, tlp.Solution(**kw), str(b))
        assert a.read_bytes() == b.read_bytes(), key


def test_config_equal(tmp_path):
    """The port's SolverConfig is the JAX package's, field for field, and
    folds MPS header parameters the same way."""
    from vanderbei_tpu.core.config import SolverConfig as JConfig
    from vanderbei_tpu_torch.core.config import SolverConfig as TConfig
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(JConfig())
    lp = tmps.read_mps(_write(tmp_path, "header"))
    for prec in ("auto", "f64"):
        want = JConfig(precision=prec).apply_lp_params(_jax_lp(lp))
        got = TConfig(precision=prec).apply_lp_params(lp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# the fields the native reader fills; it leaves the RHS/RANGES/BOUNDS set
# names empty, in both packages
_SECTION_NAMES = ("rhs_name", "ranges_name", "bounds_name")


@pytest.mark.parametrize("key", sorted(TEXTS))
def test_native_reader_equals_python_reader(tmp_path, key):
    path = _write(tmp_path, key)
    got = tmps.read_mps(path, engine="native")
    want = tmps.read_mps(path, engine="python")
    for name in _SECTION_NAMES:
        setattr(got, name, getattr(want, name))
    _assert_same(want, got)
    # the default engine reads with the native reader
    assert tmps.read_mps(path).rhs_name == ""


def test_native_source_is_the_jax_packages():
    from vanderbei_tpu import native as jnative
    with open(jnative._SRC, "rb") as a, open(tnative.SOURCE, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(tnative.library_path()) == tnative.BUILD_DIR


def test_native_reader_refuses_missing_file():
    with pytest.raises(ValueError):
        tmps.read_mps("/nonexistent/file.mps", engine="native")


def _build(mod):
    """The same model through either package's LPBuilder: every row kind,
    bounds, an integer column and quadratic terms."""
    b = mod.LPBuilder(name="mix", maximize=True)
    b.var("a", obj=1.0).var("b", lower=-2.0, upper=3.0, obj=2.0)
    b.var("c", upper=5.0, obj=-1.0, integer=True).var("d", lower=-np.inf)
    b.constraint("ge", {"a": 1.0, "b": 2.0}, lo=1.0)
    b.constraint("le", {"b": 1.0, "c": -1.0, "d": 4.0}, hi=7.0)
    b.constraint("eq", {"a": 1.0, "d": 1.0}, lo=2.0, hi=2.0)
    b.constraint("rng", {"c": 3.0, "a": -1.0}, lo=-1.0, hi=6.0)
    return b.quad("a", "a", 2.0).quad("b", "a", 0.5).quad("c", "c", 1.0).build()


def test_builder_equal():
    _assert_same(_build(jbuilder), _build(tbuilder))
    with pytest.raises(ValueError):
        tbuilder.LPBuilder().var("x").var("x")


def test_solution_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    for b_canon in (rng.normal(size=4), None):
        sol = tlp.Solution(status=0, x=rng.normal(size=3),
                           y=rng.normal(size=4), w=rng.normal(size=4),
                           z=rng.normal(size=3), primal_obj=1.25,
                           dual_obj=1.5, iterations=17, b_canon=b_canon)
        path = str(tmp_path / "sol.npz")
        tcheckpoint.save_solution(path, sol)
        back = tcheckpoint.load_solution(path)
        for f in ("status", "primal_obj", "dual_obj", "iterations"):
            assert getattr(back, f) == getattr(sol, f), f
        for f in ("x", "y", "w", "z"):
            np.testing.assert_array_equal(getattr(back, f), getattr(sol, f))
        assert (back.b_canon is None) == (b_canon is None)
        # the JAX package reads it back the same way
        from vanderbei_tpu.utils.checkpoint import load_solution
        jback = load_solution(path)
        assert jback.iterations == 17 and jback.primal_obj == 1.25
