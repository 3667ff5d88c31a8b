"""ops/quad, precision "dd" and the --metrics table: vanderbei_tpu_torch
against vanderbei_tpu on the CPU.

Bars: the error-free transforms are exact (s + err == a + b and
p + err == a * b, checked in exact rational arithmetic); dot2, matvec2 and
sum2 agree with the JAX package's within 1 ulp of its result on the
cancellation cases of tests/test_quad.py; whole "dd" solves hold the f64
bars (same status, iterations within 1, objectives within 1e-9 relative);
the metrics CSVs have the same number of rows, and every row whose mu is
above 1e-6 agrees within rtol 1e-9 (they print identically).  Below that
mu the two f64 runs' roundoff is no longer small against the iterates'
differences that mu and the residuals measure (on the LPs here the rows
then part by up to 2.6e-7 relative in mu, 3.5e-8 in the objectives and
7.7e-11 absolute in the dual infeasibility), so those rows are held to
rtol 1e-6, with atol 1e-9 for the infeasibilities.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vanderbei_tpu_torch as vtt
from tests.test_mps import row
from tests.test_torch_solve import _compare, _jax_lp
from vanderbei_tpu import cli as jax_cli
from vanderbei_tpu.ops import quad as jq
from vanderbei_tpu_torch import cli as port_cli
from vanderbei_tpu_torch.ops import quad as tq
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _operands(np_dtype, size=400, seed=0):
    """Pairs spread over twelve binades, so sums and products round."""
    rng = np.random.default_rng(seed)
    mag = lambda: 10.0 ** rng.uniform(-6, 6, size)
    a = (rng.normal(size=size) * mag()).astype(np_dtype)
    b = (rng.normal(size=size) * mag()).astype(np_dtype)
    return a, b


def _exact(v):
    return [Fraction(float(x)) for x in v]


@pytest.mark.parametrize("np_dtype,dtype", DTYPES)
def test_two_sum_is_error_free(np_dtype, dtype):
    a, b = _operands(np_dtype)
    s, err = tq.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    assert s.dtype == err.dtype == dtype
    assert np.array_equal(s.numpy(), a + b)      # s is the rounded sum
    for x, y, u, v in zip(_exact(a), _exact(b), _exact(s), _exact(err)):
        assert u + v == x + y


@pytest.mark.parametrize("np_dtype,dtype", DTYPES)
def test_fast_two_sum_is_error_free(np_dtype, dtype):
    a, b = _operands(np_dtype, seed=1)
    big = np.where(np.abs(a) >= np.abs(b), a, b)
    small = np.where(np.abs(a) >= np.abs(b), b, a)
    s, err = tq.fast_two_sum(torch.from_numpy(big), torch.from_numpy(small))
    for x, y, u, v in zip(_exact(big), _exact(small), _exact(s), _exact(err)):
        assert u + v == x + y


@pytest.mark.parametrize("np_dtype,dtype", DTYPES)
def test_two_prod_is_error_free(np_dtype, dtype):
    a, b = _operands(np_dtype, seed=2)
    p, err = tq.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert p.dtype == dtype
    assert np.array_equal(p.numpy(), a * b)
    for x, y, u, v in zip(_exact(a), _exact(b), _exact(p), _exact(err)):
        assert u + v == x * y


@pytest.mark.parametrize("np_dtype,dtype", DTYPES)
def test_split_halves_are_exact(np_dtype, dtype):
    a, _ = _operands(np_dtype, seed=3)
    hi, lo = tq.split(torch.from_numpy(a))
    assert np.array_equal((hi + lo).numpy(), a)
    # each half has at most half the significand's bits
    bits = 12 if dtype == torch.float32 else 26
    for h in hi.numpy():
        if h:
            m, _ = np.frexp(np.float64(h))
            assert float(m * 2 ** bits).is_integer()


def test_dd_mul_and_div_match_jax():
    x = (1.0, 2.0 ** -30)
    jx = jq.DD(jnp.float64(x[0]), jnp.float64(x[1]))
    tx = tq.DD(torch.tensor(x[0], dtype=torch.float64),
               torch.tensor(x[1], dtype=torch.float64))
    for jr, tr in ((jq.dd_mul(jx, jx), tq.dd_mul(tx, tx)),
                   (jq.dd_div(jq.dd(jnp.float64(1.0)), jq.dd(jnp.float64(3.0))),
                    tq.dd_div(tq.dd(torch.tensor(1.0, dtype=torch.float64)),
                              tq.dd(torch.tensor(3.0, dtype=torch.float64))))):
        assert float(jr.hi) == float(tr.hi) and float(jr.lo) == float(tr.lo)


def _within_ulp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), (got, want)


def test_matvec2_cancellation_matches_jax():
    A = np.array([[1e16, 1.0, -1e16, 1.0], [3.0, 1e14, 2.0, -1e14]])
    x = np.ones(4)
    want = np.asarray(jq.matvec2(jnp.asarray(A), jnp.asarray(x)))
    got = tq.matvec2(torch.from_numpy(A), torch.from_numpy(x)).numpy()
    _within_ulp(got, want)
    np.testing.assert_array_equal(got, [2.0, 5.0])


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_matvec2_matches_jax(np_dtype):
    rng = np.random.default_rng(5)
    A = rng.normal(size=(17, 33)).astype(np_dtype)
    x = rng.normal(size=33).astype(np_dtype)
    X = rng.normal(size=(33, 3)).astype(np_dtype)
    _within_ulp(tq.matvec2(torch.from_numpy(A), torch.from_numpy(x)).numpy(),
                jq.matvec2(jnp.asarray(A), jnp.asarray(x)))
    # a (dim, k) right-hand side: the JAX package's vmap over columns
    col = jax.vmap(jq.matvec2, in_axes=(None, 1), out_axes=1)
    _within_ulp(tq.matvec2(torch.from_numpy(A), torch.from_numpy(X)).numpy(),
                col(jnp.asarray(A), jnp.asarray(X)))


def test_dot2_matches_jax_f32():
    rng = np.random.default_rng(1)
    a = rng.normal(size=4096).astype(np.float32)
    b = rng.normal(size=4096).astype(np.float32)
    _within_ulp(tq.dot2(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                jq.dot2(jnp.asarray(a), jnp.asarray(b)))


def test_sum2_cancellation_matches_jax():
    a = np.array([1e16, 3.14159, -1e16, 2.71828, 1.0, -1.0])
    got = tq.sum2(torch.from_numpy(a)).numpy()
    _within_ulp(got, jq.sum2(jnp.asarray(a)))
    assert float(got) == pytest.approx(3.14159 + 2.71828, rel=1e-15)
    _within_ulp(tq.norm2sq(torch.from_numpy(a)).numpy(),
                jq.norm2sq(jnp.asarray(a)))


@pytest.mark.parametrize("method", ["hsd", "hsdls"])
def test_dd_solve_matches_jax(method):
    want, got = _compare(_jax_lp(random_bounded_lp(60, 120, seed=2)),
                         "dd", method=method)
    assert want.status == got.status == 0
    assert [s["precision"] for s in got.stages] == ["f64"]


def test_dd_solve_dense_tail_matches_jax():
    """dd through the dense (non-UbTail) system: compensated products of
    the whole canonical A."""
    want, got = _compare(_jax_lp(random_bounded_lp(60, 120, seed=3)), "dd",
                         use_ub_structure=False)
    assert got.status == 0


def test_sigfig_10_selects_dd(tmp_path):
    """min -x - 2y, x + y <= 4, x + 3y <= 6: x = 3, y = 1, obj -5."""
    p = tmp_path / "s.mps"
    p.write_text("\n".join([
        "SIGFIG        10", "NAME          S", "ROWS", row("N", "obj"),
        row("L", "r1"), row("L", "r2"), "COLUMNS",
        row("", "x", "obj", -1.0, "r1", 1.0), row("", "x", "r2", 1.0),
        row("", "y", "obj", -2.0, "r1", 1.0), row("", "y", "r2", 3.0),
        "RHS", row("", "rhs", "r1", 4.0, "r2", 6.0), "ENDATA"]) + "\n")
    lp = vtt.read_mps(str(p))
    cfg = vtt.SolverConfig().apply_lp_params(lp)
    assert cfg.precision == "dd" and cfg.hsd_eps == 1e-14
    want, got = _compare(_jax_lp(lp), "auto")
    assert got.status == 0
    assert got.primal_obj == pytest.approx(-5.0, abs=1e-9)


@pytest.mark.parametrize("method,precision", [("hsd", "f64"), ("hsd", "dd"),
                                              ("hsdls", "f64")])
def test_metrics_csv_matches_jax_cli(tmp_path, monkeypatch, method,
                                     precision):
    monkeypatch.setattr(jax_cli, "enable_persistent_cache", lambda: None)
    mps = tmp_path / "rand.mps"
    vtt.write_lp(random_bounded_lp(30, 60, seed=4), str(mps))
    jpath, tpath = tmp_path / "jax.csv", tmp_path / "port.csv"
    args = [str(mps), "--method", method, "--precision", precision,
            "--no-out", "--verbose", "0"]
    assert jax_cli.main(args + ["--metrics", str(jpath)]) == 0
    assert port_cli.main(args + ["--metrics", str(tpath),
                                 "--device", "cpu"]) == 0
    want = np.genfromtxt(jpath, delimiter=",", names=True)
    got = np.genfromtxt(tpath, delimiter=",", names=True)
    assert got.dtype.names == want.dtype.names == (
        "iter", "mu", "primal_obj", "dual_obj", "primal_infeas",
        "dual_infeas")
    assert len(got) == len(want) > 5
    np.testing.assert_array_equal(got["iter"], np.arange(len(got)))
    head = want["mu"] > 1e-6
    assert head.sum() >= 5
    for k in want.dtype.names[1:]:
        np.testing.assert_allclose(got[k][head], want[k][head], rtol=1e-9,
                                   err_msg=k)
        atol = 1e-9 if k.endswith("infeas") else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=atol,
                                   err_msg=k)
    assert got["mu"][-1] < 1e-12 < got["mu"][0]


def test_metrics_refused_for_simplex(tmp_path):
    mps = tmp_path / "rand.mps"
    vtt.write_lp(random_bounded_lp(10, 20, seed=0), str(mps))
    with pytest.raises(SystemExit):
        port_cli.main([str(mps), "--method", "pd", "--metrics", "m.csv",
                       "--device", "cpu"])
