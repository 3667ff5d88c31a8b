"""Whole solves: vanderbei_tpu_torch.solve on the CPU against
vanderbei_tpu.solve on the same LPs.

Bars: at precision "f64" the same status, iteration counts within 1 and
objectives within 1e-9 relative; at "mixed" (f32 sprint, f64 polish) the
same status, iterations within 3 and objectives within 1e-8 relative.  The
CLIs write equal .out files (see _same_out), and importing the port loads
no JAX.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vanderbei_tpu as vt
import vanderbei_tpu_torch as vtt
from tests.test_canonicalize import make_lp
from tests.test_mps import row
from vanderbei_tpu import cli as jax_cli
from vanderbei_tpu.core import lp as jlp
from vanderbei_tpu.core.builder import LPBuilder
from vanderbei_tpu_torch import cli
from vanderbei_tpu_torch.core.canonicalize import canonicalize
from vanderbei_tpu_torch.models import registry
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARS = {"f64": (1, 1e-9), "mixed": (3, 1e-8)}

# The tests run in several worker processes that share a few cores: with
# one intra-op thread each, torch's thread pools do not contend (the port's
# tests run about five times faster so).  Each module that runs whole
# solves sets this itself.
torch.set_num_threads(1)


def _port_lp(lp):
    return vtt.LP(**{f.name: getattr(lp, f.name)
                     for f in dataclasses.fields(jlp.LP)})


def _jax_lp(lp):
    return jlp.LP(**{f.name: getattr(lp, f.name)
                     for f in dataclasses.fields(jlp.LP)})


def _compare(jax_lp, precision="f64", method="hsd", bars=None, **cfg):
    """Solve in both packages and hold the port to `bars` (iterations,
    relative objective), by default BARS of the precision."""
    want = vt.solve(jax_lp, method=method,
                    config=vt.SolverConfig(precision=precision, **cfg))
    got = vtt.solve(_port_lp(jax_lp), method=method,
                    config=vtt.SolverConfig(precision=precision, **cfg),
                    device="cpu")
    d_it, rel = bars or BARS["mixed" if precision == "mixed" else "f64"]
    assert got.status == want.status
    assert abs(got.iterations - want.iterations) <= d_it
    if want.status == 0:
        err = abs(got.primal_obj - want.primal_obj)
        assert err <= rel * max(1.0, abs(want.primal_obj))
        assert got.x.shape == want.x.shape and got.y.shape == want.y.shape
    return want, got


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("m,n", [(60, 120), (300, 600)])
def test_random_bounded_lp(m, n, precision):
    want, got = _compare(_jax_lp(random_bounded_lp(m, n, seed=0)), precision)
    assert want.status == 0
    if precision == "mixed":
        assert [s["precision"] for s in got.stages] == ["f32", "f64"]
        assert got.stages[0]["paused"] and got.stages[0]["iterations"] > 0


def test_random_bounded_lp_long_step():
    _compare(_jax_lp(random_bounded_lp(60, 120, seed=1)), method="hsdls")


def test_random_bounded_lp_dense_tail():
    """use_ub_structure=False keeps the ub rows in the factored system."""
    _compare(_jax_lp(random_bounded_lp(60, 120, seed=2)),
             use_ub_structure=False)


def test_maximize_sense(tmp_path):
    p = tmp_path / "m.mps"
    p.write_text("\n".join([
        "MAX", "NAME          M", "ROWS", row("N", "obj"), row("L", "r1"),
        "COLUMNS", row("", "x", "obj", 1.0, "r1", 1.0),
        row("", "y", "obj", 2.0, "r1", 1.0),
        "RHS", row("", "rhs", "r1", 4.0), "ENDATA"]) + "\n")
    _, got = _compare(vt.read_mps(str(p), engine="python"))
    assert got.status == 0 and got.primal_obj == pytest.approx(8.0, abs=1e-6)


def test_infeasible():
    _, got = _compare(make_lp([[1.0], [-1.0]], [2.0, -1.0], [1.0]))
    assert got.status == int(vtt.Status.PRIMAL_INFEASIBLE)


def test_unbounded():
    _, got = _compare(make_lp([[1.0, -1.0]], [-1.0], [1.0, 1.0],
                              maximize=True))
    assert got.status != 0


def _diet():
    lpb = LPBuilder(name="diet")
    lpb.var("x1", obj=2.0)
    lpb.var("x2", upper=4.0, obj=3.0)
    lpb.constraint("protein", {"x1": 1.0, "x2": 2.0}, lo=10.0)
    lpb.constraint("budget", {"x1": 3.0, "x2": 1.0}, hi=15.0)
    return lpb.build()


def _range_and_equality():
    lpb = LPBuilder(maximize=True)
    lpb.var("a", obj=1.0)
    lpb.var("b", obj=1.0)
    lpb.constraint("eq", {"a": 1.0, "b": 1.0}, lo=3.0, hi=3.0)
    lpb.constraint("rng", {"a": 1.0, "b": -1.0}, lo=-1.0, hi=1.0)
    return lpb.build()


def _free_with_upper_bound():
    lpb = LPBuilder("freeub")
    lpb.var("x", lower=-np.inf, upper=-1.0, obj=1.0)
    lpb.var("y", lower=0.0, upper=5.0, obj=1.0)
    lpb.constraint("r1", {"x": 1.0, "y": 1.0}, lo=-2.0)
    return lpb.build()


@pytest.mark.parametrize("build,obj", [(_diet, 16.0),
                                       (_range_and_equality, 3.0)])
def test_builder(build, obj):
    _, got = _compare(build())
    assert got.status == 0 and got.primal_obj == pytest.approx(obj, abs=1e-6)


@pytest.mark.parametrize("use_struct", [True, False])
def test_builder_free_var_with_upper_bound(use_struct):
    _, got = _compare(_free_with_upper_bound(), free_vars="split",
                      use_ub_structure=use_struct)
    assert got.status == 0 and got.primal_obj == pytest.approx(-2.0, abs=1e-7)


def test_suboptimal_hsd_falls_back_to_intpt_on_the_dense_form(monkeypatch):
    """An hsd verdict of SUBOPTIMAL, forced on a boxed LP that the UbTail
    path builds from its CSC: the unscaled retry is built the same way,
    and the intpt cross-check gets the dense canonical form, which solves
    the LP."""
    lp = random_bounded_lp(30, 60, seed=5)
    real_hsd, real_intpt = registry.SOLVERS["hsd"], registry._solve_intpt
    seen = []

    def suboptimal(canon, cfg, device, stages, **kw):
        seen.append(("hsd", canon))
        out = real_hsd(canon, cfg, device, stages, **kw)
        return (int(vtt.Status.SUBOPTIMAL),) + out[1:]

    def intpt(canon, cfg, device, stages):
        seen.append(("intpt", canon))
        return real_intpt(canon, cfg, device, stages)

    monkeypatch.setitem(registry.SOLVERS, "hsd", suboptimal)
    monkeypatch.setattr(registry, "_solve_intpt", intpt)
    sol = vtt.solve(lp, config=vtt.SolverConfig(precision="f64", verbose=0),
                    device="cpu")
    assert [name for name, _ in seen] == ["hsd", "hsd", "intpt"]
    (_, scaled), (_, unscaled), (_, dense) = seen
    assert scaled.A is None and unscaled.A is None
    assert scaled.row_scale is not None and unscaled.row_scale is None
    want = canonicalize(lp, scale="geometric")
    assert dense.A.tobytes() == want.A.tobytes()
    assert dense.b.tobytes() == want.b.tobytes()
    assert sol.status == 0 and sol.stages[-1]["precision"] == "f64"
    ref = vtt.solve(lp, config=vtt.SolverConfig(precision="f64", verbose=0),
                    device="cpu")
    assert sol.primal_obj == pytest.approx(ref.primal_obj, rel=1e-6)


def _same_out(a: str, b: str):
    """Two .out files agree token by token: labels, bounds and OB flags
    exactly; each printed number (5 significant digits) within one unit of
    its last digit, or 1e-9 absolutely.  The near-zero members of the
    optimal complementary pairs (~1e-10) carry roundoff in their last
    digits, so byte equality is not a property of two f64 solvers."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty), (x, y)
        for u, v in zip(tx, ty):
            try:
                fu, fv = float(u), float(v)
            except ValueError:
                assert u == v, (x, y)
                continue
            assert fu == fv or abs(fu - fv) <= 1e-4 * abs(fu) + 1e-9, (x, y)


def test_cli_out_equals_jax_cli(tmp_path, monkeypatch):
    # the JAX CLI would point XLA's compile cache at the repository
    monkeypatch.setattr(jax_cli, "enable_persistent_cache", lambda: None)
    mps = tmp_path / "rand.mps"
    vtt.write_lp(random_bounded_lp(40, 80, seed=4), str(mps))
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([str(mps), "--out", str(jax_out), "--verbose", "0"]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "vanderbei_tpu_torch", str(mps),
         "--device", "cpu", "--out", str(port_out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "optimal solution" in proc.stdout.splitlines()
    _same_out(jax_out.read_text(), port_out.read_text())


def test_import_loads_no_jax():
    code = ("import sys, vanderbei_tpu_torch, vanderbei_tpu_torch.cli, "
            "vanderbei_tpu_torch.utils.checkpoint, "
            "vanderbei_tpu_torch.utils.randlp, "
            "vanderbei_tpu_torch.models.intpt, "
            "vanderbei_tpu_torch.models.staged, "
            "vanderbei_tpu_torch.models.simplex, "
            "vanderbei_tpu_torch.ops.quad, vanderbei_tpu_torch.native, "
            "vanderbei_tpu_torch.core.builder, "
            "vanderbei_tpu_torch.parallel.batch, "
            "vanderbei_tpu_torch.parallel.mesh, "
            "vanderbei_tpu_torch.parallel.distributed, "
            "vanderbei_tpu_torch.evaluate, vanderbei_tpu_torch.sweep, "
            "vanderbei_tpu_torch.io.netlib, "
            "vanderbei_tpu_torch.utils.profiling, "
            "vanderbei_tpu_torch.tools.mesh_solve, "
            "vanderbei_tpu_torch.tools.multichip_scaling, "
            "vanderbei_tpu_torch.tools.ab_solve, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] == 'vanderbei_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vtt.solve(_port_lp(_diet()), device="cuda")


def test_unported_paths_raise():
    """Every method and precision of the JAX package is ported: only a
    method neither package has is refused."""
    lp = _port_lp(_diet())
    assert vtt.solve(lp, config=vtt.SolverConfig(precision="dd"),
                     device="cpu").status == 0
    with pytest.raises(ValueError, match="unknown method"):
        vtt.solve(lp, method="revised", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        vt.solve(_jax_lp(lp), method="revised")


def test_solvers_equal():
    assert set(vtt.SOLVERS) == set(vt.SOLVERS)
    assert vtt.get_solver("pd") is vtt.SOLVERS["pd"]


@pytest.mark.parametrize("method,m,n", [("intpt", 9, 40), ("pd", 40, 80),
                                        ("twophase", 40, 80)])
def test_cli_out_equals_jax_cli_by_method(tmp_path, monkeypatch, method,
                                          m, n):
    """intpt's LP has no equality rows (m < 10): stopping at a 1e-6 gap,
    intpt leaves the duals of equality rows, some 1e4 in size on the 40 x
    80 LP, determined only to about 7 % (x agrees to 1e-11), short of the
    .out's five digits."""
    monkeypatch.setattr(jax_cli, "enable_persistent_cache", lambda: None)
    mps = tmp_path / "rand.mps"
    vtt.write_lp(random_bounded_lp(m, n, seed=4), str(mps))
    jax_out, port_out = tmp_path / "jax.out", tmp_path / "port.out"
    assert jax_cli.main([str(mps), "--method", method, "--out", str(jax_out),
                         "--verbose", "0"]) == 0
    assert cli.main([str(mps), "--method", method, "--device", "cpu",
                     "--out", str(port_out), "--verbose", "0"]) == 0
    _same_out(jax_out.read_text(), port_out.read_text())
