"""intpt and the QP path: vanderbei_tpu_torch against vanderbei_tpu on the
CPU, on the same seeded inputs.

Bars: at precision "f64" the same status, iterations within 1 and
objectives within 1e-9 relative (the whole-solve bars of
test_torch_solve.py).  At "mixed" the same status, iterations within 3
and objectives within 1e-7 relative: intpt stops at a gap of
ipm_eps = 1e-6 relative, so two f32 sprints that differ only in roundoff
(a BLAS's summation order) hand the f64 stage points from which it
certifies optima up to that far apart.  The readings the bar rests on:
the two packages' mixed solves differ by 1.9e-8 on the 300 x 600 LP below
(with one and with four torch threads alike; 3.3e-8 was also seen), by
1.6e-10 on the 60 x 120 LP and by 2.9e-12 on the random QP; over seeds
0-5 at 60 x 120 the JAX package's own mixed and f64 solves differed by
4.5e-10 to 4.8e-8.  A resumed solve equals the uninterrupted one exactly
in iterations and to 1e-12 in x.
"""

import numpy as np
import pytest
import torch

import vanderbei_tpu as vt
import vanderbei_tpu_torch as vtt
from tests.test_torch_solve import BARS, _compare, _jax_lp, _port_lp
from vanderbei_tpu.core.canonicalize import canonicalize as jcanonicalize
from vanderbei_tpu.models import intpt as jintpt
from vanderbei_tpu.models import registry as jregistry
from vanderbei_tpu.utils import checkpoint as jcheckpoint
from vanderbei_tpu_torch.models import intpt as tintpt
from vanderbei_tpu_torch.models import registry as tregistry
from vanderbei_tpu_torch.utils import checkpoint as tcheckpoint
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp, random_bounded_qp

MIXED = (3, 1e-7)    # intpt's "mixed" bars (see above)

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)


def _bars(precision):
    return MIXED if precision == "mixed" else None


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("m,n,seed", [(60, 120, 0), (300, 600, 1)])
def test_intpt_random_bounded_lp(m, n, seed, precision):
    want, got = _compare(_jax_lp(random_bounded_lp(m, n, seed=seed)),
                         precision, method="intpt", bars=_bars(precision))
    assert want.status == 0
    if precision == "mixed":
        assert [s["precision"] for s in got.stages] == ["f32", "f64"]
        assert got.stages[0]["paused"] and got.stages[0]["iterations"] > 0


def _qp_projection():
    """min (x1^2 + x2^2)/2 s.t. x1 + x2 >= 2: x = (1, 1), obj 1."""
    b = vtt.LPBuilder("QP1")
    b.var("x1")
    b.var("x2")
    b.constraint("r", {"x1": 1.0, "x2": 1.0}, lo=2.0)
    return b.quad("x1", "x1", 1.0).quad("x2", "x2", 1.0).build()


def _qp_linear_term():
    """min x1 + x'Qx/2, Q = [[1, .5], [.5, 4]], s.t. x1 + x2 >= 1."""
    b = vtt.LPBuilder("QP2")
    b.var("x1", obj=1.0)
    b.var("x2")
    b.constraint("r", {"x1": 1.0, "x2": 1.0}, lo=1.0)
    b.quad("x1", "x1", 1.0).quad("x1", "x2", 0.5).quad("x2", "x2", 4.0)
    return b.build()


def _qp_bounds_shift():
    """min x^2/2 s.t. x >= 2 (a lower bound, folded into c): obj 2."""
    b = vtt.LPBuilder("QP3")
    b.var("x1", lower=2.0)
    b.constraint("r", {"x1": 1.0}, lo=0.0)
    return b.quad("x1", "x1", 1.0).build()


@pytest.mark.parametrize("build,obj", [(_qp_projection, 1.0),
                                       (_qp_linear_term, None),
                                       (_qp_bounds_shift, 2.0)])
def test_qp(build, obj):
    lp = build()
    assert lp.qnz > 0
    _, got = _compare(_jax_lp(lp), method="intpt")
    assert got.status == 0
    if obj is not None:
        assert got.primal_obj == pytest.approx(obj, abs=1e-5)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_random_qp(precision):
    """A seeded 100 x 200 bounded LP plus a banded PSD Q; "mixed" runs the
    f32 sprint on the dual form with Q added to the normal matrix."""
    want, got = _compare(_jax_lp(random_bounded_qp(100, 200, seed=3)),
                         precision, method="intpt", bars=_bars(precision))
    assert want.status == 0
    if precision == "mixed":
        assert got.stages[0]["precision"] == "f32"


def test_quads_routes_hsd_to_intpt(capsys):
    lp = _qp_linear_term()
    want = vt.solve(_jax_lp(lp), method="hsd",
                    config=vt.SolverConfig(verbose=1))
    jax_out = capsys.readouterr().out
    got = vtt.solve(lp, method="hsd", config=vtt.SolverConfig(verbose=1),
                    device="cpu")
    port_out = capsys.readouterr().out
    line = "QUADS present: routing method 'hsd' -> 'intpt' (QP-capable)"
    assert line in jax_out.splitlines() and line in port_out.splitlines()
    assert got.status == want.status == 0
    assert got.iterations == want.iterations
    assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-9)


def _suboptimal(solver):
    """Wrap an hsd solver so that it reports SUBOPTIMAL (status 7)."""
    def wrapped(*args, **kw):
        return (7, *solver(*args, **kw)[1:])
    return wrapped


def test_cross_check_retry(monkeypatch, capsys):
    """An hsd SUBOPTIMAL verdict (forced in both packages) is retried
    unscaled, then cross-checked with intpt, whose OPTIMAL result is kept
    with its iterations added to the first hsd run's (the unscaled run,
    not kept, adds none)."""
    monkeypatch.setitem(jregistry.SOLVERS, "hsd",
                        _suboptimal(jregistry.SOLVERS["hsd"]))
    monkeypatch.setitem(tregistry.SOLVERS, "hsd",
                        _suboptimal(tregistry.SOLVERS["hsd"]))
    lp = random_bounded_lp(60, 120, seed=1)
    want = vt.solve(_jax_lp(lp), method="hsd",
                    config=vt.SolverConfig(precision="f64", verbose=1))
    got = vtt.solve(lp, method="hsd",
                    config=vtt.SolverConfig(precision="f64", verbose=1),
                    device="cpu")
    out = capsys.readouterr().out.splitlines()
    for line in ("hsd suboptimal: retrying unscaled",
                 "hsd suboptimal (phi collapse): falling back to intpt"):
        assert out.count(line) == 2
    assert got.status == want.status == 0
    d_it, rel = BARS["f64"]
    assert abs(got.iterations - want.iterations) <= d_it
    assert abs(got.primal_obj - want.primal_obj) <= rel * abs(want.primal_obj)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-6, atol=1e-6)
    # hsd, hsd unscaled, then intpt's one f64 stage
    assert [s["precision"] for s in got.stages] == ["f64"] * 3
    hsd_run, _, intpt_run = got.stages
    assert got.iterations == hsd_run["iterations"] + intpt_run["iterations"]


def _canon(seed=1):
    return jcanonicalize(_jax_lp(random_bounded_lp(40, 80, seed=seed)))


def test_resume_equals_uninterrupted(tmp_path):
    """Pause at a duality gap of 1.0, checkpoint, reload, resume: the same
    iterations and x as one uninterrupted run."""
    canon = _canon()
    A, b, c = (torch.from_numpy(v) for v in (canon.A, canon.b, canon.c))
    full = tintpt.solve_canon(A, b, c, canon.f)
    paused = tintpt.solve_canon(A, b, c, canon.f, pause_gap=1.0)[-1]
    assert int(paused.status) == -1 and 0 < int(paused.iter) < int(full[5])
    path = str(tmp_path / "state.npz")
    tcheckpoint.save_state(path, paused)
    loaded = tcheckpoint.load_state(path, "cpu")
    assert isinstance(loaded, tintpt.IntptState)
    resumed = tintpt.solve_canon(A, b, c, canon.f, init=loaded)
    assert int(resumed[0]) == int(full[0]) == 0
    assert int(resumed[5]) == int(full[5])
    np.testing.assert_allclose(resumed[1].numpy(), full[1].numpy(),
                               rtol=1e-12, atol=1e-12)


def test_resume_jax_checkpoint(tmp_path):
    """A state paused and saved by the JAX package resumes in the port to
    the JAX package's uninterrupted result (the f64 bars)."""
    import jax.numpy as jnp
    canon = _canon(seed=2)
    jargs = [jnp.asarray(v) for v in (canon.A, canon.b, canon.c)]
    want = jintpt.solve_canon(*jargs, canon.f)
    paused = jintpt.solve_canon(*jargs, canon.f, pause_gap=1.0)[-1]
    path = str(tmp_path / "jax_state.npz")
    jcheckpoint.save_state(path, paused)
    A, b, c = (torch.from_numpy(v) for v in (canon.A, canon.b, canon.c))
    got = tintpt.solve_canon(A, b, c, canon.f,
                             init=tcheckpoint.load_state(path, "cpu"))
    assert int(got[0]) == int(want[0]) == 0
    assert abs(int(got[5]) - int(want[5])) <= BARS["f64"][0]
    obj = lambda x: float(np.asarray(canon.c) @ np.asarray(x))
    assert obj(got[1]) == pytest.approx(obj(want[1]), rel=BARS["f64"][1])


def test_port_lp_helper_keeps_quads():
    """_port_lp/_jax_lp carry Q across, so the QP comparisons above solve
    the same problem in both packages."""
    lp = random_bounded_qp(10, 20, seed=0)
    back = _port_lp(_jax_lp(lp))
    np.testing.assert_array_equal(back.dense_Q(), lp.dense_Q())
