"""The branches of the f32 -> f64 precision ladder, on the CPU.

- A single LP whose f32 sprint ends non-finite or SUBOPTIMAL polishes from
  a clean f64 start: the polish begins at init_state, the solve equals the
  port's precision="f64" solve bit for bit, and the JAX package, forced
  the same way, agrees to the f64 bars of test_torch_solve.
- In a 3-lane class, the lane whose sprint is forced so restarts clean
  while the other lanes polish from their cast sprint state, bit for bit,
  and end as they do unforced.
- A warm single-LP polish that exhausts max_iter gets exactly one clean
  "f64 retry" stage (as in the JAX package); a batch gets none.

Each failure is forced by wrapping the solver loop (hsd._hsd_loop, and the
JAX package's hsd.solve_canon), not by a knob of the program.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import vanderbei_tpu as vt
import vanderbei_tpu_torch as vtt
from vanderbei_tpu.core import lp as jlp
from vanderbei_tpu.models import hsd as jhsd
from vanderbei_tpu_torch.core.status import Status
from vanderbei_tpu_torch.models import hsd
from vanderbei_tpu_torch.parallel import batch as pb
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)

RUNNING, SUBOPTIMAL = int(Status.RUNNING), int(Status.SUBOPTIMAL)
CASES = ["single-nonfinite", "single-suboptimal", "lane-nonfinite",
         "lane-suboptimal", "single-retry", "batch-no-retry"]


def _force(state, how, lanes=...):
    """state with its x made non-finite, its status SUBOPTIMAL, or its
    iterations exhausted (`how` a max_iter) at its running status, in
    `lanes` (every lane, or the one LP, by default)."""
    if how == "nonfinite":
        x = state.x.clone()
        x[lanes] = float("nan")
        return state._replace(x=x)
    status, it = state.status.clone(), state.iter.clone()
    if how == "suboptimal":
        status[lanes] = SUBOPTIMAL
        return state._replace(status=status)
    status[lanes], it[lanes] = RUNNING, how
    return state._replace(status=status, iter=it)


def _spy(monkeypatch, pick):
    """Wrap the port's hsd loop: each call's (a copy of its init, its
    output after pick(A, init, kw, out) -> out, the clean start on its
    operands) in order."""
    real, calls = hsd._hsd_loop, []

    def loop(A, b, c, f, init, **kw):
        copy = type(init)(*(t.clone() for t in init))
        state, paused = real(A, b, c, f, init, **kw)
        state = pick(A, init, kw, state)
        ub = kw.get("ub")
        fresh = hsd.init_state(A, extra_rows=0 if ub is None
                               else ub.idx2.shape[-1])
        calls.append((copy, state, fresh))
        return state, paused
    monkeypatch.setattr(hsd, "_hsd_loop", loop)
    return calls


def _same(a, b):
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.numpy().tobytes() == v.numpy().tobytes()


def _lane(state, j):
    return type(state)(*(t[j] for t in state))


def _warm_polish(A, init):
    return A.dtype == torch.float64 and int(init.iter.max()) > 0


def _jax_forced(monkeypatch, lp, how):
    """The JAX package's mixed solve of lp, its sprint (or its warm polish)
    forced as the port's."""
    real = jhsd.solve_canon

    def loop(A, *a, **kw):
        out = real(A, *a, **kw)
        s = out[-1]
        if how == "retry":
            hit = A.dtype == jnp.float64 and int(kw["init"].iter) > 0
            s = s._replace(status=jnp.asarray(RUNNING, s.status.dtype),
                           iter=jnp.asarray(jhsd.DEFAULT_MAX_ITER,
                                            s.iter.dtype)) if hit else s
        elif A.dtype == jnp.float32:
            s = (s._replace(x=s.x.at[0].set(jnp.nan)) if how == "nonfinite"
                 else s._replace(status=jnp.asarray(SUBOPTIMAL,
                                                    s.status.dtype)))
        return out[:-1] + (s,)
    jlp_ = jlp.LP(**{f.name: getattr(lp, f.name)
                     for f in dataclasses.fields(jlp.LP)})
    with monkeypatch.context() as m:
        m.setattr(jhsd, "solve_canon", loop)
        return vt.solve(jlp_, config=vt.SolverConfig(precision="mixed"))


def _single(monkeypatch, how):
    lp = random_bounded_lp(60, 120, seed=0)
    plain = vtt.solve(lp, config=vtt.SolverConfig(precision="f64"),
                      device="cpu")

    def pick(A, init, kw, out):
        if how == "retry":
            return (_force(out, kw["max_iter"]) if _warm_polish(A, init)
                    else out)
        return _force(out, how) if A.dtype == torch.float32 else out
    calls = _spy(monkeypatch, pick)
    got = vtt.solve(lp, config=vtt.SolverConfig(precision="mixed"),
                    device="cpu")
    want = _jax_forced(monkeypatch, lp, how)
    labels = ["f32", "f64"] + (["f64 retry"] if how == "retry" else [])
    assert [s["precision"] for s in got.stages] == labels
    assert [init.x.dtype for init, _, _ in calls] == [torch.float32] + [
        torch.float64] * (len(labels) - 1)
    # the last stage starts clean, and so ends as the plain f64 solve
    _same(calls[-1][0], calls[-1][2])
    assert got.status == plain.status == 0
    assert got.iterations == plain.iterations == got.stages[-1]["iterations"]
    assert got.x.tobytes() == plain.x.tobytes()
    assert got.y.tobytes() == plain.y.tobytes()
    assert want.status == got.status
    assert abs(want.iterations - got.iterations) <= 1
    assert abs(want.primal_obj - got.primal_obj) <= 1e-9 * max(
        1.0, abs(want.primal_obj))


def _class():
    lps = [random_bounded_lp(30 + j, 60 + 2 * j, density=0.1, seed=j)
           for j in range(3)]
    classes, _ = pb.group_by_class(lps, granularity=64,
                                   use_ub_structure=True, scale="geometric")
    (key, entries), = classes.items()
    _, M1, N, K = key
    return pb.stack_class_structured(entries, M1, N, K)


def _batch(monkeypatch, how):
    A, b, c, ub = _class()
    plain = pb.solve_batch_hsd(A, b, c, ub=ub, device="cpu")

    def pick(A_, init, kw, out):
        if how == "retry":
            return (_force(out, kw["max_iter"]) if _warm_polish(A_, init)
                    else out)
        return _force(out, how, 1) if A_.dtype == torch.float32 else out
    calls = _spy(monkeypatch, pick)
    stages = []
    got = pb.solve_batch_hsd(A, b, c, ub=ub, device="cpu", stages=stages)
    assert [s["precision"] for s in stages] == ["f32", "f64"]
    assert len(calls) == 2
    if how == "retry":
        assert (got[0] == int(Status.ITERATION_LIMIT)).all()
        return
    (_, sprint, _), (init, _, fresh) = calls
    cast = hsd.cast_state(sprint, torch.float64)
    _same(_lane(init, 1), _lane(fresh, 1))
    for j in (0, 2):
        _same(_lane(init, j), _lane(cast, j))
        assert int(sprint.iter[j]) > 0
        for u, v in zip(got, plain):
            assert u[j].numpy().tobytes() == v[j].numpy().tobytes()
    assert int(got[0][1]) == 0


@pytest.mark.parametrize("case", CASES)
def test_ladder_branch(monkeypatch, case):
    where, how = case.split("-", 1)
    how = {"no-retry": "retry"}.get(how, how)
    (_single if where == "single" else _batch)(monkeypatch, how)
