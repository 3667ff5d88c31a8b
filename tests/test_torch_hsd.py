"""vanderbei_tpu_torch.models.hsd against vanderbei_tpu.models.hsd.

One make_step from the same state (converted with utils.checkpoint's
converters), at iteration 0 and after 5 JAX iterations, for every corrector
and the long step, with and without the UbTail structure: every state field
agrees to rtol 1e-8, atol 1e-12 (one step; the two differ only in
summation order).  Then a JAX solve paused at mu 1e-4 and checkpointed to
npz resumes in the port to the uninterrupted JAX status and objective.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vanderbei_tpu.core import lp as jlp
from vanderbei_tpu.core.canonicalize import canonicalize
from vanderbei_tpu.models import hsd as jhsd
from vanderbei_tpu.models.registry import _hsd_structured_operands
from vanderbei_tpu.ops.kkt import UbTail as JUbTail
from vanderbei_tpu.utils import checkpoint as jckpt
from vanderbei_tpu_torch.models import hsd as thsd
from vanderbei_tpu_torch.utils import checkpoint as tckpt
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

KNOBS = dict(eps=1e-12, step_factor=0.95, beta=0.8, epsdiag=1e-14,
             refine_tol=1e-10, gap_tol=1e-6, feas_tol=1e-6, max_refine=8)


def _operands(structured):
    """A seeded bounded LP as (source, f): the structured head/tail split
    dict, or the dense canonical form with the ub rows in A."""
    lp = random_bounded_lp(24, 40, density=0.2, seed=3)
    jl = jlp.LP(**{f.name: getattr(lp, f.name)
                   for f in dataclasses.fields(jlp.LP)})
    canon = canonicalize(jl, scale="geometric")
    if structured:
        return _hsd_structured_operands(canon, M1=32, K=48, N=48), canon.f
    return canon, canon.f


def _jax_args(src):
    if isinstance(src, dict):
        return (jnp.asarray(src["A1"]), jnp.asarray(src["b"]),
                jnp.asarray(src["c"]),
                JUbTail(jnp.asarray(src["idx2"]), jnp.asarray(src["w2"])))
    return jnp.asarray(src.A), jnp.asarray(src.b), jnp.asarray(src.c), None


def _torch_args(src):
    return tckpt.operands_from_canon(src, "cpu", torch.float64)


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("mode", ["mehrotra", "reference", "long_step"])
@pytest.mark.parametrize("start_iter", [0, 5])
def test_make_step_matches(structured, mode, start_iter):
    src, f = _operands(structured)
    jA, jb, jc, jub = _jax_args(src)
    long_step = mode == "long_step"
    corrector = "reference" if long_step else mode
    extra = 0 if jub is None else jub.idx2.shape[0]
    state = jhsd.init_state(jA, extra_rows=extra)
    if start_iter:
        state = jhsd._hsd_loop(jA, jb, jc, f, state, max_iter=start_iter,
                               pause_mu=0.0, long_step=long_step,
                               corrector=corrector, ub=jub, **KNOBS)
        assert int(state.iter) == start_iter
        assert int(state.status) == -1
    jstep = jax.jit(jhsd.make_step(jA, jb, jc, f=f, long_step=long_step,
                                   corrector=corrector, ub=jub, **KNOBS))
    want = {k: np.asarray(v) for k, v in jstep(state)._asdict().items()}

    tA, tb, tc, tub = _torch_args(src)
    tstate = tckpt.state_from_numpy(
        {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")
    tstep = thsd.make_step(tA, tb, tc, f=f, long_step=long_step,
                           corrector=corrector, ub=tub, **KNOBS)
    got = tckpt.state_to_numpy(tstep(tstate))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-12,
                                   err_msg=k)


def test_pause_in_jax_resume_in_port(tmp_path):
    src, f = _operands(structured=True)
    jA, jb, jc, jub = _jax_args(src)
    full = jhsd.solve_canon(jA, jb, jc, f, ub=jub)
    paused = jhsd.solve_canon(jA, jb, jc, f, ub=jub, pause_mu=1e-4)[-1]
    assert int(paused.status) == -1 and 0 < int(paused.iter) < int(full[5])
    path = str(tmp_path / "state.npz")
    jckpt.save_state(path, paused)

    tA, tb, tc, tub = _torch_args(src)
    loaded = tckpt.load_state(path, "cpu")
    assert loaded.x.dtype == torch.float64
    assert int(loaded.iter) == int(paused.iter)
    st, x, *_ = thsd.solve_canon(tA, tb, tc, f, ub=tub, init=loaded)
    assert int(st) == int(full[0]) == 0
    want = float(jc @ full[1]) + f
    got = float(tc @ x) + f
    assert abs(got - want) <= 1e-9 * abs(want)


def test_state_npz_roundtrip(tmp_path):
    src, f = _operands(structured=False)
    tA, tb, tc, _ = _torch_args(src)
    state = thsd.solve_canon(tA, tb, tc, f, pause_mu=1e-2)[-1]
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, state)
    back = jckpt.load_state(path, jhsd.HsdState)      # the JAX loader reads it
    for k, v in tckpt.state_to_numpy(state).items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), v)
