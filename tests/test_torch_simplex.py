"""The pd and twophase simplex methods: vanderbei_tpu_torch against
vanderbei_tpu on the CPU.

Bars: given the JAX package's own perturbation draw, the port pivots the
same way, so the same status, the same pivot count and the canonical
objective within 1e-9 relative (x within 1e-9); with the port's own
torch.Generator draw the path differs, and the same status and the
objective within 1e-9 relative remain.  Optimal, infeasible and unbounded
LPs, as tests/test_solvers.py builds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vanderbei_tpu as vt
import vanderbei_tpu_torch as vtt
from tests.test_canonicalize import make_lp
from tests.test_torch_solve import _jax_lp, _port_lp
from vanderbei_tpu.core.canonicalize import canonicalize as jcanonicalize
from vanderbei_tpu.models import simplex as jsimplex
from vanderbei_tpu_torch.core.canonicalize import canonicalize
from vanderbei_tpu_torch.models import simplex as tsimplex
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)

LPS = {
    "optimal60": lambda: _jax_lp(random_bounded_lp(60, 120, seed=0)),
    "optimal100": lambda: _jax_lp(random_bounded_lp(100, 200, seed=1)),
    "infeasible": lambda: make_lp([[1.0], [-1.0]], [2.0, -1.0], [1.0]),
    "unbounded": lambda: make_lp([[1.0, -1.0]], [-1.0], [1.0, 1.0],
                                 maximize=True),
}
STATUS = {"optimal60": 0, "optimal100": 0,
          "infeasible": int(vtt.Status.PRIMAL_INFEASIBLE),
          "unbounded": int(vtt.Status.PRIMAL_UNBOUNDED)}


def _jax_draws(method, seed, m, n):
    """The U[0,1) draws vanderbei_tpu's simplex takes from PRNGKey(seed)."""
    key = jax.random.PRNGKey(seed)
    if method == "twophase":
        return None, np.asarray(jax.random.uniform(key, (n,), jnp.float64))
    kx, ky = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kx, (m,), jnp.float64)),
            np.asarray(jax.random.uniform(ky, (n,), jnp.float64)))


@pytest.mark.parametrize("method", ["pd", "twophase"])
@pytest.mark.parametrize("name", sorted(LPS))
def test_same_pivots_with_jax_draw(method, name):
    lp = LPS[name]()
    cfg = vt.SolverConfig(method=method)
    jcanon = jcanonicalize(lp)
    tcanon = canonicalize(_port_lp(lp))
    solve_j = {"pd": jsimplex.solve_canon_pd,
               "twophase": jsimplex.solve_canon_twophase}[method]
    solve_t = {"pd": tsimplex.solve_canon_pd,
               "twophase": tsimplex.solve_canon_twophase}[method]
    want = [np.asarray(v) for v in solve_j(jcanon, cfg)]
    stages = []
    got = solve_t(tcanon, vtt.SolverConfig(method=method), "cpu", stages,
                  draws=_jax_draws(method, cfg.seed, *tcanon.A.shape))
    assert int(got[0]) == int(want[0]) == STATUS[name]
    assert int(got[5]) == int(want[5]) == stages[0]["iterations"]
    if STATUS[name] == 0:
        obj_j = float(tcanon.c @ want[1])
        obj_t = float(tcanon.c @ got[1])
        assert obj_t == pytest.approx(obj_j, rel=1e-9)
        for a, b in zip(got[1:5], want[1:5]):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", ["pd", "twophase"])
@pytest.mark.parametrize("name", sorted(LPS))
def test_own_draw_same_answer(method, name):
    lp = LPS[name]()
    want = vt.solve(lp, method=method)
    got = vtt.solve(_port_lp(lp), method=method, device="cpu")
    assert got.status == want.status == STATUS[name]
    if want.status == 0:
        assert got.primal_obj == pytest.approx(want.primal_obj, rel=1e-9)
        assert got.x.shape == want.x.shape and got.y.shape == want.y.shape


def test_draws_come_from_the_seed():
    cfg = vtt.SolverConfig(seed=7)
    a, b = tsimplex.perturbation_draws(cfg, 5, 9), \
        tsimplex.perturbation_draws(cfg, 5, 9)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert a[0].shape == (5,) and a[1].shape == (9,)
    assert not torch.equal(
        tsimplex.perturbation_draws(cfg.with_(seed=8), 5, 9)[1], a[1])
    assert a[1].dtype == torch.float64
    assert bool(((a[1] >= 0) & (a[1] < 1)).all())


@pytest.mark.parametrize("method", ["pd", "twophase"])
def test_time_limit_stops_pivoting(method):
    """TIMLIM: a zero budget stops after the first pivot with the
    iteration-limit status, in both methods (vanderbei_tpu's twophase
    does not check the deadline)."""
    lp = _port_lp(LPS["optimal100"]())
    sol = vtt.solve(lp, method=method, device="cpu",
                    config=vtt.SolverConfig(time_limit=0.0))
    assert sol.status == int(vtt.Status.ITERATION_LIMIT)
    assert sol.iterations == 1
