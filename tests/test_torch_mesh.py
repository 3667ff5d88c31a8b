"""The tensor-parallel slice: vanderbei_tpu_torch.parallel.{mesh,distributed}
and solve(lp, mesh=) on 2 and 4 CPU ranks (gloo), against the JAX
package's on 8 virtual CPU devices and against the port's single-device
solve.

One spawn of the ranks per world size runs every case
(torch_mesh_ranks.tp_rank); each case is its own test on the cached
result.  Bars: make_mesh puts rank r where the JAX grid puts device r, and
an indivisible size raises the JAX package's text; the sharded normal
matrix equals JAX's to rtol 1e-12 and the sharded KKT solve the dense
np.linalg.solve to rtol 1e-8 (tests/test_parallel.py's bars); a
tensor-parallel solve has the status of JAX's tensor-parallel solve and of
the port's single-device solve, the same iterations at "f64" and "dd" and
within 1 at "mixed" (two shards reassociate the f32 sums), the objective
within 1e-10 and x within rtol 1e-5 / atol 1e-6 (tests/test_parallel.py),
and is the same on every rank.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import vanderbei_tpu as vt
import vanderbei_tpu_torch as vtt
from vanderbei_tpu.core import lp as jlp
from vanderbei_tpu.parallel import distributed as jdist
from vanderbei_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vanderbei_tpu_torch.ops.kkt import UbTail
from vanderbei_tpu_torch.parallel.distributed import (ColumnShards,
                                                      column_shard,
                                                      run_ranks)
from vanderbei_tpu_torch.parallel.mesh import make_mesh

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
BARS = {"f64": 0, "mixed": 1, "dd": 0}     # iterations apart


def _jax_lp(lp):
    return jlp.LP(**{f.name: getattr(lp, f.name)
                     for f in dataclasses.fields(jlp.LP)})


_spawned = {}


def _ranks(world):
    """tp_rank on `world` CPU ranks, spawned once per test process."""
    if world not in _spawned:
        _spawned[world] = run_ranks(
            ranks.tp_rank, world, "gloo", "cpu", timeout_s=240)
    return _spawned[world]


_jax_solves = {}


def _jax_tp(kind, method, precision):
    """JAX's tensor-parallel solve, A column-sharded 8 ways."""
    key = kind, method, precision
    if key not in _jax_solves:
        _jax_solves[key] = vt.solve(
            _jax_lp(ranks.tp_lp(kind)), method=method,
            config=vt.SolverConfig(precision=precision),
            mesh=jax_make_mesh(8, model_parallel=8))
    return _jax_solves[key]


def _close(got, want, d_it):
    assert got["status"] == want.status == 0
    assert abs(got["iterations"] - want.iterations) <= d_it
    assert abs(got["obj"] - want.primal_obj) <= 1e-10 * max(
        1.0, abs(want.primal_obj))
    np.testing.assert_allclose(got["x"], want.x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world,model", [(2, 1), (2, 2), (4, 1), (4, 2),
                                         (4, 4)])
def test_make_mesh_layout(world, model):
    want = jax_make_mesh(world, model_parallel=model)
    assert want.axis_names == ("batch", "model")
    grid = [[d.id for d in row] for row in want.devices]
    for out in _ranks(world):
        assert out["layouts"][model] == grid


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_indivisible_text(world):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(world, model_parallel=3)
    assert {out["indivisible"] for out in _ranks(world)} == {str(want.value)}


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, device_type="cpu")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_normal_matrix(world):
    A, D, E, _, _ = ranks.kkt_operands()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("batch", "model"))
    want = np.asarray(jdist.sharded_normal_matrix(
        jnp.asarray(A), jnp.asarray(1.0 / D), jnp.asarray(E), mesh))
    np.testing.assert_allclose(want, A / D @ A.T + np.diag(E), rtol=1e-12)
    for out in _ranks(world):
        np.testing.assert_allclose(out["normal"], want, rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_kkt_solve(world):
    A, D, E, ry, rx = ranks.kkt_operands()
    m = A.shape[0]
    K = np.block([[-np.diag(E), A], [A.T, np.diag(D)]])
    ref = np.linalg.solve(K, np.concatenate([ry, rx]))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("batch", "model"))
    As, Ds, rxs = jdist.place_column_sharded(
        jnp.asarray(A), jnp.asarray(D), jnp.asarray(rx), mesh)
    jdy, jdx = jdist.sharded_kkt_solve(As, jnp.asarray(E), Ds,
                                       jnp.asarray(ry), rxs, mesh)
    for out in _ranks(world):
        dy, dx = out["kkt"]
        np.testing.assert_allclose(dy, ref[:m], rtol=1e-8)
        np.testing.assert_allclose(dx, ref[m:], rtol=1e-8)
        np.testing.assert_allclose(dy, np.asarray(jdy), rtol=1e-8)
        np.testing.assert_allclose(dx, np.asarray(jdx), rtol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind,method,precision", ranks.SOLVE_CASES)
def test_tp_solve(world, kind, method, precision):
    outs = _ranks(world)
    got = outs[0][kind, method, precision]
    for other in outs[1:]:
        o = other[kind, method, precision]
        assert (o["status"], o["iterations"], o["obj"]) == (
            got["status"], got["iterations"], got["obj"])
        np.testing.assert_array_equal(o["x"], got["x"])
    _close(got, _jax_tp(kind, method, precision), BARS[precision])
    single = vtt.solve(ranks.tp_lp(kind), method=method,
                       config=vtt.SolverConfig(precision=precision),
                       device="cpu")
    _close(got, single, BARS[precision])
    if precision == "mixed":
        assert [s["precision"] for s in got["stages"]] == ["f32", "f64"]
    # each stage counted the all-reduces it issued; only "dd" completes
    # its column sums by the compensated sum2
    assert all(s["all_reduces"] > 0 for s in got["stages"])
    assert all((s["all_reduces_sum2"] > 0) == (precision == "dd")
               for s in got["stages"])


@pytest.mark.parametrize("world", WORLDS)
def test_tp_solve_pads_uneven_columns(world):
    """127 columns, exact dims: the mesh pads them to a multiple of the
    model ranks with a zero column, and the answer is the single-device
    one."""
    lp = ranks.tp_lp(n=127)
    single = vtt.solve(lp, pad_to=1, device="cpu")
    got = _ranks(world)[0]["uneven"]
    assert got["x"].shape == (127,)
    _close(got, single, 3)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("where", ranks.TIME_LIMIT_CASES)
def test_tp_time_limit_stops_every_rank_together(world, where):
    """A time limit that has passed on rank 0 alone stops every rank after
    the same first iteration, in the HSD loop and at the retry test of the
    warm-started polish: a rank that went on would leave the others'
    collectives unmatched, and the spawn would time out."""
    outs = [out["time_limit", where] for out in _ranks(world)]
    assert {(o["status"], o["iterations"]) for o in outs} == {
        (int(vtt.Status.ITERATION_LIMIT), 1)}
    assert not any("retry" in s["precision"] for o in outs
                   for s in o["stages"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", ranks.NON_HSD)
def test_tp_rejects_non_hsd(world, method):
    with pytest.raises(ValueError, match="hsd family") as want:
        vt.solve(_jax_lp(ranks.tp_lp()), method=method,
                 mesh=jax_make_mesh(8, model_parallel=8))
    assert {out[method] for out in _ranks(world)} == {str(want.value)}


def test_column_shards_tail_owner_map():
    """Tail rows weigh 0 on the ranks that do not own their column;
    padding rows (weight 0, column 0) belong to the owner of column 0."""
    ub = UbTail(torch.tensor([0, 5, 9, 4, 0]),
                torch.tensor([1.0, 2.0, 3.0, 4.0, 0.0]))
    first, second = ColumnShards(None, 0, 4, 12), ColumnShards(None, 4, 8, 12)
    idx, w2 = first.tail(ub)
    assert first.own.tolist() == [True, False, False, False, True]
    assert idx.tolist() == [0, 0, 0, 0, 0]
    assert w2.tolist() == [1.0, 0.0, 0.0, 0.0, 0.0]
    idx, w2 = second.tail(ub)
    assert second.own.tolist() == [False, True, False, True, False]
    assert idx.tolist() == [0, 1, 0, 0, 0]
    assert w2.tolist() == [0.0, 2.0, 0.0, 4.0, 0.0]
    a = np.arange(24.0).reshape(2, 12)
    np.testing.assert_array_equal(column_shard(a, second), a[:, 4:8])
    assert column_shard(a, second).flags.c_contiguous


def test_failing_rank_fails_the_run_fast():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised") as err:
        run_ranks(ranks.raise_on_rank_1, 2, "gloo", "cpu", timeout_s=120)
    assert "rank 1 fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < 60


def test_hung_ranks_fail_the_run_at_its_limit():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within 5"):
        run_ranks(ranks.hang, 2, "gloo", "cpu", timeout_s=5)
    assert time.monotonic() - t0 < 30
