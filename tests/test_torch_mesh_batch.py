"""Sharded batches: parallel.batch.shard_batch + solve_batch_hsd(mesh=) +
gather_lanes on a (2, 2) mesh of 4 CPU ranks (gloo), against the JAX
package's solve_batch_hsd on shard_batch'd arrays over make_mesh(8, 2).

One spawn runs every case (torch_mesh_ranks.batch_rank): a dense class
of 8 raw 24 x 64 lanes and a structured (UbTail) class of 8 seeded bounded
LPs, ("s", 64, 128, 128), both mixed, and the dense class again in f64
with compensated ("dd") sums, whose column sums go through
ColumnShards.sum2.  Bars, lane by lane: the same status and iterations as
JAX's sharded solve and as the port's single-device batch, the objective
c'x within 1e-10 (relative, floor 1); every rank assembles the same
class.  A rank's block is the block JAX puts on the device of its
mesh coordinates.
"""

import numpy as np
import pytest
import torch

from vanderbei_tpu.ops.kkt import UbTail as JUbTail
from vanderbei_tpu.parallel import batch as jb
from vanderbei_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vanderbei_tpu_torch.parallel import batch as tb
from vanderbei_tpu_torch.parallel.distributed import run_ranks

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

KINDS = ("dense", "structured")
CASES = tuple(ranks.BATCH_CASES)
LANES = range(8)
_cache = {}


def _ranks():
    if "ranks" not in _cache:
        _cache["ranks"] = run_ranks(
            ranks.batch_rank, 4, "gloo", "cpu", timeout_s=240)
    return _cache["ranks"]


def _jax(case):
    """JAX's solve of the case's class, batch-sharded 4 ways and A's
    columns 2 ways over make_mesh(8, 2)."""
    if case not in _cache:
        kind, kw = ranks.BATCH_CASES[case]
        A, b, c, ub = ranks.batch_class(kind)
        arrays = [A, b, c] + ([] if ub is None else [ub.idx2, ub.w2])
        placed = jb.shard_batch(arrays, jax_make_mesh(8, model_parallel=2),
                                model_axis_dims=(2, None, 1))
        A_s, b_s, c_s = placed[:3]
        ub_s = None if ub is None else JUbTail(*placed[3:])
        out = jb.solve_batch_hsd(A_s, b_s, c_s, ub=ub_s, **kw)
        _cache[case] = [np.asarray(t) for t in out]
    return _cache[case]


def _single(case):
    """The port's single-device batched solve of the case's class."""
    key = case, "single"
    if key not in _cache:
        kind, kw = ranks.BATCH_CASES[case]
        A, b, c, ub = ranks.batch_class(kind)
        _cache[key] = [t.numpy() for t in tb.solve_batch_hsd(
            A, b, c, ub=ub, device="cpu", **kw)]
    return _cache[key]


def _objective(c, x):
    return float(c @ x)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("case", CASES)
def test_sharded_batch_lane(case, lane):
    kind, kw = ranks.BATCH_CASES[case]
    A, b, c, ub = ranks.batch_class(kind)
    outs = [out[case] for out in _ranks()]
    st, x, _, _, _, it = outs[0]
    for other in outs[1:]:
        for a, o in zip(outs[0], other):
            np.testing.assert_array_equal(a, o)
    # only the compensated case completes its column sums by sum2
    compensated = kw.get("compensated", False)
    for out in _ranks():
        assert all((s["all_reduces_sum2"] > 0) == compensated
                   for s in out[case, "stages"])
    for ref in (_jax(case), _single(case)):
        assert st[lane] == ref[0][lane] == 0
        assert it[lane] == ref[5][lane]
        want = _objective(c[lane], ref[1][lane])
        assert abs(_objective(c[lane], x[lane]) - want) <= 1e-10 * max(
            1.0, abs(want))


@pytest.mark.parametrize("kind", KINDS)
def test_shard_batch_blocks_are_jax_device_blocks(kind):
    """Rank r's block of each array is what JAX's shard_batch places on
    the device at the same (batch, model) coordinates of a (2, 2) mesh."""
    A, b, c, ub = ranks.batch_class(kind)
    arrays = [A, b, c] + ([] if ub is None else [ub.idx2, ub.w2])
    mesh = jax_make_mesh(4, model_parallel=2)
    placed = jb.shard_batch(arrays, mesh, model_axis_dims=(2, None, 1))
    grid = mesh.devices
    for out in _ranks():
        i, j = out["coords"]
        dev = grid[i, j]
        for block, arr in zip(out[kind, "blocks"], placed):
            shard, = [s for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(block, np.asarray(shard.data))


def test_batch_sharding_and_replicated():
    for rank, out in enumerate(_ranks()):
        i, _ = out["coords"]
        np.testing.assert_array_equal(out["batch_sharding"],
                                      np.arange(8.0)[4 * i:4 * i + 4])
        np.testing.assert_array_equal(out["replicated"], np.zeros(3))
