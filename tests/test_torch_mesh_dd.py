"""The compensated ("dd") reduction across column shards:
ColumnShards.sum2 of ops/quad's unrounded dot2_dd / matvec2_dd partials on
2 and 4 CPU ranks (gloo).

Bars: on inputs whose large terms cancel between the ranks
(torch_mesh_ranks.cancellation_operands) the sharded dot2/matvec2 equal
the single-device ones bit for bit, on every rank, and are the exact sums;
the plain sum of each rank's rounded dot2/matvec2 misses them; a sum2
carries 2 * world times the bytes of its plain twin.  On one device the
rounded *_dd forms give the bits of the dot2/matvec2 they replaced.
"""

import numpy as np
import pytest
import torch

from vanderbei_tpu_torch.ops import quad
from vanderbei_tpu_torch.parallel.distributed import run_ranks

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
_spawned = {}


def _ranks(world):
    if world not in _spawned:
        _spawned[world] = run_ranks(ranks.dd_sum_rank, world, "gloo", "cpu",
                                    timeout_s=120)
    return _spawned[world]


def _single():
    A, X, a, b = (torch.from_numpy(t) for t in ranks.cancellation_operands())
    return [quad.matvec2(A, X).numpy(), quad.matvec2(A, X[:, 0]).numpy(),
            quad.dot2(a, b).numpy()]


@pytest.mark.parametrize("world", WORLDS)
def test_sum2_is_the_single_device_compensated_sum(world):
    single = _single()
    np.testing.assert_array_equal(single[0], [[1.0, 2.0], [1.75, 3.5],
                                              [0.375, 0.75], [136.0, 272.0]])
    np.testing.assert_array_equal(single[2], [2.0 ** -60, 1.5])
    for out in _ranks(world):
        for got, want in zip(out["sharded"], single):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (got, want)
        # summing each rank's rounded partials loses the cancellation
        mv, mv1, dot = out["rounded"]
        assert not np.any(mv[:3] == single[0][:3])
        assert not np.any(mv1[:3] == single[1][:3])
        assert not np.any(dot == single[2])
        assert out["sum2"]["all_reduces_sum2"] == out["sum"][
            "all_reduces_sum"] == 1
        assert (out["sum2"]["all_reduce_bytes"]
                == 2 * world * out["sum"]["all_reduce_bytes"])


def _old_matvec2(A, x):
    """quad.matvec2 as it was before the unrounded forms: per column,
    two_prod, the pairwise tree, hi + lo."""
    def col(v):
        p, e = quad.two_prod(A, v.unsqueeze(-2))
        s = quad._tree(p, e, p.dim() - 1)
        return s.hi + s.lo
    if x.dim() < A.dim():
        return col(x)
    return torch.stack([col(x[..., j]) for j in range(x.shape[-1])], dim=-1)


def _old_dot2(a, b):
    p, e = quad.two_prod(a, b)
    s = quad._tree(p, e, p.dim() - 1)
    return s.hi + s.lo


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rounded_dd_forms_keep_the_single_device_bits(dtype):
    rng = np.random.default_rng(3)
    spread = lambda *s: rng.normal(size=s) * 10.0 ** rng.uniform(-6, 6, s)
    A = torch.from_numpy(spread(3, 17, 33)).to(dtype)
    X = torch.from_numpy(spread(3, 33, 2)).to(dtype)
    for got, want in (
            (quad.matvec2_dd(A, X), _old_matvec2(A, X)),
            (quad.matvec2_dd(A[0], X[0, :, 1]),
             _old_matvec2(A[0], X[0, :, 1])),
            (quad.dot2_dd(A[:, 0], A[:, 1]), _old_dot2(A[:, 0], A[:, 1]))):
        assert isinstance(got, quad.DD)
        rounded = got.hi + got.lo
        assert torch.equal(rounded, want)
    assert torch.equal(quad.matvec2(A, X), _old_matvec2(A, X))
    assert torch.equal(quad.dot2(A[:, 0], A[:, 1]),
                       _old_dot2(A[:, 0], A[:, 1]))
