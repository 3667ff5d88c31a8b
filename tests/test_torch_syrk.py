"""vanderbei_tpu_torch.ops.syrk against the TPU kernel it replaces,
vanderbei_tpu.ops.pallas_kernels.scaled_syrk_pallas run in interpret mode.

On the CPU the dispatcher takes the plain torch version; the CUDA kernel
itself is held against that version on the card by chip_smoke.py.
Tolerance: rtol 2e-5, atol 2e-4, as tests/test_pallas.py holds the TPU
kernel (f32 sums over n <= 1024 terms in two orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vanderbei_tpu.ops.pallas_kernels import scaled_syrk_pallas
from vanderbei_tpu_torch.ops import syrk

RTOL, ATOL = 2e-5, 2e-4


def _inputs(m, n, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(*lead, m, n)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, (*lead, n)).astype(np.float32)
    e = rng.uniform(0.5, 2.0, (*lead, m)).astype(np.float32)
    return A, s, e


def _pallas(A, s, e):
    return np.asarray(scaled_syrk_pallas(
        jnp.asarray(A), jnp.asarray(s), jnp.asarray(e), block_m=128,
        block_k=256 if A.shape[1] >= 256 else 128, interpret=True))


@pytest.mark.parametrize("m,n", [(256, 512), (128, 1024), (256, 256)])
def test_reference_matches_pallas(m, n):
    A, s, e = _inputs(m, n)
    got = syrk.scaled_syrk_reference(*map(torch.from_numpy, (A, s, e)))
    np.testing.assert_allclose(got.numpy(), _pallas(A, s, e), rtol=RTOL,
                               atol=ATOL)


def test_transposed_view_matches_pallas():
    """The dual form passes A' as a strided view (no copy)."""
    At, s, e = _inputs(512, 256, seed=1)       # stored (n, m)
    s, e = e, s                                # s spans n = 512, e m = 256
    X = torch.from_numpy(At).mT
    assert X.stride() == (1, 256)
    got = syrk.scaled_syrk(X, torch.from_numpy(s), torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy(), _pallas(At.T.copy(), s, e),
                               rtol=RTOL, atol=ATOL)


def test_batch_matches_pallas_per_lane():
    A, s, e = _inputs(128, 256, seed=2, lead=(3,))
    got = syrk.scaled_syrk(*map(torch.from_numpy, (A, s, e))).numpy()
    assert got.shape == (3, 128, 128)
    for b in range(3):
        np.testing.assert_allclose(got[b], _pallas(A[b], s[b], e[b]),
                                   rtol=RTOL, atol=ATOL)


def test_diagonal_only_on_diagonal():
    m = 128
    e = torch.arange(m, dtype=torch.float32)
    got = syrk.scaled_syrk(torch.zeros(m, m), torch.ones(m), e)
    np.testing.assert_array_equal(got.numpy(), np.diag(e.numpy()))


def test_cpu_tensor_routes_to_plain_version():
    A, s, e = map(torch.from_numpy, _inputs(64, 96, seed=3))
    before = syrk.launches
    got = syrk.scaled_syrk(A, s, e)
    assert syrk.launches == before
    assert torch.equal(got, syrk.scaled_syrk_reference(A, s, e))


def test_kernel_wrapper_refuses_cpu_tensors():
    A, s, e = map(torch.from_numpy, _inputs(8, 8, seed=4))
    with pytest.raises(ValueError, match="must lie on"):
        syrk.scaled_syrk_cuda(A, s, e)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No compiler means an error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        syrk.build(force=True)
