"""vanderbei_tpu_torch.ops.syrk against the TPU kernel it replaces,
vanderbei_tpu.ops.pallas_kernels.scaled_syrk_pallas run in interpret mode.

On the CPU the dispatcher takes the plain torch version; the CUDA kernel
itself is held against that version on the card by chip_smoke.py.
Tolerance: rtol 2e-5, atol 2e-4, as tests/test_pallas.py holds the TPU
kernel (f32 sums over n <= 1024 terms in two orders).

The kernel's arithmetic (3xTF32: each operand split into TF32 hi and lo,
M = hi*hi' + hi*lo' + lo*hi') is emulated here in torch and held to the
same tolerances, and the kernel's build cache is exercised with a fake
nvcc.
"""

import subprocess

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
    before = syrk.launch_count()
    got = syrk.scaled_syrk(A, s, e)
    assert syrk.launch_count() == before
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


# ---- the kernel's numerics, emulated ----------------------------------------

def _tf32_rna(x):
    """Round f32 to TF32 (11 significant bits), ties away from zero, as
    cvt.rna.tf32.f32 does."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _syrk_tf32(X, s, e, terms=3):
    """M as the kernel forms it: the row side scaled in f32 and rounded
    once, both sides split into TF32 hi + lo, f32 products."""
    a_hi, a_lo = _split(X * s.unsqueeze(-2))
    b_hi, b_lo = _split(X)
    M = a_hi @ b_hi.mT
    if terms == 3:
        M = M + (a_lo @ b_hi.mT + a_hi @ b_lo.mT)
    return M + torch.diag_embed(e)


def _f64(A, s, e):
    A = A.astype(np.float64)
    return (A * s) @ A.T + np.diag(e.astype(np.float64))


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    got = _tf32_rna(x)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 3.0], dtype=torch.float32)
    assert torch.equal(got, want)
    hi, lo = _split(torch.tensor([1.0 + 2.0 ** -20], dtype=torch.float32))
    assert hi.item() == 1.0 and lo.item() == 2.0 ** -20


@pytest.mark.parametrize("m,n", [(256, 512), (128, 1024), (256, 256)])
def test_3xtf32_matches_pallas_and_f64(m, n):
    A, s, e = _inputs(m, n, seed=5)
    got = _syrk_tf32(*map(torch.from_numpy, (A, s, e))).numpy()
    np.testing.assert_allclose(got, _pallas(A, s, e), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _f64(A, s, e), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,n", [(256, 512), (128, 1024), (256, 256)])
def test_1xtf32_misses_the_tolerance(m, n):
    """One TF32 product is not f32-accurate: the split is needed."""
    A, s, e = _inputs(m, n, seed=5)
    got = _syrk_tf32(*map(torch.from_numpy, (A, s, e)), terms=1).numpy()
    assert not np.allclose(got, _f64(A, s, e), rtol=RTOL, atol=ATOL)


def test_3xtf32_entrywise_bound_with_spread_scale():
    """|M - M_f64| <= 1e-4 (|X| diag|s| |X|' + diag|e|), chip_smoke.py's
    bound, with s spread over 1e-8..1e8."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(256, 4096)).astype(np.float32)
    s = (10.0 ** rng.uniform(-8.0, 8.0, 4096)).astype(np.float32)
    e = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    got = _syrk_tf32(*map(torch.from_numpy, (A, s, e))).numpy()
    G = _f64(np.abs(A), np.abs(s), np.abs(e))
    err = np.abs(got - _f64(A, s, e)) / G
    assert err.max() <= 1e-4


# ---- the build cache --------------------------------------------------------

@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A csrc/ of two files and an nvcc that only writes its -o file;
    returns (csrc path, list of nvcc command lines)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "scaled_syrk.cu").write_text('#include "hopper.cuh"\n')
    (csrc / "hopper.cuh").write_text("// helpers\n")
    monkeypatch.setattr(syrk, "CSRC", str(csrc))
    monkeypatch.setattr(syrk, "SOURCE", str(csrc / "scaled_syrk.cu"))
    monkeypatch.setattr(syrk, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(syrk, "_nvcc", lambda: "nvcc")
    calls = []

    def run(cmd, **kwargs):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(syrk.subprocess, "run", run)
    return csrc, calls


def test_build_reuses_library_of_unchanged_tree(fake_build):
    _, calls = fake_build
    first = syrk.build()
    assert syrk.build() == first and len(calls) == 1
    assert calls[0][-1] == syrk.SOURCE


def test_build_rebuilds_after_header_edit(fake_build):
    csrc, calls = fake_build
    first = syrk.build()
    (csrc / "hopper.cuh").write_text("// helpers, edited\n")
    second = syrk.build()
    assert second != first and len(calls) == 2
    assert syrk.build() == second and len(calls) == 2


def test_build_rebuilds_after_new_source(fake_build):
    csrc, calls = fake_build
    first = syrk.build()
    (csrc / "extra.cuh").write_text("// more\n")
    assert syrk.build() != first and len(calls) == 2


def test_build_rebuilds_after_flag_change(fake_build, monkeypatch):
    _, calls = fake_build
    first = syrk.build()
    monkeypatch.setattr(syrk, "NVCC_FLAGS", [*syrk.NVCC_FLAGS, "-lcuda"])
    assert syrk.build() != first and len(calls) == 2
    assert "-lcuda" in calls[1]
