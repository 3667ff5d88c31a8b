"""The roofline counts on known shapes."""

import types

import pytest

from benchmark import roofline

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_counts_on_known_shapes():
    assert roofline.assembly_madds(2, 3) == 9
    assert roofline.assembly_bytes(2, 3) == 4 * (6 + 3 + 2 + 3)
    m, n = 2030, 4883
    assert roofline.assembly_madds(m, n) == 2030 * 2031 // 2 * 4883


def test_pilot87_assembly_is_compute_bound():
    m, n = 2030, 4883
    ops = 2 * roofline.assembly_madds(m, n) / H100["tf32_flops"]
    mem = roofline.assembly_bytes(m, n) / H100["hbm_bytes_s"]
    assert ops > mem
    assert roofline.assembly_bound_s(m, n, H100) == pytest.approx(
        4.0666e-5, rel=1e-3)


def test_thin_assembly_is_memory_bound():
    assert (roofline.assembly_bound_s(4, 10**6, H100)
            == roofline.assembly_bytes(4, 10**6) / H100["hbm_bytes_s"])


def test_share_counts_unpadded_stopped_lanes_as_waste():
    run = types.SimpleNamespace(
        card="NVIDIA H100 80GB HBM3",
        trace={"ops": {"void scaled_syrk_kernel<true, true>(...)": 1e-3,
                       "other": 5.0}},
        requests=[{"shapes": [(1000, 2000), (1000, 2000)],
                   "f32_iterations": [10, 0], "traced": True},
                  {"shapes": [(1000, 2000)], "f32_iterations": [10],
                   "traced": False}])
    want = 100 * 10 * roofline.assembly_bound_s(1000, 2000, H100) / 1e-3
    assert roofline.kernel_share(run) == pytest.approx(want)


def test_share_is_silent_without_a_kernel_or_a_known_card():
    run = types.SimpleNamespace(card="NVIDIA H100 80GB HBM3",
                                trace={"ops": {"gemm": 1.0}}, requests=[])
    assert roofline.kernel_share(run) is None
    run.card, run.trace = "cpu", {"ops": {roofline.KERNEL: 1.0}}
    assert roofline.kernel_share(run) is None
