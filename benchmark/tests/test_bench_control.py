"""The control, the float32 reference in the program's place, fails every
cell's limits; the program, at the same size, passes them.  On the CPU
at LPs of 300 x 600 (the float32 reference is more accurate on smaller
ones than at the cells' sizes); control.py runs it on the card at the
cells' own."""

import pytest
import torch

from benchmark import control, harness

from conftest import make_tiny_root


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("c") / "root"),
                          rows=300, cols=600, density=0.02)


@pytest.mark.parametrize("cell", ["pilot87-hsd", "midcorpus-batch-hsd",
                                  "midcorpus-batch-pd"])
def test_control_fails_the_limits(control_root, cell):
    c = harness.load_cell(control_root, cell)
    for seed in (1, 2, 3):
        numbers = control.control_numbers(c, seed, 4, torch.device("cpu"))
        assert any(numbers[k] > lim for k, lim in c.limits["limits"].items())


@pytest.mark.parametrize("cell", ["pilot87-hsd", "midcorpus-batch-pd"])
def test_program_passes_the_limits(tiny_root, cell):
    code, result, lines = harness.run_cell(tiny_root, cell, 11, 0.5, False,
                                           "cpu", 0.0)
    assert code == 0 and result["correct"], lines
