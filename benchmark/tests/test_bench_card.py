"""A whole run on the card: `python -m pytest benchmark/tests -m card` on a
machine with a CUDA device runs the pd cell for a few seconds."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.card
def test_pd_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "run.py"),
         "--workload", "midcorpus-batch-pd", "--seed", "4000000001",
         "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
