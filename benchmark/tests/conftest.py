"""Benchmark tests: they run on the CPU, except those marked `card`, which
need a CUDA device and skip without one (the `card` fixture decides, at
run time).

    python -m pytest benchmark/tests -q

`tiny_root` is a copy of the benchmark (BENCHMARK.json and benchmark/)
whose configurations are cut to LPs of a few dozen rows, with the program
linked beside it, so that a whole run fits a test on the CPU.
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_tiny_root(dst: str, rows: int = 24, cols: int = 48,
                   density: float = 0.3) -> str:
    """A copy of the benchmark at dst with every LP set cut to `rows` and
    `cols` (and a few more along a set), at `density` (0.3: no row is
    empty at 24 x 48), the cells on four chips cut to two, and the program
    linked beside it."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "vanderbei_tpu_torch"),
               os.path.join(dst, "vanderbei_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            conf = json.load(f)
        for s in conf["sets"].values():
            s["rows"] = [rows, 2 if s["rows"][1] else 0]
            s["cols"] = [cols, 4 if s["cols"][1] else 0]
            s["count"] = min(s["count"], 4)
        conf["generator"]["density"] = density
        with open(path, "w") as f:
            json.dump(conf, f)
    for w in spec["workloads"]:
        w["chips"] = min(w["chips"], 2)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path / "root"))
