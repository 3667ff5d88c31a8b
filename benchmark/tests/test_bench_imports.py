"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
vanderbei_tpu, compared by whole top-level module name (the port,
vanderbei_tpu_torch, begins with the JAX package's name)."""

import os
import subprocess
import sys

from benchmark import harness

PROBE = """
import sys, json
sys.path[0] = {root!r}
from benchmark import harness, drivers, reference, roofline, trace, workload, control
code, result, lines = harness.run_cell({root!r}, "midcorpus-batch-hsd", 3, 0.2, True, "cpu", 0.0)
print(json.dumps([code, result["correct"], harness.forbidden_modules(),
                  sorted(n for n in sys.modules if n.split(".")[0] == "vanderbei_tpu_torch")[:1]]))
"""


def test_a_run_loads_no_jax(tiny_root):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=tiny_root)],
                         capture_output=True, text=True, timeout=300,
                         cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    code, correct, forbidden, port = __import__("json").loads(
        out.stdout.strip().splitlines()[-1])
    assert code == 0 and correct
    assert forbidden == []
    assert port == ["vanderbei_tpu_torch"]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vanderbei_tpu_torch_x", sys)
    assert "vanderbei_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_run_exits_3_when_a_forbidden_module_is_loaded(tiny_root,
                                                      monkeypatch):
    monkeypatch.setitem(sys.modules, "flax", sys)
    code, result, _ = harness.run_cell(tiny_root, "pilot87-hsd", 3, 0.2,
                                       False, "cpu", 0.0)
    assert code == 3 and result is None


def test_run_refuses_without_cards(tiny_root):
    out = subprocess.run(
        [sys.executable, os.path.join(tiny_root, "benchmark", "run.py"),
         "--workload", "pilot87-hsd", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=tiny_root,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == ""
