"""A cell, a traffic mix, a configuration and a metric are added as new
files and new BENCHMARK.json entries, with no edit to a file that is
there: the harness finds them by name and runs the new cell."""

import json
import os

from benchmark import harness

DUMMY_METRIC = '''
def read(run):
    return float(len(run.requests))
'''


def test_added_cell_and_metric_are_picked_up(tiny_root):
    bench = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(bench, "configs", "dummy-lp.json"), "w") as f:
        json.dump({"name": "dummy-lp", "generator": {"density": 0.4},
                   "sets": {"one": {"rows": [20, 0], "cols": [40, 0],
                                    "count": 1}},
                   "assumed": ["a test"], "reduced": []}, f)
    with open(os.path.join(bench, "traffic", "dummy-single.json"), "w") as f:
        json.dump({"set": "one", "entry": "solve", "method": "hsd",
                   "pool": 2}, f)
    with open(os.path.join(bench, "cells", "dummy-cell.json"), "w") as f:
        json.dump({"limits": {"not_optimal": 0, "obj_rel": 1e-7}}, f)
    with open(os.path.join(bench, "metrics", "requests_seen.py"), "w") as f:
        f.write(DUMMY_METRIC)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    spec = json.load(open(path))
    spec["configs"].append({"name": "dummy-lp", "source": "a test",
                            "file": "benchmark/configs/dummy-lp.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy-lp",
                              "traffic": "dummy-single", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "requests_seen", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "lps_per_s",
                              "workloads": ["dummy-cell"]})
    json.dump(spec, open(path, "w"))

    cell = harness.load_cell(tiny_root, "dummy-cell")
    assert [m["name"] for m in cell.metrics(trace=True)] == ["requests_seen"]
    code, result, lines = harness.run_cell(tiny_root, "dummy-cell", 5, 0.5,
                                           True, "cpu", 0.0)
    assert code == 0 and result["correct"], lines
    assert result["metrics"]["requests_seen"]["value"] >= 1
    assert list(result)[-1] == "checks"
    code, result, _ = harness.run_cell(tiny_root, "dummy-cell", 5, 0.5,
                                       False, "cpu", 0.0)
    assert set(result["metrics"]) == {"lps_per_s", "latency_p50_s",
                                      "setup_s"}
