"""BENCHMARK.json and the files it names: every configuration, traffic
mix, cell and metric parses and is found by name, and the file keeps the
benchmark's contract."""

import json
import os
import re

import pytest

from benchmark import harness

from conftest import REPO

SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][0] == "python3"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in SPEC["workloads"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.load_cell(REPO, cell)
    assert c.traffic["set"] in c.config["sets"]
    assert set(c.limits["limits"]) <= {"not_optimal", "ref_unsolved",
                                       "feas_rel", "obj_rel", "x_rel"}
    e2e = [m["name"] for m in c.metrics(trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.metrics(trace=True), "a cell reports a per-layer metric"
    for m in c.metrics(trace=True):
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_reader(os.path.join(REPO, "benchmark"),
                                        metric))


def test_configs_parse_and_reduce_nothing():
    for c in SPEC["configs"]:
        conf = json.load(open(os.path.join(REPO, c["file"])))
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert conf["reduced"] == c["reduced"] == []
        assert conf["assumed"]


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_metric_workloads_exist():
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
