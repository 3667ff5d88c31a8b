"""vanderbei_tpu_torch/tools/multichip_scaling.py, the port of
scripts/multichip_scaling.py, on 2 CPU ranks (gloo): a generated class of
4 seeded bounded LPs ("s", 128, 128, 128), 2 lanes a rank.

Bars: the JSON line has every field the tool documents; every lane is
OPTIMAL and the sharded statuses and iterations equal the single run's in
every run; a mismatch makes the tool exit 1.
"""

import copy
import json

import numpy as np
import pytest
import torch

from vanderbei_tpu_torch.tools import multichip_scaling as tool

torch.set_num_threads(1)

DIMS = [(60 + j, 120 + 2 * j, j) for j in range(4)]
FIELDS = {"n_ranks", "backend", "card", "batch", "class", "t_single_s",
          "t_sharded_s", "overhead_frac", "reps_single_s", "reps_sharded_s",
          "all_lanes_optimal", "launches", "busy"}
_cache = {}


def _results():
    if "results" not in _cache:
        _cache["results"] = tool.measure(2, "gloo", "cpu",
                                         class_args=(DIMS, 128),
                                         timeout_s=240)
    return _cache["results"]


def test_line_fields_and_verdicts():
    results = _results()
    line, faults = tool.summary(results, "gloo", "cpu")
    assert faults == []
    assert set(line) == FIELDS
    json.loads(json.dumps(line))
    assert (line["n_ranks"], line["backend"], line["batch"]) == (2, "gloo", 4)
    assert line["class"] == ["s", 128, 128, 128]
    assert line["all_lanes_optimal"] is True
    assert line["t_single_s"] > 0 and line["t_sharded_s"] > 0
    assert line["overhead_frac"] == pytest.approx(
        line["t_sharded_s"] / line["t_single_s"] - 1.0)
    for t, reps in (("t_single_s", "reps_single_s"),
                    ("t_sharded_s", "reps_sharded_s")):
        assert len(line[reps]) == tool.REPS
        assert line[t] == np.median(line[reps])
    # the CPU runs launch no kernel and trace no device time
    assert line["launches"] == [{}, {}] and line["busy"] == [0.0, 0.0]
    single, sharded = results[0]["single"], results[0]["sharded"]
    assert [r["label"] for r in single] == list(range(tool.REPS + 1))
    for s, p in zip(single, sharded):
        np.testing.assert_array_equal(s["status"], 0)
        np.testing.assert_array_equal(p["status"], s["status"])
        np.testing.assert_array_equal(p["iters"], s["iters"])
    # every rank gathered the same class
    for s, p in zip(sharded, results[1]["sharded"]):
        np.testing.assert_array_equal(s["iters"], p["iters"])


def test_mismatch_exits_nonzero(monkeypatch, tmp_path, capsys):
    results = copy.deepcopy(_results())
    results[0]["sharded"][2]["iters"][1] += 1
    monkeypatch.setattr(tool, "measure", lambda *a, **k: results)
    monkeypatch.setattr(tool, "card_line", lambda: "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    out = tmp_path / "line.json"
    assert tool.main(["--ranks", "2", "--out", str(out)]) == 1
    assert "differ from the single run's" in capsys.readouterr().err
    assert json.loads(out.read_text())["n_ranks"] == 2
    _, faults = tool.summary(_results(), "gloo", "cpu")
    assert faults == []
