"""The corpus harness: vanderbei_tpu_torch.evaluate against
vanderbei_tpu.evaluate on the CPU, over a temporary corpus.

VANDERBEI_TPU_NETLIB points both packages at a directory of seeded LPs
written under a few NETLIB_GOLDEN file names, plus one LP with a free
variable (aborted under free_vars="reject").  The golden columns of the
records are meaningless on such a corpus and are not compared.  Bars, per
record: the same status; iterations within 3 for the batched IPMs (their
f32 sprint) and within 1 per problem; the objective within 1e-8 relative
(hsd), 1e-7 (intpt, which stops at a 1e-6 gap); pd, given the JAX
package's per-lane draws, the same pivot count and objective within 1e-9.
Also: the golden table is the JAX package's, sweep.py's repair pass
re-runs error rows, and the harness's entry points refuse a missing CUDA
device.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_batch import _jax_pd_draws
from vanderbei_tpu import evaluate as jev
from vanderbei_tpu.core.config import SolverConfig as JConfig
from vanderbei_tpu.io import netlib as jnetlib
from vanderbei_tpu.io import netlib_golden as jgolden
from vanderbei_tpu_torch import evaluate as tev
from vanderbei_tpu_torch import sweep as tsweep
from vanderbei_tpu_torch import write_lp
from vanderbei_tpu_torch.core.builder import LPBuilder
from vanderbei_tpu_torch.core.config import SolverConfig as TConfig
from vanderbei_tpu_torch.io import netlib as tnetlib
from vanderbei_tpu_torch.io import netlib_golden as tgolden
from vanderbei_tpu_torch.models import simplex as tsimplex
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)

NAMES = ["AFIRO", "SC50A", "KB2", "BLEND"]      # seeded LPs under these
FREE = "CAPRI"                                  # the free-variable LP
BARS = {"hsd": (3, 1e-8), "intpt": (3, 1e-7), "pd": (0, 1e-9)}


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    d = tmp_path / "netlib"
    d.mkdir()
    for j, name in enumerate(NAMES):
        lp = random_bounded_lp(20 + 2 * j, 40 + 3 * j, density=0.15, seed=j)
        write_lp(lp, str(d / tgolden.NETLIB_GOLDEN[name][0]))
    free = LPBuilder("free")
    free.var("x", lower=-np.inf, obj=1.0)
    free.var("y", upper=4.0, obj=1.0)
    free.constraint("r", {"x": 1.0, "y": 1.0}, lo=-2.0, hi=3.0)
    write_lp(free.build(), str(d / tgolden.NETLIB_GOLDEN[FREE][0]))
    monkeypatch.setenv("VANDERBEI_TPU_NETLIB", str(d))
    # no reference tree in either package
    monkeypatch.setattr(jev, "REFERENCE_EVAL", str(tmp_path / "none"))
    monkeypatch.delenv("VANDERBEI_TPU_REFERENCE_EVAL", raising=False)
    return d


def _compare(want, got, method):
    d_it, rel = BARS[method]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for w, g in zip(want, got):
        assert g["status"] == w["status"], (w, g)
        assert abs(g["iterations"] - w["iterations"]) <= d_it, (w, g)
        if w["status"] == 0:
            err = abs(g["objective"] - w["objective"])
            assert err <= rel * max(1.0, abs(w["objective"])), (w, g)
        for k in ("rows", "cols", "nonzeros", "golden"):
            assert g[k] == w[k]


def test_golden_table_equal():
    assert tgolden.NETLIB_GOLDEN == jgolden.NETLIB_GOLDEN
    assert tgolden.ONDISK_OVERRIDES == jgolden.ONDISK_OVERRIDES


def test_corpus_listing(corpus):
    assert tnetlib.netlib_dir() == jnetlib.netlib_dir() == str(corpus)
    assert tnetlib.available_problems() == jnetlib.available_problems()
    assert set(tnetlib.available_problems()) == set(NAMES) | {FREE}
    assert tnetlib.available_problems(max_rows=60) == \
        jnetlib.available_problems(max_rows=60)
    lp = tnetlib.load("AFIRO")
    assert lp.m == 20 and lp.n == 40
    assert tnetlib.ondisk_objective("PILOT") == jnetlib.ondisk_objective(
        "PILOT")


@pytest.mark.parametrize("method", ["hsd", "intpt", "pd"])
def test_run_sweep_batched(corpus, tmp_path, monkeypatch, method):
    names = NAMES + [FREE]
    if method == "pd":
        # the JAX package's per-lane perturbation draws
        monkeypatch.setattr(
            tsimplex, "perturbation_draws", lambda cfg, m, n, lanes:
            _jax_pd_draws(*lanes, m, n, cfg.seed))
    kw = dict(method=method, names=names, granularity=128, max_batch=512,
              progress=False)
    want = jev.run_sweep_batched(config=JConfig(free_vars="reject"),
                                 out_dir=str(tmp_path / "jax"), **kw)
    got = tev.run_sweep_batched(config=TConfig(free_vars="reject"),
                                out_dir=str(tmp_path / "port"), device="cpu",
                                **kw)
    _compare(want, got, method)
    by = {r["name"]: r for r in got}
    assert by[FREE]["status"] not in (-1, 0)
    assert all(by[n]["status"] == 0 for n in NAMES)
    # the results trees: one .sol per problem, a README, the records
    for tree in ("jax", "port"):
        d = tmp_path / tree / "netlib" / method
        assert (d / "README.md").exists()
        sols = sorted(p.name for p in d.glob("*.sol"))
        assert sols == sorted(tgolden.NETLIB_GOLDEN[n][0] + ".sol"
                              for n in names)
    recs = json.loads((tmp_path / "port" / "netlib" / method /
                       "records.json").read_text())
    assert {r["name"] for r in recs} == set(names)


@pytest.mark.parametrize("method", ["hsd", "intpt"])
def test_run_sweep_per_problem(corpus, method):
    kw = dict(method=method, names=NAMES[:2], progress=False)
    want = jev.run_sweep(config=JConfig(), **kw)
    got = tev.run_sweep(config=TConfig(), device="cpu", **kw)
    # per problem: the registry's "auto" precision, f64 at these sizes
    _compare(want, got, method)


def test_big_classes_route_per_problem(corpus):
    """max_batch below every class sends each problem through run_sweep."""
    kw = dict(method="hsd", names=NAMES[:2], granularity=128, max_batch=32,
              progress=False)
    want = jev.run_sweep_batched(config=JConfig(), **kw)
    got = tev.run_sweep_batched(config=TConfig(), device="cpu", **kw)
    _compare(want, got, "hsd")


def test_make_record_fields():
    lp = random_bounded_lp(5, 9)
    rec = tev._make_record("AFIRO", lp, 0, tnetlib.ondisk_objective("AFIRO"),
                           17, 1.2345, {})
    assert rec == jev._make_record("AFIRO", lp, 0,
                                   jnetlib.ondisk_objective("AFIRO"), 17,
                                   1.2345, {})
    assert rec["relerr"] < 1e-12 and rec["seconds"] == 1.234


def test_client_alive_on_cpu():
    assert tev._client_alive("cpu")


@pytest.mark.parametrize("entry", [
    lambda: tev.main(["--names", "AFIRO", "--batch"]),
    lambda: tev.main(["--names", "AFIRO"]),
    lambda: tev.run_sweep_batched(names=["AFIRO"], progress=False),
    lambda: tev.run_sweep(names=["AFIRO"], progress=False),
], ids=["main-batch", "main", "run_sweep_batched", "run_sweep"])
def test_entry_points_refuse_missing_cuda(corpus, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_main_writes_tree_on_cpu(corpus, tmp_path, capsys):
    out = tmp_path / "tree"
    assert tev.main(["--names", *NAMES[:2], "--batch", "--device", "cpu",
                     "--granularity", "128", "--out", str(out)]) == 0
    text = (out / "netlib" / "hsd" / "README.md").read_text()
    assert "2 problems; 2 optimal" in text
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 and all("hsd" in l for l in printed)


def test_sweep_repairs_error_rows(corpus, tmp_path, monkeypatch):
    """Chunks run as child processes; a chunk that fails is re-run one
    problem per process, and error rows left in the tree get one repair
    run each."""
    out = tmp_path / "tree"
    calls = []

    def fake_chunk(names, method, out_dir, time_limit, extra, timeout_s):
        calls.append((tuple(names), tuple(extra)))
        recs = [dict(name=n, status=-2 if n == "KB2" and len(calls) < 4
                     else 0) for n in names]
        d = os.path.join(out_dir, "netlib", method)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "records.json")
        prev = json.load(open(path)) if os.path.exists(path) else []
        merged = {r["name"]: r for r in prev + recs}
        json.dump(list(merged.values()), open(path, "w"))
        return (9 if "KB2" in names and len(names) > 1 else 0), 0.0

    monkeypatch.setattr(tsweep, "run_chunk", fake_chunk)
    rc = tsweep.main(["--names", *NAMES, "--chunk", "2", "--out", str(out),
                      "--device", "cpu", "--batch"])
    assert rc == 0
    assert [c[0] for c in calls] == [("AFIRO", "SC50A"), ("KB2", "BLEND"),
                                     ("KB2",), ("BLEND",), ("KB2",)]
    assert all(c[1] == ("--device", "cpu", "--batch") for c in calls)
