"""The span-and-counter recorder of vanderbei_tpu_torch.utils.profiling on
the CPU: a recorded solve returns what an unrecorded one does, bit for
bit; the span tree of a request, each stage record's seconds, the bytes
uploaded and the host reads are what the program did; and a recorder that
is off records nothing.  The hsd loop's CUDA graph counts its captures,
replays, redos and reads (run on the CPU as on a card), and a replay
counts the kernel launches it makes.
"""

import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch

import vanderbei_tpu_torch as vtt
from tests.test_torch_hsd_graph import _fake_cuda, _graph_on_cpu
from vanderbei_tpu_torch.models import hsd, registry
from vanderbei_tpu_torch.ops import syrk
from vanderbei_tpu_torch.parallel import batch as pb
from vanderbei_tpu_torch.utils import checkpoint, graphs
from vanderbei_tpu_torch.utils import profiling as P
from vanderbei_tpu_torch.utils.randlp import (random_bounded_lp,
                                              random_bounded_qp)

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)

RID = 17
# children of the solve span, as registry.solve opens them
SOLVE_CHILDREN = {"canonicalize", "pad", "upload", "stage", "fetch"}


def _lp():
    return random_bounded_lp(60, 120, density=0.1, seed=3)


def _single(structured=True):
    cfg = vtt.SolverConfig(precision="mixed", use_ub_structure=structured)
    sol = vtt.solve(_lp(), config=cfg, device="cpu")
    return ([sol.status, sol.iterations, sol.x, sol.y, sol.w, sol.z,
             sol.primal_obj], sol.stages)


def _batch(method):
    lps = [random_bounded_lp(30 + j, 60 + 2 * j, density=0.1, seed=j)
           for j in range(3)]
    hsd = method == "hsd"
    classes, aborted = pb.group_by_class(lps, granularity=64,
                                         use_ub_structure=hsd)
    assert not aborted and len(classes) == 1
    (key, entries), = classes.items()
    stages = []
    if hsd:
        A, b, c, ub = pb.stack_class_structured(entries, *key[1:])
        out = pb.solve_batch_hsd(A, b, c, ub=ub, device="cpu", stages=stages)
    else:
        A, b, c = pb.stack_class(entries, *key[-2:])
        out = pb.solve_batch_pd(A, b, c, device="cpu")
    return [t.numpy() for t in out], stages


RUNS = {"single-hsd": _single, "single-hsd-dense": lambda: _single(False),
        "batch-hsd": lambda: _batch("hsd"), "batch-pd": lambda: _batch("pd")}


def _recorded(run):
    with P.recording() as rec:
        with P.request(RID):
            out = run()
    return out, rec


def _totals(rec, within=None):
    """The counters summed over the spans (only those whose ids are in
    `within`, if given)."""
    tot = Counter()
    for sid, counts in rec.counts.items():
        if within is None or sid in within:
            tot.update(counts)
    return tot


def _descendants(rec, names):
    """Ids of the spans named in `names` and of every span inside them."""
    parent = {s[0]: s[1] for s in rec.spans}
    name = {s[0]: s[3] for s in rec.spans}

    def inside(sid):
        while sid is not None:
            if name[sid] in names:
                return True
            sid = parent[sid]
        return False
    return {sid for sid in parent if inside(sid)}


@pytest.fixture(scope="module")
def runs():
    """Each run unrecorded, then recorded: {name: (out, stages, out_rec,
    stages_rec, recorder)}."""
    res = {}
    for name, run in RUNS.items():
        out, stages = run()
        (out_r, stages_r), rec = _recorded(run)
        res[name] = (out, stages, out_r, stages_r, rec)
    return res


@pytest.mark.parametrize("name", sorted(RUNS))
def test_recording_changes_no_result(runs, name):
    out, stages, out_r, stages_r, rec = runs[name]
    assert len(out) == len(out_r)
    for a, b in zip(out, out_r):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert len(stages) == len(stages_r)
    for st, st_r in zip(stages, stages_r):
        assert list(st) == list(st_r)
        assert np.array_equal(st["iterations"], st_r["iterations"])
    assert rec.spans


@pytest.mark.parametrize("name", sorted(RUNS))
def test_span_tree(runs, name):
    _, _, _, stages, rec = runs[name]
    by_id = {s[0]: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    for sid, parent, rid, sname, lo, hi, attrs in rec.spans:
        assert rid == RID
        assert lo <= hi
        if parent is not None:
            p = by_id[parent]
            assert p[4] <= lo and hi <= p[5], (sname, p[3])
    roots = [s for s in rec.spans if s[1] is None]
    names = Counter(s[3] for s in rec.spans)
    if name.startswith("single"):
        assert [s[3] for s in roots] == ["solve"]
        children = {s[3] for s in rec.spans if s[1] == roots[0][0]}
        assert children == SOLVE_CHILDREN
    else:
        assert [s[3] for s in roots] == ["group_by_class", "stack",
                                         "solve_batch"]
        assert names["canonicalize"] == 3
        assert all(by_id[s[1]][3] == "group_by_class"
                   for s in rec.spans if s[3] == "canonicalize")
        children = {s[3] for s in rec.spans if s[1] == roots[2][0]}
        assert children == {"upload", "stage"}
        assert rec.counts[roots[2][0]]["lanes"] == 3
    if name.endswith("pd"):
        assert names["normal_matrix"] == names["factor"] == 0
        return
    # one assembly and one factor an iteration that steps: every iteration
    # but a stage's last, where the stop test decides and nothing steps
    its = [int(np.max(st["iterations"])) for st in stages]
    stepped = sum(it - (not st.get("paused", st["precision"] == "f32"))
                  for it, st in zip(its, stages))
    assert names["normal_matrix"] == names["factor"] == stepped
    in_stage = _descendants(rec, {"stage"})
    assert all(s[0] in in_stage for s in rec.spans
               if s[3] in ("normal_matrix", "factor", "kkt_solve"))
    stage_spans = [s for s in rec.spans if s[3] == "stage"]
    assert [s[6]["iterations"] for s in stage_spans] == its
    assert [s[6]["precision"] for s in stage_spans] == [
        st["precision"] for st in stages]


@pytest.mark.parametrize("name", ["single-hsd", "single-hsd-dense",
                                  "batch-hsd"])
def test_stage_seconds_are_the_span(runs, name):
    _, _, _, stages, rec = runs[name]
    spans = [s for s in rec.spans if s[3] == "stage"]
    assert len(spans) == len(stages) > 0
    for st, s in zip(stages, spans):
        assert st["seconds"] == (s[5] - s[4]) / 1e9


# (canonicalize.structured, canonicalize.dense) of each run: the hsd
# family's UbTail LPs are built from the CSC, everything else densely
CANON_COUNTS = {"single-hsd": (1, 0), "single-hsd-dense": (0, 1),
                "batch-hsd": (3, 0), "batch-pd": (0, 3)}


def _assert_canon_counts(rec, structured, dense):
    """The two counters total `structured` and `dense`, all of it inside
    canonicalize spans."""
    for within in (None, {s[0] for s in rec.spans
                          if s[3] == "canonicalize"}):
        tot = _totals(rec, within)
        assert (tot["canonicalize.structured"],
                tot["canonicalize.dense"]) == (structured, dense)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_canonicalize_counters(runs, name):
    _assert_canon_counts(runs[name][4], *CANON_COUNTS[name])


@pytest.mark.parametrize("method", ["intpt", "qp"])
def test_canonicalize_counters_dense_paths(method):
    """intpt, and a QP (routed from hsd to intpt), canonicalize densely."""
    if method == "qp":
        lp, method = random_bounded_qp(20, 40, density=0.2, seed=4), "hsd"
    else:
        lp = random_bounded_lp(20, 40, density=0.2, seed=4)
    cfg = vtt.SolverConfig(precision="f64", verbose=0)
    sol, rec = _recorded(lambda: vtt.solve(lp, method=method, config=cfg,
                                           device="cpu"))
    assert sol.status == 0
    _assert_canon_counts(rec, 0, 1)


def test_canonicalize_counters_off():
    with P.recording() as rec:
        pass
    _single()
    _batch("hsd")
    assert rec.counts == {} and P._REC is None


def _as_on_a_card(monkeypatch):
    """Count the host arrays moved to the CPU as a card's solve counts
    those it moves to the card: on the CPU nothing crosses a bus."""
    monkeypatch.setattr(checkpoint, "_host_to_device",
                        lambda t, device: t.device.type == "cpu")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_h2d_bytes_none_on_the_host(runs, name):
    rec = runs[name][4]
    assert rec.spans and _totals(rec)["h2d_bytes"] == 0


@pytest.mark.parametrize("structured", [True, False])
def test_h2d_bytes_single(monkeypatch, structured):
    _as_on_a_card(monkeypatch)
    moved = []
    real = registry.operands_from_canon

    def spy(canon, device, dtype):
        out = real(canon, device, dtype)
        moved.extend(t for t in out[:3])
        if out[3] is not None:
            moved.extend(out[3])
        return out
    monkeypatch.setattr(registry, "operands_from_canon", spy)
    _, rec = _recorded(lambda: _single(structured))
    assert len(moved) == (10 if structured else 6)
    assert _totals(rec)["h2d_bytes"] == sum(t.nbytes for t in moved)
    uploads = {s[0] for s in rec.spans if s[3] == "upload"}
    assert _totals(rec, uploads)["h2d_bytes"] == sum(t.nbytes for t in moved)


@pytest.mark.parametrize("method", ["hsd", "pd"])
def test_h2d_bytes_batch(monkeypatch, method):
    _as_on_a_card(monkeypatch)
    moved = []
    real = pb.to_device

    def spy(a, device, dtype):
        t = real(a, device, dtype)
        moved.append(t)
        return t
    monkeypatch.setattr(pb, "to_device", spy)
    _, rec = _recorded(lambda: _batch(method))
    # A, b, c; hsd: the tail in f32 and f64; pd: its two draws
    assert len(moved) == (7 if method == "hsd" else 5)
    assert _totals(rec)["h2d_bytes"] == sum(t.nbytes for t in moved)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_host_reads(runs, name):
    out, stages, _, _, rec = runs[name]
    tot = _totals(rec)
    sites = {k: v for k, v in tot.items() if k.startswith("host_reads.")}
    assert sites and sum(sites.values()) == tot["host_reads"]
    inside = _totals(rec, _descendants(rec, {"stage"}))
    if name.endswith("pd"):
        # pd reads its loop flag once every refresh_every (64) pivots
        pivots = int(np.max(out[-1]))
        assert inside["host_reads"] == tot["host_reads"] == (
            -(-pivots // 64) + 1)
        return
    iterations = sum(int(np.max(st["iterations"])) for st in stages)
    assert inside["host_reads"] >= iterations
    assert tot["host_reads"] >= inside["host_reads"]


def test_off_records_nothing():
    with P.recording() as rec:
        pass
    assert P._REC is None
    out, stages = _single()
    assert rec.spans == [] and rec.counts == {}
    assert P._REC is None and P._RID is None
    # off, a span is the shared no-op context, and neither it, a count nor
    # a counted read keeps anything: 2000 of each leave no memory behind
    # (an empty loop itself peaks at ~120 bytes)
    assert P.span("x") is P.span("y")

    def calls(n):
        for _ in range(n):
            with P.span("x"):
                P.count("h2d_bytes", 8)
                P.host_read("s", int)
    calls(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        calls(2000)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now - before < 100 and peak - before < 400


def test_nesting_and_counts_outside_spans():
    with P.recording() as outer:
        P.count("h2d_bytes", 3)
        with P.recording() as inner:
            with P.span("a", k=1):
                P.count("host_reads")
        with P.request(5):
            with P.span("b"):
                pass
    assert P._REC is None and P._RID is None
    assert outer.counts == {None: {"h2d_bytes": 3}}
    assert [(s[1], s[2], s[3], s[6]) for s in inner.spans] == [
        (None, None, "a", {"k": 1})]
    assert inner.counts == {inner.spans[0][0]: {"host_reads": 1}}
    assert [(s[2], s[3]) for s in outer.spans] == [(5, "b")]


def test_spanned_records_each_call():
    @P.spanned("work")
    def work(x, *, y=1):
        """Doc."""
        P.count("host_reads", y)
        return x + y
    assert work.__name__ == "work" and work.__doc__ == "Doc."
    assert work(1) == 2
    with P.recording() as rec:
        with P.span("outer"):
            assert work(2, y=3) == 5
    assert work(3) == 4
    (sid, parent, _, name, *_), outer = rec.spans
    assert (name, parent) == ("work", outer[0])
    assert rec.counts == {sid: {"host_reads": 3}}


GRAPH_COUNTERS = ("hsd.graph.captures", "hsd.graph.replays",
                  "hsd.graph.retries", "hsd.graph.redos",
                  "host_reads.hsd.graph")


def test_graph_counters(monkeypatch):
    """The loop's CUDA graph (models/hsd.py, run on the CPU as on a card):
    captures, replays, Tikhonov retries, eager redos and its read an
    iteration are counted inside the stage spans with the recorder on,
    and not at all off."""
    _graph_on_cpu(monkeypatch)
    with P.recording() as off:
        pass
    _single()
    assert off.counts == {}
    # no solve meets the refinement target: eager redos; the first
    # factor at level 0 fails: a retry
    cfg = vtt.SolverConfig(precision="f64", refine_tol=1e-30)
    sol, rec = _recorded(lambda: vtt.solve(_lp(), config=cfg, device="cpu"))
    inside = _totals(rec, _descendants(rec, {"stage"}))
    tot = _totals(rec)
    for name in GRAPH_COUNTERS:
        assert inside[name] == tot[name] > 0, name
    assert tot["hsd.graph.captures"] == len(hsd.REFINE_PASSES)
    assert tot["hsd.graph.replays"] >= sol.iterations
    assert tot["host_reads.hsd.graph"] - tot["hsd.graph.replays"] in (0, 1)
    assert (tot["hsd.graph.retries"] + tot["hsd.graph.redos"]
            <= tot["hsd.graph.replays"])
    assert "host_reads.hsd.loop" not in tot


def test_replay_counts_kernel_launches(monkeypatch):
    """utils/graphs.capture: the warm-up's kernel launches count, the
    capture's (which launch nothing) do not, and each replay counts them
    again, by path and by shape (ops/syrk's counters)."""
    replays = _fake_cuda(monkeypatch)
    path, shape = "tma/k-contiguous", ((2560, 5120), "k-contiguous")

    def launch():
        syrk.add_counts(({path: 1}, {shape: 1}))
        return "out"

    syrk.reset_counts()
    try:
        replay = graphs.capture(launch)
        assert syrk.counts() == ({path: 1}, {shape: 1})    # the warm-up
        assert [replay(), replay()] == ["out", "out"] and len(replays) == 2
        assert syrk.counts() == ({path: 3}, {shape: 3})
        assert syrk.launch_count() == 3
    finally:
        syrk.reset_counts()
