"""The CUDA-graph iteration of vanderbei_tpu_torch.models.hsd on the CPU.

On a card, one LP's hsd loop replays body.speculate, the read-free
iteration, as a cached CUDA graph, reads its flags once an iteration and
redoes the iteration eagerly where they ask for it (_hsd_loop).  Here the
`graphs` fixture runs that path with the engagement rule of a card and a
capture whose replay runs the iteration eagerly, and every test holds it
bit for bit to the eager loop: each iteration from the states of an eager
run, and whole solves (status, iterations, x, y, w, z) at f64 and mixed
precision, hsd and hsdls, with and without the Mehrotra corrector and the
UbTail structure.  Both redo paths are forced, by a head whose first
factor is indefinite (a Tikhonov retry, replayed from the next level) and
by a refinement target no solve meets (redone eagerly); and the inputs outside the rule (a batch, column shards,
compensated sums, a per-iteration callback, trace rows, CPU tensors)
capture nothing and run the eager loop as it is.
"""

import gc
import types
import weakref
from collections import Counter, OrderedDict

import numpy as np
import pytest
import torch

import vanderbei_tpu_torch as vtt
from vanderbei_tpu_torch.core import ubtail
from vanderbei_tpu_torch.core.builder import LPBuilder
from vanderbei_tpu_torch.models import hsd, registry
from vanderbei_tpu_torch.ops import kkt
from vanderbei_tpu_torch.parallel.distributed import ColumnShards
from vanderbei_tpu_torch.utils import profiling as P
from vanderbei_tpu_torch.utils.checkpoint import operands_from_canon
from vanderbei_tpu_torch.utils.graphs import capture
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)

KNOBS = dict(eps=1e-12, step_factor=0.95, beta=0.8, epsdiag=1e-14,
             refine_tol=1e-10, gap_tol=1e-6, feas_tol=1e-6, max_refine=8)
MPS = """NAME          SMALL
ROWS
 N  obj
 L  lim1
 G  lim2
 E  myeqn
 L  rng
COLUMNS
    x1        obj       1.0        lim1      1.0
    x1        lim2      1.0        rng       1.0
    x2        obj       2.0        lim1      1.0
    x2        myeqn     -1.0
    x3        obj       -1.0       myeqn     1.0
    x3        rng       2.0
    x4        obj       0.5        lim2      1.0
    x4        rng       -1.0
RHS
    rhs       lim1      4.0        lim2      1.0
    rhs       myeqn     7.0        rng       6.0
RANGES
    rng       rng       4.0
BOUNDS
 UP bnd       x1        4.0
 UP bnd       x2        5.0
 UP bnd       x3        9.0
 UP bnd       x4        3.0
ENDATA
"""


def _builder_lp():
    lpb = LPBuilder("boxed")
    for j in range(6):
        lpb.var(f"x{j}", upper=2.0 + j, obj=(-1.0) ** j * (1.0 + 0.5 * j))
    lpb.constraint("cap", {f"x{j}": 1.0 + j % 3 for j in range(6)}, hi=9.0)
    lpb.constraint("mix", {"x0": 1.0, "x2": -1.0, "x4": 2.0}, lo=1.0)
    lpb.constraint("bal", {"x1": 1.0, "x3": 1.0, "x5": -1.0}, lo=0.5,
                   hi=0.5)
    return lpb.build()


def _lp(name, tmp_path):
    """The LP `name`: a seeded random bounded LP, one built by LPBuilder
    or one read from MPS (written under tmp_path)."""
    if name == "random":
        return random_bounded_lp(60, 120, density=0.1, seed=3)
    if name == "builder":
        return _builder_lp()
    path = tmp_path / "small.mps"
    path.write_text(MPS)
    return vtt.read_mps(str(path), engine="python")


LPS = ("builder", "mps", "random")


def _graph_on_cpu(mp):
    """The engagement rule of a card for CPU tensors, and a capture whose
    replay runs the iteration eagerly; returns the list of the iterations
    captured."""
    captured = []
    real = hsd._graph_engages

    def engages(A, *rest):
        card = types.SimpleNamespace(device=torch.device("cuda"), dim=A.dim)
        return real(card if A.device.type == "cpu" else A, *rest)

    def capture(fn, *args, warm=None, device=None):
        captured.append(fn)
        return lambda: fn(*args)

    mp.setattr(hsd, "_graph_engages", engages)
    mp.setattr(hsd, "capture", capture)
    mp.setattr(hsd, "_GRAPHS", OrderedDict())
    return captured


def _fake_cuda(mp):
    """torch.cuda's streams, device guard, graph and capture, doing
    nothing: utils/graphs.capture runs fn at its warm-up and its capture,
    and a replay runs nothing.  Returns the list each replay appends to."""
    replays = []

    class Fake:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def wait_stream(self, other):
            pass

        def replay(self):
            replays.append(1)

    for name in ("Stream", "CUDAGraph", "graph", "stream", "device"):
        mp.setattr(torch.cuda, name, Fake)
    mp.setattr(torch.cuda, "current_stream", lambda *a: Fake())
    return replays


@pytest.fixture
def graphs(monkeypatch):
    """The graph path on the CPU (_graph_on_cpu); yields the iterations
    captured."""
    yield _graph_on_cpu(monkeypatch)


@pytest.fixture
def eager_capture(monkeypatch):
    """The real engagement rule, and a capture that counts: the CPU never
    engages it."""
    captured = []
    monkeypatch.setattr(hsd, "capture",
                        lambda fn, *a, **k: captured.append(fn))
    monkeypatch.setattr(hsd, "_GRAPHS", OrderedDict())
    yield captured


def _graph_counts(rec):
    tot = Counter()
    for counts in rec.counts.values():
        tot.update({k: v for k, v in counts.items()
                    if k.startswith(("hsd.graph", "host_reads.hsd.graph"))})
    return tot


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _assert_same_solution(got, want):
    assert (got.status, got.iterations) == (want.status, want.iterations)
    for f in "xywz":
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    assert got.primal_obj == want.primal_obj
    assert [(s["precision"], s["iterations"], s["paused"])
            for s in got.stages] == [(s["precision"], s["iterations"],
                                      s["paused"]) for s in want.stages]


def _solve(lp, method, **cfg):
    with P.recording() as rec:
        sol = vtt.solve(lp, method=method, config=vtt.SolverConfig(**cfg),
                        device="cpu")
    return sol, rec


# (method, config) of the whole-solve cases: both stages (mixed) or one
# (f64), hsd with and without the corrector, the long step, and the dense
# path (the ub rows in A: m > n, the dual form)
SOLVES = {"hsd-mixed": ("hsd", dict(precision="mixed")),
          "hsd-f64": ("hsd", dict(precision="f64")),
          "hsd-reference-mixed": ("hsd", dict(precision="mixed",
                                              hsd_corrector="reference")),
          "hsdls-mixed": ("hsdls", dict(precision="mixed")),
          "hsd-dense-f64": ("hsd", dict(precision="f64",
                                        use_ub_structure=False)),
          "hsd-dense-mixed": ("hsd", dict(precision="mixed",
                                          use_ub_structure=False))}


@pytest.mark.parametrize("lp_name", LPS)
@pytest.mark.parametrize("case", sorted(SOLVES))
def test_whole_solve_is_the_eager_solve(monkeypatch, tmp_path, lp_name,
                                        case):
    method, cfg = SOLVES[case]
    lp = _lp(lp_name, tmp_path)
    want, rec_e = _solve(lp, method, **cfg)
    assert _graph_counts(rec_e) == Counter()
    captured = _graph_on_cpu(monkeypatch)
    got, rec = _solve(lp, method, **cfg)
    _assert_same_solution(got, want)
    counts = _graph_counts(rec)
    # a graph for each REFINE_PASSES entry, for each layout and knobs (an
    # unscaled retry after SUBOPTIMAL reuses them)
    per = len(hsd.REFINE_PASSES)
    assert counts["hsd.graph.captures"] == len(captured)
    assert per <= len(captured) <= per * len(want.stages)
    assert len(captured) % per == 0
    # every live iteration of an hsd stage is one replay at least (more
    # for a retry or a refinement pass more), each read once; the stage
    # reads once more at most, when the graph ran its last live test.
    # A SUBOPTIMAL verdict's intpt cross-check replays nothing.
    for sid, _, _, name, _, _, attrs in rec.spans:
        if name != "stage":
            continue
        n = rec.counts.get(sid, {})
        replays, reads = (n.get("hsd.graph.replays", 0),
                          n.get("host_reads.hsd.graph", 0))
        retries = n.get("hsd.graph.retries", 0)
        if "host_reads.intpt.loop" in n:
            assert replays == reads == retries == 0
        else:
            assert replays >= attrs["iterations"] > 0
            assert replays <= reads <= replays + 1
            assert retries + n.get("hsd.graph.redos", 0) <= replays


def _operands(lp, structured, dtype):
    canon = ubtail.canonical(lp, structured, scale="geometric")
    struct = ubtail._hsd_structured_operands(canon) if structured else None
    if struct is None:
        canon = registry._pad(canon, "auto")
    return operands_from_canon(struct or canon, "cpu", dtype), canon.f


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("mode", ["mehrotra", "reference", "long_step"])
@pytest.mark.parametrize("dtype", ["f32-sprint", "f64"])
def test_each_iteration_is_the_eager_iteration(structured, mode, dtype):
    """From every state of an eager run, speculate's new state is body's,
    bit for bit, wherever it asks for no redo; its live flag is the loop's
    and its live-next flag the loop's test on the next state."""
    sprint = dtype == "f32-sprint"
    (A, b, c, ub), f = _operands(_lp("random", None), structured,
                                 torch.float32 if sprint else torch.float64)
    long_step = mode == "long_step"
    knobs = dict(KNOBS, long_step=long_step,
                 corrector="reference" if long_step else mode)
    if sprint:
        knobs.update(epsdiag=1e-8, refine_tol=1e-4)
    pause_mu, max_iter = (1e-4 if sprint else 0.0), 200
    states = []
    init = hsd.init_state(A, extra_rows=0 if ub is None else
                          ub.idx2.shape[0])
    hsd._hsd_loop(A, b, c, f, init, max_iter=max_iter, pause_mu=pause_mu,
                  ub=ub, on_iter=states.append, **knobs)
    assert len(states) > 3
    body = hsd.make_step(A, b, c, ub=ub, **knobs)
    pause = torch.full((), pause_mu, dtype=A.dtype)
    for s, nxt in zip(states, states[1:] + [None]):
        pre = body.decide(s)
        live = bool((s.status == -1) & (s.iter < max_iter)
                    & (pre.mu > pause))
        steps = live and bool(pre.new_status == -1)
        want = body(s, None, pre, steps)
        for passes in (0, 1, 2):
            t = s
            while True:
                out, flags = body.speculate(t, max_iter, pause, passes)
                live_f, retry, refine, live_next = flags.tolist()
                assert live_f == live
                if not retry:
                    break
                # the retry from the next level is the eager escalation's
                assert steps
                t = t._replace(reg=kkt.next_reg(t.reg))
            if refine:
                assert steps
                continue
            for a, w in zip(out, want):
                assert _same_bits(a, w)
            # the loop's live test on the next state
            assert live_next == (nxt is not None)
            if nxt is not None:
                for a, w in zip(out, nxt):
                    assert _same_bits(a, w)


def _indefinite_first_head(monkeypatch):
    """A head whose factor at the sticky level 0 is indefinite: there,
    where its unit diagonal carries no Tikhonov shift, _cholesky sees its
    negative, so each such factor retries (f64 only: an f32 diagonal
    cannot tell the first level from 1).  Returns the list of the factors
    so forced."""
    real = kkt._cholesky
    forced = []

    def cholesky(Mr):
        d = torch.diagonal(Mr, dim1=-2, dim2=-1)
        if Mr.dtype == torch.float64 and bool((d - 1).abs().amax() < 5e-15):
            forced.append(Mr.shape)
            return real(-Mr)
        return real(Mr)
    monkeypatch.setattr(kkt, "_cholesky", cholesky)
    return forced


@pytest.mark.parametrize("force", ["tikhonov-retry", "refinement"])
def test_redo_is_the_eager_iteration(monkeypatch, force):
    lp = _lp("random", None)
    cfg = dict(precision="f64")
    forced = []
    if force == "refinement":
        cfg["refine_tol"] = 1e-30
    else:
        forced = _indefinite_first_head(monkeypatch)
    want, _ = _solve(lp, "hsd", **cfg)
    assert len(forced) == (force == "tikhonov-retry")
    _graph_on_cpu(monkeypatch)
    got, rec = _solve(lp, "hsd", **cfg)
    _assert_same_solution(got, want)
    counts = _graph_counts(rec)
    if force == "tikhonov-retry":
        # the graph's first factor was forced, and its replay from the
        # next level redid the iteration
        assert len(forced) == 2 and counts["hsd.graph.retries"] >= 1
    else:
        assert counts["hsd.graph.redos"] >= 1


class _OneRank(ColumnShards):
    """The column shards of a world of one: each all-reduce is the
    identity."""

    def _all_reduce(self, flat, op, name):
        self.ops[name] += 1


def _loop_case(case):
    """(args, keywords) of an _hsd_loop call outside the engagement rule."""
    (A, b, c, ub), f = _operands(_lp("random", None), True, torch.float64)
    kw = dict(KNOBS, max_iter=200, pause_mu=0.0, ub=ub)
    if case == "batched":
        A, b, c = (torch.stack([t, t]) for t in (A, b, c))
        kw["ub"] = kkt.UbTail(*(torch.stack([t, t]) for t in ub))
    elif case == "cols":
        cols = _OneRank(None, 0, A.shape[1], A.shape[1])
        kw.update(cols=cols, ub=cols.tail(ub))
    elif case == "compensated":
        kw["compensated"] = True
    elif case == "on_iter":
        kw["on_iter"] = lambda s: None
    elif case == "trace":
        kw["trace"] = True
    init = hsd.init_state(A, extra_rows=ub.idx2.shape[0])
    return (A, b, c, f, init), kw


@pytest.mark.parametrize("case", ["batched", "cols", "compensated",
                                  "on_iter", "trace", "cpu"])
def test_outside_the_rule_nothing_is_captured(request, monkeypatch, capsys,
                                              case):
    args, kw = _loop_case(case)
    with monkeypatch.context() as mp:
        mp.setattr(hsd, "_graph_engages", lambda *a: False)
        want, paused = hsd._hsd_loop(*args, **kw)
    captured = request.getfixturevalue(
        "eager_capture" if case == "cpu" else "graphs")
    with P.recording() as rec:
        got, paused2 = hsd._hsd_loop(*args, **kw)
    capsys.readouterr()
    assert captured == [] and _graph_counts(rec) == Counter()
    assert paused2 == paused
    for a, w in zip(got, want):
        assert _same_bits(a, w)


def test_cache_reuses_and_bounds(graphs, monkeypatch):
    """A second solve of the same layout captures nothing; the cache keeps
    the GRAPH_CACHE layouts used last."""
    monkeypatch.setattr(hsd, "GRAPH_CACHE", 2)
    cfg = vtt.SolverConfig(precision="mixed")
    lps = [random_bounded_lp(60, 120, density=0.1, seed=s) for s in (3, 4)]
    per = len(hsd.REFINE_PASSES)
    for lp in lps:
        vtt.solve(lp, config=cfg, device="cpu")
    assert len(graphs) == 2 * per and len(hsd._GRAPHS) == 2
    first = dict(hsd._GRAPHS)
    # another knob is another graph
    vtt.solve(lps[0], config=vtt.SolverConfig(precision="f64",
                                              refine_tol=1e-9),
              device="cpu")
    assert len(graphs) == 3 * per and len(hsd._GRAPHS) == 2
    assert list(hsd._GRAPHS)[0] == list(first)[1]


def test_capture_keeps_its_inputs(monkeypatch):
    """A graph reads its inputs at the addresses they had at the capture:
    replay keeps fn and its arguments alive, so that no later allocation
    takes their memory (an input freed after the capture once read as a
    wrong live test a few iterations into a solve on the card)."""
    _fake_cuda(monkeypatch)

    def closing_over(scale):
        return (lambda pause: pause * scale), weakref.ref(scale)

    fn, scale = closing_over(torch.ones(3))
    pause = torch.zeros(())
    seen = (weakref.ref(pause), scale)
    replay = capture(fn, pause)
    del pause, fn
    gc.collect()
    assert all(ref() is not None for ref in seen)
    del replay
    gc.collect()
    assert all(ref() is None for ref in seen)
