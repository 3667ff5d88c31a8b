"""Instance batching: vanderbei_tpu_torch.parallel.batch against
vanderbei_tpu.parallel.batch on the CPU, fed the same stacked arrays.

Bars, lane by lane: the same status; iterations within 1 at precision
"f64" (and f32factor, compensated) and within 3 at "mixed"; the objective
c'x within 1e-9 (f64) or 1e-8 (mixed) relative; intpt's within 1e-7 (it
stops at a 1e-6 gap, so two f32 sprints that differ in roundoff may part
by more than hsd's bar).  pd, given the JAX package's per-lane draws,
pivots the same: equal pivot counts and x within 1e-9.  A lane of a
batched solve equals the solve of the same padded lane alone, and a
paused batched JAX state resumes in the port.  Classes are tiny (B = 3
LPs of about 30 x 60, padded to 64 x 64 heads) so that JAX's jitted batch
solvers compile fast.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vanderbei_tpu.core import lp as jlp
from vanderbei_tpu.models import hsd as jhsd
from vanderbei_tpu.ops.kkt import UbTail as JUbTail
from vanderbei_tpu.parallel import batch as jb
from vanderbei_tpu.utils import checkpoint as jckpt
from vanderbei_tpu_torch.core import ubtail
from vanderbei_tpu_torch.core.builder import LPBuilder
from vanderbei_tpu_torch.core.canonicalize import canonicalize
from vanderbei_tpu_torch.models import hsd as thsd
from vanderbei_tpu_torch.models import intpt as tintpt
from vanderbei_tpu_torch.ops import kkt as tkkt
from vanderbei_tpu_torch.parallel import batch as tb
from vanderbei_tpu_torch.utils import checkpoint as tckpt
from vanderbei_tpu_torch.utils.randlp import random_bounded_lp

# one intra-op thread per test process: the xdist workers share a few cores
torch.set_num_threads(1)

BARS = {"f64": (1, 1e-9), "mixed": (3, 1e-8), "f32factor": (1, 1e-9)}
GRAN = 64


def _lps():
    lps = [random_bounded_lp(30 + j, 60 + 2 * j, density=0.1, seed=j)
           for j in range(3)]
    # a free variable: aborted under free_vars="reject", split otherwise
    free = LPBuilder("free")
    free.var("x", lower=-np.inf, obj=1.0)
    free.var("y", upper=4.0, obj=1.0)
    free.constraint("r", {"x": 1.0, "y": 1.0}, lo=-2.0, hi=3.0)
    return lps + [free.build()]


def _jax_lp(lp):
    return jlp.LP(**{f.name: getattr(lp, f.name)
                     for f in dataclasses.fields(jlp.LP)})


def _classes(structured, free_vars="reject"):
    """The same LPs grouped by both packages (asserting the same keys)."""
    lps = _lps()
    kw = dict(granularity=GRAN, use_ub_structure=structured,
              scale="geometric", free_vars=free_vars)
    jc, jab = jb.group_by_class([_jax_lp(lp) for lp in lps], **kw)
    tc, tab = tb.group_by_class(lps, **kw)
    assert list(jc) == list(tc) and jab == tab
    for key in jc:
        assert [i for i, _ in jc[key]] == [i for i, _ in tc[key]]
    return jc, tc


def _stack(key, entries, mod):
    if key[0] == "s":
        _, M1, N, K = key
        return mod.stack_class_structured(entries, M1, N, K)
    return (*mod.stack_class(entries, *key[-2:]), None)


def _biggest(structured):
    """The stacked arrays of the class with the most lanes."""
    jc, tc = _classes(structured)
    key = max(jc, key=lambda k: len(jc[k]))
    return key, _stack(key, tc[key], tb)


def _jax_ub(ub):
    return None if ub is None else JUbTail(jnp.asarray(ub.idx2),
                                           jnp.asarray(ub.w2))


def _objs(c, x):
    return np.einsum("bn,bn->b", np.asarray(c), np.asarray(x)[:, :c.shape[1]])


def _assert_lanes(want, got, c, d_it, rel):
    want = [np.asarray(v) for v in want]
    got = [v.cpu().numpy() for v in got]
    np.testing.assert_array_equal(got[0], want[0])
    assert np.all(np.abs(got[5] - want[5]) <= d_it), (got[5], want[5])
    opt = want[0] == 0           # objectives of the OPTIMAL lanes
    oj, ot = _objs(c, want[1])[opt], _objs(c, got[1])[opt]
    assert np.all(np.abs(ot - oj) <= rel * np.maximum(1.0, np.abs(oj))), \
        (ot, oj)
    return want, got


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("free_vars", ["reject", "split"])
def test_group_and_stack_equal(structured, free_vars):
    jc, tc = _classes(structured, free_vars)
    assert any(k[0] == ("s" if structured else "d") or len(k) == 2
               for k in jc)
    for key in jc:
        for a, b in zip(_stack(key, jc[key], jb), _stack(key, tc[key], tb)):
            if a is None:
                assert b is None
                continue
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(u, v)
                assert u.dtype == v.dtype


def _arrays(stacked):
    """A stacked class's arrays, the UbTail's two included."""
    *head, ub = stacked
    return [*head, *(() if ub is None else (ub.idx2, ub.w2))]


@pytest.mark.parametrize("structured", [False, True])
def test_group_from_csc_equals_dense(structured):
    """With use_ub_structure, group_by_class builds each lane that takes
    the structure straight from its CSC (a UbCanon) and the rest densely;
    the keys, the lanes and the stacked arrays are bitwise those of the
    dense canonical forms, in one call whose LPs fall into an "s" and a
    "d" class (no upper bound; more head rows than columns).  Without it
    (the pd path) every lane is canonicalize's, unchanged."""
    lps = _lps()[:3] + [
        dataclasses.replace(lp, u=np.full(lp.n, np.inf)) for lp in _lps()[:2]]
    lps.append(random_bounded_lp(58, 60, density=0.1, seed=5))
    kw = dict(scale="geometric", free_vars="split")
    classes, aborted = tb.group_by_class(lps, granularity=GRAN,
                                         use_ub_structure=structured, **kw)
    dense = {}
    for idx, lp in enumerate(lps):
        canon = canonicalize(lp, pad_to=1, **kw)
        key = tb.class_key(canon, GRAN, structured)
        dense.setdefault(key, []).append((idx, canon))
    assert not aborted and list(classes) == list(dense)
    assert {len(k) == 2 or k[0] for k in classes} == (
        {"s", "d"} if structured else {True})
    for key, entries in classes.items():
        assert [i for i, _ in entries] == [i for i, _ in dense[key]]
        for (_, got), (_, want) in zip(entries, dense[key]):
            assert isinstance(got, ubtail.UbCanon) == (key[0] == "s")
            if got.A is not None:
                assert got.A.tobytes() == want.A.tobytes()
        for a, b in zip(_arrays(_stack(key, entries, tb)),
                        _arrays(_stack(key, dense[key], tb))):
            assert (a.dtype, a.shape) == (b.dtype, b.shape)
            assert a.tobytes() == b.tobytes()


def test_size_class_equal():
    for dims in [(1, 1), (31, 64), (33, 65), (1000, 1537)]:
        for g in (32, 128, 512):
            assert tb.size_class(*dims, g) == jb.size_class(*dims, g)


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_solve_batch_hsd(structured, precision):
    key, (A, b, c, ub) = _biggest(structured)
    assert A.shape[0] == 3 and (key[0] == "s") == structured
    want = jb.solve_batch_hsd(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                              ub=_jax_ub(ub), precision=precision)
    stages = []
    got = tb.solve_batch_hsd(A, b, c, ub=ub, precision=precision,
                             device="cpu", stages=stages)
    _assert_lanes(want, got, c, *BARS[precision])
    assert np.all(np.asarray(want[0]) == 0)
    assert [s["precision"] for s in stages] == (
        ["f32", "f64"] if precision == "mixed" else ["f64"])
    np.testing.assert_array_equal(sum(s["iterations"] for s in stages),
                                  got[5].numpy())


@pytest.mark.parametrize("option", ["f32factor", "compensated", "hsdls"])
def test_solve_batch_hsd_options(option):
    """One structured class each: the f32-factor polish, the compensated
    (dd-residual) polish and the long-step variant, all from f64 data."""
    _, (A, b, c, ub) = _biggest(True)
    kw = {"f32factor": dict(precision="f32factor"),
          "compensated": dict(precision="f64", compensated=True),
          "hsdls": dict(precision="f64", long_step=True)}[option]
    want = jb.solve_batch_hsd(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                              ub=_jax_ub(ub), **kw)
    got = tb.solve_batch_hsd(A, b, c, ub=ub, device="cpu", **kw)
    _assert_lanes(want, got, c, *BARS["f64"])


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_solve_batch_intpt(precision):
    _, (A, b, c, _) = _biggest(False)
    want = jb.solve_batch_intpt(jnp.asarray(A), jnp.asarray(b),
                                jnp.asarray(c), precision=precision)
    got = tb.solve_batch_intpt(A, b, c, precision=precision, device="cpu")
    want, _ = _assert_lanes(want, got, c, BARS[precision][0], 1e-7)
    # at "mixed" the middle lane stops DUAL_INFEASIBLE in both packages:
    # the f64 stage's first divergence test compares against the f32
    # sprint's residual norms (ROADMAP Queue 3)
    assert np.sum(want[0] == 0) >= 2


def test_solve_batch_intpt_dual_form():
    """m > n lanes (ranged rows double the canonical rows): the dual form,
    whose normal matrices come from the transposed view A' (B, n, m)."""
    lps = []
    for j in range(3):
        lp = random_bounded_lp(40 + 2 * j, 30, density=0.2, seed=10 + j)
        lps.append(dataclasses.replace(lp, r=np.where(lp.r == 0.0, 1.0,
                                                      lp.r)))
    classes, _ = tb.group_by_class(lps, granularity=32)
    (key, entries), = classes.items()
    A, b, c = tb.stack_class(entries, *key)
    assert A.shape[1] > A.shape[2]
    want = jb.solve_batch_intpt(jnp.asarray(A), jnp.asarray(b),
                                jnp.asarray(c), precision="f64")
    got = tb.solve_batch_intpt(A, b, c, precision="f64", device="cpu")
    want, _ = _assert_lanes(want, got, c, 1, 1e-7)
    assert np.all(want[0] == 0)


def _jax_pd_draws(B, m, n, seed=0):
    """The per-lane U[0,1) draws of vanderbei_tpu's solve_batch_pd."""
    ux, uy = [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), B):
        kx, ky = jax.random.split(key)
        ux.append(np.asarray(jax.random.uniform(kx, (m,), jnp.float64)))
        uy.append(np.asarray(jax.random.uniform(ky, (n,), jnp.float64)))
    return np.stack(ux), np.stack(uy)


@pytest.mark.parametrize("refresh_every", [64, 16])
def test_solve_batch_pd(refresh_every):
    _, (A, b, c, _) = _biggest(False)
    want = [np.asarray(v) for v in jb.solve_batch_pd(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
        refresh_every=refresh_every)]
    got = [v.numpy() for v in tb.solve_batch_pd(
        A, b, c, refresh_every=refresh_every,
        draws=_jax_pd_draws(*A.shape), device="cpu")]
    np.testing.assert_array_equal(got[0], want[0])
    assert np.all(want[0] == 0)
    np.testing.assert_array_equal(got[5], want[5])
    for u, v in zip(got[1:5], want[1:5]):
        np.testing.assert_allclose(u, v, rtol=1e-9, atol=1e-9)


def test_solve_batch_pd_own_draws_same_optimum():
    _, (A, b, c, _) = _biggest(False)
    want = [np.asarray(v) for v in jb.solve_batch_pd(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))]
    got = [v.numpy() for v in tb.solve_batch_pd(A, b, c, seed=3,
                                                device="cpu")]
    np.testing.assert_array_equal(got[0], want[0])
    oj, ot = _objs(c, want[1]), _objs(c, got[1])
    np.testing.assert_allclose(ot, oj, rtol=1e-9)


@pytest.mark.parametrize("method", ["hsd", "intpt"])
def test_batched_lane_equals_single(method):
    """Each lane of a batched f64 solve against the B-less solve of the
    same padded lane: the same status and iterations, objectives within
    1e-12 (the two differ only in the batched products' summation)."""
    structured = method == "hsd"
    _, (A, b, c, ub) = _biggest(structured)
    if method == "hsd":
        got = tb.solve_batch_hsd(A, b, c, ub=ub, precision="f64",
                                 device="cpu")
    else:
        got = tb.solve_batch_intpt(A, b, c, precision="f64", device="cpu")
    t = lambda a: torch.from_numpy(np.asarray(a))
    for j in range(A.shape[0]):
        if method == "hsd":
            ubj = tkkt.UbTail(t(ub.idx2[j]).long(), t(ub.w2[j]))
            one = thsd.solve_canon(t(A[j]), t(b[j]), t(c[j]), 0.0, ub=ubj,
                                   max_refine=4)
        else:
            one = tintpt.solve_canon(t(A[j]), t(b[j]), t(c[j]), 0.0,
                                     max_refine=4, gap_floor=1e-2)
        assert int(one[0]) == int(got[0][j])
        assert int(one[5]) == int(got[5][j])
        oo, ob = float(t(c[j]) @ one[1]), float(t(c[j]) @ got[1][j])
        assert abs(oo - ob) <= 1e-12 * max(1.0, abs(oo))


def test_one_kernel_call_per_f32_iteration(monkeypatch):
    """The f32 sprint forms the whole class's normal matrices with ONE
    scaled_syrk call per iteration, X (B, M1, N) k-contiguous."""
    _, (A, b, c, ub) = _biggest(True)
    calls = []
    syrk = tkkt.scaled_syrk

    def counted(X, s, e):
        calls.append(tuple(X.shape))
        return syrk(X, s, e)

    monkeypatch.setattr(tkkt, "scaled_syrk", counted)
    stages = []
    tb.solve_batch_hsd(A, b, c, ub=ub, precision="mixed", device="cpu",
                       stages=stages)
    assert stages[0]["precision"] == "f32"
    assert len(calls) == int(stages[0]["iterations"].max()) > 0
    assert set(calls) == {tuple(A.shape)}


def test_jax_paused_batch_resumes_in_port(tmp_path):
    """vanderbei_tpu's batched f32 sprint, cast to f64 and saved to npz,
    polishes in the port as it does in JAX."""
    _, (A, b, c, ub) = _biggest(True)
    jub = _jax_ub(ub)
    knobs = dict(max_iter=200, eps=1e-12, step_factor=0.95, beta=0.8,
                 epsdiag=1e-14, refine_tol=1e-10, long_step=False,
                 max_refine=4)
    A32 = jnp.asarray(A, jnp.float32)
    jub32 = JUbTail(jub.idx2, jub.w2.astype(jnp.float32))
    st = jb._run_batch(A32, jnp.asarray(b, jnp.float32),
                       jnp.asarray(c, jnp.float32), jb._batch_init(A32, jub32),
                       pause_mu=1e-4, factor_dtype=None, ub=jub32,
                       **dict(knobs, epsdiag=1e-8, refine_tol=1e-4))
    st = jax.vmap(lambda s: jhsd.cast_state(s, jnp.float64))(st)
    assert np.all(np.asarray(st.status) == -1)
    path = str(tmp_path / "batch.npz")
    jckpt.save_state(path, st)
    want = jb._run_batch(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), st,
                         pause_mu=0.0, factor_dtype=None, ub=jub, **knobs)

    loaded = tckpt.load_state(path, "cpu")
    assert loaded.x.shape == (A.shape[0], A.shape[2])
    assert loaded.iter.shape == (A.shape[0],)
    tub = tkkt.UbTail(torch.from_numpy(ub.idx2).long(),
                      torch.from_numpy(ub.w2))
    t = lambda a: torch.from_numpy(np.asarray(a))
    got, paused = thsd._hsd_loop(t(A), t(b), t(c), 0.0, loaded,
                                 pause_mu=0.0, ub=tub, **knobs)
    assert not paused
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    assert np.all(np.abs(got.iter.numpy() - np.asarray(want.iter)) <= 1)
    x_j = np.asarray(want.x) / np.asarray(want.phi)[:, None]
    x_t = (got.x / got.phi[:, None]).numpy()
    np.testing.assert_allclose(_objs(c, x_t), _objs(c, x_j), rtol=1e-9)


@pytest.mark.parametrize("solver", ["hsd", "intpt", "pd"])
def test_cuda_device_without_cuda_raises(monkeypatch, solver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (A, b, c, _) = _biggest(False)
    fn = {"hsd": tb.solve_batch_hsd, "intpt": tb.solve_batch_intpt,
          "pd": tb.solve_batch_pd}[solver]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(A, b, c)
