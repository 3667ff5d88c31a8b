"""vanderbei_tpu_torch.ops.kkt against vanderbei_tpu.ops.kkt: the same
seeded (A, E, D, rhs) through both factor+solve paths.

Tolerance: dy, dx agree to rtol 1e-9 in f64 (both refine to the f64
residual floor; they differ only in summation order), and the Tikhonov
level each factor ended at is equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vanderbei_tpu.ops import kkt as jkkt
from vanderbei_tpu_torch.ops import kkt as tkkt

RTOL, ATOL = 1e-9, 1e-12


def _both(A, E, D, ry, rx, Q=None, ub=None, factor_dtype=None, reg0=None):
    """Factor and solve with both packages; returns ((dy, dx, reg) JAX,
    (dy, dx, reg) torch) as numpy."""
    jub = tub = None
    if ub is not None:
        idx2, w2 = ub
        jub = jkkt.UbTail(jnp.asarray(idx2, jnp.int32), jnp.asarray(w2))
        tub = tkkt.UbTail(torch.as_tensor(idx2, dtype=torch.int64),
                          torch.as_tensor(w2))
    jfd = {None: None, "f32": jnp.float32}[factor_dtype]
    tfd = {None: None, "f32": torch.float32}[factor_dtype]
    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.as_tensor(a)
    jf = jkkt.kkt_factor(J(A), J(E), J(D), 1e-14, Q=J(Q), factor_dtype=jfd,
                         ub=jub, reg0=reg0)
    jdy, jdx = jkkt.kkt_solve(J(A), J(E), J(D), jf, J(ry), J(rx), Q=J(Q),
                              ub=jub)
    tf = tkkt.kkt_factor(T(A), T(E), T(D), 1e-14, Q=T(Q), factor_dtype=tfd,
                         ub=tub, reg0=reg0)
    tdy, tdx = tkkt.kkt_solve(T(A), T(E), T(D), tf, T(ry), T(rx), Q=T(Q),
                              ub=tub)
    return ((np.asarray(jdy), np.asarray(jdx), float(jf.reg)),
            (tdy.numpy(), tdx.numpy(), float(tf.reg)))


def _check(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t[0], j[0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(t[1], j[1], rtol=rtol, atol=atol)
    assert t[2] == j[2]


@pytest.mark.parametrize("m,n,k", [(5, 9, 1), (7, 7, 2), (30, 50, 2)])
def test_primal_form(m, n, k):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n))
    E = rng.uniform(0.5, 2.0, m)
    D = rng.uniform(0.5, 2.0, n)
    ry, rx = rng.normal(size=(m, k)), rng.normal(size=(n, k))
    _check(*_both(A, E, D, ry, rx))


@pytest.mark.parametrize("with_q", [False, True])
def test_dual_form(with_q):
    rng = np.random.default_rng(2)
    m, n = 9, 5
    A = rng.normal(size=(m, n))
    Qh = rng.normal(size=(n, n))
    Q = Qh @ Qh.T + np.eye(n) if with_q else None
    E = rng.uniform(0.5, 2.0, m)
    D = rng.uniform(0.5, 2.0, n)
    ry, rx = rng.normal(size=m), rng.normal(size=n)
    _check(*_both(A, E, D, ry, rx, Q=Q))


def test_ub_tail_duplicate_padding_indices():
    """Schur-eliminated singleton tail with two padding rows that both point
    at column 0 (the shapes of tests/test_kkt.py's UbTail case): the
    scatter-adds must sum duplicates, as .at[].add does."""
    rng = np.random.default_rng(7)
    m1, k, n = 9, 6, 14
    A1 = rng.normal(size=(m1, n))
    idx2 = np.array([1, 4, 7, 11, 0, 0])
    w2 = np.array([1.0, 0.5, 2.0, 1.0, 0.0, 0.0])
    E = rng.uniform(0.5, 2.0, m1 + k)
    D = rng.uniform(0.5, 2.0, n)
    ry, rx = rng.normal(size=(m1 + k, 2)), rng.normal(size=(n, 2))
    _check(*_both(A1, E, D, ry, rx, ub=(idx2, w2)))


def test_ub_tail_rmatvec_sums_duplicates():
    rng = np.random.default_rng(3)
    A1 = rng.normal(size=(4, 6))
    idx2 = np.array([2, 2, 0, 0])
    w2 = np.array([1.0, 3.0, 0.5, 0.0])
    y = rng.normal(size=8)
    want = np.asarray(jkkt.tail_rmatvec(
        jnp.asarray(A1), jkkt.UbTail(jnp.asarray(idx2, jnp.int32),
                                     jnp.asarray(w2)), jnp.asarray(y)))
    got = tkkt.tail_rmatvec(torch.as_tensor(A1),
                            tkkt.UbTail(torch.as_tensor(idx2),
                                        torch.as_tensor(w2)),
                            torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def test_f32_factor_f64_refinement():
    rng = np.random.default_rng(3)
    m, n = 40, 24
    A = rng.normal(size=(m, n))
    D = 10.0 ** rng.uniform(-4, 4, n)
    E = 10.0 ** rng.uniform(-4, 4, m)
    ry, rx = rng.normal(size=m), rng.normal(size=n)
    j, t = _both(A, E, D, ry, rx, factor_dtype="f32")
    _check(j, t)


def test_all_f32_data():
    """The mixed ladder's sprint: f32 data, f32 normal matrix (the syrk),
    f32 factor.  f32 tolerance: both stop refining at the f32 floor."""
    rng = np.random.default_rng(4)
    m, n = 20, 32
    A = rng.normal(size=(m, n)).astype(np.float32)
    E = rng.uniform(0.5, 2.0, m).astype(np.float32)
    D = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ry = rng.normal(size=m).astype(np.float32)
    rx = rng.normal(size=n).astype(np.float32)
    j, t = _both(A, E, D, ry, rx)
    assert t[0].dtype == np.float32
    _check(j, t, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("factor_dtype,reg", [(None, 1e-2), ("f32", 1e-1)])
def test_tikhonov_retry_extreme_scale(factor_dtype, reg):
    """Dual form with A = 0, so M = diag(D) + Q exactly, built as S0 T S0:
    a diagonal spread of 1e-8..1e8 around a T whose Jacobi-scaled form has
    one eigenvalue near -5e-3.  Every rung of the ladder below `reg` fails
    by a margin of 1e-3 or more and `reg` succeeds by as much, far from
    the PD boundary, so both packages must take the same steps.  The
    true system is indefinite, so refinement cannot improve on the
    regularized factor: with an f32 factor the solutions agree to f32
    accuracy (rtol 1e-5), with an f64 one to rtol 1e-9."""
    rng = np.random.default_rng(5)
    m, n = 6, 4
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    T = V @ np.diag([-5e-3, 0.6, 0.9, 1.3]) @ V.T
    s0 = 10.0 ** rng.uniform(-4, 4, n)
    M = s0[:, None] * T * s0[None, :]
    dsc = 1.0 / np.sqrt(np.diag(M))
    lam = np.linalg.eigvalsh(M * dsc[:, None] * dsc[None, :])
    assert -3e-2 < lam[0] < -2e-3 and lam[1] > 0.1     # precondition
    D = np.diag(M).copy()
    Q = M - np.diag(D)
    A = np.zeros((m, n))
    E = np.ones(m)
    ry, rx = rng.normal(size=m), rng.normal(size=n)
    j, t = _both(A, E, D, ry, rx, Q=Q, factor_dtype=factor_dtype)
    assert j[2] == pytest.approx(reg, rel=1e-6)
    _check(j, t, rtol=RTOL if factor_dtype is None else 1e-5)


def test_sticky_reg0_seed():
    rng = np.random.default_rng(6)
    m, n = 8, 12
    A = rng.normal(size=(m, n))
    E = rng.uniform(0.5, 2.0, m)
    D = rng.uniform(0.5, 2.0, n)
    ry, rx = rng.normal(size=m), rng.normal(size=n)
    j, t = _both(A, E, D, ry, rx, reg0=1e-6)
    assert j[2] == 1e-6
    _check(j, t)
