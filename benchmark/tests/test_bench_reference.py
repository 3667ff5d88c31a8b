"""The plain reference solver against scipy's HiGHS, and the judge."""

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from benchmark import lpgen, reference


def highs(lp):
    return linprog(lp.c, A_ub=lp.A[lp.n_eq:], b_ub=lp.b[lp.n_eq:],
                   A_eq=lp.A[:lp.n_eq], b_eq=lp.b[:lp.n_eq],
                   bounds=list(zip(np.zeros(lp.shape[1]), lp.u)),
                   method="highs")


def solve(lps, dtype=torch.float64):
    st = lambda f: torch.from_numpy(np.stack([f(lp) for lp in lps]))
    return reference.solve(st(lambda p: p.A), st(lambda p: p.b),
                           st(lambda p: p.c), st(lambda p: p.u),
                           lps[0].n_eq, dtype=dtype)


@pytest.mark.parametrize("m,n", [(60, 120), (200, 400)])
def test_float64_matches_highs(m, n):
    lps = [lpgen.random_bounded_lp(m, n, seed=s) for s in (1, 2, 3)]
    x, obj, conv, its = solve(lps)
    assert conv.all() and (its < 40).all()
    for k, lp in enumerate(lps):
        ref = highs(lp)
        assert abs(obj[k] - ref.fun) <= 1e-9 * abs(ref.fun)
        assert reference.feasibility(lp, x[k]) <= 1e-9


def test_float32_is_far_from_highs():
    lps = [lpgen.random_bounded_lp(200, 400, seed=s) for s in (1, 2)]
    x, obj, _, _ = solve(lps, torch.float32)
    worst = max(abs(obj[k] - highs(lp).fun) / abs(highs(lp).fun)
                for k, lp in enumerate(lps))
    assert worst > 1e-7


def test_judge_numbers():
    lps = [lpgen.random_bounded_lp(40, 80, density=0.3, seed=s)
           for s in (1, 2)]
    ref = reference.reference_solve(lps, torch.device("cpu"))
    exact = [(0, obj, x) for x, obj, _ in ref]
    got = reference.judge(lps, exact, torch.device("cpu"))
    assert got["not_optimal"] == 0 and got["ref_unsolved"] == 0
    assert got["obj_rel"] < 1e-14 and got["x_rel"] == 0
    assert got["feas_rel"] < 1e-9
    bad = [exact[0], (5, exact[1][1], exact[1][2] * 1.001)]
    got = reference.judge(lps, bad, torch.device("cpu"))
    assert got["not_optimal"] == 1
    assert got["obj_rel"] > 1e-5 and got["feas_rel"] > 1e-6
    nan = [(0, float("nan"), np.full(80, np.nan))] * 2
    got = reference.judge(lps, nan, torch.device("cpu"))
    assert got["obj_rel"] == float("inf") and got["feas_rel"] == float("inf")
