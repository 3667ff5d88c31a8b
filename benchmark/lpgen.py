"""Seeded random bounded LPs, frozen from the port's utils/randlp.py so that
a change to the program cannot move the benchmark's data.

    min c'x  s.t.  A_eq x = b_eq,  A_le x <= b_le,  0 <= x <= u

A has N(0,1) entries at the given density, u ~ U[1, 3], c ~ N(0, 1); the
right-hand sides come from an interior point x0 = U[0.2, 0.8] * u, with a
slack of U[0.1, 1] on the <= rows, so the LP is feasible and, being boxed,
bounded.  The first m // 10 rows are equalities.

`random_bounded_lp` makes these draws in randlp's order from one stream.
The benchmark splits them: a pool member (`pool_matrix`: A and u) is made
once at set-up, and every request draws its own c, x0 and slack
(`request_lp`) from (seed, request index, lane), so each request is a new
LP on a known matrix.  `pool_matrix` draws A's pattern as a Binomial(m n,
density) count of positions without replacement, which is the law of
randlp's independent draw per entry in a fiftieth of the draws.
Everything here is numpy; the LP is kept in its natural form
(`NaturalLP`), which both the reference and the driver read.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NaturalLP:
    """min c'x, A[:n_eq] x = b[:n_eq], A[n_eq:] x <= b[n_eq:], 0 <= x <= u;
    A dense (m, n) float64."""

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    u: np.ndarray
    n_eq: int

    @property
    def shape(self) -> tuple:
        return self.A.shape


def stream(seed: int, *path: int) -> np.random.Generator:
    """A numpy generator for (seed, *path); any whole seed, of any size or
    sign, maps to one stream."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, *map(int, path)]))


def _matrix(rng, m: int, n: int, density: float):
    A = np.where(rng.random((m, n)) < density, rng.standard_normal((m, n)),
                 0.0)
    u = rng.uniform(1.0, 3.0, n)
    return A, u


def _vectors(rng, A, u, n_eq: int):
    m, n = A.shape
    c = rng.standard_normal(n)
    x0 = rng.uniform(0.2, 0.8, n) * u
    slack = rng.uniform(0.1, 1.0, m - n_eq)
    b = A @ x0
    b[n_eq:] += slack
    return b, c


def random_bounded_lp(m: int, n: int, density: float = 0.02,
                      seed: int = 0) -> NaturalLP:
    """randlp.random_bounded_lp(m, n, density, seed), draw for draw, in the
    natural form (randlp stores the <= rows negated, as >= rows)."""
    rng = np.random.default_rng(seed)
    A, u = _matrix(rng, m, n, density)
    n_eq = m // 10
    b, c = _vectors(rng, A, u, n_eq)
    return NaturalLP(A, b, c, u, n_eq)


def pool_matrix(m: int, n: int, density: float, rng) -> tuple:
    """A pool member's (A, u): A's entries nonzero independently with
    probability `density`, N(0, 1) where they are; u ~ U[1, 3]."""
    k = rng.binomial(m * n, density)
    A = np.zeros(m * n)
    A[rng.choice(m * n, size=k, replace=False)] = rng.standard_normal(k)
    return A.reshape(m, n), rng.uniform(1.0, 3.0, n)


def request_lp(A, u, rng) -> NaturalLP:
    """A new LP on the matrix A and the boxes u: fresh c, x0 and slack."""
    n_eq = A.shape[0] // 10
    b, c = _vectors(rng, A, u, n_eq)
    return NaturalLP(A, b, c, u, n_eq)
