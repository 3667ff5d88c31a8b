"""Solver status taxonomy (a copy of vanderbei_tpu/core/status.py).

Matches the reference's status codes and messages (src/common/main.c:21-30)
so golden-output comparisons against the evaluate/ tree are 1:1.
"""

import enum


class Status(enum.IntEnum):
    OPTIMAL = 0
    PRIMAL_UNBOUNDED = 1
    PRIMAL_INFEASIBLE = 2
    DUAL_UNBOUNDED = 3
    DUAL_INFEASIBLE = 4
    ITERATION_LIMIT = 5
    INFINITE_LOWER_BOUNDS = 6
    SUBOPTIMAL = 7
    # internal sentinel used inside solver loops; never returned to callers
    RUNNING = -1


# Index-aligned with the Status codes above (reference main.c:21-30).
STATUS_MESSAGES = [
    "optimal solution",
    "primal unbounded",
    "primal infeasible",
    "dual unbounded",
    "dual infeasible",
    "iteration limit",
    "infinite lower bounds - not implemented",
    "suboptimal solution",
]


def status_message(status: int) -> str:
    return STATUS_MESSAGES[int(status)]
