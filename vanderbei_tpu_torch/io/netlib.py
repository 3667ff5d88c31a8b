"""Netlib corpus loader and golden-value oracle, the port of
vanderbei_tpu/io/netlib.py.

The corpus is a directory of netlib MPS files named as in NETLIB_GOLDEN:
the directory VANDERBEI_TPU_NETLIB names, else problems/netlib under the
repository root.  The corpus itself is not part of the repository.
"""

from __future__ import annotations

import os

from .mps import read_mps
from .netlib_golden import NETLIB_GOLDEN, ONDISK_OVERRIDES

DEFAULT_CORPUS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "problems", "netlib")


def netlib_dir() -> str:
    return os.environ.get("VANDERBEI_TPU_NETLIB", DEFAULT_CORPUS)


def available_problems(max_rows: int | None = None,
                       max_cols: int | None = None) -> list[str]:
    """Names of netlib problems whose MPS files are on disk, optionally
    filtered by size, sorted by nonzero count (small first)."""
    root = netlib_dir()
    out = []
    for name, (fname, rows, cols, nz, _flags, _opt) in NETLIB_GOLDEN.items():
        if max_rows is not None and rows > max_rows:
            continue
        if max_cols is not None and cols > max_cols:
            continue
        if os.path.exists(os.path.join(root, fname)):
            out.append((nz, name))
    return [name for _, name in sorted(out)]


def load(name: str):
    """Read one netlib problem by canonical (upper-case) name."""
    fname = NETLIB_GOLDEN[name][0]
    return read_mps(os.path.join(netlib_dir(), fname))


def golden_objective(name: str) -> float:
    return NETLIB_GOLDEN[name][5]


def ondisk_objective(name: str) -> float:
    """The true optimum of the ON-DISK file: the published table value,
    unless the file revision is known to differ (ONDISK_OVERRIDES)."""
    return ONDISK_OVERRIDES.get(name, NETLIB_GOLDEN[name][5])
