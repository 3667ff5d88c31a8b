"""Checkpoint / resume and the numpy <-> tensor converters.

save_state / load_state persist an HsdState as an npz with the field names
of vanderbei_tpu.utils.checkpoint, so either package can resume the
other's paused solve.  operands_from_canon moves a canonical LP (or the
structured head/tail split) to the device: a plain
torch.from_numpy(...).to(device, dtype), the counterpart of
vanderbei_tpu/ops/assemble.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.hsd import HsdState
from ..ops.kkt import UbTail

_INT_FIELDS = ("iter", "status", "stall")


def state_to_numpy(state: HsdState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(fields: dict, device, dtype=torch.float64) -> HsdState:
    """Build an HsdState from numpy arrays (e.g. a JAX state's fields):
    float fields in `dtype`, iter/status/stall as int64, all on `device`."""
    return HsdState(**{
        k: torch.as_tensor(np.array(fields[k]), device=device,
                           dtype=torch.int64 if k in _INT_FIELDS else dtype)
        for k in HsdState._fields})


def save_state(path: str, state: HsdState) -> None:
    np.savez(path, **state_to_numpy(state))


def load_state(path: str, device, dtype=None) -> HsdState:
    """Read an npz written by either package's save_state; dtype defaults
    to the stored float dtype."""
    d = np.load(path)
    if dtype is None:
        dtype = torch.from_numpy(np.asarray(d["x"])).dtype
    return state_from_numpy(d, device, dtype)


def operands_from_canon(canon, device, dtype):
    """(A, b, c, ub) on the device for a CanonLP (ub None) or for the dict
    of registry._hsd_structured_operands (A is the head, ub its tail)."""
    to = lambda a: torch.from_numpy(np.asarray(a)).to(device, dtype)
    if isinstance(canon, dict):
        ub = UbTail(torch.from_numpy(canon["idx2"].astype(np.int64)).to(device),
                    to(canon["w2"]))
        return to(canon["A1"]), to(canon["b"]), to(canon["c"]), ub
    return to(canon.A), to(canon.b), to(canon.c), None
