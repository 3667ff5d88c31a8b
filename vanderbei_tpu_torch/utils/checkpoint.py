"""Checkpoint / resume and the numpy <-> tensor converters.

save_solution / load_solution round-trip a Solution through an npz (the
machine-readable counterpart of the .out file).  save_state / load_state
persist an HsdState or an IntptState as an npz with the field names of
vanderbei_tpu.utils.checkpoint, so either package can resume the other's
paused solve; a batched state (every field with a leading lane dim, as
the JAX package's vmapped solves carry it) crosses the same way.
operands_from_canon moves a canonical LP (or the structured head/tail
split) to the device: a plain torch.from_numpy(...).to(device, dtype)
(to_device, which counts the bytes moved), the counterpart of
vanderbei_tpu/ops/assemble.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lp import Solution
from ..models.hsd import HsdState
from ..models.intpt import IntptState
from ..ops.kkt import UbTail
from .profiling import count, spanned

_INT_FIELDS = ("iter", "status", "stall")


def save_solution(path: str, sol: Solution) -> None:
    np.savez(
        path,
        status=np.int64(sol.status),
        x=sol.x, y=sol.y, w=sol.w, z=sol.z,
        primal_obj=np.float64(sol.primal_obj),
        dual_obj=np.float64(sol.dual_obj),
        iterations=np.int64(sol.iterations),
        b_canon=sol.b_canon if sol.b_canon is not None else np.zeros(0),
    )


def load_solution(path: str) -> Solution:
    d = np.load(path)
    b_canon = d["b_canon"]
    return Solution(
        status=int(d["status"]), x=d["x"], y=d["y"], w=d["w"], z=d["z"],
        primal_obj=float(d["primal_obj"]), dual_obj=float(d["dual_obj"]),
        iterations=int(d["iterations"]),
        b_canon=b_canon if b_canon.size else None,
    )


def state_to_numpy(state) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(fields, device, dtype=torch.float64):
    """Build a solver state from numpy arrays (e.g. a JAX state's fields,
    single or batched): an HsdState when the fields hold phi, else an
    IntptState; float fields in `dtype`, iter/status/stall as int64, all
    on `device`, shapes as given."""
    state_cls = HsdState if "phi" in fields else IntptState
    return state_cls(**{
        k: torch.as_tensor(np.array(fields[k]), device=device,
                           dtype=torch.int64 if k in _INT_FIELDS else dtype)
        for k in state_cls._fields})


def save_state(path: str, state) -> None:
    np.savez(path, **state_to_numpy(state))


def load_state(path: str, device, dtype=None):
    """Read an npz written by either package's save_state (an HsdState or
    an IntptState, told apart by the phi field); dtype defaults to the
    stored float dtype."""
    d = np.load(path)
    if dtype is None:
        dtype = torch.from_numpy(np.asarray(d["x"])).dtype
    return state_from_numpy(d, device, dtype)


def _host_to_device(t, device) -> bool:
    """Whether moving tensor t to `device` copies it from the host to a
    device (a CPU solve moves nothing across a bus)."""
    return t.device.type == "cpu" and torch.device(device).type != "cpu"


def to_device(a, device, dtype):
    """a (an array, or a tensor) on `device` in `dtype`.  A host array
    moved to a device counts its bytes in `dtype` as `h2d_bytes`."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    if _host_to_device(t, device):
        count("h2d_bytes", t.numel() * dtype.itemsize)
    return t.to(device, dtype)


@spanned("upload")
def operands_from_canon(canon, device, dtype):
    """(A, b, c, ub) on the device for a CanonLP (ub None) or for the dict
    of ubtail._hsd_structured_operands (A is the head, ub its tail)."""
    to = lambda a: to_device(a, device, dtype)
    if isinstance(canon, dict):
        ub = UbTail(to_device(canon["idx2"], device, torch.int64),
                    to(canon["w2"]))
        return to(canon["A1"]), to(canon["b"]), to(canon["c"]), ub
    return to(canon.A), to(canon.b), to(canon.c), None
