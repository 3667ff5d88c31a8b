"""CUDA graphs of the solvers' read-free steps.

`capture(fn, *args)` records fn(*args) once as one CUDA graph and returns
replay(), which launches it and returns fn's outputs, refreshed in place.
fn must read nothing on the host and take its inputs from tensors whose
addresses do not change (the graph keeps every address, and the
scaled-SYRK kernel's TMA map holds X's by value): a caller copies new
inputs into those tensors between replays (`copy_into`).  pd replays one
graph a pivot (models/simplex.py), a single LP's hsd loop one an
iteration (models/hsd.py).
"""

from __future__ import annotations

import torch

from ..ops import syrk
from .profiling import spanned


def copy_into(dst, src):
    """Copy every tensor of src into dst's (NamedTuples or tuples of
    tensors of the same shapes); returns dst."""
    for d, t in zip(dst, src):
        d.copy_(t)
    return dst


@spanned("graph_capture")
def capture(fn, *args, warm=None, device=None):
    """fn(*args) captured as one CUDA graph on `device` (the current one by
    default).  warm(*args) (fn itself by default) runs first on a side
    stream, outside the capture, so that the libraries set up their
    handles and workspaces.  Returns replay() -> fn's outputs; replay
    holds fn, warm and args, whose tensors the graph reads.

    The capture launches nothing, so the kernel launches that fn makes
    (ops/syrk.route_launches, launch_shapes) are taken back out of the
    counters there and counted again at every replay."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            (warm or fn)(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = syrk.counts()
        with torch.cuda.graph(graph):
            out = fn(*args)
    launched = tuple({key: n - was.get(key, 0) for key, n in now.items()
                      if n != was.get(key, 0)}
                     for now, was in zip(syrk.counts(), before))
    syrk.add_counts(launched, -1)

    def replay():
        with torch.cuda.device(device):
            graph.replay()
        syrk.add_counts(launched)
        return out

    # the graph reads fn's arguments and what fn closes over at the
    # addresses they had at the capture: they live as long as replay
    replay.inputs = (fn, warm, args)
    return replay
