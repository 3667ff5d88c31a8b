"""vanderbei_tpu_torch — the PyTorch/CUDA port of vanderbei_tpu.

The same LP/QP framework (MPS readers, model builder, canonicalizer, the
interior-point solvers intpt/hsd/hsdls with their f32 -> f64 precision
ladder and compensated "dd" mode, the pd/twophase simplex solvers, `.out`
writer) on torch tensors, for one NVIDIA H100.  The normal-equations
assembly of the f32 stage is a hand-written CUDA kernel
(csrc/scaled_syrk.cu, built with nvcc at first use); everything else is
torch.  The JAX package vanderbei_tpu stays the reference, and this
package imports nothing of it.

Public API:
    read_mps(path)                      -> LP        (io/mps.py, native/)
    LPBuilder(...).build()              -> LP        (core/builder.py)
    canonicalize(lp)                    -> CanonLP   (core/canonicalize.py)
    solve(lp, method=..., device=...)   -> Solution  (models/registry.py)
    write_sol(lp, sol, path), write_lp(lp, path)     (io/writer.py)
"""

import torch as _torch

# the f32 stage needs true f32 products (the counterpart of the JAX
# package's "highest" matmul precision): TF32 stalls the refinement
_torch.backends.cuda.matmul.allow_tf32 = False

from .core.lp import LP, Solution  # noqa: E402
from .core.status import Status, STATUS_MESSAGES  # noqa: E402
from .core.canonicalize import canonicalize, CanonLP  # noqa: E402
from .core.config import SolverConfig  # noqa: E402
from .io.mps import read_mps  # noqa: E402
from .io.writer import write_sol, write_lp  # noqa: E402
from .models.registry import solve, get_solver, SOLVERS  # noqa: E402
from .core.builder import LPBuilder  # noqa: E402

__all__ = [
    "LP",
    "Solution",
    "Status",
    "STATUS_MESSAGES",
    "canonicalize",
    "CanonLP",
    "SolverConfig",
    "read_mps",
    "write_sol",
    "write_lp",
    "solve",
    "get_solver",
    "SOLVERS",
    "LPBuilder",
]
