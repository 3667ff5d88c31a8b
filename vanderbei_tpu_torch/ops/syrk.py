"""Normal-equations assembly M = X diag(s) X' + diag(e), the counterpart of
vanderbei_tpu/ops/pallas_kernels.py.

`scaled_syrk` routes on the device of its operand and on nothing else: a
CUDA tensor goes to the hand-written Hopper kernel in csrc/scaled_syrk.cu,
a CPU tensor to `scaled_syrk_reference`, the plain torch version.  There
is no size cutoff, no environment switch and no fallback: a CUDA launch
that fails raises.

The kernel is compiled at first use with nvcc into a shared library with a
plain C interface under `_build/` (rebuilt when the source is newer) and
bound with ctypes; no PyTorch headers are compiled, so the build takes
seconds.  `launches` counts the kernel's launches, so a run can show that
the solver went through it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "scaled_syrk.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libscaled_syrk.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart", "static",
              "-Xptxas", "-v"]

launches = 0          # kernel launches since the last reset
build_log = ""        # nvcc's output (ptxas register/spill report) of a build
_lib = None


def scaled_syrk_reference(X, s, e):
    """M = X diag(s) X' + diag(e) in plain torch; X is (m, n) or (B, m, n)."""
    M = (X * s.unsqueeze(-2)) @ X.mT
    return M + torch.diag_embed(e)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "scaled_syrk kernel is built from source at first "
                           "use")
    return path


def build(force: bool = False) -> str:
    """Compile csrc/scaled_syrk.cu into _build/ if missing or stale."""
    global build_log
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    build_log = proc.stdout + proc.stderr
    return LIBRARY


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vt_scaled_syrk_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                           i64, i64, i64, i64, i64, ptr]
        lib.vt_scaled_syrk_f32.restype = i32
        lib.vt_cuda_error_string.argtypes = [i32]
        lib.vt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def scaled_syrk_cuda(X, s, e):
    """Launch the Hopper kernel: X (m, n) or (B, m, n) f32 on a CUDA device,
    any non-negative strides; s (…, n) and e (…, m) f32 with unit stride
    along their last dimension.  Returns a new contiguous f32 M."""
    global launches
    batched = X.dim() == 3
    if not batched:
        if X.dim() != 2:
            raise ValueError(f"scaled_syrk: X must be 2-D or 3-D, got "
                             f"{tuple(X.shape)}")
        X, s, e = X.unsqueeze(0), s.unsqueeze(0), e.unsqueeze(0)
    B, m, n = X.shape
    for name, t in (("X", X), ("s", s), ("e", e)):
        if t.device.type != "cuda" or t.device != X.device:
            raise ValueError(f"scaled_syrk: {name} must lie on {X.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"scaled_syrk: {name} must be float32, got "
                            f"{t.dtype}")
    if tuple(s.shape) != (B, n) or tuple(e.shape) != (B, m):
        raise ValueError(f"scaled_syrk: shapes X {tuple(X.shape)}, "
                         f"s {tuple(s.shape)}, e {tuple(e.shape)} disagree")
    if min(X.stride()) < 0 or s.stride(-1) != 1 or e.stride(-1) != 1:
        raise ValueError("scaled_syrk: X needs non-negative strides and s, e "
                         "unit stride along their last dimension")
    if B > 65535:
        raise ValueError(f"scaled_syrk: batch {B} exceeds the grid limit")
    lib = _load()
    M = torch.empty((B, m, m), device=X.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = lib.vt_scaled_syrk_f32(
            X.data_ptr(), s.data_ptr(), e.data_ptr(), M.data_ptr(), B, m, n,
            X.stride(0), X.stride(1), X.stride(2), s.stride(0), e.stride(0),
            stream)
        launches += 1
    if rc != 0:
        raise RuntimeError("scaled_syrk kernel launch failed: "
                           + lib.vt_cuda_error_string(rc).decode())
    return M if batched else M[0]


def scaled_syrk(X, s, e):
    """M = X diag(s) X' + diag(e): the kernel on a CUDA tensor, the plain
    torch version on a CPU tensor."""
    if X.device.type == "cuda":
        return scaled_syrk_cuda(X, s, e)
    if X.device.type == "cpu":
        return scaled_syrk_reference(X, s, e)
    raise ValueError(f"scaled_syrk: no kernel for device {X.device}")
