"""Normal-equations assembly M = X diag(s) X' + diag(e), the counterpart of
vanderbei_tpu/ops/pallas_kernels.py.

`scaled_syrk` routes on the device of its operand and on nothing else: a
CUDA tensor goes to the hand-written Hopper kernel in csrc/scaled_syrk.cu,
a CPU tensor to `scaled_syrk_reference`, the plain torch version.  There
is no size cutoff, no environment switch and no fallback: a CUDA launch
that fails raises.

The kernel is compiled at first use with nvcc into a shared library with a
plain C interface under `_build/` and bound with ctypes; no PyTorch headers
are compiled, so the build takes seconds.  The library's file name carries
a hash of every source under csrc/ and of the nvcc flags, so an edit to
any of them builds a new library and a stale one is never loaded.
`route_launches` counts the kernel's launches by copy path and layout
(keys such as "tma/transposed"), so a run can show that the solver went
through it, and `launch_shapes` by the shape and layout of X; `launch_count()`
is their total, `reset_counts` zeroes both, `counts()` copies them and
`add_counts` adds to them (a CUDA graph's launches at each replay,
utils/graphs.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCE = os.path.join(CSRC, "scaled_syrk.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart", "static",
              "-ldl", "-Xptxas", "-v"]

route_launches = {}   # launches since the last reset, by route/layout
launch_shapes = {}    # ... and by (X's shape, layout)
build_log = ""        # nvcc's output (ptxas register/spill report) of a build
_lib = None


def reset_counts() -> None:
    route_launches.clear()
    launch_shapes.clear()


def counts() -> tuple:
    """Both counters as they stand, copied: (route_launches,
    launch_shapes)."""
    return dict(route_launches), dict(launch_shapes)


def add_counts(launches: tuple, sign: int = 1) -> None:
    """Add launches, as counts() gives them, to both counters (sign -1:
    take them away)."""
    for total, part in zip((route_launches, launch_shapes), launches):
        for key, n in part.items():
            total[key] = total.get(key, 0) + sign * n
            if not total[key]:
                del total[key]


def launch_count() -> int:
    """The kernel's launches since the last reset."""
    return sum(route_launches.values())


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


def library_path() -> str:
    """_build/libscaled_syrk-<hash>.so, the hash taken over the nvcc flags
    and the name and bytes of every file under csrc/."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(b"\0" + name.encode() + b"\0")
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libscaled_syrk-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile csrc/scaled_syrk.cu into _build/ unless a library built from
    the same sources and flags is there; returns its path."""
    global build_log
    library = library_path()
    if not force and os.path.exists(library):
        return library
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stderr}")
    os.replace(tmp, library)
    build_log = proc.stdout + proc.stderr
    return library


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vt_scaled_syrk_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                           i64, i64, i64, i64, i64, ptr]
        lib.vt_scaled_syrk_f32.restype = i32
        lib.vt_scaled_syrk_route.argtypes = [ptr, i32, i32, i32, i64, i64,
                                             i64]
        lib.vt_scaled_syrk_route.restype = i32
        lib.vt_cuda_error_string.argtypes = [i32]
        lib.vt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def scaled_syrk_cuda(X, s, e):
    """Launch the Hopper kernel: X (m, n) or (B, m, n) f32 on a CUDA device,
    any non-negative strides; s (…, n) and e (…, m) f32 with unit stride
    along their last dimension.  Returns a new contiguous f32 M."""
    batched = X.dim() == 3
    shape_key = (tuple(X.shape), layout(X))
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
    lib = _load()
    M = torch.empty((B, m, m), device=X.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = lib.vt_scaled_syrk_f32(
            X.data_ptr(), s.data_ptr(), e.data_ptr(), M.data_ptr(), B, m, n,
            X.stride(0), X.stride(1), X.stride(2), s.stride(0), e.stride(0),
            stream)
    if rc != 0:
        raise RuntimeError("scaled_syrk kernel launch failed: "
                           + lib.vt_cuda_error_string(rc).decode())
    key = f"{route(X)}/{layout(X)}"
    route_launches[key] = route_launches.get(key, 0) + 1
    launch_shapes[shape_key] = launch_shapes.get(shape_key, 0) + 1
    return M if batched else M[0]


def route(X) -> str:
    """How the kernel copies this X (m, n) or (B, m, n) into shared memory:
    "tma" when its base and non-unit strides are 16-byte aligned and one
    stride is unit, else "cp.async"."""
    X3 = X if X.dim() == 3 else X.unsqueeze(0)
    B, m, n = X3.shape
    tma = _load().vt_scaled_syrk_route(X3.data_ptr(), B, m, n, *X3.stride())
    return "tma" if tma else "cp.async"


def layout(X) -> str:
    """"transposed" when X's rows are its contiguous dimension (the dual
    form's A' view), else "k-contiguous": the kernel's two layouts."""
    sxm, sxn = X.stride(-2), X.stride(-1)
    return "k-contiguous" if (sxn == 1 or sxm != 1) else "transposed"


def scaled_syrk(X, s, e):
    """M = X diag(s) X' + diag(e): the kernel on a CUDA tensor, the plain
    torch version on a CPU tensor."""
    if X.device.type == "cuda":
        return scaled_syrk_cuda(X, s, e)
    if X.device.type == "cpu":
        return scaled_syrk_reference(X, s, e)
    raise ValueError(f"scaled_syrk: no kernel for device {X.device}")
