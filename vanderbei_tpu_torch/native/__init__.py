"""The native (C++) MPS reader, bound with ctypes: the port of
vanderbei_tpu/native.

mps_reader.cc is a byte-for-byte copy of the JAX package's source.  It
parses with the semantics of the Python reader in io/mps.py, several times
faster, and fills the same LP.  The library is built with g++ at first use
into `_build/libvmps-<hash>.so` (the hash covers the source and the
flags, so an edited source never loads a stale library); nothing is built
beside the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "mps_reader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None


class _VmpsLP(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int64), ("n", ctypes.c_int64),
        ("nz", ctypes.c_int64), ("qnz", ctypes.c_int64),
        ("A", ctypes.POINTER(ctypes.c_double)),
        ("iA", ctypes.POINTER(ctypes.c_int64)),
        ("kA", ctypes.POINTER(ctypes.c_int64)),
        ("b", ctypes.POINTER(ctypes.c_double)),
        ("r", ctypes.POINTER(ctypes.c_double)),
        ("c", ctypes.POINTER(ctypes.c_double)),
        ("l", ctypes.POINTER(ctypes.c_double)),
        ("u", ctypes.POINTER(ctypes.c_double)),
        ("Q", ctypes.POINTER(ctypes.c_double)),
        ("iQ", ctypes.POINTER(ctypes.c_int64)),
        ("kQ", ctypes.POINTER(ctypes.c_int64)),
        ("varsgn", ctypes.POINTER(ctypes.c_int64)),
        ("rowlab", ctypes.POINTER(ctypes.c_char)),
        ("rowlab_off", ctypes.POINTER(ctypes.c_int64)),
        ("collab", ctypes.POINTER(ctypes.c_char)),
        ("collab_off", ctypes.POINTER(ctypes.c_int64)),
        ("maximize", ctypes.c_int32),
        ("inftol", ctypes.c_double),
        ("sf_req", ctypes.c_int64),
        ("verbose", ctypes.c_int64),
        ("itnlim", ctypes.c_int64),
        ("timlim", ctypes.c_double),
        ("name", ctypes.c_char * 256),
        ("obj", ctypes.c_char * 256),
        ("err", ctypes.c_char_p),
        ("np_", ctypes.c_int64),
        ("pkeys", ctypes.POINTER(ctypes.c_char)),
        ("pkeys_off", ctypes.POINTER(ctypes.c_int64)),
        ("pvals", ctypes.POINTER(ctypes.c_char)),
        ("pvals_off", ctypes.POINTER(ctypes.c_int64)),
    ]


def library_path() -> str:
    h = hashlib.sha256("\0".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvmps-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile mps_reader.cc into _build/ unless a library built from the
    same source and flags is there; returns its path."""
    library = library_path()
    if os.path.exists(library):
        return library
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stderr}")
    os.replace(tmp, library)
    return library


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.vmps_read.restype = ctypes.POINTER(_VmpsLP)
        lib.vmps_read.argtypes = [ctypes.c_char_p]
        lib.vmps_release.restype = None
        lib.vmps_release.argtypes = [ctypes.POINTER(_VmpsLP)]
        _lib = lib
    return _lib


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _labels(text_ptr, off_ptr, count):
    if count == 0:
        return []
    offs = np.ctypeslib.as_array(off_ptr, shape=(count + 1,))
    raw = ctypes.cast(text_ptr, ctypes.POINTER(ctypes.c_char * int(offs[-1])))
    blob = bytes(raw.contents)
    return [blob[int(offs[i]):int(offs[i + 1]) - 1].decode()
            for i in range(count)]


def read_mps_native(path: str):
    """Parse one MPS file with the native reader; returns an LP."""
    from ..core.lp import LP

    lib = _load()
    p = lib.vmps_read(path.encode())
    try:
        s = p.contents
        if s.err:
            raise ValueError(s.err.decode())
        m, n = int(s.m), int(s.n)
        return LP(
            name=s.name.decode(),
            m=m, n=n,
            A=_arr(s.A, int(s.nz), np.float64),
            iA=_arr(s.iA, int(s.nz), np.int64),
            kA=_arr(s.kA, n + 1, np.int64),
            b=_arr(s.b, m, np.float64),
            c=_arr(s.c, n, np.float64),
            f=0.0,
            r=_arr(s.r, m, np.float64),
            l=_arr(s.l, n, np.float64),
            u=_arr(s.u, n, np.float64),
            Q=_arr(s.Q, int(s.qnz), np.float64),
            iQ=_arr(s.iQ, int(s.qnz), np.int64),
            kQ=_arr(s.kQ, n + 1, np.int64),
            qnz=int(s.qnz),
            varsgn=_arr(s.varsgn, n, np.int64),
            rowlab=_labels(s.rowlab, s.rowlab_off, m),
            collab=_labels(s.collab, s.collab_off, n),
            maximize=bool(s.maximize),
            inftol=float(s.inftol),
            sf_req=int(s.sf_req),
            verbose=int(s.verbose),
            itnlim=int(s.itnlim),
            timlim=float(s.timlim),
            obj_name=s.obj.decode(),
            params=dict(zip(_labels(s.pkeys, s.pkeys_off, int(s.np_)),
                            _labels(s.pvals, s.pvals_off, int(s.np_)))),
        )
    finally:
        lib.vmps_release(p)
