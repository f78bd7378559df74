"""Native (C++) components, loaded via ctypes.

The reference keeps its performance-critical host code in C++ (kd-tree
builder, loaders, scheduler); here the device-side compute is JAX/Pallas
and the host-side acceleration-structure build is native C++ compiled on
first use (c++ -O3 -shared) into libmts_native.so beside this file, which
git ignores. A pure-numpy fallback exists in render/bvh.py.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libmts_native.so")
_SRC = os.path.join(_DIR, "bvh_builder.cpp")

_lib = None
_load_failed = False


def _compile() -> bool:
    """Build the library for this machine. Several processes may build at
    once (parallel test workers): each writes its own file and renames it
    into place, so none loads a half-written library."""
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for flags in (["-march=native"], []):
        try:
            subprocess.run(
                ["c++", "-O3", *flags, "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, _SO)
        return True
    return False


def get_lib():
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _compile():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.mts_build_bvh.restype = ctypes.c_int64
        lib.mts_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def build_bvh_native(vertices: np.ndarray, faces: np.ndarray, max_leaf: int):
    """Native binned-SAH build. Returns the same tuple layout as
    render/bvh.py or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    t = f.shape[0]
    cap = max(2 * t, 2)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    perm = np.empty(t, np.int64)
    m = lib.mts_build_bvh(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), t,
        max_leaf,
        bmin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bmax.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        skip.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if m <= 0:
        return None
    return (
        bmin[:m].copy(), bmax[:m].copy(), first[:m].copy(), count[:m].copy(),
        skip[:m].copy(), perm,
    )
