"""ctypes binding to the native C++ BVH builder (native/bvh_builder.cpp).

Auto-builds the shared library on first use (`make -C native`, which needs
a C++ compiler). When that fails, the numpy builder is used instead, with a
warning, and `builder()` names the builder that runs. The native builder
uses binned SAH, producing better trees than the numpy median-split
fallback for large meshes (flamingo.off is 52,895 triangles — reference KD
build is the heavy init step, SURVEY.md §3.1).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

from tracer.accel.bvh import FlatBVH

_LIB = None
_TRIED = False
_ERROR = None   # why the native library is unavailable


def _lib_path() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libtracer_native.so")


def _load():
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.abspath(_lib_path())
    src_dir = os.path.dirname(path)
    try:
        if (not os.path.exists(path)
                or os.path.getmtime(path) < os.path.getmtime(
                    os.path.join(src_dir, "bvh_builder.cpp"))):
            subprocess.run(["make", "-C", src_dir], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        _ERROR = f"{e}; {detail.decode(errors='replace')[-300:]}".strip()
        warnings.warn(f"native BVH builder unavailable ({_ERROR}); "
                      "using the numpy builder", RuntimeWarning)
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tracer_build_bvh.restype = ctypes.c_int
    lib.tracer_build_bvh.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(f32p), ctypes.POINTER(f32p),
        ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(i32p),
        i32p, i32p,
    ]
    lib.tracer_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def builder() -> str:
    """Which BVH builder compile_scene uses by default."""
    if _load() is not None:
        return "native C++ SAH (native/libtracer_native.so)"
    return f"numpy median split (native unavailable: {_ERROR})"


def build_bvh_native(tri_lo: np.ndarray, tri_hi: np.ndarray,
                     leaf_width: int = 4, max_depth: int = 64):
    """SAH BVH via the C++ builder; returns FlatBVH or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    n = tri_lo.shape[0]

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    node_lo = f32p()
    node_hi = f32p()
    leaf_start = i32p()
    skip = i32p()
    leaf_tris = i32p()
    n_nodes = ctypes.c_int32()
    n_slots = ctypes.c_int32()

    rc = lib.tracer_build_bvh(
        tri_lo.ctypes.data_as(f32p), tri_hi.ctypes.data_as(f32p), n,
        leaf_width, max_depth,
        ctypes.byref(node_lo), ctypes.byref(node_hi),
        ctypes.byref(leaf_start), ctypes.byref(skip),
        ctypes.byref(leaf_tris), ctypes.byref(n_nodes), ctypes.byref(n_slots))
    if rc != 0:
        return None
    B = n_nodes.value
    S = n_slots.value

    def take(ptr, count, dtype):
        if count == 0:
            return np.zeros(0, dtype)
        arr = np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype).copy()
        lib.tracer_free(ptr)
        return arr

    bvh = FlatBVH(
        node_lo=take(node_lo, 3 * B, np.float32).reshape(-1, 3),
        node_hi=take(node_hi, 3 * B, np.float32).reshape(-1, 3),
        node_leaf_start=take(leaf_start, B, np.int32),
        node_skip=take(skip, B, np.int32),
        leaf_tris=take(leaf_tris, S, np.int32),
        leaf_width=leaf_width,
        n_nodes=B,
    )
    return bvh
