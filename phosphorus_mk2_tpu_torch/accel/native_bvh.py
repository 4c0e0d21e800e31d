"""ctypes binding for the native C++ BVH builder (csrc/bvh_builder.cpp).

Counterpart of ``phosphorus_mk2_tpu/accel/native_bvh.py``. The library
is compiled with the host's ``g++`` at first use into
``build/torch_kernels/`` (never into ``native/``, which belongs to the
JAX package). Unlike the JAX module, nothing here gives way silently: a
compiler error raises, and ``accel/bvh_builder.attach_bvh`` decides when
the Python builder may run instead.
"""
from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

from phosphorus_mk2_tpu_torch.accel.build import CSRC, load_shared

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LOCK = threading.Lock()
_lib = None


def compiler() -> str | None:
    """The host C++ compiler, or None when the host has none."""
    return shutil.which("g++")


def build() -> ctypes.CDLL:
    """Compile csrc/bvh_builder.cpp (once per source and flags) and load
    it. Raises RuntimeError when there is no compiler or it fails."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        gxx = compiler()
        if gxx is None:
            raise RuntimeError("g++ not found: the native BVH builder cannot be built")
        lib, _ = load_shared(CSRC / "bvh_builder.cpp", gxx, GXX_FLAGS, "phbvh")
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [f32p, ctypes.c_int64, i32p, ctypes.c_int64]
        lib.bvh_counts.restype = None
        lib.bvh_counts.argtypes = [ctypes.c_void_p, i64p, i64p]
        lib.bvh_export.restype = None
        lib.bvh_export.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native builder can be used here: it is built (once)
    and loaded. A failure to build reads as False, as in the JAX package;
    ``build`` raises it."""
    try:
        build()
    except (RuntimeError, OSError):
        return False
    return True


def build_bvh_native(vertices: np.ndarray, faces: np.ndarray) -> dict:
    """Native build; returns the same dict as ``bvh_builder.build_bvh``."""
    lib = build()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"vertices (V, 3) and faces (F, 3) expected, got {v.shape} {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError("faces index outside the vertex array")
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    handle = lib.bvh_build(v.ctypes.data_as(f32p), v.shape[0],
                           f.ctypes.data_as(i32p), f.shape[0])
    try:
        n_nodes = ctypes.c_int64()
        n_leaf = ctypes.c_int64()
        lib.bvh_counts(handle, ctypes.byref(n_nodes), ctypes.byref(n_leaf))
        bmin = np.empty((n_nodes.value, 8, 3), np.float32)
        bmax = np.empty((n_nodes.value, 8, 3), np.float32)
        child = np.empty((n_nodes.value, 8), np.int32)
        count = np.empty((n_nodes.value, 8), np.int32)
        leaf = np.empty((n_leaf.value,), np.int32)
        lib.bvh_export(handle, bmin.ctypes.data_as(f32p), bmax.ctypes.data_as(f32p),
                       child.ctypes.data_as(i32p), count.ctypes.data_as(i32p),
                       leaf.ctypes.data_as(i32p))
        return {
            "node_bmin": bmin,
            "node_bmax": bmax,
            "node_child": child,
            "node_count": count,
            "leaf_tris": leaf,
        }
    finally:
        lib.bvh_free(handle)
