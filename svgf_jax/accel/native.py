"""ctypes bindings for the native (C++) build components.

The reference does all host-side build work in C++ (BVH.cpp, Scene.cpp);
svgf_jax keeps the same split: `make -C native` produces libsvgf_native.so
and these entry points transparently accelerate accel.bvh.build_blas and
Shape tangent generation. Pure-NumPy fallbacks remain the reference
implementations (and are what the tests validate against).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "native", "libsvgf_native.so"),
        os.path.join(os.path.dirname(__file__), "libsvgf_native.so"),
    ):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.svgf_build_blas.restype = ctypes.c_int32
                lib.svgf_build_blas.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ]
                lib.svgf_tangents.restype = None
                lib.svgf_tangents.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ]
                _LIB = lib
                break
            except OSError:
                pass
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_blas_native(tri_pos: np.ndarray):
    """Native SAH build. tri_pos: (T,3,3). Returns BLAS arrays or None."""
    lib = _find_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
    T = t.shape[0]
    n = 2 * T - 1
    node_min = np.empty((n, 3), np.float32)
    node_max = np.empty((n, 3), np.float32)
    skip = np.empty((n,), np.int32)
    leaf_tri = np.empty((n,), np.int32)
    got = lib.svgf_build_blas(_fp(t), T, _fp(node_min), _fp(node_max),
                              _ip(skip), _ip(leaf_tri))
    if got != n:
        return None
    return node_min, node_max, skip, leaf_tri


def tangents_native(pos, nrm, uv, idx):
    lib = _find_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.float32)
    nrm = np.ascontiguousarray(nrm, np.float32)
    uv = np.ascontiguousarray(uv, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    out = np.empty((pos.shape[0], 4), np.float32)
    lib.svgf_tangents(_fp(pos), _fp(nrm), _fp(uv), _ip(idx),
                      pos.shape[0], idx.shape[0], _fp(out))
    return out
