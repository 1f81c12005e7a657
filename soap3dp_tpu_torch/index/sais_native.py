"""ctypes loader for the native SA-IS extension (csrc/host/sais.cpp).

Builds the shared library on first use with g++ (no pip deps needed)
into the package's _build/. Falls back to None when no compiler
is available; callers then use the numpy prefix-doubling implementation.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from soap3dp_tpu_torch.utils.nativebuild import BUILD_DIR, SRC_DIR, build_native_lib

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        src = os.path.join(SRC_DIR, "sais.cpp")
        so = os.path.join(BUILD_DIR, "libsais.so")
        if not os.path.exists(src):
            return None
        if not build_native_lib(src, so, "sais", "numpy fallback"):
            return None
        lib = ctypes.CDLL(so)
        lib.sais_u8.restype = ctypes.c_int
        lib.sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.sais_u8_u32.restype = ctypes.c_int
        lib.sais_u8_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def suffix_array_sais(codes: np.ndarray) -> np.ndarray | None:
    """SA of codes + sentinel via native SA-IS, or None if unavailable.

    Returns uint32 of length n+1 with SA[0] = n (the sentinel suffix),
    matching soap3dp_tpu_torch.index.suffix_array.suffix_array.
    """
    lib = _load()
    if lib is None:
        return None
    n = int(codes.shape[0])
    t = np.ascontiguousarray(codes, dtype=np.uint8)
    # u32 template end to end: positions fit 32 bits for any genome
    # within the 4 Gbp format limit. The win is footprint — the
    # transient int64 buffer + convert copy disappear (37 -> 12.4 GB
    # peak at 3.1 Gbp); the passes themselves are latency-bound on
    # random T/ls reads, so wall time is roughly unchanged
    out = np.empty(n + 1, dtype=np.uint32)
    out[0] = n
    body = out[1:]
    rc = lib.sais_u8_u32(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        body.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        return None
    return out
