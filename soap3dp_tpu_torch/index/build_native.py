"""ctypes loader for the fused native table builder (csrc/host/index_build.cpp).

One streaming pass over the suffix array replaces the numpy fm +
sampling stages, and a rolling-count pass replaces the LUT stage —
bit-identical artifacts (tests/test_builder_native.py) at ~10x less
memory traffic on the 1-core build host. Falls back to the numpy
builders when no compiler is available (callers check for None).
"""

from __future__ import annotations

import ctypes
import os
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
        src = os.path.join(SRC_DIR, "index_build.cpp")
        so = os.path.join(BUILD_DIR, "libindexbuild.so")
        if not build_native_lib(src, so, "index_build", "numpy stages"):
            return None
        lib = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fused_tables_u32.restype = ctypes.c_int
        lib.fused_tables_u32.argtypes = [
            u8p, ctypes.c_int64, u32p, ctypes.c_int64,
            u32p, u32p, u32p, u32p, u32p, i64p, i64p]
        lib.lut_build.restype = ctypes.c_int
        lib.lut_build.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                  u32p, u32p]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("SOAP3DP_NO_NATIVE"):
        return False
    return _load() is not None


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def fused_tables(codes: np.ndarray, sa: np.ndarray, sa_rate: int):
    """occ/bwt words + SA sampling + primary + base counts, one pass.

    Returns (occ, bwt_words, mark_rank, mark_words, sa_samples,
    primary, base_counts) matching builder._build_fm_tables /
    _build_sa_sampling / suffix_array.bwt_from_sa, or None when the
    native library is unavailable.
    """
    lib = _load()
    if lib is None or os.environ.get("SOAP3DP_NO_NATIVE"):
        return None
    n = int(codes.shape[0])
    codes = np.ascontiguousarray(codes, np.uint8)
    sa = np.ascontiguousarray(sa, np.uint32)
    assert sa.shape[0] == n + 1
    nw = n // 16 + 1
    nmw = (n + 1) // 32 + 1
    occ = np.empty(4 * nw, np.uint32)
    bwt_words = np.empty(nw, np.uint32)
    mark_rank = np.empty(nmw, np.uint32)
    mark_words = np.empty(nmw, np.uint32)
    sa_samples = np.empty(n // sa_rate + 1, np.uint32)
    primary = ctypes.c_int64(-1)
    base_counts = np.empty(4, np.int64)
    rc = lib.fused_tables_u32(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), _u32p(sa), ctypes.c_int64(sa_rate),
        _u32p(occ), _u32p(bwt_words), _u32p(mark_rank), _u32p(mark_words),
        _u32p(sa_samples), ctypes.byref(primary),
        base_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    return (occ, bwt_words, mark_rank, mark_words, sa_samples,
            int(primary.value), base_counts.astype(np.uint64))


def lut_native(codes: np.ndarray, k: int):
    """[lo, hi) per k-mer matching builder._build_lut, or None."""
    lib = _load()
    if lib is None or os.environ.get("SOAP3DP_NO_NATIVE"):
        return None
    if not (1 <= k <= 15):
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    size = 1 << (2 * k)
    lo = np.empty(size, np.uint32)
    hi = np.empty(size, np.uint32)
    rc = lib.lut_build(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(int(codes.shape[0])), ctypes.c_int32(k),
        _u32p(lo), _u32p(hi))
    if rc != 0:
        return None
    return lo, hi
