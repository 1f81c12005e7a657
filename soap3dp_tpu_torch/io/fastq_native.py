"""ctypes loader for the native FASTA/FASTQ batch reader
(csrc/host/fastq_reader.cpp), the analog of the reference's C++
QueryParser (QueryParser.cpp:27-995). Builds with g++ -lz on first use;
callers fall back to the pure-Python parser when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from soap3dp_tpu_torch.utils.nativebuild import BUILD_DIR, SRC_DIR, build_native_lib

NAME_STRIDE = 192

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        src = os.path.join(SRC_DIR, "fastq_reader.cpp")
        so = os.path.join(BUILD_DIR, "libfastqreader.so")
        if not os.path.exists(src):
            return None
        if not build_native_lib(src, so, "fastq reader", "python parser", extra=["-lz"]):
            return None
        lib = ctypes.CDLL(so)
        lib.fqr_open.restype = ctypes.c_void_p
        lib.fqr_open.argtypes = [ctypes.c_char_p]
        lib.fqr_close.argtypes = [ctypes.c_void_p]
        lib.fqr_next_batch.restype = ctypes.c_int64
        lib.fqr_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeReader:
    """Iterate batches parsed by the C++ reader."""

    def __init__(self, path: str, batch_size: int, max_len: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native reader unavailable")
        self._lib = lib
        self._h = lib.fqr_open(os.fsencode(path))
        if not self._h:
            raise FileNotFoundError(path)
        self.batch_size = batch_size
        self.max_len = max_len
        self.path = path
        self._warned = False

    def next_batch(self):
        """(names, codes, lens, quals|None) or None at EOF."""
        B, L = self.batch_size, self.max_len
        codes = np.zeros((B, L), np.uint8)
        lens = np.zeros(B, np.int32)
        quals = np.zeros((B, L), np.uint8)
        names = ctypes.create_string_buffer(B * NAME_STRIDE)
        flags = np.zeros(2, np.int32)
        n = self._lib.fqr_next_batch(
            self._h, B, L,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            names, NAME_STRIDE,
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if n < 0:
            raise ValueError(
                f"{self.path}: parse error (not FASTA/FASTQ, or corrupt gzip)")
        if n == 0:
            return None
        if flags[1] and not self._warned:
            print(f"[soap3dp] warning: reads longer than {L} bp truncated",
                  file=sys.stderr)
            self._warned = True
        # names stay a numpy fixed-width 'S' array end-to-end (writers
        # consume the columnar form directly): materializing per-read
        # Python bytes here measured ~30% of total parse cost
        name_arr = np.frombuffer(names, dtype=f"S{NAME_STRIDE}", count=n)
        w = max(int(np.char.str_len(name_arr).max(initial=1)), 1)
        if w < NAME_STRIDE:  # compact to the batch's true name width
            name_arr = np.ascontiguousarray(
                name_arr.view(np.uint8).reshape(n, NAME_STRIDE)[:, :w]
            ).view(f"S{w}").reshape(n)
        return (name_arr, codes[:n], lens[:n],
                quals[:n] if flags[0] else None)

    def close(self):
        if self._h:
            self._lib.fqr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
