"""Build, load and count the port's hand-written CUDA kernels.

Each source of ``csrc/`` (a plain C interface, no PyTorch headers) is
compiled with nvcc for sm_90a at first use into ``_build/`` and loaded
with ctypes; every kernel wrapper counts its launches on a
``CudaKernel``. Nothing here runs at import: the CPU tests import every
module on a machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")


class CudaLibrary:
    """A source of csrc/ built with nvcc at first use into _build/ (named
    by a digest of the source and every csrc/*.cuh) and loaded with
    ctypes."""

    def __init__(self, name: str):
        self.src = os.path.join(_CSRC_DIR, name)
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self):
        h = hashlib.sha256()
        for path in [self.src] + sorted(glob.glob(os.path.join(_CSRC_DIR,
                                                               "*.cuh"))):
            with open(path, "rb") as fh:
                h.update(fh.read())
        name = os.path.splitext(os.path.basename(self.src))[0]
        so = os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")
        if not os.path.exists(so):
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, self.src]
            t0 = time.time()
            res = subprocess.run(cmd, capture_output=True, text=True)
            self.build_seconds = time.time() - t0
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.src}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, so)
        return ctypes.CDLL(so)


class CudaKernel:
    """One kernel (C symbol) of a CudaLibrary. ``launches`` counts its
    launches, ``per_device`` them by card index and ``shapes`` them by
    launch shape (a tuple of ints the wrapper names) (only the wrapper
    that launches the kernel adds to them)."""

    def __init__(self, library: CudaLibrary, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.reset()
        self._fn = None
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Set the launch counts to 0."""
        self.launches = 0
        self.per_device: dict[int, int] = {}
        self.shapes: dict[tuple[int, ...], int] = {}

    def function(self):
        lib = self.library.load()
        with self._lock:
            if self._fn is None:
                fn = getattr(lib, self.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                self._fn = fn
            return lib, self._fn

    def count(self, device: torch.device, shape: tuple[int, ...]) -> None:
        with self._lock:
            self.launches += 1
            self.per_device[device.index] = \
                self.per_device.get(device.index, 0) + 1
            self.shapes[shape] = self.shapes.get(shape, 0) + 1
