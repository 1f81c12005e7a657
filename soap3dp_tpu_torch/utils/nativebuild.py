"""Shared build-on-first-use for the native helper libraries.

Their C++ sources are csrc/host/ (SRC_DIR); each is built with g++ at
first use into the package's _build/ directory (BUILD_DIR).

Compiles to a per-process temp file and os.replace()s it into place so
concurrent processes never dlopen a half-written .so (the shared
checkout is exactly the multi-process CLI scenario), and a crashed
compile leaves no partial artifact behind.
"""

from __future__ import annotations

import os
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")


def build_native_lib(src: str, so: str, what: str, fallback: str,
                     extra: list[str] | None = None) -> bool:
    """Ensure ``so`` is built from ``src``; True when usable.

    Skips the compile when the .so is newer than the source. On compile
    failure prints one stderr line naming the ``fallback`` path taken.
    """
    if not os.path.exists(src):
        return False
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return True
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, src] + (extra or []),
            check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"[soap3dp] native {what} build failed ({e}); "
              f"using {fallback}", file=sys.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        # another process may have built it concurrently
        return os.path.exists(so)
