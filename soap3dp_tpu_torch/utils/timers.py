"""Env-gated per-stage wall timers (SOAP3DP_TIMERS=1).

The rebuild's analog of the reference's per-stage timing breakdowns
(setStartTime/getElapsedTime, 2bwt-lib/Timing.c; stage prints
SOAP3-DP.cu:816-830 and the BGS_GPU_CASE_BREAKDOWN_TIME compile flags,
definitions.h:282-287) — but switchable at run time.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

ENABLED = bool(os.environ.get("SOAP3DP_TIMERS"))
_acc: dict[str, float] = {}
_cpu: dict[str, float] = {}
_cnt: dict[str, int] = {}


@contextmanager
def stage(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.time()
    c0 = time.thread_time()
    try:
        yield
    finally:
        # wall time on a busy single-core host includes GIL/scheduler
        # waits; thread CPU time is the honest per-stage cost
        _acc[name] = _acc.get(name, 0.0) + (time.time() - t0)
        _cpu[name] = _cpu.get(name, 0.0) + (time.thread_time() - c0)
        _cnt[name] = _cnt.get(name, 0) + 1


def report(prefix: str = "[timers]") -> None:
    if not ENABLED or not _acc:
        return
    total = sum(_acc.values())
    for name, secs in sorted(_acc.items(), key=lambda kv: -kv[1]):
        print(f"{prefix} {name:<32s} {secs:8.3f}s "
              f"(cpu {_cpu.get(name, 0.0):7.3f}s) x{_cnt[name]:<5d} "
              f"{100 * secs / total:5.1f}%", file=sys.stderr)
    _acc.clear()
    _cpu.clear()
    _cnt.clear()
