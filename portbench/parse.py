"""Readers of what the port prints on standard error during a job:
its stage timers (``SOAP3DP_TIMERS=1``), the index load line and the
run summary (``cli/runner.py``)."""

from __future__ import annotations

import re

_TIMER = re.compile(r"^\[timers\] (\S+)\s+([0-9.]+)s \(cpu\s+([0-9.]+)s\) "
                    r"x(\d+)", re.M)
_LOAD = re.compile(r"index loaded in ([0-9.]+)s, uploaded to \S+ in "
                   r"([0-9.]+)s")
_DONE = re.compile(r"done: PairSummary\(([^)]*)\)")


def timers(text: str) -> dict[str, float]:
    """Stage -> wall seconds of the ``[timers]`` lines of one job."""
    out: dict[str, float] = {}
    for name, wall, _cpu, _n in _TIMER.findall(text):
        out[name] = out.get(name, 0.0) + float(wall)
    return out


def index_seconds(text: str) -> tuple[float, float] | None:
    """(load, upload) seconds of a job's ``index loaded`` line."""
    m = _LOAD.search(text)
    return (float(m.group(1)), float(m.group(2))) if m else None


def summary(text: str) -> dict[str, int] | None:
    """The counters of a job's ``done: PairSummary(...)`` line."""
    m = _DONE.search(text)
    if m is None:
        return None
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m.group(1))}


def stage_sum(jobs: list, names: tuple, prefixes: tuple = ()) -> float:
    """Wall seconds of the named stages (and of stages starting with a
    prefix) over every job."""
    total = 0.0
    for job in jobs:
        for name, wall in job["timers"].items():
            if name in names or name.startswith(prefixes):
                total += wall
    return total
