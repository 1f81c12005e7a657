"""The port's own spans and counters, and their place on the profile's
clock.

With ``SOAP3DP_TIMERS=1`` (every job of a ``--trace 1`` run) each job
of the port prints one ``[trace] <json>`` line on its standard error
(``soap3dp_tpu_torch/utils/timers.py`` ``report``): its spans (name,
thread, start and end on ``time.perf_counter_ns()``, thread CPU time,
parent, batch ordinal, wait flag) and its counters, after its
``[timers]`` lines. The run keeps each job's standard error as
``run["jobs"][i]["stderr"]``; ``traces(run)`` parses the lines there,
one ``Trace`` a job. A reader of a span or counter returns ``None``
where the jobs print no ``[trace]`` line. Outside the benchmark, any
``soap3dp-torch pair`` run with ``SOAP3DP_TIMERS=1`` prints the same
lines.

``place(run)`` puts the profiled job's (the window's first) main-thread
spans on torch.profiler's clock: ``trace.py`` records the same stages
on the same clock (``time.perf_counter``) as ``host_spans``, already on
the profile's; the offset is the median difference of their starts,
spans matched by name and order, and each matched span's residual is
the smaller of its start's and its end's distance after the offset (a
thread switch between the two clock reads of one edge delays that edge
alone). A reader that needs the profile takes nothing from a job whose
largest residual passes ``RESIDUAL_LIMIT_US``.
"""

from __future__ import annotations

import json
import statistics
from typing import NamedTuple

from portbench.trace import gaps, kernel_of, union_us

MAIN = "MainThread"
RESIDUAL_LIMIT_US = 50.0
PREFIX = "[trace] "


class Span(NamedTuple):
    id: int
    parent: int
    thread: str
    name: str
    start: int      # ns, perf_counter_ns
    end: int
    cpu: int        # ns of the thread's CPU time
    batch: int
    wait: bool

    @property
    def wall(self) -> int:
        return self.end - self.start


class Trace:
    """One job's ``[trace]`` object: ``spans`` (absolute ns),
    ``counters``, ``drains`` (span id -> batch ordinals)."""

    def __init__(self, obj: dict):
        col = {f: i for i, f in enumerate(obj["fields"])}
        names, threads, origin = obj["names"], obj["threads"], obj["origin_ns"]
        self.spans = [Span(r[col["id"]], r[col["parent"]],
                           threads[r[col["thread"]]], names[r[col["name"]]],
                           origin + r[col["start"]], origin + r[col["end"]],
                           r[col["cpu"]], r[col["batch"]],
                           bool(r[col["wait"]]))
                      for r in obj["spans"]]
        self.counters: dict[str, int] = dict(obj["counters"])
        self.drains = {int(k): v for k, v in obj["drains"].items()}

    def main(self) -> list[Span]:
        return [s for s in self.spans if s.thread == MAIN]

    def named(self, *names: str) -> list[Span]:
        return [s for s in self.spans if s.name in names]


def job_trace(text: str) -> Trace | None:
    """The last ``[trace]`` line of one job's standard error."""
    for line in reversed(text.splitlines()):
        if line.startswith(PREFIX):
            return Trace(json.loads(line[len(PREFIX):]))
    return None


def traces(run: dict) -> list[Trace] | None:
    """Every job's trace, or None unless every job of the window printed
    one."""
    out = []
    for job in run["jobs"]:
        if "program_trace" not in job:
            job["program_trace"] = job_trace(job.get("stderr", ""))
        if job["program_trace"] is None:
            return None
        out.append(job["program_trace"])
    return out or None


def union_ns(spans) -> int:
    return int(union_us([(s.start, s.end) for s in spans]))


def offset_us(program: list[Span], host: list) -> tuple[float, float] | None:
    """(offset, largest residual), microseconds: a program span at
    ``start`` ns lies at ``start / 1e3 + offset`` on the profile's
    clock. ``host``: (start us, end us, name) of the same stages."""
    by_name: dict[str, list] = {}
    for h in host:
        by_name.setdefault(h[2], []).append(h)
    pairs = []
    mine: dict[str, list[Span]] = {}
    for s in program:
        mine.setdefault(s.name, []).append(s)
    for name, ps in mine.items():
        hs = sorted(by_name.get(name, []))
        pairs += zip(sorted(ps, key=lambda s: s.start), hs)
    if not pairs:
        return None
    off = statistics.median(h[0] - p.start / 1e3 for p, h in pairs)
    resid = max(min(abs(h[0] - (p.start / 1e3 + off)),
                    abs(h[1] - (p.end / 1e3 + off))) for p, h in pairs)
    return off, resid


def place(run: dict) -> tuple[list[tuple[float, float, str]], float] | None:
    """The profiled job's main-thread spans on the profile's clock,
    (start us, end us, name), and the largest residual; None without a
    profile or a trace, or past ``RESIDUAL_LIMIT_US``."""
    tr = run.get("trace")
    trs = traces(run)
    if not tr or not trs or not tr.get("host_spans"):
        return None
    program = trs[0].main()
    fit = offset_us(program, tr["host_spans"])
    if fit is None or fit[1] > RESIDUAL_LIMIT_US:
        return None
    off, resid = fit
    return ([(s.start / 1e3 + off, s.end / 1e3 + off, s.name)
             for s in program], resid)


def events_complete(tr: dict) -> bool:
    """The profile holds as many events of every kernel as the port's
    launch counters counted."""
    seen: dict[str, int] = {}
    for _dev, _a, _b, name in tr["device_events"]:
        k = kernel_of(name)
        if k:
            seen[k] = seen.get(k, 0) + 1
    return all(seen.get(k, 0) >= n for k, n in tr["expected_launches"].items())


OUTER = ("runner.job", "runner.batch")


def idle_unspanned(idle, placed) -> tuple[float, float]:
    """(idle us, idle us during which no main-thread span but ``OUTER``
    ones is open) of idle stretches (start, end)."""
    spanned = sorted((a, b) for a, b, n in placed if n not in OUTER)
    total = sum(b - a for a, b in idle)
    covered = 0.0
    for a, b in idle:
        covered += union_us([(max(s, a), min(e, b)) for s, e in spanned
                             if e > a and s < b])
    return total, total - covered


def card0_idle(tr: dict) -> list[tuple[float, float]]:
    t0, t1 = tr["window_us"]
    return gaps([(a, b) for d, a, b, _n in tr["device_events"] if d == 0],
                t0, t1)
