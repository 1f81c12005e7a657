"""The port's spans and counters, switched on by SOAP3DP_TIMERS=1.

The rebuild's analog of the reference's per-stage timing breakdowns
(setStartTime/getElapsedTime, 2bwt-lib/Timing.c; stage prints
SOAP3-DP.cu:816-830 and the BGS_GPU_CASE_BREAKDOWN_TIME compile flags,
definitions.h:282-287), switchable at run time.

On, each ``stage(name)`` records one span: its name, its thread, start
and end on ``time.perf_counter_ns()`` (the clock ``time.perf_counter()``
reads), its thread CPU time (``time.thread_time_ns()``), its parent (the
enclosing span on the same thread, or the span ``linked`` names), the
runner's batch ordinal current when it opened (``batch``), and whether
it only blocks (``wait``). ``count(name, n)`` adds to a counter. Spans
and counters go into per-thread buffers: the hot path takes no lock.
Off, ``stage``, ``wait``, ``batch`` and ``linked`` return one shared
no-op context and ``count`` returns at once: nothing is allocated or
recorded.

``report()`` at the end of a job prints the ``[timers]`` lines (each
name's wall and thread CPU seconds, calls and share of the summed wall)
from the spans, then one line ``[trace] <json>`` with the job's spans
and counters (``export``), and clears both. Call sites reach ``stage``
as a module attribute, and ``wait`` and ``batch`` go through it, so a
caller may wrap it.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time

ENABLED = bool(os.environ.get("SOAP3DP_TIMERS"))
# the columns of an exported span; times are ns after the export's origin
FIELDS = ("id", "parent", "thread", "name", "start", "end", "cpu", "batch",
          "wait")

_ids = itertools.count(1)  # span ids, one sequence for every thread
_local = threading.local()
_buffers: list["_Buffer"] = []
_buffers_lock = threading.Lock()  # taken once a thread, and by report()
_waits: set[str] = set()
_batch = -1


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Buffer:
    """One thread's closed spans, open span ids and counters."""

    __slots__ = ("thread", "spans", "stack", "counts")

    def __init__(self):
        self.thread = threading.current_thread()
        self.spans: list[tuple] = []
        self.stack: list[int] = []
        self.counts: dict[str, int] = {}


def _buffer() -> _Buffer:
    try:
        return _local.buf
    except AttributeError:
        buf = _local.buf = _Buffer()
        with _buffers_lock:
            _buffers.append(buf)
        return buf


class _Span:
    __slots__ = ("name", "parent", "drains", "record", "buf", "id", "batch",
                 "t0", "c0", "t1")

    def __init__(self, name: str, parent: int | None = None,
                 drains: tuple = (), record: bool = True):
        self.name = name
        self.parent = parent
        self.drains = drains
        self.record = record
        self.t1 = None

    # the wall clock is read first on entry and last on exit: its edges
    # then sit where a caller wrapping the span reads its own clock, and
    # the thread CPU clock's read (a system call) falls inside the span
    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        if self.record:
            buf = self.buf = _buffer()
            self.id = next(_ids)
            if self.parent is None:
                self.parent = buf.stack[-1] if buf.stack else 0
            buf.stack.append(self.id)
            self.batch = _batch
            self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        cpu = time.thread_time_ns() - self.c0 if self.record else 0
        self.t1 = time.perf_counter_ns()
        if self.record:
            self.buf.stack.pop()
            self.buf.spans.append((self.id, self.parent, self.name, self.t0,
                                   self.t1, cpu, self.batch, self.drains))
        return False

    def elapsed(self) -> float:
        """Seconds from the span's start to its end, or to now while it
        is open."""
        end = time.perf_counter_ns() if self.t1 is None else self.t1
        return (end - self.t0) / 1e9


def stage(name: str):
    """A span around the ``with`` block."""
    return _Span(name) if ENABLED else _NOOP


def wait(name: str):
    """A span that only blocks (a device sync, a queue, a join)."""
    if not ENABLED:
        return _NOOP
    _waits.add(name)
    return stage(name)


def batch(ordinal: int):
    """The span of one batch of the runner's loop (``runner.batch``);
    spans opened while it is the current batch carry ``ordinal``."""
    global _batch
    if not ENABLED:
        return _NOOP
    _batch = ordinal
    return stage("runner.batch")


def batch_id() -> int:
    """The runner's current batch ordinal (-1 before the first)."""
    return _batch


def current() -> int:
    """The id of this thread's innermost open span (0: none, or off)."""
    if not ENABLED:
        return 0
    stack = _buffer().stack
    return stack[-1] if stack else 0


def linked(name: str, parent: int, drains: tuple = ()):
    """A span whose parent is ``parent`` (``current()`` of another
    thread), carrying the batch ordinals whose work it ``drains``."""
    return _Span(name, parent, tuple(drains)) if ENABLED else _NOOP


def clocked(name: str):
    """A span that keeps its clock readings (``elapsed()``) whether or
    not tracing is on, and is recorded only when it is."""
    return _Span(name, record=ENABLED)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if not ENABLED:
        return
    counts = _buffer().counts
    counts[name] = counts.get(name, 0) + int(n)


def _harvest() -> list[tuple[str, list, dict]]:
    """Every buffer's (thread name, closed spans, counters), emptied;
    buffers of threads that have ended are dropped."""
    with _buffers_lock:
        bufs = list(_buffers)
        _buffers[:] = [b for b in bufs if b.thread.is_alive()]
    out = []
    for b in bufs:
        spans, b.spans = b.spans, []
        counts, b.counts = b.counts, {}
        if spans or counts:
            out.append((b.thread.name, spans, counts))
    return out


def export(harvest) -> dict:
    """The ``[trace]`` object of harvested buffers: ``origin_ns`` (the
    earliest start, on ``perf_counter_ns``), ``threads`` and ``names``
    (the tables a span's thread and name index), ``fields`` and
    ``spans`` (one row a span, times in ns after the origin, parent 0
    for none), ``drains`` (span id -> the batch ordinals a linked span
    drained) and ``counters`` (summed over threads)."""
    names: dict[str, int] = {}
    threads: list[str] = []
    counters: dict[str, int] = {}
    rows, drains = [], {}
    origin = min((s[3] for _t, spans, _c in harvest for s in spans),
                 default=0)
    for tname, spans, counts in harvest:
        ti = len(threads)
        threads.append(tname)
        for k, v in counts.items():
            counters[k] = counters.get(k, 0) + v
        for sid, parent, name, t0, t1, cpu, bat, dr in spans:
            ni = names.setdefault(name, len(names))
            rows.append([sid, parent, ti, ni, t0 - origin, t1 - origin, cpu,
                         bat, int(name in _waits)])
            if dr:
                drains[str(sid)] = list(dr)
    rows.sort(key=lambda r: r[4])
    return {"origin_ns": origin, "threads": threads, "names": list(names),
            "fields": list(FIELDS), "spans": rows, "drains": drains,
            "counters": counters}


def report(prefix: str = "[timers]") -> None:
    """Print the job's ``[timers]`` lines and its ``[trace]`` line to
    standard error, and clear every buffer."""
    global _batch
    if not ENABLED:
        return
    harvest = _harvest()
    _batch = -1
    if not harvest:
        return
    acc: dict[str, list[int]] = {}
    for _t, spans, _c in harvest:
        for _i, _p, name, t0, t1, cpu, *_ in spans:
            a = acc.setdefault(name, [0, 0, 0])
            a[0] += t1 - t0
            a[1] += cpu
            a[2] += 1
    total = max(sum(a[0] for a in acc.values()), 1)
    for name, (wall, cpu, n) in sorted(acc.items(), key=lambda kv: -kv[1][0]):
        print(f"{prefix} {name:<32s} {wall / 1e9:8.3f}s "
              f"(cpu {cpu / 1e9:7.3f}s) x{n:<5d} "
              f"{100 * wall / total:5.1f}%", file=sys.stderr)
    print("[trace] " + json.dumps(export(harvest), separators=(",", ":")),
          file=sys.stderr)
