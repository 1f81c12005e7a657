"""``spans.py`` and the readers of the port's own spans and counters on
a made-up run: the ``[trace]`` line's parse, the offset and residual
that place the profiled job's spans on the profile's clock, the refusal
past 50 us, the idle share no stage owns on hand-made gaps, and nothing
(no exception) from a run whose jobs print no ``[trace]`` line."""

from __future__ import annotations

import json

import pytest

from portbench import spans
from portbench.cell import load_reader

FIELDS = ["id", "parent", "thread", "name", "start", "end", "cpu", "batch",
          "wait"]
WAITS = {"search.sync", "io.reader_wait", "overlap.join"}
ORIGIN = 5_000_000_000  # ns on perf_counter_ns
US = 1000


def trace_line(spans_, counters=None, drains=None) -> str:
    """A ``[trace]`` line of spans (id, parent, thread, name, start us,
    end us, cpu us, batch) as the port prints one."""
    names, threads, rows = [], [], []
    for sid, parent, thread, name, a, b, cpu, bat in spans_:
        if name not in names:
            names.append(name)
        if thread not in threads:
            threads.append(thread)
        rows.append([sid, parent, threads.index(thread), names.index(name),
                     a * US, b * US, cpu * US, bat, int(name in WAITS)])
    obj = {"origin_ns": ORIGIN, "threads": threads, "names": names,
           "fields": FIELDS, "spans": rows, "drains": drains or {},
           "counters": counters or {}}
    return "[trace] " + json.dumps(obj)


M, F = "MainThread", "soap3dp-flush_0"
JOB = [
    (1, 0, M, "runner.job", 0, 1000, 600, -1),
    (2, 1, M, "runner.batch", 0, 700, 450, 0),
    (3, 2, M, "A.search", 0, 150, 100, 0),
    (4, 3, M, "search.sync", 100, 200, 5, 0),
    (5, 2, M, "io.reader_wait", 150, 250, 1, 0),
    (6, 2, M, "A.emit", 300, 450, 150, 0),
    (7, 1, M, "runner.drain", 700, 1000, 20, 0),
    (8, 7, M, "overlap.join", 900, 950, 0, 0),
    (9, 2, F, "overlap.flush", 460, 980, 500, 0),
    (10, 9, F, "rescue.half_emit", 500, 550, 50, 0),
    (11, 9, F, "rescue.deep_emit", 600, 630, 30, 0),
    (12, 9, F, "rescue.salvage_emit", 700, 720, 20, 0),
]
COUNTERS = {"search.phase1_reads": 1000, "search.redispatch_reads": 20,
            "search.round2_reads": 30, "search.round3_reads": 10,
            "search.host_realign_reads": 40}


def host_spans(jitter=lambda i: (0.0, 0.0), offset=123_456.0):
    """trace.py's view of the main thread's stages: (start us, end us,
    name) on the profile's clock, each edge moved by ``jitter(i)``."""
    out = []
    for i, (_s, _p, thread, name, a, b, *_r) in enumerate(JOB):
        if thread != M:
            continue
        ja, jb = jitter(i)
        t = ORIGIN / US + offset
        out.append((t + a + ja, t + b + jb, name))
    return out


def made_up_run(host=None, stderr=None):
    line = trace_line(JOB, COUNTERS, {"9": [0]})
    job = {"stderr": stderr if stderr is not None else "x\n" + line + "\n"}
    t = ORIGIN / US + 123_456.0
    events = [(0, t + 100, t + 200, "fm_search_kernel"),
              (0, t + 500, t + 600, "Memcpy HtoD")]
    return {"jobs": [job, dict(job)], "window_reads": 1000, "window_s": 1.0,
            "trace": {"host_spans": host if host is not None else host_spans(),
                      "device_events": events, "window_us": (t, t + 1000),
                      "cards": 1, "expected_launches": {"FS1": 1}}}


def read(name, run):
    return load_reader(name)(run)


def test_trace_line_parse():
    tr = spans.job_trace("noise\n" + trace_line(JOB, COUNTERS, {"9": [0]}))
    assert len(tr.spans) == len(JOB)
    s = {x.name: x for x in tr.spans}
    assert s["search.sync"].wait and not s["A.search"].wait
    assert s["runner.job"].start == ORIGIN and s["runner.job"].wall == 1000 * US
    assert s["overlap.flush"].thread == F and s["overlap.flush"].parent == 2
    assert tr.drains == {9: [0]} and tr.counters == COUNTERS
    assert len(tr.main()) == 8
    assert spans.job_trace("[timers] A.search 1.0s") is None


def test_program_span_readers():
    run = made_up_run()
    # waits on the main thread: [100, 250] and [900, 950], a job each
    assert read("runner.blocked_us_per_read", run) == pytest.approx(
        2 * 200 / 1000)
    assert read("runner.offcpu_us_per_read", run) == pytest.approx(
        2 * 400 / 1000)
    assert read("runner.drain_s", run) == pytest.approx(300e-6)
    assert read("pair.rescue_emit_us_per_read", run) == pytest.approx(
        2 * 100 / 1000)
    assert read("search.redo_pct", run) == pytest.approx(10.0)


def test_offset_and_residual():
    fit = spans.offset_us(spans.job_trace(trace_line(JOB)).main(),
                          host_spans(lambda i: (-2.0 if i == 0 else -1.0,
                                                2.0)))
    off, resid = fit
    assert off == pytest.approx(123_456.0 - 1.0)
    assert resid == pytest.approx(1.0)
    # a thread switch between the two clock reads of one edge
    late = host_spans(lambda i: (5000.0, 0.0) if i == 3 else (0.0, 0.0))
    placed, resid = spans.place(made_up_run(late))
    assert resid == pytest.approx(0.0)
    assert placed[0][:2] == pytest.approx(
        (ORIGIN / US + 123_456.0, ORIGIN / US + 123_456.0 + 1000))
    assert placed[0][2] == "runner.job"


def test_refused_past_50_us():
    far = host_spans(lambda i: (60.0, 60.0) if i == 2 else (0.0, 0.0))
    run = made_up_run(far)
    assert spans.place(run) is None
    assert read("device.idle_unspanned_pct", run) is None
    near = host_spans(lambda i: (40.0, 40.0) if i == 2 else (0.0, 0.0))
    assert spans.place(made_up_run(near))[1] == pytest.approx(40.0)


def test_idle_unspanned_on_hand_made_gaps():
    idle = [(0, 100), (200, 500), (600, 1000)]
    placed = [(a, b, n) for _i, _p, t, n, a, b, *_r in JOB if t == M]
    total, bare = spans.idle_unspanned(idle, placed)
    # spanned below job and batch: [0, 250], [300, 450], [700, 1000]
    assert total == 800 and bare == 800 - (100 + 50 + 150 + 300)
    run = made_up_run()
    assert read("device.idle_unspanned_pct", run) == pytest.approx(
        100 * 200 / 800)
    run["trace"]["expected_launches"]["FS1"] = 2
    assert read("device.idle_unspanned_pct", run) is None


NEW = ("runner.blocked_us_per_read", "runner.offcpu_us_per_read",
       "runner.drain_s", "pair.rescue_emit_us_per_read", "search.redo_pct",
       "device.idle_unspanned_pct")


def test_nothing_from_a_program_without_the_trace_line():
    """The parent's jobs print only ``[timers]`` lines: every reader of
    the trace returns nothing and raises nothing."""
    run = made_up_run(stderr="[timers] A.search 1.000s (cpu 1.000s) x1\n")
    for name in NEW:
        assert read(name, run) is None
    del run["trace"]
    assert read("device.idle_unspanned_pct", run) is None
