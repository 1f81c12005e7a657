"""The port's span and counter recorder (``utils/timers.py``): nothing
recorded with tracing off, spans that nest per thread with their parent
and batch ordinal, no span or count lost between threads, the
``[timers]`` lines in their format and a ``[trace]`` line that parses,
and one ``pair --device cpu`` job traced end to end."""

import json
import re
import sys
import threading

import numpy as np
import pytest
import torch

from soap3dp_tpu_torch.utils import timers

torch.set_num_threads(1)

# the port's stage names before the recorder, and the names and prefixes
# the benchmark's stage readers (portbench/metrics/) sum
OLD_NAMES = {
    "runner.dispatch", "io.parse", "io.reader_wait", "io.write_worker",
    "io.writer_drain", "io.sam.format", "io.sam.fwrite", "dispatch.pack",
    "dispatch.h2d", "dispatch.launch", "dp.seed_cand", "dp.pack", "dp.align",
    "A2.single", "A.search", "A.host_realign", "A.tables", "A.pairing",
    "A.emit", "A2.fetch", "A2.tables", "BC.half_rescue", "D.deep_dp",
    "E.salvage", "BC.prescan"}
READ_NAMES = {"io.sam.format", "io.sam.fwrite", "BC.half_rescue",
              "D.deep_dp", "E.salvage", "dispatch.pack", "dispatch.h2d",
              "dispatch.launch", "dp.seed_cand", "dp.pack", "dp.align",
              "BC.prescan"}
READ_PREFIXES = ("A.", "A2.")
# the benchmark's parse of a [timers] line (portbench/parse.py)
TIMER_LINE = re.compile(r"^\[timers\] (\S+)\s+([0-9.]+)s \(cpu\s+([0-9.]+)s\) "
                        r"x(\d+)", re.M)


@pytest.fixture
def tracing(monkeypatch):
    monkeypatch.setattr(timers, "ENABLED", True)
    timers._harvest()
    yield
    timers._harvest()
    timers._batch = -1


def _rows(obj):
    """The exported spans as dicts with their names and threads."""
    out = []
    for r in obj["spans"]:
        d = dict(zip(obj["fields"], r))
        d["name"] = obj["names"][d["name"]]
        d["thread"] = obj["threads"][d["thread"]]
        out.append(d)
    return out


def _export():
    return timers.export(timers._harvest())


def test_off_path_records_nothing(monkeypatch, capsys):
    monkeypatch.setattr(timers, "ENABLED", False)
    timers._harvest()
    noop = timers.stage("a")
    assert noop is timers.stage("b") is timers.wait("c") is \
        timers.batch(3) is timers.linked("d", 7, (1,))
    with timers.stage("a"), timers.wait("c"):
        timers.count("n", 5)
    assert timers.current() == 0 and timers.batch_id() == -1
    assert timers._harvest() == []
    timers.report()
    assert capsys.readouterr().err == ""
    # the one span that keeps its clock off the record
    with timers.clocked("runner.load") as span:
        pass
    assert span.elapsed() >= 0 and timers._harvest() == []


def test_spans_nest_per_thread_with_parent_and_batch(tracing):
    with timers.batch(3):
        with timers.stage("outer"):
            with timers.stage("inner"):
                timers.count("reads", 10)
            with timers.wait("sync"):
                pass
            parent = timers.current()
            got = []
            t = threading.Thread(target=lambda: got.append(_flush(parent)),
                                 name="worker")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and got
    timers.count("reads", 5)
    obj = _export()
    rows = {r["name"]: r for r in _rows(obj)}
    assert set(rows) == {"runner.batch", "outer", "inner", "sync", "flush",
                         "flush.inner"}
    b, o, i, s = (rows[n] for n in ("runner.batch", "outer", "inner", "sync"))
    assert b["parent"] == 0 and o["parent"] == b["id"]
    assert i["parent"] == o["id"] and s["parent"] == o["id"]
    assert {r["batch"] for r in rows.values()} == {3}
    assert [n for n, r in rows.items() if r["wait"]] == ["sync"]
    assert b["start"] <= o["start"] <= i["start"] <= i["end"] <= o["end"] \
        <= b["end"]
    f = rows["flush"]
    assert f["thread"] == "worker" and f["parent"] == o["id"]
    assert rows["flush.inner"]["parent"] == f["id"]
    assert obj["drains"] == {str(f["id"]): [1, 2]}
    assert obj["counters"] == {"reads": 15}
    assert min(r["start"] for r in rows.values()) == 0
    assert all(r["cpu"] >= 0 for r in rows.values())


def _flush(parent):
    with timers.linked("flush", parent, (1, 2)):
        with timers.stage("flush.inner"):
            pass
    return True


def test_concurrent_threads_lose_no_span_or_count(tracing):
    N, K = 8, 1500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(j):
            for k in range(K):
                with timers.stage(f"s{k % 3}"):
                    with timers.wait("w"):
                        timers.count("n", 1)
                        timers.count(f"t{j}", 2)

        threads = [threading.Thread(target=work, args=(j,)) for j in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    obj = _export()
    rows = _rows(obj)
    assert len(rows) == 2 * N * K
    assert len({r["id"] for r in rows}) == 2 * N * K
    assert obj["counters"]["n"] == N * K
    assert all(obj["counters"][f"t{j}"] == 2 * K for j in range(N))
    ids = {r["id"]: r for r in rows}
    for r in rows:
        if r["name"] == "w":
            p = ids[r["parent"]]
            assert p["thread"] == r["thread"] and p["name"].startswith("s")


def test_report_prints_timers_lines_and_one_trace_line(tracing, capsys):
    for _ in range(3):
        with timers.stage("A.search"):
            with timers.stage("search.parse"):
                pass
    with timers.wait("io.reader_wait"):
        pass
    timers.count("search.phase1_reads", 7)
    timers.report()
    err = capsys.readouterr().err.splitlines()
    tl = [l for l in err if l.startswith("[timers] ")]
    tr = [l for l in err if l.startswith("[trace] ")]
    assert len(tl) == 3 and len(tr) == 1 and len(err) == 4
    got = {m[0]: m for m in TIMER_LINE.findall("\n".join(tl))}
    assert set(got) == {"A.search", "search.parse", "io.reader_wait"}
    assert got["A.search"][3] == "3"
    obj = json.loads(tr[0][len("[trace] "):])
    walls = {}
    for r in _rows(obj):
        walls[r["name"]] = walls.get(r["name"], 0) + r["end"] - r["start"]
    total = sum(walls.values())
    for line in tl:
        name = line.split()[1]
        cpu = sum(r["cpu"] for r in _rows(obj) if r["name"] == name)
        n = sum(1 for r in _rows(obj) if r["name"] == name)
        # the format the lines had before they were summed from spans
        assert line == (f"[timers] {name:<32s} {walls[name] / 1e9:8.3f}s "
                        f"(cpu {cpu / 1e9:7.3f}s) x{n:<5d} "
                        f"{100 * walls[name] / total:5.1f}%")
    assert obj["counters"] == {"search.phase1_reads": 7}
    assert obj["origin_ns"] > 0 and obj["fields"] == list(timers.FIELDS)
    # cleared
    timers.report()
    assert capsys.readouterr().err == ""


@pytest.fixture(scope="module")
def traced_job(tmp_path_factory):
    """One ``pair --device cpu`` job with tracing on: 256 pairs of 100 bp
    against a 200 kbp genome in batches of 64, a few ends with an indel
    or random (the rescue phases run), and its standard error."""
    import contextlib
    import io

    from soap3dp_tpu_torch.cli.main import main as port_main

    d = tmp_path_factory.mktemp("timers_job")
    rng = np.random.default_rng(2024)
    G = 200_000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fa = d / "g.fa"
    fa.write_text(">c1\n" + acgt[codes[:G // 2]].tobytes().decode() + "\n>c2\n"
                  + acgt[codes[G // 2:]].tobytes().decode() + "\n")
    with contextlib.redirect_stderr(io.StringIO()):
        assert port_main(["build", str(fa)]) == 0
    B, L, INS = 256, 100, 400
    comp = np.array([3, 2, 1, 0], np.uint8)
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for b in range(B):
            p = int(rng.integers(0, G - INS - 1))
            left = codes[p:p + L].copy()
            right = comp[codes[p + INS - L:p + INS]][::-1].copy()
            if b % 16 == 1:
                right = np.concatenate([right[:30], right[33:],
                                        rng.integers(0, 4, 3)]).astype(np.uint8)
            if b % 32 == 3:
                left = rng.integers(0, 4, L).astype(np.uint8)
            f1.write(f"@p{b}\n{acgt[left].tobytes().decode()}\n+\n{'I' * L}\n")
            f2.write(f"@p{b}\n{acgt[right].tobytes().decode()}\n+\n{'I' * L}\n")
    argv = ["pair", str(d / "g.fa.index"), str(d / "r1.fq"), str(d / "r2.fq"),
            "-v", "300", "-u", "500", "--batch-size", "64", "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    try:
        # untraced first: it also makes the process's first imports,
        # which a job that is not a process's first does not make
        mp.setattr(timers, "ENABLED", False)
        off = io.StringIO()
        with contextlib.redirect_stderr(off):
            assert port_main(argv + ["-o", str(d / "off")]) == 0
        mp.setattr(timers, "ENABLED", True)
        timers._harvest()
        sink = io.StringIO()
        with contextlib.redirect_stderr(sink):
            assert port_main(argv + ["-o", str(d / "on")]) == 0
    finally:
        mp.undo()
        timers._harvest()
    text = sink.getvalue()
    line = [l for l in text.splitlines() if l.startswith("[trace] ")]
    assert len(line) == 1
    return {"text": text, "off": off.getvalue(), "batches": B // 64,
            "pairs": B, "trace": json.loads(line[0][len("[trace] "):]),
            "sams": (d / "on.sam", d / "off.sam")}


def _union(iv):
    total, cur = 0, None
    for a, b in sorted(iv):
        if cur is None or a > cur[1]:
            total += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0 if cur is None else cur[1] - cur[0])


def test_traced_job_batches_flushes_and_coverage(traced_job):
    obj = traced_job["trace"]
    rows = _rows(obj)
    main = [r for r in rows if r["thread"] == "MainThread"]
    batches = [r for r in main if r["name"] == "runner.batch"]
    assert [r["batch"] for r in batches] == list(range(traced_job["batches"]))
    job = [r for r in main if r["name"] == "runner.job"]
    assert len(job) == 1 and job[0]["parent"] == 0
    job = job[0]
    ids = {r["id"]: r for r in rows}
    flushes = [r for r in rows if r["name"] == "overlap.flush"]
    assert flushes
    for f in flushes:
        assert f["thread"].startswith("soap3dp-flush")
        assert ids[f["parent"]]["thread"] == "MainThread"
        drained = obj["drains"][str(f["id"])]
        assert drained and set(drained) <= set(range(traced_job["batches"]))
    assert any(r["name"] == "BC.half_rescue" for r in rows)
    below = [(r["start"], r["end"]) for r in main
             if r["name"] not in ("runner.job", "runner.batch")]
    assert _union(below) >= 0.98 * (job["end"] - job["start"])
    waits = {r["name"] for r in main if r["wait"]}
    assert {"io.reader_wait", "io.writer_drain", "overlap.join"} <= waits
    c = obj["counters"]
    assert c["search.phase1_reads"] == 2 * traced_job["pairs"]


def test_traced_job_keeps_the_stage_readers_names(traced_job):
    """Every new name leaves the benchmark's stage readers as they were:
    none starts with A. or A2. or is a name one of them sums; the stages
    they sum are still there, in lines their parse reads."""
    names = set(traced_job["trace"]["names"])
    new = names - OLD_NAMES
    assert new and not any(n.startswith(READ_PREFIXES) for n in new)
    assert not new & READ_NAMES
    timed = {m[0] for m in TIMER_LINE.findall(traced_job["text"])}
    assert timed == names
    assert {"A.search", "A2.fetch", "A.emit", "dispatch.launch",
            "BC.half_rescue", "dp.align", "io.sam.format"} <= timed


def test_traced_job_writes_what_the_untraced_one_does(traced_job):
    """Tracing changes no output, and off it prints no timers."""
    on, off = traced_job["sams"]
    strip = lambda p: sorted(l for l in open(p) if not l.startswith("@PG"))  # noqa: E731
    assert strip(on) == strip(off)
    assert "[timers]" not in traced_job["off"]
    assert "[trace]" not in traced_job["off"]


def test_tie_block_counters_and_span(tracing):
    """Phase A's tied pairs: the block's span and counters, and none
    written a record at a time through a SAM writer without -p; a
    writer whose block form takes no alternates counts them there."""
    from soap3dp_tpu_torch.io.sam import SamWriter
    from soap3dp_tpu_torch.pipeline.options import AlignOptions
    from tests.test_torch_pair_tie_block import RecordTieSam, run_sam

    opts = AlignOptions(min_insert=100, max_insert=700)
    run_sam(SamWriter, opts)
    obj = _export()
    c = obj["counters"]
    assert c["pair.tie_block_pairs"] > 0 and c["pair.xa_entries"] > 0
    assert c["pair.tie_record_pairs"] == 0
    rows = _rows(obj)
    ids = {r["id"]: r for r in rows}
    spans = [r for r in rows if r["name"] == "pair.tie_emit"]
    assert spans and all(ids[r["parent"]]["name"] == "A.emit" for r in spans)
    run_sam(RecordTieSam, opts)
    obj = _export()
    c2 = obj["counters"]
    assert c2["pair.tie_record_pairs"] == c["pair.tie_block_pairs"]
    assert c2["pair.xa_entries"] == c["pair.xa_entries"]
    assert "pair.tie_block_pairs" not in c2
    assert "pair.tie_emit" not in obj["names"]
