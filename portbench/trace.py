"""The traced run's instruments: one torch.profiler pass over a job,
host spans around the port's stage timers, the DP launches' problems,
and the port's launch counters; and the arithmetic on what they give
(busy union, idle gaps, time by kernel).

``Tracer`` patches the port while it is active and restores it after:
``soap3dp_tpu_torch.utils.timers.stage`` also records its span on the
batch loop's thread (placed on the profile's clock by the job's range),
and
the DP launchers of ``kernels/banded_dp.py`` record each launch's shape
and its problems' cells (a reduction on the card, read after the job).
"""

from __future__ import annotations

import contextlib
import threading
import time

# the port's kernel symbols as the profiler names their device events
# (a part of every name), and their rows in the kernel table
SYMBOLS = {
    "dp_align_kernel": "K1", "dp_forward_kernel": "K2",
    "dp_traceback_kernel": "TB", "dp_wire_kernel": "DW",
    "fm_search_kernel": "FS1", "sa_decode_kernel": "FS2",
    "expand_decode_kernel": "FS2x", "seed_expand_kernel": "FS2s",
    "verify_kernel": "FS3", "dedupe_scatter_kernel": "FS4",
    "dedupe_scan_kernel": "FS4", "lane_counts_kernel": "FS5",
    "search_wire_kernel": "FS6", "prescan_kernel": "GP",
    "pack_kernel": "PK",
}
DP_KERNELS = ("K1", "K2", "TB", "DW")
SEARCH_KERNELS = ("FS1", "FS2", "FS2x", "FS2s", "FS3", "FS4", "FS5", "FS6",
                  "GP", "PK")
# the port's launch counters (module, attribute): kernel, kernels a launch
COUNTERS = {
    ("fm_search", "SEARCH_KERNEL"): ("FS1", 1),
    ("fm_search", "DECODE_KERNEL"): ("FS2", 1),
    ("fm_search", "EXPAND_KERNEL"): ("FS2x", 1),
    ("fm_search", "SEED_EXPAND_KERNEL"): ("FS2s", 1),
    ("fm_search", "VERIFY_KERNEL"): ("FS3", 1),
    ("fm_search", "DEDUPE_KERNEL"): ("FS4", 2),
    ("fm_search", "LANE_COUNTS_KERNEL"): ("FS5", 1),
    ("fm_search", "SEARCH_WIRE_KERNEL"): ("FS6", 1),
    ("fm_search", "PRESCAN_KERNEL"): ("GP", 1),
    ("fm_search", "PACK_KERNEL"): ("PK", 1),
    ("banded_dp", "DP_KERNEL"): ("K1", 1),
    ("banded_dp", "FORWARD_KERNEL"): ("K2", 1),
    ("banded_dp", "TRACEBACK_KERNEL"): ("TB", 1),
    ("banded_dp", "WIRE_KERNEL"): ("DW", 1),
}
# the profiled job's range (the profiler also repeats it on the device's
# timeline, where it is no work)
JOB_SPAN = "portbench:job"


def kernel_of(name: str) -> str | None:
    """The kernel-table row of a device event's name, or None."""
    for sym in sorted(SYMBOLS, key=len, reverse=True):
        if sym in name:
            return SYMBOLS[sym]
    return None


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    cur = None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The idle stretches of [t0, t1] outside the intervals."""
    out = []
    cur = t0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def gap_owners(idle, spans) -> dict[str, float]:
    """Idle microseconds by the innermost of the batch loop's stages open
    at each gap's middle ("host outside any stage" where none is)."""
    out: dict[str, float] = {}
    for a, b in idle:
        mid = (a + b) / 2
        inner = None
        for s, e, name in spans:
            if s <= mid <= e and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        key = inner[2] if inner else "host outside any stage"
        out[key] = out.get(key, 0.0) + (b - a)
    return out


class Tracer:
    """Profiles what runs inside ``with tracer:``; ``result()`` after."""

    def __init__(self):
        self.launches: list[tuple] = []
        # (perf_counter start, end, stage) of the batch loop's (the main
        # thread's) stages, and the perf_counter at which JOB_SPAN opened
        self.host: list[tuple] = []
        self.job_mark = None
        self._saved = []
        self.prof = None

    @contextlib.contextmanager
    def job(self):
        """The profiled job: a ``JOB_SPAN`` range the host stages are
        placed against."""
        import torch

        with torch.profiler.record_function(JOB_SPAN):
            self.job_mark = time.perf_counter()
            yield

    def _patch(self, obj, attr, new):
        self._saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from soap3dp_tpu_torch.kernels import banded_dp as bd
        from soap3dp_tpu_torch.kernels import fm_search as fs
        from soap3dp_tpu_torch.utils import timers

        self.counters = {}
        for (mod, attr), (row, per) in COUNTERS.items():
            k = getattr({"fm_search": fs, "banded_dp": bd}[mod], attr)
            k.reset()
            self.counters[attr] = (k, row, per)
        stage = timers.stage
        host = self.host
        main = threading.main_thread().ident

        @contextlib.contextmanager
        def traced_stage(name):
            t0 = time.perf_counter()
            try:
                with stage(name):
                    yield
            finally:
                if threading.get_ident() == main:
                    host.append((t0, time.perf_counter(), name))

        self._patch(timers, "stage", traced_stage)
        launches = self.launches

        def cells(params):
            return (params[:, 0].long() * params[:, 1].long()).sum()

        def wrap(attr, row):
            orig = getattr(bd, attr)

            def launch(*a, **kw):
                if row in ("K1", "K2"):
                    reads, wins, params = a[0], a[1], a[2]
                    sc = a[-1] if not kw else kw.get("sc", a[-1])
                    launches.append((row, reads.shape[0], reads.shape[1],
                                     wins.shape[1], cells(params),
                                     (sc.match, sc.mismatch, sc.gap_open,
                                      sc.gap_ext)))
                elif row == "TB":
                    launches.append((row, a[1].shape[0], 0, 0, None, None))
                else:
                    launches.append((row, a[0].shape[0], 0, 0, None, None))
                return orig(*a, **kw)
            self._patch(bd, attr, launch)

        wrap("_launch_dp", "K1")
        wrap("_launch_forward", "K2")
        wrap("_launch_traceback", "TB")
        wrap("_launch_wire", "DW")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        self.prof.__exit__(*exc)
        self.expected: dict[str, int] = {}
        for k, row, per in self.counters.values():
            self.expected[row] = self.expected.get(row, 0) + k.launches * per
        while self._saved:
            obj, attr, old = self._saved.pop()
            setattr(obj, attr, old)
        return False

    def result(self) -> dict:
        """Device events (card, start us, end us, name), the span of
        ``JOB_SPAN``, host stage spans (start us, end us, name), the
        launch counters by kernel
        as they stood when the profile closed, and the DP launches with
        their cells."""
        dev, spans = [], []
        job = (0.0, 0.0)
        for e in self.prof.events():
            kind = str(getattr(e, "device_type", ""))
            if e.name == JOB_SPAN:
                if not kind.endswith("CUDA"):
                    job = (e.time_range.start, e.time_range.end)
            elif kind.endswith("CUDA"):
                dev.append((int(getattr(e, "device_index", 0)),
                            e.time_range.start, e.time_range.end, e.name))
        if self.job_mark is not None:
            to_us = lambda t: job[0] + (t - self.job_mark) * 1e6  # noqa: E731
            spans = [(to_us(a), to_us(b), n) for a, b, n in self.host]
        launches = [(row, P, Lr, Lw, None if c is None else int(c), sc)
                    for row, P, Lr, Lw, c, sc in self.launches]
        return {"device_events": sorted(dev, key=lambda x: x[1]),
                "job_us": job,
                "host_spans": spans, "expected_launches": self.expected,
                "dp_launches": launches}
