"""device.idle_unspanned_pct: of card 0's idle time in the profiled
job, the share during which no main-thread span of the port is open
but ``runner.job`` and ``runner.batch`` (the batch loop's time that no
stage owns). The job's spans are placed on the profile's clock by
``spans.place``; nothing where their residual passes 50 us, or where
the profile holds fewer events of a kernel than the port's launch
counters counted."""

from portbench import spans


def read(run):
    tr = run.get("trace")
    if not tr or not spans.events_complete(tr):
        return None
    placed = spans.place(run)
    if placed is None:
        return None
    total, bare = spans.idle_unspanned(spans.card0_idle(tr), placed[0])
    return 100.0 * bare / total if total > 0 else None
