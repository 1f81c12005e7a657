"""runner.blocked_us_per_read: the batch loop's blocking, the union of
the main thread's ``wait`` spans (device syncs ``search.sync``, the
reader ``io.reader_wait``, the writer's full queue
``io.writer_put_wait`` and its close ``io.writer_drain``, the flusher's
back-pressure ``overlap.submit_wait`` and join ``overlap.join``) over
every job of the window, microseconds a read of the window."""

from portbench import spans


def read(run):
    trs = spans.traces(run)
    if trs is None:
        return None
    ns = sum(spans.union_ns([s for s in tr.main() if s.wait]) for tr in trs)
    return ns / 1e3 / run["window_reads"]
