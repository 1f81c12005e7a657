"""pair.rescue_emit_us_per_read: the rescue phases' per-pair emission
loops (spans ``rescue.half_emit``, ``rescue.deep_emit``,
``rescue.salvage_emit``, ``pipeline/pair.py``, on the flusher thread),
over every job of the window, microseconds a read of the window."""

from portbench import spans

EMIT = ("rescue.half_emit", "rescue.deep_emit", "rescue.salvage_emit")


def read(run):
    trs = spans.traces(run)
    if trs is None:
        return None
    ns = sum(s.wall for tr in trs for s in tr.named(*EMIT))
    return ns / 1e3 / run["window_reads"] if ns > 0 else None
