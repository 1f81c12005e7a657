"""search.redo_pct: the seed search's retried reads, 100 x (reads
re-dispatched for a budget overflow + escalated to round 2 + to round
3 + re-aligned on the host) / reads dispatched in a first-phase search
(counters ``search.redispatch_reads``, ``search.round2_reads``,
``search.round3_reads``, ``search.host_realign_reads``,
``search.phase1_reads``, ``fm/search.py``, ``fm/host_search.py``), over
every job of the window."""

from portbench import spans

REDO = ("search.redispatch_reads", "search.round2_reads",
        "search.round3_reads", "search.host_realign_reads")


def read(run):
    trs = spans.traces(run)
    if trs is None:
        return None
    first = sum(tr.counters.get("search.phase1_reads", 0) for tr in trs)
    if not first:
        return None
    redo = sum(tr.counters.get(k, 0) for tr in trs for k in REDO)
    return 100.0 * redo / first
