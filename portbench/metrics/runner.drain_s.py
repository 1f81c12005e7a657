"""runner.drain_s: the mean over the window's jobs of the end-of-job
drain, span ``runner.drain`` (``cli/runner.py``: the last batch's
phase 2, the rescue backlog flushed and joined, the writer closed),
seconds."""

from portbench import spans


def read(run):
    trs = spans.traces(run)
    if trs is None:
        return None
    walls = [sum(s.wall for s in tr.named("runner.drain")) for tr in trs]
    if not all(walls):
        return None
    return sum(walls) / len(walls) / 1e9
