"""runner.index_s: the mean over the window's jobs of the index's load
and upload seconds (``cli/runner.py`` ``_load``'s stderr line)."""


def read(run):
    vals = [j["index_s"] for j in run["jobs"] if j["index_s"] is not None]
    return sum(vals) / len(vals) if vals else None
