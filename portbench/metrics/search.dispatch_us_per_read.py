"""search.dispatch_us_per_read: the seed search's dispatches (timers
``dispatch.pack`` + ``dispatch.h2d`` + ``dispatch.launch``,
``fm/search.py``), microseconds a read of the window."""

from portbench.parse import stage_sum


def read(run):
    s = stage_sum(run["jobs"], ("dispatch.pack", "dispatch.h2d",
                                "dispatch.launch"))
    return 1e6 * s / run["window_reads"] if s > 0 else None
