"""dp.call_us_per_read: the DP rescue's calls (timers ``dp.seed_cand``
+ ``dp.pack`` + ``dp.align`` + ``BC.prescan``,
``pipeline/dp_rescue.py``), microseconds a read of the window."""

from portbench.parse import stage_sum


def read(run):
    s = stage_sum(run["jobs"], ("dp.seed_cand", "dp.pack", "dp.align",
                                "BC.prescan"))
    return 1e6 * s / run["window_reads"] if s > 0 else None
