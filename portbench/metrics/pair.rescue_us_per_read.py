"""pair.rescue_us_per_read: the pair pipeline's rescue phases (timers
``BC.half_rescue`` + ``D.deep_dp`` + ``E.salvage``,
``pipeline/pair.py``), microseconds a read of the window."""

from portbench.parse import stage_sum


def read(run):
    s = stage_sum(run["jobs"], ("BC.half_rescue", "D.deep_dp", "E.salvage"))
    return 1e6 * s / run["window_reads"] if s > 0 else None
