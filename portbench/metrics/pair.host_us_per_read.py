"""pair.host_us_per_read: the pair pipeline's phases A and A2 on the
host (timers ``A.*`` + ``A2.*``, ``pipeline/pair.py``), microseconds a
read of the window."""

from portbench.parse import stage_sum


def read(run):
    s = stage_sum(run["jobs"], (), ("A.", "A2."))
    return 1e6 * s / run["window_reads"] if s > 0 else None
