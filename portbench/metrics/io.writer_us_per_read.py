"""io.writer_us_per_read: the SAM writer's formatting and writing
(timers ``io.sam.format`` + ``io.sam.fwrite``, ``io/sam.py``,
``io/aio.py``), microseconds a read of the window."""

from portbench.parse import stage_sum


def read(run):
    s = stage_sum(run["jobs"], ("io.sam.format", "io.sam.fwrite"))
    return 1e6 * s / run["window_reads"] if s > 0 else None
