"""runner.offcpu_us_per_read: the batch loop's time off the CPU, each
job's ``runner.job`` span's wall less its thread CPU time (blocked, or
waiting for the interpreter lock), over every job of the window,
microseconds a read of the window."""

from portbench import spans


def read(run):
    trs = spans.traces(run)
    if trs is None:
        return None
    jobs = [s for tr in trs for s in tr.named("runner.job")]
    if len(jobs) != len(trs):
        return None
    return sum(s.wall - s.cpu for s in jobs) / 1e3 / run["window_reads"]
