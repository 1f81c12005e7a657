"""kernels.search_device_us_per_read: the device time of the search's,
the seeding's and the rescue prescan's kernels (FS1-FS6, FS2x, FS2s,
GP, PK of ``kernels/fm_search.py``) in the profiled job, microseconds a
read of that job."""

from portbench.trace import SEARCH_KERNELS, kernel_of


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    us = sum(b - a for _dev, a, b, name in tr["device_events"]
             if kernel_of(name) in SEARCH_KERNELS)
    return us / tr["reads"] if us > 0 else None
