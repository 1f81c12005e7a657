"""device.idle_pct: the share of the profiled job's wall, over the
cell's cards, in which no kernel, copy or set ran on the device
(torch.profiler). Nothing where the profile holds fewer events of a
kernel than the port's launch counters counted in the same job."""

from portbench.trace import kernel_of, union_us


def read(run):
    tr = run.get("trace")
    if not tr or not tr["device_events"]:
        return None
    seen = {}
    for _dev, _a, _b, name in tr["device_events"]:
        k = kernel_of(name)
        if k:
            seen[k] = seen.get(k, 0) + 1
    if any(seen.get(k, 0) < n for k, n in tr["expected_launches"].items()):
        return None
    t0, t1 = tr["window_us"]
    busy = sum(union_us([(a, b) for d, a, b, _n in tr["device_events"]
                         if d == card]) for card in range(tr["cards"]))
    return 100.0 * (1.0 - busy / ((t1 - t0) * tr["cards"]))
