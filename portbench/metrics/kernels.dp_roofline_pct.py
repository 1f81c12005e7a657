"""kernels.dp_roofline_pct: the DP kernels' (K1, K2, TB, DW of
``kernels/banded_dp.py``) share of their roofline over the profiled
job: the sum of every launch's bound (``portbench/roofline.py``) over
the sum of their device times. Nothing where the job launched no DP
kernel, or where the profile holds another number of DP events than
the launches recorded."""

from portbench import roofline
from portbench.trace import DP_KERNELS, kernel_of


def read(run):
    tr = run.get("trace")
    if not tr or not tr["dp_launches"]:
        return None
    times = {}
    counts = {}
    for _dev, a, b, name in tr["device_events"]:
        k = kernel_of(name)
        if k in DP_KERNELS:
            times[k] = times.get(k, 0.0) + (b - a) / 1e3
            counts[k] = counts.get(k, 0) + 1
    launched = {}
    for row, *_ in tr["dp_launches"]:
        launched[row] = launched.get(row, 0) + 1
    if launched != counts:
        return None
    peak32 = roofline.int32_peak_ops(tr["sm_clock_mhz"])
    bound = 0.0
    for row, P, Lr, Lw, cells, scores in tr["dp_launches"]:
        if row == "K1":
            bound += roofline.k1_bound(P, Lr, Lw, cells, roofline.forward_peak(
                Lr, scores, peak32))
        elif row == "K2":
            bound += roofline.k2_bound(P, Lr, Lw, cells, roofline.forward_peak(
                Lr, scores, peak32))
        elif row == "TB":
            bound += roofline.tb_bound(P)
        else:
            bound += roofline.dw_bound(P)
    total = sum(times.values())
    return 100.0 * bound / total if total > 0 else None
