"""The arithmetic of the traced run and the parsers of the port's
stderr: busy unions, idle gaps and their owners, kernel names, the
roofline bounds, the metric readers on a made-up run."""

from __future__ import annotations

import os

import pytest

from portbench import parse, roofline
from portbench.cell import load_reader
from portbench.trace import gap_owners, gaps, kernel_of, union_us

HERE = os.path.dirname(os.path.abspath(__file__))

CAPTURED = """\
[soap3dp] index loaded in 1.25s, uploaded to cuda:0 in 0.75s (250000000 bp, 24 sequences)
[soap3dp] batch: 65536 pairs, 60000 BWT-paired (2.10s)
[timers] BC.half_rescue                      1.632s (cpu   1.500s) x4      30.1%
[timers] A.search                            0.500s (cpu   0.400s) x4       9.2%
[timers] A2.fetch                            0.250s (cpu   0.200s) x4       4.6%
[timers] io.sam.format                       0.100s (cpu   0.090s) x8       1.8%
[timers] io.sam.fwrite                       0.050s (cpu   0.001s) x8       0.9%
[timers] dispatch.launch                     0.040s (cpu   0.030s) x4       0.7%
[timers] dp.align                            0.015s (cpu   0.010s) x6       0.3%
[timers] BC.prescan                          0.005s (cpu   0.004s) x2       0.1%
[soap3dp] done: PairSummary(num_pairs=262144, paired_bwt=250000, paired_dp=9000, single_rescued=2000, unaligned=1144, num_records=524288, still_flagged=12, capped_anchors=0)
"""


def test_parsers_on_captured_lines():
    t = parse.timers(CAPTURED)
    assert t["BC.half_rescue"] == 1.632 and t["A2.fetch"] == 0.25
    assert parse.index_seconds(CAPTURED) == (1.25, 0.75)
    s = parse.summary(CAPTURED)
    assert s["num_pairs"] == 262144 and s["still_flagged"] == 12
    jobs = [{"timers": t}, {"timers": t}]
    assert parse.stage_sum(jobs, (), ("A.", "A2.")) == pytest.approx(1.5)
    assert parse.stage_sum(jobs, ("dp.align", "BC.prescan")) == \
        pytest.approx(0.04)
    assert parse.index_seconds("nothing") is None


def test_union_gaps_and_owners():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert union_us(iv) == 30
    assert gaps(iv, 0, 50) == [(20, 30), (40, 50)]
    assert gaps([], 0, 5) == [(0, 5)]
    spans = [(15, 44, "BC.half_rescue"), (18, 32, "dp.align")]
    own = gap_owners(gaps(iv, 0, 50), spans)
    assert own == {"dp.align": 10, "host outside any stage": 10}


def test_kernel_names():
    assert kernel_of("void dp_align_kernel<4>(unsigned char const*)") == "K1"
    assert kernel_of("seed_expand_kernel(Lanes, long)") == "FS2s"
    assert kernel_of("expand_decode_kernel(Lanes, long)") == "FS2x"
    assert kernel_of("void verify_kernel_any(Reads)") == "FS3"
    assert kernel_of("dedupe_scan_kernel") == "FS4"
    assert kernel_of("Memcpy HtoD (Pageable -> Device)") is None


def test_roofline_arithmetic():
    peak = roofline.int32_peak_ops(1980.0)
    assert peak == pytest.approx(132 * 64 * 1.98e9)
    sc = (1, -2, -3, -1)
    assert roofline.forward_peak(120, sc, peak) == 2 * peak
    assert roofline.forward_peak(300, sc, peak) == peak
    cells = 8192 * 100 * 256
    b = roofline.k1_bound(8192, 120, 256, cells, 2 * peak)
    assert b == pytest.approx(cells * 17 / (2 * peak) * 1e3)
    k2 = roofline.k2_bound(2048, 120, 4224, 2048 * 100 * 4200, 2 * peak)
    assert k2 >= (120 + 4224) * 2048 * 121 / roofline.HBM_BYTES_PER_S * 1e3
    assert roofline.dw_bound(1000) == pytest.approx(16016 / 3.35e12 * 1e3)


def _traced_run():
    us = 1e6
    events = [(0, 0.0, 0.1 * us, "Memcpy HtoD"),
              (0, 0.2 * us, 0.2 * us + 100, "void dp_align_kernel<4>()"),
              (0, 0.3 * us, 0.3 * us + 50, "dp_wire_kernel"),
              (0, 0.4 * us, 0.4 * us + 20, "fm_search_kernel"),
              (0, 0.5 * us, 0.5 * us + 30, "dedupe_scatter_kernel"),
              (0, 0.6 * us, 0.6 * us + 30, "dedupe_scan_kernel")]
    return {
        "jobs": [{"timers": parse.timers(CAPTURED), "index_s": 2.0},
                 {"timers": parse.timers(CAPTURED), "index_s": 3.0}],
        "window_reads": 1_000_000, "window_s": 20.0,
        "trace": {"device_events": events, "window_us": (0.0, 1.0 * us),
                  "cards": 1, "reads": 524288, "sm_clock_mhz": 1980.0,
                  "expected_launches": {"K1": 1, "DW": 1, "FS1": 1,
                                        "FS4": 2, "K2": 0},
                  "dp_launches": [("K1", 512, 120, 256, 512 * 100 * 256,
                                   (1, -2, -3, -1)),
                                  ("DW", 512, 0, 0, None, None)]}}


def test_metric_readers_on_a_made_up_run():
    run = _traced_run()
    read = lambda n: load_reader(n)(run)  # noqa: E731
    assert read("runner.index_s") == 2.5
    assert read("pair.rescue_us_per_read") == pytest.approx(2 * 1.632)
    assert read("pair.host_us_per_read") == pytest.approx(2 * 0.75)
    assert read("io.writer_us_per_read") == pytest.approx(2 * 0.15)
    assert read("dp.call_us_per_read") == pytest.approx(2 * 0.02)
    assert read("search.dispatch_us_per_read") == pytest.approx(2 * 0.04)
    assert read("kernels.search_device_us_per_read") == \
        pytest.approx(80 / 524288)
    busy = 0.1e6 + 230
    assert read("device.idle_pct") == pytest.approx(100 * (1 - busy / 1e6))
    bound = (roofline.k1_bound(512, 120, 256, 512 * 100 * 256,
                               2 * roofline.int32_peak_ops(1980.0))
             + roofline.dw_bound(512))
    assert read("kernels.dp_roofline_pct") == pytest.approx(
        100 * bound / 0.150)


def test_readers_return_nothing_when_events_were_lost():
    run = _traced_run()
    run["trace"]["expected_launches"]["FS1"] = 2
    assert load_reader("device.idle_pct")(run) is None
    run["trace"]["dp_launches"].append(("K1", 8, 120, 256, 1, (1, -2, -3, -1)))
    assert load_reader("kernels.dp_roofline_pct")(run) is None
    del run["trace"]
    for name in ("device.idle_pct", "kernels.dp_roofline_pct",
                 "kernels.search_device_us_per_read"):
        assert load_reader(name)(run) is None
