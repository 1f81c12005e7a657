"""Measure the DP rescue's gapless prescan (dp_rescue._prescan_impl) on
one CUDA card, in one or more checkouts of the repo, in the order given.

    python3 compare_prescan.py [TREE ...]      # default: this checkout

For example PARENT CHANGE CHANGE PARENT. Each run is a fresh process in
one checkout (compare_e2e.run_in_tree) that builds its kernels and runs
that checkout's chip_smoke.py phases 4 (PE default: E2E_GENOME_BP,
E2E_PAIRS, -u 500 -v 300) and 5 (the mate-pair library over the whole
insert window) with the stage timers on (SOAP3DP_TIMERS=1). It records
every gapless_prescan call of each phase: the histogram of its (M, O),
the _prescan_impl calls and how many of them ran the plain version on
the card, and the timers BC.prescan and BC.half_rescue. Then it replays
the first chunk (at most _PRESCAN_CHUNK candidates, as gapless_prescan
cuts it) of each phase's largest call through that checkout's
_prescan_impl under torch.profiler: the device time of a call (the sum
of its device events, read between marker kernels), its device events
(launches and copies) and its span. The run saves the replayed inputs;
this process counts GP's bound on them with chip_smoke.prescan_work and
prescan_bound, so every checkout is held to the same one
(chip_smoke.py times the grouped conv1d yardstick).

It measures the DP rescue's problem pack (dp_rescue._pack_problems, which
run_banded_dp calls before every dp_align) the same way: each phase's
pack calls (a histogram of their problems x read width x max_win, the
bytes of reads and words each uploads, the timers dp.pack and
dp.align), then the largest call (by bytes written) and the most
frequent call shape of each phase replayed through that checkout's
_pack_problems: its device time and device events between marker
kernels, its peak extra device memory (max_memory_allocated over the
call, less what was allocated before it), the device time of the
upload of that call's reads and words, and whether it equals the
plain version (the prescan's largest call too). The run saves the
replayed inputs; this process counts PK's bound on them with
chip_smoke.pack_work and pack_bound.

It also ranks the kernels a redesign chooses among: each run keeps the
first call of each phase-4 launch shape of FS2x (fmindex.expand_decode),
FS2s (fmindex.seed_expand_decode), FS4 (fmindex.dedupe), GP
(dp_rescue._prescan_impl) and PK (dp_rescue._pack_problems), and of
each phase-5 launch shape of GP and PK, replays it REPS times through
that checkout's entry and times it with this checkout's
chip_smoke._call_span_ms (so every tree is timed by the same code): the
call's device span, its first kernel's start to its last one's end (FS4
launches several a call), and its kernels' device time summed; and
holds its output to the plain version's. PK is also replayed at max_win
0 (its read units alone: reads_only_span_ms). FS2x and FS2s are also
replayed on the genome's index at sa_rate 1 (the same SA rows, no walk:
each slot reads its SA value), so their span there is the lane search's
and the outputs' time without the walk. This process counts each
shape's bound once on the first run's inputs (chip_smoke.fs_work,
prescan_work, pack_work) and ranks the kernels by launches x (span -
bound) over the run's phase-4 launch-shape histogram
(chip_smoke.rank_by_loss). Every run also replays FS4 on the same keys:
the first run saves its phase-4 FS4 call of the largest K (round 1,
K2 < K) and each run times its own fmindex.dedupe on those keys
(SAME_KEY_REPS calls) and says whether its own call's keys equal them,
so a change in FS4's replayed time is split into the kernel's and the
keys'. The same for FS5: the first run saves its phase-4 calls of the
most lanes in the search's mode (round 1) and in the seeding's (the
largest seeding call), and each run times its own lane counts on those
counts (SAME_KEY_REPS calls, warm and with the L2 evicted before each
call, fs5_same_counts). FS1, FS3 and FS5 are replayed with the other phase-4
launch shapes (FS1's and FS3's bounds: chip_smoke.py's phase 2; FS5's
counted from its shape, 24 bytes a lane). Prints one line per run and
writes them to compare_prescan.json in chip_smoke.py's output
directory; exits non-zero after that if a replayed call (or the largest calls above) disagrees
with its plain version. Both phases share phase 4's cached index and
seeded reads. The rescue queue's flushes follow the host's timing, so
a run's pack shapes may differ from another's. GP's and PK's calls are
kept and replayed in their word-block form (the reads, then one block
of words a call, dp_rescue.rescue_words); a checkout whose GP and PK
take separate vectors cannot run this version (compare_rescue.py holds
that form against this one).
"""

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs
from compare_e2e import ROOT, run_in_tree

REPS = 5  # replayed calls a timing
SAME_KEY_REPS = 30  # FS4's calls on the first run's keys

RUN = """
import collections, dataclasses, importlib.util, re
from torch.profiler import ProfilerActivity, profile
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.index.builder import load_index
from soap3dp_tpu_torch.pipeline import dp_rescue
from soap3dp_tpu_torch.utils import shapes, timers

# the calling checkout's chip_smoke.py times every tree's replays
spec = importlib.util.spec_from_file_location("smoke_timing", {timing!r})
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
timers.ENABLED = True
CHUNK = dp_rescue._PRESCAN_CHUNK
phase_of = [None]
calls = collections.defaultdict(list)
largest = {{}}
impl = collections.Counter()
orig_gp, orig_impl = dp_rescue.gapless_prescan, dp_rescue._prescan_impl
orig_plain = getattr(dp_rescue, "_prescan_plain", None)
orig_pack = dp_rescue._pack_problems
orig_fs = {{"FS2x": fmindex.expand_decode, "FS2s": fmindex.seed_expand_decode,
           "FS4": fmindex.dedupe, "FS1": fmindex.seed_intervals,
           "FS3": fmindex.count_mismatches_rows, "FS5": fmindex.lane_counts}}
packs = collections.defaultdict(list)  # phase: [(P, Lr, max_win, bytes up)]
seen = collections.Counter()  # (phase, kernel, launch shape): calls
first = {{}}  # (phase, kernel, launch shape): the first call's inputs


def keep(kernel, shape, args):
    key = (phase_of[0], kernel, "x".join(map(str, shape)))
    seen[key] += 1
    if key not in first:
        first[key] = tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args)


def expand(idx, l, *a):
    keep("FS2x", (a[-1], l.shape[0], idx.sa_rate), (l,) + a)
    return orig_fs["FS2x"](idx, l, *a)


def seed_expand(idx, l, *a):
    keep("FS2s", (a[-1], l.shape[0], idx.sa_rate), (l,) + a)
    return orig_fs["FS2s"](idx, l, *a)


def search1(idx, ori, S, *a):
    keep("FS1", (2 * ori.B * S, ori.L, a[-2], a[-1]), (ori, S) + a)
    return orig_fs["FS1"](idx, ori, S, *a)


def verify3(idx, tp, ori, *a):
    keep("FS3", (tp.shape[0], (ori.L + 15) // 16), (tp, ori) + a)
    return orig_fs["FS3"](idx, tp, ori, *a)


def counts5(l, r, cap, S, *a):
    keep("FS5", (l.shape[0], S, int(bool(a))), (l, r, cap, S) + a)
    return orig_fs["FS5"](l, r, cap, S, *a)


def dedupe(krow, ktp, pos_ok, K2):
    K = krow.shape[0]
    keep("FS4", (K, K2, max((K - 1).bit_length() + 1, 10)),
         (krow, ktp, pos_ok, K2))
    return orig_fs["FS4"](krow, ktp, pos_ok, K2)


def gp(idx, reads, lens, cand, win_start, win_len, max_win):
    M, L = cand.read.shape[0], reads.shape[1]
    O = shapes.bucket_multiple(max_win, 128)
    key = phase_of[0]
    calls[key].append((M, O))
    if M and (key not in largest or M * O > largest[key][0]):
        largest[key] = (M * O, [np.array(x) for x in (
            reads, lens, cand.read, cand.strand, win_start, win_len)]
            + [max_win])
    return orig_gp(idx, reads, lens, cand, win_start, win_len, max_win)


def counted_impl(idx, reads_p, words, O, W):
    impl[phase_of[0], "calls"] += 1
    keep("GP", (words.shape[0], O, reads_p.shape[1]), (reads_p, words, O, W))
    return orig_impl(idx, reads_p, words, O, W)


def counted_plain(*a):
    impl[phase_of[0], "plain_on_card"] += a[1].is_cuda
    return orig_plain(*a)


def pack(idx, reads, words, max_win):
    key = (phase_of[0], words.shape[0], reads.shape[1], max_win)
    packs[key[0]].append(key[1:] + (
        reads.numel() * reads.element_size()
        + words.numel() * words.element_size(),))
    keep("PK", key[1:], (reads, words, max_win))
    return orig_pack(idx, reads, words, max_win)


dp_rescue.gapless_prescan = gp
dp_rescue._pack_problems = pack
fmindex.expand_decode, fmindex.seed_expand_decode = expand, seed_expand
fmindex.dedupe = dedupe
fmindex.seed_intervals, fmindex.count_mismatches_rows = search1, verify3
fmindex.lane_counts = counts5
dp_rescue._prescan_impl = counted_impl
if orig_plain is not None:
    dp_rescue._prescan_plain = counted_plain
SYMBOL = {{"FS2x": "expand_decode_kernel", "FS2s": "seed_expand_kernel",
          "FS4": "dedupe_", "GP": "prescan_kernel", "PK": "pack_kernel",
          "FS1": "fm_search_kernel", "FS3": "verify_kernel",
          "FS5": "lane_counts_kernel"}}
out = {{"card": cs.card_line()}}
for key, mate in (("phase4", False), ("phase5", True)):
    phase_of[0] = key
    res, _ = cs.phase_e2e(dev, {bp}, {pairs}, out["card"], {work!r},
                          cs.OUT_DIR, profile=False, mate_pair=mate)
    log = open(os.path.join(cs.OUT_DIR, ("mp_" if mate else "")
                            + "e2e_stderr.log")).read()
    stage = {{m.group(1): float(m.group(2)) for m in re.finditer(
        r"\\[timers\\] (\\S+)\\s+([0-9.]+)s", log)}}
    stage_n = {{m.group(1): int(m.group(2)) for m in re.finditer(
        r"\\[timers\\] (\\S+)\\s+[0-9.]+s \\(cpu +[0-9.]+s\\) x(\\d+)",
        log)}}
    up = [b for *_, b in packs[key]]
    out[key] = {{"reads_per_s": res["reads_per_s"], "recall": res["recall"],
                "launches": res["launches"],
                "BC.prescan_s": stage.get("BC.prescan"),
                "BC.half_rescue_s": stage.get("BC.half_rescue"),
                "prescan_calls": len(calls[key]),
                "impl_calls": impl[key, "calls"],
                "plain_on_card": impl[key, "plain_on_card"],
                "M_O_histogram": {{f"{{m}}x{{o}}": n for (m, o), n in sorted(
                    collections.Counter(calls[key]).items())}},
                "dp.pack_s": stage.get("dp.pack"),
                "dp.pack_n": stage_n.get("dp.pack"),
                "dp.align_s": stage.get("dp.align"),
                "dp.align_n": stage_n.get("dp.align"),
                "pack_calls": len(packs[key]),
                "pack_histogram": {{f"{{p}}x{{l}}x{{w}}": n for (p, l, w), n in
                                   sorted(collections.Counter(
                                       x[:3] for x in packs[key]).items())}},
                "upload_bytes_per_call": up,
                "upload_bytes": sum(up),
                "launch_shapes": {{k: res["launch_shapes"].get(k, {{}})
                                  for k in SYMBOL}}}}
dp_rescue.gapless_prescan, dp_rescue._prescan_impl = orig_gp, orig_impl
dp_rescue._pack_problems = orig_pack
fmindex.expand_decode = orig_fs["FS2x"]
fmindex.seed_expand_decode = orig_fs["FS2s"]
fmindex.dedupe = orig_fs["FS4"]
fmindex.seed_intervals = orig_fs["FS1"]
fmindex.count_mismatches_rows = orig_fs["FS3"]
fmindex.lane_counts = orig_fs["FS5"]
if orig_plain is not None:
    dp_rescue._prescan_plain = orig_plain

_, _, path, _, _, _ = cs._genome_index({bp}, {work!r})
didx = fmindex.device_index(load_index(path), dev)


def device_items(fn, reps):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    spans = cs._device_spans(prof)
    marks = [(a, b) for a, b, n in spans if "spin_kernel" in n]
    per = []
    for (_, b0), (a1, _) in zip(marks, marks[1:]):
        ev = [(a, b) for a, b, n in spans
              if b0 <= a < a1 and "spin_kernel" not in n]
        if ev:
            per.append((sum(b - a for a, b in ev) / 1e3, len(ev),
                        (ev[-1][1] - ev[0][0]) / 1e3))
    if not per:
        return {{"device_ms": None, "events": None, "span_ms": None}}
    per = per[len(per) // 2:]  # a profile may lose its first milliseconds
    return {{"device_ms": float(np.median([p[0] for p in per])),
            "events": int(np.median([p[1] for p in per])),
            "span_ms": float(np.median([p[2] for p in per]))}}


def same(a, b):
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(x, y) for x, y in zip(a, b))


for key in ("phase4", "phase5"):
    if key not in largest:
        continue
    reads, lens, read, strand, ws, wl, max_win = largest[key][1]
    Mall, (B, L) = read.shape[0], reads.shape
    O = shapes.bucket_multiple(max_win, 128)
    W = O + ((L + 127) // 128) * 128
    lens_rows = np.zeros(B, np.int32)
    lens_rows[read] = np.asarray(lens, np.int32)[:Mall]
    M = min(Mall, CHUNK)
    case = {{"reads": reads, "lens_rows": lens_rows,
             "read_idx": read[:M].astype(np.int64),
             "strand": strand[:M].astype(np.int8),
             "ws": ws[:M].astype(np.int64),
             "rlens": np.asarray(lens[:M], np.int32),
             "wlens": np.asarray(wl[:M], np.int32), "O": O, "W": W}}
    a = cs.prescan_args(case, didx, dev)
    npz = os.path.join({work!r}, f"prescan_{{os.getpid()}}_{{key}}.npz")
    np.savez(npz, **case)
    out[key]["replay"] = {{"M": M, "M_call": Mall, "O": O, "W": W, "Lr": L,
                          "case": npz, "equal": same(
                              dp_rescue._prescan_impl(*a),
                              dp_rescue._prescan_plain(*a)), **device_items(
                              lambda: dp_rescue._prescan_impl(*a), {reps})}}


def peak_extra(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    m0 = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) - m0


for key in ("phase4", "phase5"):
    shapes_n = collections.Counter(x[:3] for x in packs[key])
    if not shapes_n:
        continue
    largest_shape = max(shapes_n, key=lambda s: s[0] * (s[1] + s[2]))
    frequent = max(shapes_n, key=lambda s: (shapes_n[s], s[0] * s[2]))
    out[key]["pack_replay"] = []
    for what, shp in (("largest", largest_shape), ("most_frequent", frequent)):
        if what == "most_frequent" and shp == largest_shape:
            out[key]["pack_replay"][0]["what"] += " and most_frequent"
            continue
        a = first[key, "PK", "x".join(map(str, shp))]
        P, L, max_win = shp
        host = [a[0].cpu().numpy(), a[1].cpu().numpy()]
        npz = os.path.join({work!r},
                           f"pack_{{os.getpid()}}_{{key}}_{{what}}.npz")
        np.savez(npz, **cs.rescue_case("PK", *host, didx.pac.shape[0],
                                       max_win))
        row = {{"what": what, "P": P, "Lr": L, "max_win": max_win,
               "calls_of_shape": shapes_n[shp], "case": npz,
               "output_bytes": P * (L + max_win),
               "equal": same(dp_rescue._pack_problems(didx, *a),
                             dp_rescue._pack_problems_plain(didx, *a)),
               **device_items(lambda: dp_rescue._pack_problems(didx, *a),
                              {reps}),
               "peak_extra_bytes": peak_extra(
                   lambda: dp_rescue._pack_problems(didx, *a))}}
        upl = device_items(lambda: [fmindex.to_device(h, dev) for h in host],
                           {reps})
        row["upload"] = {{"bytes": sum(h.nbytes for h in host),
                         "rows": host[0].shape[0], **upl}}
        out[key]["pack_replay"].append(row)

CALL = {{"FS2x": lambda a: fmindex.expand_decode(didx, *a),
        "FS2s": lambda a: fmindex.seed_expand_decode(didx, *a),
        "FS4": lambda a: fmindex.dedupe(*a),
        "GP": lambda a: dp_rescue._prescan_impl(didx, *a),
        "PK": lambda a: dp_rescue._pack_problems(didx, *a),
        "FS1": lambda a: fmindex.seed_intervals(didx, *a),
        "FS3": lambda a: fmindex.count_mismatches_rows(didx, *a),
        "FS5": lambda a: fmindex.lane_counts(*a)}}
PLAIN = {{"FS2x": lambda a: fmindex.expand_decode_plain(didx, *a),
         "FS2s": lambda a: fmindex.seed_expand_plain(didx, *a),
         "FS4": lambda a: fmindex.dedupe_plain(*a),
         "GP": lambda a: dp_rescue._prescan_plain(didx, *a),
         "PK": lambda a: dp_rescue._pack_problems_plain(didx, *a),
         "FS1": lambda a: fmindex.seed_intervals_plain(didx, *a),
         "FS3": lambda a: fmindex.count_mismatches_rows_plain(didx, *a),
         "FS5": lambda a: fmindex.lane_counts_plain(*a)}}
# the replays whose inputs are saved for this process's bounds (FS1's and
# FS3's hold the reads' rows, FS5's bound is counted from its shape)
SAVED = ("FS2x", "FS2s", "FS4", "GP", "PK")


def host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def saved(args):  # the arrays of a call's inputs; a SeedLanes' fields
    out = {{}}         # as a<i>_<field>
    for i, a in enumerate(args):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                v = getattr(a, f.name)
                if v is not None:
                    out[f"a{{i}}_{{f.name}}"] = host(v)
        else:
            out[f"a{{i}}"] = host(a)
    return out


out["replays"] = []
for (ph, kernel, shape), args in sorted(first.items()):
    if ph != "phase4" and kernel not in ("GP", "PK"):
        continue
    fn = CALL[kernel]
    span, events = timing._call_span_ms(lambda: fn(args), {reps},
                                        SYMBOL[kernel])
    npz = None
    if kernel in SAVED:
        npz = os.path.join(
            {work!r}, f"replay_{{os.getpid()}}_{{len(out['replays'])}}.npz")
        np.savez(npz, **saved(args))
    fresh = (lambda a: timing.fresh_args("lane_counts", a)) \
        if kernel == "FS5" else (lambda a: a)
    row = {{"phase": ph, "kernel": kernel, "shape": shape,
           "launches": seen[ph, kernel, shape],
           "equal": same(fn(fresh(args)), PLAIN[kernel](fresh(args))),
           "span_ms": span, "events_ms": events, "case": npz}}
    if kernel == "PK":  # its read units alone: the same call at max_win 0
        rd = args[:-1] + (0,)
        row["reads_only_span_ms"] = timing._call_span_ms(
            lambda: fn(rd), {reps}, SYMBOL[kernel])[0]
        row["reads_only_equal"] = same(fn(rd), PLAIN[kernel](rd))
    out["replays"].append(row)
    torch.cuda.empty_cache()

# FS2x and FS2s on the same lanes with no walk: the genome's index at
# sa_rate 1 (the same BWT, so the same SA rows; each slot reads its SA
# value), built once by this checkout's chip_smoke
_, _, path1, _, _, _ = timing._genome_index({bp}, {work!r}, sa_rate=1)
didx1 = fmindex.device_index(load_index(path1), dev)
ENTRY = {{"FS2x": (fmindex.expand_decode, fmindex.expand_decode_plain),
         "FS2s": (fmindex.seed_expand_decode, fmindex.seed_expand_plain)}}
for row in out["replays"]:
    if row["kernel"] not in ENTRY:
        continue
    kern, plain = ENTRY[row["kernel"]]
    args = first["phase4", row["kernel"], row["shape"]]
    row["sa1_span_ms"] = timing._call_span_ms(
        lambda: kern(didx1, *args), {reps}, SYMBOL[row["kernel"]])[0]
    row["sa1_equal"] = same(kern(didx1, *args), plain(didx1, *args))

# FS4 on the first run's keys: its phase-4 call of the largest K
fs4 = max((k for k in first if k[:2] == ("phase4", "FS4")),
          key=lambda k: first[k][0].shape[0])
own = first[fs4]
if not os.path.exists({keys!r}):
    np.savez({keys!r}, **{{f"a{{i}}": host(a) for i, a in enumerate(own)}})
with np.load({keys!r}) as z:
    keys = tuple(torch.from_numpy(z[f"a{{i}}"]).to(dev) for i in range(3))
    keys += (int(z["a3"]),)
span, events = timing._call_span_ms(lambda: fmindex.dedupe(*keys),
                                    {same_reps}, SYMBOL["FS4"])
out["fs4_same_keys"] = {{
    "shape": "x".join(map(str, (keys[0].shape[0], keys[3]))),
    "span_ms": span, "events_ms": events,
    "equal": same(fmindex.dedupe(*keys), fmindex.dedupe_plain(*keys)),
    "own_keys_equal": all(np.array_equal(host(a), host(b))
                          for a, b in zip(own, keys))}}

# FS5 on the first run's counts: phase 4's round-1 search call (the most
# lanes with flagged words) and its largest seeding call (the most lanes
# without), warm and with the L2 evicted before each call
from soap3dp_tpu_torch.kernels import fm_search as fsk
fs5 = [k for k in first if k[:2] == ("phase4", "FS5")]
out["fs5_same_counts"] = {{}}
for mode, search in (("search", 1), ("seed", 0)):
    mine = [k for k in fs5 if int(k[2].split("x")[2]) == search]
    if not mine:
        continue
    k = max(mine, key=lambda k: int(k[2].split("x")[0]))
    npz = os.path.join({work!r}, f"fs5_counts_{{mode}}.npz")
    if not os.path.exists(npz):
        a = first[k]
        np.savez(npz, l=host(a[0]), r=host(a[1]), cap=a[2], S=a[3])
    with np.load(npz) as z:
        l, r = (torch.from_numpy(z[x]).to(dev) for x in ("l", "r"))
        cap, S = int(z["cap"]), int(z["S"])
    nf = -(-(l.shape[0] // (2 * S)) // 32)

    def call():
        flags = (torch.empty(nf, dtype=torch.int32, device=dev),) \
            if search else ()
        return fsk.lane_counts(l, r, cap, S, *flags)

    want = fmindex.lane_counts_plain(
        l, r, cap, S, *((torch.zeros(nf, dtype=torch.int32,
                                     device=dev),) if search else ()))
    res = {{"lanes": l.shape[0], "S": S, "cap": cap,
           "warm_ms": timing._kernel_device_ms(call, {same_reps},
                                               SYMBOL["FS5"]),
           "cold_ms": timing._cold_device_ms(call, {same_reps},
                                             SYMBOL["FS5"], dev),
           "equal": same(call(), want)}}
    res["own_counts_equal"] = all(np.array_equal(host(x), y) for x, y in
                                  zip(first[k][:2], (host(l), host(r))))
    out["fs5_same_counts"][mode] = res
print("RESULT " + json.dumps(out), flush=True)
"""


def saved_args(z) -> list:
    """A replayed call's saved inputs in order: arrays, and a SeedLanes'
    fields (a<i>_<field>) as a dict."""
    out = {}
    for key in z.files:
        i, _, field = key[1:].partition("_")
        if field:
            out.setdefault(int(i), {})[field] = z[key]
        else:
            out[int(i)] = z[key]
    return [out[i] for i in sorted(out)]


def replay_work(kernel: str, args: list, didx, dev, peak: float) -> dict:
    """The bound (ms, what bounds it) and the work counted for it of a
    replayed call of ``kernel`` from its saved inputs ``args`` (numpy
    arrays, in the entry's order after the index), by chip_smoke's
    functions."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    def tensor(a):
        return torch.from_numpy(a).to(dev) if a.ndim else int(a)

    if kernel == "FS5":
        RS, S, search = args
        nf = -(-(RS // (2 * S)) // 32) if search else 0
        bms, by = cs.bound_ms(RS * cs.OPS_COUNT_LANE, 24 * RS + 8 + 4 * nf,
                              peak)
        return {"bound_ms": bms, "bound_by": by, "lanes": RS}
    if kernel in ("FS2x", "FS2s", "FS4"):
        t = [fmindex.SeedLanes(**{k: tensor(v) for k, v in a.items()})
             if isinstance(a, dict) else tensor(a) for a in args]
        # a parent's seeds as arrays: each lane's start (FS2x: and each
        # row's read length)
        if kernel == "FS2x" and len(t) == 6:
            t = t[:2] + [fmindex.SeedLanes.given(t[2], lens=t[3])] + t[4:]
        if kernel == "FS2s" and torch.is_tensor(t[2]):
            t[2] = fmindex.SeedLanes.given(t[2])
        fn = {"FS2x": "expand_decode", "FS2s": "seed_expand_decode",
              "FS4": "dedupe"}[kernel]
        a = tuple(t) if kernel == "FS4" else (didx, *t)
        work = cs.fs_work(fn, a, getattr(fmindex, cs.plain_of(fn))(*a))
        bms, by = cs.bound_ms(work["ops"], work["bytes"], peak)
        return {"bound_ms": bms, "bound_by": by,
                **{k: v for k, v in work.items() if k not in (
                    "sectors", "block_sectors")}}
    # GP's (reads, words, O, W), PK's (reads, words, max_win)
    c = cs.rescue_case(kernel, args[0], args[1], didx.pac.shape[0],
                       *args[2:])
    if kernel == "GP":
        need = cs.prescan_work(c)
        bms, by = cs.prescan_bound(need, peak)
    else:
        need = cs.pack_work(c)
        bms, by = cs.pack_bound(need)
    return {"bound_ms": bms, "bound_by": by, **need}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="*", default=[ROOT])
    args = ap.parse_args(argv)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    os.makedirs(work, exist_ok=True)
    keys = os.path.join(work, "fs4_keys.npz")
    for name in (keys, os.path.join(work, "fs5_counts_search.npz"),
                 os.path.join(work, "fs5_counts_seed.npz")):
        if os.path.exists(name):     # the first run of this call saves them
            os.remove(name)
    card = cs.card_line()
    print(card, flush=True)
    peak = cs.int32_peak_ops()
    runs, first = [], {}
    for tree in args.trees:
        run = {"tree": tree, **run_in_tree(
            tree, RUN, work=work, reps=REPS, bp=cs.E2E_GENOME_BP,
            pairs=cs.E2E_PAIRS, timing=os.path.abspath(cs.__file__),
            keys=keys, same_reps=SAME_KEY_REPS)}
        for key in ("phase4", "phase5"):
            for row in run[key].get("pack_replay", []):
                with np.load(row.pop("case")) as z:
                    c = {k: z[k] for k in z.files}
                need = cs.pack_work(c)
                row["bound_ms"], row["bound_by"] = cs.pack_bound(need)
                row.update(need)
            row = run[key].get("replay")
            if row is None:
                continue
            with np.load(row.pop("case")) as z:
                c = {k: z[k] for k in z.files}
            c["O"], c["W"] = int(c["O"]), int(c["W"])
            first.setdefault(key, c)
            need = cs.prescan_work(c)
            row["bound_ms"], row["bound_by"] = cs.prescan_bound(need, peak)
            row.update(need, same_case_as_first=all(
                np.array_equal(c[k], first[key][k]) for k in c))
        runs.append(run)
    # each replayed shape's bound, counted once on the first run's inputs
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.index.builder import load_index

    dev = torch.device("cuda", 0)
    _, _, path, _, _, _ = cs._genome_index(cs.E2E_GENOME_BP, work)
    didx = fmindex.device_index(load_index(path), dev)
    bounds = {}
    for run in runs:
        timed = {}
        for row in run["replays"]:
            key = (row["phase"], row["kernel"], row["shape"])
            case = row.pop("case")
            if case is not None:
                with np.load(case) as z:
                    a = saved_args(z)
            elif row["kernel"] == "FS5":
                a = [int(x) for x in row["shape"].split("x")]
            else:   # FS1, FS3: bounds in chip_smoke.py's phase 2
                continue
            if key not in bounds:
                bounds[key] = replay_work(row["kernel"], a, didx, dev, peak)
            row.update(bounds[key])
            if row["phase"] == "phase4":
                timed.setdefault(row["kernel"], {})[row["shape"]] = (
                    row["span_ms"], row["bound_ms"])
        run["ranking"] = cs.rank_by_loss(run["phase4"]["launch_shapes"],
                                         timed)
        print(json.dumps(run), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "compare_prescan.json"), "w") as fh:
        json.dump({"card": card, "runs": runs}, fh, indent=1)
    bad = [(r["tree"], x["kernel"], x["shape"]) for r in runs
           for x in r["replays"]
           if not (x["equal"] and x.get("sa1_equal", True)
                   and x.get("reads_only_equal", True))]
    bad += [(r["tree"], "FS4 same keys") for r in runs
            if not r["fs4_same_keys"]["equal"]]
    bad += [(r["tree"], "FS5 same counts", mode) for r in runs
            for mode, res in r.get("fs5_same_counts", {}).items()
            if not res["equal"]]
    bad += [(r["tree"], key, x.get("what", "GP")) for r in runs
            for key in ("phase4", "phase5")
            for x in r[key].get("pack_replay", []) + [r[key].get("replay")]
            if x is not None and not x["equal"]]
    if bad:
        sys.exit(f"a replayed call disagrees with its plain version: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
