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
bytes of reads and lengths each uploads, the timers dp.pack and
dp.align), then the largest call (by bytes written) and the most
frequent call shape of each phase replayed through that checkout's
_pack_problems: its device time and device events between marker
kernels, its peak extra device memory (max_memory_allocated over the
call, less what was allocated before it) and the device time of the
upload of that call's reads and lengths. The run saves the replayed
inputs; this process counts PK's bound on them with chip_smoke.pack_work
and pack_bound. Prints one line per run and writes them to
compare_prescan.json in chip_smoke.py's output directory. Both phases
share phase 4's cached index and seeded reads.
"""

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs
from compare_e2e import ROOT, run_in_tree

REPS = 5  # replayed calls a timing

RUN = """
import collections, re
from torch.profiler import ProfilerActivity, profile
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.index.builder import load_index
from soap3dp_tpu_torch.pipeline import dp_rescue
from soap3dp_tpu_torch.utils import shapes, timers

timers.ENABLED = True
CHUNK = dp_rescue._PRESCAN_CHUNK
phase_of = [None]
calls = collections.defaultdict(list)
largest = {{}}
impl = collections.Counter()
orig_gp, orig_impl = dp_rescue.gapless_prescan, dp_rescue._prescan_impl
orig_plain = getattr(dp_rescue, "_prescan_plain", None)
orig_pack = dp_rescue._pack_problems
packs = collections.defaultdict(list)  # phase: [(P, Lr, max_win, bytes up)]
first_pack = {{}}  # (phase, P, Lr, max_win): the first such call's inputs


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


def counted_impl(*a):
    impl[phase_of[0], "calls"] += 1
    return orig_impl(*a)


def counted_plain(*a):
    impl[phase_of[0], "plain_on_card"] += a[1].is_cuda
    return orig_plain(*a)


def pack(idx, reads, lens, cread, strand_rev, win_start, un, max_win):
    key = (phase_of[0], cread.shape[0], reads.shape[1], max_win)
    packs[key[0]].append(key[1:] + (
        reads.numel() * reads.element_size()
        + lens.numel() * lens.element_size(),))
    first_pack.setdefault(key, (reads, lens, cread, strand_rev, win_start,
                                un, max_win))
    return orig_pack(idx, reads, lens, cread, strand_rev, win_start, un,
                     max_win)


dp_rescue.gapless_prescan = gp
dp_rescue._pack_problems = pack
dp_rescue._prescan_impl = counted_impl
if orig_plain is not None:
    dp_rescue._prescan_plain = counted_plain
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
                "upload_bytes": sum(up)}}
dp_rescue.gapless_prescan, dp_rescue._prescan_impl = orig_gp, orig_impl
dp_rescue._pack_problems = orig_pack
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
    a = [didx] + [fmindex.to_device(case[k], dev) for k in (
        "reads", "lens_rows", "read_idx", "strand", "ws", "rlens",
        "wlens")] + [O, W]
    npz = os.path.join({work!r}, f"prescan_{{os.getpid()}}_{{key}}.npz")
    np.savez(npz, **case)
    out[key]["replay"] = {{"M": M, "M_call": Mall, "O": O, "W": W, "Lr": L,
                          "case": npz, **device_items(
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
        a = first_pack[(key,) + shp]
        reads, lens = a[0], a[1]
        P, L, max_win = shp
        host = [reads.cpu().numpy(), lens.cpu().numpy()]
        npz = os.path.join({work!r},
                           f"pack_{{os.getpid()}}_{{key}}_{{what}}.npz")
        np.savez(npz, reads=host[0], lens=host[1],
                 cread=a[2].cpu().numpy(), strand=a[3].cpu().numpy(),
                 win_start=a[4].cpu().numpy(), un=a[5], max_win=max_win,
                 n_pac=didx.pac.shape[0])
        row = {{"what": what, "P": P, "Lr": L, "max_win": max_win,
               "calls_of_shape": shapes_n[shp], "case": npz,
               "output_bytes": P * (L + max_win),
               **device_items(lambda: dp_rescue._pack_problems(didx, *a),
                              {reps}),
               "peak_extra_bytes": peak_extra(
                   lambda: dp_rescue._pack_problems(didx, *a))}}
        upl = device_items(lambda: [fmindex.to_device(h, dev) for h in host],
                           {reps})
        row["upload"] = {{"bytes": sum(h.nbytes for h in host),
                         "rows": host[0].shape[0], **upl}}
        out[key]["pack_replay"].append(row)
print("RESULT " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="*", default=[ROOT])
    args = ap.parse_args(argv)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    os.makedirs(work, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    peak = cs.int32_peak_ops()
    runs, first = [], {}
    for tree in args.trees:
        run = {"tree": tree, **run_in_tree(
            tree, RUN, work=work, reps=REPS, bp=cs.E2E_GENOME_BP,
            pairs=cs.E2E_PAIRS)}
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
        print(json.dumps(run), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "compare_prescan.json"), "w") as fh:
        json.dump({"card": card, "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
