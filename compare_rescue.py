"""Compare the DP rescue's gapless prescan call (GP's) and its problem
pack (PK's) between checkouts of the repo on one CUDA card, in the
order given.

    python3 compare_rescue.py [--e2e] PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Four calls, each through the entry a user's run reaches, on inputs made
once by this checkout (chip_smoke.prescan_path_case on a seeded genome
of chip_smoke.E2E_GENOME_BP bases: reads of 100 bases in 120-wide rows,
one row a candidate, as pipeline/pair.py makes the half rescue's):

* ``prescan4`` / ``prescan5``: dp_rescue.gapless_prescan as
  pipeline/pair.py calls it, at phase 4's largest call (8,532 x O 384 x
  Lr 120) and phase 5's (8,655 x O 4,224 x Lr 120);
* ``pack4`` / ``pack5``: run_banded_dp's ``dp.pack`` stage at phase 4's
  largest pack (16,384 x 120 x 256: 8,532 problems padded) and phase 5's
  (16,384 x 120 x 4,224), run_banded_dp called as pair.py calls it with
  its dp_align_shards replaced by one that keeps the shards it is given
  and returns no survivor, so the call is the pack stage alone.

The index is the genome's packed words on the card in a DeviceIndex
whose other tables are placeholders (GP and PK read pac alone). Each
checkout runs in a fresh process (compare_e2e.run_in_tree) that builds
its kernels and, for each call: checks its output against the first
checkout's (gapless_prescan's three arrays; the pack's oriented reads,
windows and problem rows); times the call on the host clock (REPS
calls, each ending with the card idle); counts, in one call, the host
syncs and device-to-host bytes as compare_dp.py counts them and the
uploads (dp_rescue.to_device or stage_to_device calls and their
bytes); splits one call's wall into staging and upload (time inside
them), the kernel's launch (time inside fm_search.prescan /
pack_problems), the wait for the call's own work and the download (a
stream synchronize before the .cpu() of the result, then the .cpu()),
the rest being host glue; and profiles one call between two marker
kernels: its device items by name, the library launches among them
(neither GP, PK, a marker nor a copy) and its host-to-device copies.

With ``--e2e`` each checkout also runs chip_smoke.py's phase 4 (the PE
cell: chip_smoke.E2E_GENOME_BP, E2E_PAIRS, default options; its index
built once and cached) with the same split on every gapless_prescan and
run_banded_dp call, and one part more for the prescan: the wait for
work queued on the stream before the call began (an event recorded on
entry, synchronized before the download), which is another stage's
work and not the call's. Prints one line a run and writes
compare_rescue.json in chip_smoke.py's output directory; exits non-zero
if a checkout's output differs from the first's.
"""

import argparse
import json
import os

import numpy as np

import chip_smoke as cs
from compare_dp import COUNTING
from compare_e2e import ROOT, run_in_tree

REPS = 10
# (candidates, max_win) of the prescan calls; (problems before the
# padding, max_win) of the pack calls
CALLS = {"prescan4": (8532, 300), "prescan5": (8655, 4100),
         "pack4": (8532, 256), "pack5": (8655, 4224)}
SYMBOLS = ("prescan_kernel", "pack_kernel")

# the split of a call's wall; with --e2e the same on the run's calls
SPLIT = r'''
import collections, threading, time
from soap3dp_tpu_torch.kernels import fm_search as fsk
from soap3dp_tpu_torch.pipeline import dp_rescue

split = collections.defaultdict(float)
# the measured call's kind, its entry event and its thread (other
# threads' uploads and downloads, the run's flushes, are not the call's)
where = [None, None, None]


def active():
    return where[0] if where[2] == threading.get_ident() else None


def _timed_into(part, fn):
    def inner(*a, **kw):
        kind = active()
        if kind is None:
            return fn(*a, **kw)
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            split[kind, part] += time.perf_counter() - t0
    return inner


# a checkout's uploads: to_device (an array a copy) and stage_to_device
# (several arrays in one copy), whichever dp_rescue calls
orig_up = {name: getattr(dp_rescue, name)
           for name in ("to_device", "stage_to_device")
           if hasattr(dp_rescue, name)}


def counted_upload(name):
    fn = orig_up[name]

    def inner(a, device):
        kind = active()
        if kind is not None:
            split[kind, "uploads"] += 1
            split[kind, "upload_bytes"] += sum(
                np.asarray(x).nbytes
                for x in (a if name == "stage_to_device" else [a]))
        return fn(a, device)
    return inner


orig_cpu_split = torch.Tensor.cpu


def split_cpu(t, *a, **kw):
    kind = active()
    if kind is None or not t.is_cuda:
        return orig_cpu_split(t, *a, **kw)
    t0 = time.perf_counter()
    if where[1] is not None:
        where[1].synchronize()
    t1 = time.perf_counter()
    torch.cuda.current_stream(t.device).synchronize()
    t2 = time.perf_counter()
    out = orig_cpu_split(t, *a, **kw)
    t3 = time.perf_counter()
    split[kind, "wait_before_call_s"] += t1 - t0
    split[kind, "wait_own_s"] += t2 - t1
    split[kind, "download_s"] += t3 - t2
    split[kind, "downloads"] += 1
    split[kind, "download_bytes"] += t.numel() * t.element_size()
    return out


orig_gp, orig_dp = dp_rescue.gapless_prescan, dp_rescue.run_banded_dp
orig_shards = dp_rescue.dp_align_shards
pack_end = [None]


def split_gp(*a, **kw):
    where[:] = "prescan", torch.cuda.Event(), threading.get_ident()
    where[1].record()
    t0 = time.perf_counter()
    try:
        return orig_gp(*a, **kw)
    finally:
        split["prescan", "wall_s"] += time.perf_counter() - t0
        split["prescan", "calls"] += 1
        where[:] = None, None, None


def split_dp(*a, **kw):
    where[:] = "pack", None, threading.get_ident()
    t0 = time.perf_counter()
    pack_end[0] = None
    try:
        return orig_dp(*a, **kw)
    finally:
        end = pack_end[0] or time.perf_counter()
        split["pack", "wall_s"] += end - t0
        split["pack", "calls"] += 1
        where[:] = None, None, None


def split_shards(*a, **kw):
    pack_end[0] = time.perf_counter()
    # the DP's own uploads and downloads are not the pack's
    where[:] = None, None, None
    return dp_rescue.dp_align_shards_inner(*a, **kw)


def splitting(on):
    for name, fn in orig_up.items():
        setattr(dp_rescue, name, _timed_into("upload_s", counted_upload(name))
                if on else fn)
    torch.Tensor.cpu = split_cpu if on else orig_cpu_split
    dp_rescue.gapless_prescan = split_gp if on else orig_gp
    dp_rescue.run_banded_dp = split_dp if on else orig_dp
    dp_rescue.dp_align_shards = split_shards if on else orig_shards
    fsk.prescan = (_timed_into("launch_s", orig_kernels[0]) if on
                   else orig_kernels[0])
    fsk.pack_problems = (_timed_into("launch_s", orig_kernels[1]) if on
                         else orig_kernels[1])


orig_kernels = (fsk.prescan, fsk.pack_problems)
dp_rescue.dp_align_shards_inner = orig_shards


def split_of(kind):
    s = {k: v for (c, k), v in split.items() if c == kind}
    n = max(s.get("calls", 1), 1)
    per = {k: v / n for k, v in s.items() if k != "calls"}
    per["glue_s"] = per.get("wall_s", 0.0) - sum(per.get(k, 0.0) for k in (
        "upload_s", "launch_s", "wait_before_call_s", "wait_own_s",
        "download_s"))
    per["calls"] = s.get("calls", 0)
    return per
'''

BODY = r'''
from torch.profiler import ProfilerActivity, profile
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.kernels.banded_dp import DPScores

d = np.load(ARGS["inputs"])
pac = torch.from_numpy(d["pac"]).to(dev)
z32 = torch.zeros(8, dtype=torch.int32, device=dev)
didx = fmindex.DeviceIndex(
    occ_blocks=torch.zeros((1, 8), dtype=torch.int32, device=dev),
    mark_rank=z32, mark_words=z32, sa_samples=z32,
    counts=torch.zeros(5, dtype=torch.int64, device=dev), pac=pac,
    lut_lo=z32, lut_hi=z32, primary=0, n=int(d["n"]), sa_rate=8, lut_k=1)
sc = DPScores()
kept = []


def no_dp(shards, sc=None):
    """run_banded_dp's DP replaced: the shards kept, no survivor."""
    kept.append(shards)
    P = sum(s[0].shape[0] for s in shards)
    z = np.zeros(P, np.int32)
    return (z - 1, z, z, z, np.zeros((P, 1), np.int32),
            np.zeros((P, 1), np.int32), z, z.astype(np.int64),
            np.zeros(P, bool))


dp_rescue.dp_align_shards_inner = no_dp
dp_rescue.dp_align_shards = no_dp


def case(key):
    c = {k[len(key) + 1:]: d[k] for k in d.files if k.startswith(key + "_")}
    cand = dp_rescue.Candidates(read=c["read"], strand=c["strand"],
                                pos=c["ws"])
    if key.startswith("prescan"):
        return lambda: dp_rescue.gapless_prescan(
            didx, c["reads"], c["lens"], cand, c["ws"], c["wlens"],
            int(c["max_win"]))
    M = len(c["read"])
    clip = np.full(M, 49, np.int32)
    mw = int(c["max_win"])

    def call():
        kept.clear()
        dp_rescue.run_banded_dp(
            didx, c["reads"], c["lens"], cand, c["ws"], c["wlens"], mw,
            clip, clip, np.full(M, mw + 1, np.int32), np.zeros(M, np.int32),
            (c["lens"] * 0.3).astype(np.int64), sc)
        (oriented, wins, params, _), = kept[0]
        return oriented, wins, params
    return call


def host(out):
    return [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in out]


out = {}
for key in ARGS["calls"]:
    call = case(key)
    got = host(call())
    torch.cuda.synchronize()
    walls = []
    for _ in range(ARGS["reps"]):
        t0 = time.perf_counter()
        r = call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    del r
    copies.clear()
    syncs[0] = 0
    counting(True)
    try:
        call()
    finally:
        counting(False)
    torch.cuda.synchronize()
    split.clear()
    splitting(True)
    dp_rescue.dp_align_shards_inner = no_dp
    try:
        call()
    finally:
        splitting(False)
        dp_rescue.dp_align_shards = no_dp
    torch.cuda.synchronize()
    kind = "prescan" if key.startswith("prescan") else "pack"
    parts = split_of(kind)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        call()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    spans = cs._device_spans(prof)
    marks = [a for a, _, n in spans if "spin_kernel" in n]
    window = (spans if len(marks) < 2 else
              [x for x in spans if marks[-2] < x[0] < marks[-1]])
    items = {}
    for a, b, n in window:
        items.setdefault(n, [0.0, 0])
        items[n][0] += (b - a) / 1e3
        items[n][1] += 1
    library = {n: v[1] for n, v in items.items()
               if not n.startswith("Mem") and "spin_kernel" not in n
               and not any(s in n for s in ARGS["symbols"])}
    out[key] = {
        "wall_ms": float(np.median(walls)), "walls_ms": walls,
        "device_ms": sum(b - a for a, b, _ in window) / 1e3,
        "marked": len(marks) >= 2, "items": items, "library": library,
        "library_launches": sum(library.values()),
        "kernel_ms": {s: sum(v[0] for n, v in items.items() if s in n)
                      for s in ARGS["symbols"]},
        "htod": sum(v[1] for n, v in items.items()
                    if n.startswith("Memcpy HtoD")),
        "dtoh": sum(v[1] for n, v in items.items()
                    if n.startswith("Memcpy DtoH")),
        "dtoh_bytes": list(copies), "host_syncs": syncs[0],
        "uploads": int(parts.get("uploads", 0)),
        "upload_bytes": int(parts.get("upload_bytes", 0)),
        "split_ms": {k: v * 1e3 for k, v in parts.items()
                     if k.endswith("_s")},
        "result_dtypes": [str(x.dtype) for x in got]}
    np.savez(ARGS["result"].format(key), *got)
    torch.cuda.empty_cache()

if ARGS["e2e"]:
    import re
    split.clear()
    splitting(True)
    dp_rescue.dp_align_shards_inner = orig_shards
    try:
        res, _ = cs.phase_e2e(dev, ARGS["bp"], ARGS["pairs"], cs.card_line(),
                              ARGS["work"], cs.OUT_DIR, profile=False)
    finally:
        splitting(False)
    log = open(os.path.join(cs.OUT_DIR, "e2e_stderr.log")).read()
    stage = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[timers\] (\S+)\s+([0-9.]+)s", log)}
    out["e2e"] = {"reads_per_s": res["reads_per_s"], "recall": res["recall"],
                  "BC.prescan_s": stage.get("BC.prescan"),
                  "dp.pack_s": stage.get("dp.pack"),
                  "prescan": {k: (v * 1e3 if k.endswith("_s") else v)
                              for k, v in split_of("prescan").items()},
                  "pack": {k: (v * 1e3 if k.endswith("_s") else v)
                           for k, v in split_of("pack").items()}}
print("RESULT " + json.dumps(out), flush=True)
'''


def _body(args: dict) -> str:
    """COUNTING, SPLIT and BODY as run_in_tree's body, the arguments
    given as one JSON literal, every brace escaped."""
    text = (f"ARGS = json.loads({json.dumps(args)!r})\nimport time\n"
            + COUNTING + SPLIT + BODY)
    return text.replace("{", "{{").replace("}", "}}")


def inputs(path: str, genome_bp: int) -> None:
    """The calls' inputs, written once to ``path``: a seeded genome's
    packed words and, for each call, chip_smoke.prescan_path_case's
    reads and windows (one row a candidate)."""
    from soap3dp_tpu_torch.utils import dna

    rng = np.random.default_rng(20261019)
    codes = rng.integers(0, 4, genome_bp, dtype=np.uint8)
    arrays = {"pac": dna.pack_codes(codes).view(np.int32), "n": genome_bp}
    for key, (M, win) in CALLS.items():
        c = cs.prescan_path_case(rng, codes, M, win)
        arrays.update({f"{key}_reads": c["reads"], f"{key}_lens": c["rlens"],
                       f"{key}_read": c["read_idx"].astype(np.int32),
                       f"{key}_strand": c["strand"], f"{key}_ws": c["ws"],
                       f"{key}_wlens": c["wlens"], f"{key}_max_win": win})
    np.savez(path, **arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--genome-bp", type=int, default=cs.E2E_GENOME_BP)
    ap.add_argument("--pairs", type=int, default=cs.E2E_PAIRS)
    args = ap.parse_args(argv)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    build = os.path.join(ROOT, "soap3dp_tpu_torch", "_build")
    path = os.path.join(build, "compare_rescue.npz")
    os.makedirs(build, exist_ok=True)
    inputs(path, args.genome_bp)
    runs, first = [], {}
    for i, tree in enumerate(args.trees):
        result = path[:-4] + f"_{i}_{{}}.npz"
        res = run_in_tree(tree, _body({
            "inputs": path, "result": result, "reps": REPS,
            "calls": list(CALLS), "symbols": SYMBOLS, "e2e": args.e2e,
            "bp": args.genome_bp, "pairs": args.pairs,
            "work": os.path.join(build, "e2e")}))
        for key in CALLS:
            with np.load(result.format(key)) as z:
                mine = [z[k] for k in sorted(z.files,
                                             key=lambda s: int(s[4:]))]
            first.setdefault(key, mine)
            res[key]["equal_to_first"] = (
                len(mine) == len(first[key]) and all(
                    np.array_equal(a.astype(np.int64), b.astype(np.int64))
                    for a, b in zip(mine, first[key])))
        runs.append({"tree": tree, "card": card, **res})
        line = {"tree": tree}
        for key in CALLS:
            r = res[key]
            line[key] = {k: r[k] for k in (
                "wall_ms", "device_ms", "kernel_ms", "library_launches",
                "library", "uploads", "upload_bytes", "htod", "dtoh",
                "dtoh_bytes", "host_syncs", "split_ms", "result_dtypes",
                "equal_to_first", "marked")}
        if "e2e" in res:
            line["e2e"] = res["e2e"]
        print(json.dumps(line), flush=True)
    with open(os.path.join(cs.OUT_DIR, "compare_rescue.json"), "w") as fh:
        json.dump({"card": card, "runs": runs}, fh, indent=1)
    if not all(r[k]["equal_to_first"] for r in runs for k in CALLS):
        raise SystemExit("a checkout's output differs from the first's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
