"""Compare the DP rescue's device dispatch between checkouts of the repo
on one CUDA card, in the order given.

    python3 compare_dp.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Two calls of dp_align_shards, as pipeline/dp_rescue.py's run_banded_dp
makes them (one shard on the card; the problems' vectors uploaded from
the host, each checkout in its own form), on problems made by this
checkout's chip_smoke.py generators (main_path_problems: reads of 100
bases in 120-wide rows, the rescue clips, cutoff 0.3 L):

* ``k1``: phase 4's largest K1 call, 16,384 x 120 x 256;
* ``wide``: phase 5's largest wide call, 16,384 x 120 x 4,224 (K2 and
  TB over chunks of the problem axis).

Each checkout runs in a fresh process (compare_e2e.run_in_tree) that
builds its kernels and, for each call: checks the tuple against the
first checkout's (every field, runs over each lane's nrun prefix);
times the call on the host clock (REPS calls, each ending with its
numpy tuple); profiles one call under torch.profiler between two marker
kernels: its device items by name, the library launches among them
(neither a DP kernel, a marker nor a copy), its device-to-host copies
and their time, and, for the wide call, the copies and the card's idle
time between one chunk's forward kernel and the next; counts the bytes
each device-to-host copy moves and the host syncs of the call
(torch.Tensor.cpu / item / tolist, a blocking copy_, and the event,
stream and device synchronizes, counted where Python calls them); and
times torch.empty of the wide route's direction buffer through the
caching allocator. Then DW alone: DW_REPS calls of the call's wire
kernel on one set of its route's outputs (K1's, or K2's and TB's), each
between two marker kernels of one profile (chip_smoke._call_span_ms:
the median span from a call's first wire kernel to its last, and the
median sum of their device times, whatever the design's launches), its
CUDA-event time a call in a loop (the wrapper's host work included),
and an empty launch's device time (torch.cuda._sleep(0)), the floor of
one launch. Prints one line a run and writes compare_dp.json in
chip_smoke.py's output directory.
"""

import argparse
import json
import os

import numpy as np

import chip_smoke as cs
from compare_e2e import ROOT, run_in_tree

REPS = 10
DW_REPS = 30
CALLS = {"k1": (16384, 120, 256), "wide": (16384, 120, 4224)}
DP_SYMBOLS = ("dp_align_kernel", "dp_forward_kernel", "dp_traceback_kernel",
              "dp_wire_")

COUNTING = """
copies, syncs = [], [0]
cpu, copy_, item, tolist = (torch.Tensor.cpu, torch.Tensor.copy_,
                            torch.Tensor.item, torch.Tensor.tolist)
ev_sync, st_sync, dev_sync = (torch.cuda.Event.synchronize,
                              torch.cuda.Stream.synchronize,
                              torch.cuda.synchronize)


def c_cpu(t, *a, **kw):
    if t.is_cuda:
        copies.append(t.numel() * t.element_size())
        syncs[0] += 1
    return cpu(t, *a, **kw)


def c_copy(dst, src, non_blocking=False):
    if src.is_cuda and not dst.is_cuda:
        copies.append(src.numel() * src.element_size())
        syncs[0] += not non_blocking
    return copy_(dst, src, non_blocking)


def c_item(t):
    syncs[0] += t.is_cuda
    return item(t)


def c_tolist(t):
    syncs[0] += t.is_cuda
    return tolist(t)


def c_ev(e):
    syncs[0] += 1
    return ev_sync(e)


def c_st(s):
    syncs[0] += 1
    return st_sync(s)


def c_dev(*a, **kw):
    syncs[0] += 1
    return dev_sync(*a, **kw)


def counting(on):
    torch.Tensor.cpu = c_cpu if on else cpu
    torch.Tensor.copy_ = c_copy if on else copy_
    torch.Tensor.item = c_item if on else item
    torch.Tensor.tolist = c_tolist if on else tolist
    torch.cuda.Event.synchronize = c_ev if on else ev_sync
    torch.cuda.Stream.synchronize = c_st if on else st_sync
    torch.cuda.synchronize = c_dev if on else dev_sync
"""

RUN = """
import time
from torch.profiler import ProfilerActivity, profile
from soap3dp_tpu_torch.fm.fmindex import to_device
from soap3dp_tpu_torch.kernels import banded_dp as bd

sc = bd.DPScores()
d = np.load({inputs!r})
symbols = {symbols!r}
packed = hasattr(bd, "pack_params")
out = {{"packed_form": packed}}
""" + COUNTING + """
for key in ("k1", "wide"):
    reads = torch.from_numpy(d[key + "_0"]).to(dev)
    wins = torch.from_numpy(d[key + "_2"]).to(dev)
    vec = [d[f"{{key}}_{{i}}"] for i in (1, 3, 4, 5, 6, 7, 8)]

    if packed:   # run_banded_dp since the wire: one (P, 8) block
        def call():
            params = to_device(bd.pack_params(*vec), dev)
            return bd.dp_align_shards([(reads, wins, params, vec[-1])], sc)
    else:        # before: seven uploaded vectors, dp_align's nine inputs
        def call():
            v = [to_device(x, dev) for x in vec]
            return bd.dp_align_shards([[reads, v[0], wins] + v[1:]], sc)

    got = call()
    torch.cuda.synchronize()
    walls = []
    for _ in range({reps}):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    copies.clear()
    syncs[0] = 0
    counting(True)
    try:
        call()
    finally:
        counting(False)
    torch.cuda.synchronize()
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
    items = {{}}
    for a, b, n in window:
        items.setdefault(n, [0.0, 0])
        items[n][0] += (b - a) / 1e3
        items[n][1] += 1
    library = {{n: v[1] for n, v in items.items()
               if not n.startswith("Mem") and "spin_kernel" not in n
               and not any(s in n for s in symbols)}}
    fwd = sorted((a, b) for a, b, n in window if "dp_forward_kernel" in n)
    between = []
    for (a0, b0), (a1, _) in zip(fwd, fwd[1:]):
        inside = [(a, b, n) for a, b, n in window if b0 <= a < a1]
        busy = sorted((a, b) for a, b, _ in inside)
        idle, t = 0.0, b0
        for a, b in busy:
            idle += max(0.0, a - t)
            t = max(t, b)
        idle += max(0.0, a1 - t)
        between.append({{"dtoh": sum(n.startswith("Memcpy DtoH")
                                    for _, _, n in inside),
                        "idle_ms": idle / 1e3}})
    out[key] = {{
        "P": int(reads.shape[0]), "Lr": int(reads.shape[1]),
        "Lw": int(wins.shape[1]),
        "wall_ms": float(np.median(walls)), "walls_ms": walls,
        "device_ms": sum(b - a for a, b, _ in window) / 1e3,
        "marked": len(marks) >= 2,
        "items": items, "library": library,
        "library_launches": sum(library.values()),
        "kernel_ms": {{s: sum(v[0] for n, v in items.items() if s in n)
                      for s in symbols}},
        "dtoh": sum(v[1] for n, v in items.items()
                    if n.startswith("Memcpy DtoH")),
        "dtoh_ms": sum(v[0] for n, v in items.items()
                       if n.startswith("Memcpy DtoH")),
        "dtoh_bytes": list(copies), "host_syncs": syncs[0],
        "between_chunks": between,
        "passing": int((np.asarray(got[6]) > 0).sum())}}
    if packed:   # DW alone on one set of the route's outputs
        params = to_device(bd.pack_params(*vec), dev)
        outputs = bd._k1_outputs if key == "k1" else bd._wide_outputs
        wire, runs = outputs(reads, wins, params, sc)
        dw = lambda: bd._launch_wire(params, runs, wire)
        span, ev = cs._call_span_ms(dw, {dw_reps}, "dp_wire_")
        out[key].update(dw_span_ms=span, dw_events_ms=ev,
                        dw_call_ms=cs._events_ms(dw, {dw_reps}))
        del wire, runs
    np.savez({result!r}.format(key), *got)
    del reads, wins
    torch.cuda.empty_cache()

nbytes = (4224 + 120) * 2042 * 121
torch.empty(nbytes, dtype=torch.uint8, device=dev)
torch.cuda.synchronize()
alloc = []
for _ in range(20):
    t0 = time.perf_counter()
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    alloc.append((time.perf_counter() - t0) * 1e3)
    del buf
out["dirs_empty_ms"] = float(np.median(alloc))
out["empty_launch_ms"] = cs._kernel_device_ms(lambda: torch.cuda._sleep(0),
                                              50, "spin_kernel")
out["dirs_bytes"] = nbytes
print("RESULT " + json.dumps(out), flush=True)
"""


def inputs(path: str) -> None:
    """The two calls' problems (chip_smoke.main_path_problems, seeds of
    phase 2's K1 and wide cases), written once to ``path``."""
    arrays = {}
    for key, seed in (("k1", cs.K1_SEED), ("wide", cs.WIDE_SEED)):
        P, Lr, Lw = CALLS[key]
        prob = cs.main_path_problems(np.random.default_rng(seed), P, Lr, Lw,
                                     read_len=100)
        arrays.update({f"{key}_{i}": np.ascontiguousarray(x)
                       for i, x in enumerate(prob)})
    np.savez(path, **arrays)


def same_tuple(a: list, b: list) -> bool:
    """Two dp_align tuples equal: every field, runs over each lane's nrun
    prefix (chip_smoke._dp_equal)."""
    return cs._dp_equal(a, b)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    path = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "compare_dp.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    inputs(path)
    runs, first = [], None
    for i, tree in enumerate(args.trees):
        result = path[:-4] + f"_{i}_{{}}.npz"
        res = run_in_tree(tree, RUN, inputs=path, reps=REPS,
                          dw_reps=DW_REPS, symbols=DP_SYMBOLS,
                          result=result)
        for key in CALLS:
            with np.load(result.format(key)) as z:
                mine = [z[f"arr_{k}"] for k in range(9)]
            first = first or {}
            first.setdefault(key, mine)
            res[key]["equal_to_first"] = same_tuple(mine, first[key])
        runs.append({"tree": tree, "card": card, **res})
        line = {"tree": tree, "packed_form": res["packed_form"],
                "dirs_empty_ms": res["dirs_empty_ms"],
                "empty_launch_ms": res["empty_launch_ms"]}
        for key in CALLS:
            r = res[key]
            line[key] = {k: r[k] for k in (
                "wall_ms", "device_ms", "library_launches", "library",
                "dtoh", "dtoh_ms", "dtoh_bytes", "host_syncs", "kernel_ms",
                "passing", "equal_to_first", "marked", "dw_span_ms",
                "dw_events_ms", "dw_call_ms") if k in r}
            if key == "wide":
                line[key]["between_chunks"] = r["between_chunks"]
        print(json.dumps(line), flush=True)
    with open(os.path.join(cs.OUT_DIR, "compare_dp.json"), "w") as fh:
        json.dump({"card": card, "runs": runs}, fh, indent=1)
    if not all(r[k]["equal_to_first"] for r in runs for k in CALLS):
        raise SystemExit("a checkout's tuple differs from the first's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
