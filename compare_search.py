"""Compare the seed search of phase 4's first batch (chip_smoke.py's
search_device_items: 131,072 reads of a 250 Mbp seeded genome, both ends
over segments {0, 1}, rounds included) between checkouts of the repo on
one CUDA card.

    python3 compare_search.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each checkout runs in a fresh process that imports its own
chip_smoke.py, builds its kernels and profiles the search under
torch.profiler (the second of two searches, between marker kernels).
This process makes the index and the reads once (chip_smoke's phase-4
genome and pairs) and reads each run's device items: their total, the
library launches among them (chip_smoke.library_items: neither an FS
kernel, a marker nor a copy), the device-to-host copies and their time,
and the bytes each dispatch's result download holds (counted at
fm/search.py's _HostCopy, which every checkout has). Each run then
profiles the DP seeding (dp_rescue.seed_candidates, as the single-end
salvage seeds) of the batch's first SEED_READS end-1 reads the same way:
its device items by name (ms, launches) and their total, its
device-to-host copies' times (the candidates' prefix and the total's
scalar), the bytes of its downloads (counted at torch.Tensor.cpu and,
where a checkout has it, dp_rescue._prefix_to_host) and its library
launches. Prints one line a run and
writes compare_search.json in chip_smoke.py's output directory.
"""

import argparse
import json
import os

import numpy as np

import chip_smoke as cs
from compare_e2e import run_in_tree

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED_READS = 16384

RUN = """
from soap3dp_tpu_torch.fm import search as fsearch
copies = []
base = fsearch._HostCopy


class Counted(base):
    def __init__(self, vec):
        copies.append(vec.numel() * vec.element_size())
        super().__init__(vec)


fsearch._HostCopy = Counted
os.makedirs({out!r}, exist_ok=True)
res = cs.search_device_items(dev, {reads!r}, {out!r})

from torch.profiler import ProfilerActivity, profile
from soap3dp_tpu_torch.fm.fmindex import device_index
from soap3dp_tpu_torch.index.builder import load_index
from soap3dp_tpu_torch.io.fastq import read_pairs
from soap3dp_tpu_torch.pipeline import dp_rescue

didx = device_index(load_index({reads!r}["index"]), dev)
b1, _ = next(read_pairs({reads!r}["r1"], {reads!r}["r2"],
                        batch_size={seed_reads}))
sp, sl = dp_rescue.single_dp_seed_matrix(b1.lens, b1.codes.shape[1])
seed_bytes = []
to_host = torch.Tensor.cpu
to_prefix = getattr(dp_rescue, "_prefix_to_host", None)


def counted_cpu(t, *a, **kw):
    if t.is_cuda:
        seed_bytes.append(t.numel() * t.element_size())
    return to_host(t, *a, **kw)


def counted_prefix(packed, K, n):
    seed_bytes.append(3 * n * packed.element_size())
    return to_prefix(packed, K, n)


def seed():
    dp_rescue.seed_candidates(didx, b1.codes, b1.lens, sp, sl)
    torch.cuda.synchronize(dev)


seed()
torch.Tensor.cpu = counted_cpu
if to_prefix is not None:
    dp_rescue._prefix_to_host = counted_prefix
try:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            seed()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(dev)
finally:
    torch.Tensor.cpu = to_host
    if to_prefix is not None:
        dp_rescue._prefix_to_host = to_prefix
spans = cs._device_spans(prof)
marks = [a for a, _, n in spans if "spin_kernel" in n]
window = (spans if len(marks) < 2 else
          [x for x in spans if marks[-2] < x[0] < marks[-1]])
seed_items = {{}}
for a, b, n in window:
    seed_items.setdefault(n, [0.0, 0])
    seed_items[n][0] += (b - a) / 1e3
    seed_items[n][1] += 1
seeding = {{"reads": len(b1), "marked": len(marks) >= 2,
           "device_ms": sum(b - a for a, b, _ in window) / 1e3,
           "items": seed_items,
           "dtoh_ms": [(b - a) / 1e3 for a, b, n in window
                       if n.startswith("Memcpy DtoH")],
           "download_bytes": seed_bytes[len(seed_bytes) // 2:]}}
print("RESULT " + json.dumps({{"items": res["items"],
                               "device_ms": res["device_ms"],
                               "marked": res["marked"],
                               "copies": copies, "seeding": seeding}}),
      flush=True)
"""


def inputs(work: str) -> dict:
    """Phase 4's index (chip_smoke._genome_index, cached) and its pairs
    (workloads.make_pe_fastq with phase_e2e's generator), written once."""
    from soap3dp_tpu_torch import workloads

    rng, genome, idx_path, _, _, _ = cs._genome_index(cs.E2E_GENOME_BP, work)
    r1, r2 = (os.path.join(work, f"r{e}.fq") for e in (1, 2))
    workloads.make_pe_fastq(rng, genome.codes, cs.E2E_PAIRS, r1, r2)
    return {"index": idx_path, "r1": r1, "r2": r2}


def summary(res: dict) -> dict:
    """A run's numbers: device ms, items, library launches by name, the
    device-to-host copies, the bytes of one search's downloads (the last
    third of the counted copies: a warm-up and two profiled searches)."""
    items = res["items"]
    library = cs.library_items(items)
    down = [v for n, v in items.items() if n.startswith("Memcpy DtoH")]
    per = res["copies"][2 * len(res["copies"]) // 3:]
    return {"device_ms": res["device_ms"], "items": len(items),
            "launches": sum(v[1] for v in items.values()),
            "library_launches": sum(library.values()), "library": library,
            "dtoh_ms": sum(v[0] for v in down),
            "dtoh": sum(v[1] for v in down), "download_bytes": per,
            "marked": res["marked"], "seeding": res["seeding"],
            "seed_prefix_ms": max(res["seeding"]["dtoh_ms"], default=0.0),
            "seed_library": cs.library_items(
                res["seeding"].get("items", {}))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    card = cs.card_line()
    print(card, flush=True)
    reads = inputs(work)
    runs = []
    for i, tree in enumerate(args.trees):
        out = os.path.join(cs.OUT_DIR, f"compare_search_{i}")
        res = run_in_tree(tree, RUN, reads=reads, out=out,
                          seed_reads=SEED_READS)
        runs.append({"tree": tree, **summary(res)})
        print(json.dumps(runs[-1]), flush=True)
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).append(r)
    medians = {t: {k: float(np.median([r[k] for r in rs]))
                   for k in ("device_ms", "dtoh_ms", "library_launches",
                             "launches", "seed_prefix_ms")}
               for t, rs in by_tree.items()}
    print("MEDIANS " + json.dumps(medians), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "compare_search.json"), "w") as fh:
        json.dump({"card": card, "runs": runs, "medians": medians}, fh,
                  indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
