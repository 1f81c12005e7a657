"""Compare the port's end-to-end `pair` run (chip_smoke.py phase 4: a
250 Mbp seeded genome, 100,000 read pairs, default options) between two
checkouts of the repo on one CUDA card, in alternating order.

    python3 compare_e2e.py PARENT_DIR CHANGE_DIR [--rounds 3]

Each round runs parent, change, change, parent, each in a fresh process
that imports that checkout's chip_smoke.py, builds its kernels first and
then times the CLI call (index load and upload included, as phase 4
reports them). Both checkouts share one cached index and the same
seeded reads. Prints one line per run and the medians, and writes them
to compare_e2e.json in chip_smoke.py's output directory.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

from chip_smoke import OUT_DIR, card_line

ROOT = os.path.dirname(os.path.abspath(__file__))

# the start of every run: that checkout's chip_smoke.py, its kernels built
PREAMBLE = """
import json, os, sys
sys.path.insert(0, {tree!r})
import numpy as np
import torch
import chip_smoke as cs
os.makedirs(cs.OUT_DIR, exist_ok=True)
cs._build_all()
dev = torch.device("cuda", 0)
"""

RUN = """
res, _ = cs.phase_e2e(dev, {bp}, {pairs}, cs.card_line(), {work!r},
                      cs.OUT_DIR, profile=False)
keys = ("reads_per_s", "reads_per_s_after_load", "index_upload_s",
        "wall_s", "batch_s", "recall", "launches")
print("RESULT " + json.dumps({{k: res[k] for k in keys}}), flush=True)
"""


def run_in_tree(tree: str, body: str, **fields) -> dict:
    """Run PREAMBLE and then ``body``, both formatted with ``fields`` and
    ``tree``, in a fresh process in the checkout ``tree``. Returns the
    object of the last line it prints that starts with RESULT; exits if
    the run fails."""
    code = (PREAMBLE + body).format(tree=os.path.abspath(tree), **fields)
    p = subprocess.run([sys.executable, "-c", code], cwd=tree,
                       capture_output=True, text=True)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    if p.returncode or not lines:
        sys.stdout.write(p.stdout[-4000:] + p.stderr[-4000:])
        sys.exit(f"run in {tree} failed ({p.returncode})")
    return json.loads(lines[-1][7:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--genome-bp", type=int, default=250_000_000)
    ap.add_argument("--pairs", type=int, default=100_000)
    args = ap.parse_args(argv)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    card = card_line()
    print(card, flush=True)
    runs = []
    for r in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            res = run_in_tree(getattr(args, side), RUN, work=work,
                              bp=args.genome_bp, pairs=args.pairs)
            runs.append({"round": r, "side": side, **res})
            print(json.dumps(runs[-1]), flush=True)
    summary = {"card": card}
    for side in ("parent", "change"):
        mine = [x for x in runs if x["side"] == side]
        for key in ("reads_per_s", "reads_per_s_after_load",
                    "index_upload_s"):
            vals = sorted(x[key] for x in mine)
            summary[f"{side}_{key}"] = {"median": statistics.median(vals),
                                        "min": vals[0], "max": vals[-1]}
    print(json.dumps(summary), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "compare_e2e.json"), "w") as fh:
        json.dump({"runs": runs, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
