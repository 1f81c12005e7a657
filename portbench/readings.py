"""The readings that the limits of ``limits/<cell>.json`` are set from,
many seeds in one process: for each seed, one job of the cell's own
size through the port (the lower readings: what sound runs give) and
the control (the upper: the reference in the program's place, one
mismatch fewer allowed than the configuration states). The benchmark's
own runs do not run this.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \
        [--control-only]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import genome as genome_mod  # noqa: E402
from portbench import reads as reads_mod  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench.cell import Cell  # noqa: E402
from portbench.reference import judge as judge_mod  # noqa: E402
from portbench.reference.index import KmerIndex  # noqa: E402


def control_reading(cell: Cell, g, kidx, reads, seed: int, work: str
                    ) -> tuple[dict, bool]:
    """The control's numbers on the pairs a run would judge, and whether
    they pass the cell's limits: its answers written as SAM and put
    through the run's own judge."""
    sample = R.sample_pairs(cell, reads, seed)
    lib = judge_mod.Library.of(cell.config["guarantees"])
    path = os.path.join(work, "control.sam")
    judge_mod.control_sam(kidx, lib, reads.codes[:, sample],
                          [reads_mod.read_name(int(i)) for i in sample],
                          g.names, path)
    nums, _faults, _info = R.judge_jobs(cell, g, kidx, reads, [path], seed)
    return nums, R.passes(R.checks_of(nums, cell.limits))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)
    cell = Cell(args.workload, ROOT)
    R.apply_env(cell)
    cache = R.cache_dir(cell, os.path.join(HERE, ".cache"))
    if args.control_only:
        gc = cell.config["genome"]
        g = genome_mod.cached(cache, gc["total_bp"], gc["seed"])
        kidx = KmerIndex.cached(g, cache)
        index_prefix = None
    else:
        g, index_prefix, kidx = R.prepare(cell, os.path.join(HERE, ".cache"))
    for seed in args.seeds:
        reads = reads_mod.simulate(g, cell.mix, int(cell.config["job_pairs"]),
                                   R.rng_for(seed, "reads"))
        out = {"workload": cell.name, "seed": seed}
        work = tempfile.mkdtemp(prefix="portbench-readings-")
        try:
            out["control"], out["control_correct"] = control_reading(
                cell, g, kidx, reads, seed, work)
            if not args.control_only:
                fq = [os.path.join(work, f"reads_{e}.fq") for e in (1, 2)]
                reads_mod.write_fastq(reads, *fq)
                opts = list(cell.config["cli"]) + R.write_ini(cell, work)
                prefix = os.path.join(work, "job")
                job = R.run_job(["pair", index_prefix, *fq, *opts, "-o",
                                 prefix])
                out["rc"] = job["rc"]
                nums, faults, info = R.judge_jobs(cell, g, kidx, reads,
                                                  [prefix + ".sam"], seed)
                out.update(program=nums, info=info, faults=faults[:5])
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
