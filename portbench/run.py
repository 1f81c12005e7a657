"""The benchmark of the PyTorch and CUDA port: one cell of
``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s``, from the process's start to the first
timed job): the configuration's genome and the port's index from its
own builder, cached under ``portbench/.cache/``; the reference's K-mer
table beside them; the cell's reads simulated from ``--seed`` and
written as FASTQ under ``TMPDIR``; one untimed warm-up job.

The window: jobs, each one ``soap3dp-torch pair`` call in this process
(``soap3dp_tpu_torch.cli.main.main``) over the FASTQ pair with the
configuration's options, back to back while ``--seconds`` have not run
out; the last one finishes. ``reads_per_s`` is every job's reads over
the wall from the first job's start to the last one's end. With
``--trace 1`` the port's stage timers are on and the first job runs
under torch.profiler; the result line then holds the per-layer
metrics.

After the window: the peak device memory, the check that no JAX module
was loaded, the recall of every record of every job against the
simulation's truth, and the reference's judgement of a sample of
pairs (``reference/judge.py``), each number printed beside its limit
as the last lines of standard error and under ``checks`` in the result
line, the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import genome as genome_mod  # noqa: E402
from portbench import parse, reads as reads_mod  # noqa: E402
from portbench.cell import Cell  # noqa: E402
from portbench.reference import judge as judge_mod  # noqa: E402
from portbench.reference.index import KmerIndex  # noqa: E402

PORT = "soap3dp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "soap3dp_tpu")
RECALL_TOL = 8
STREAMS = {"reads": 1, "warmup": 2, "sample": 3}


def loaded(names, modules=None) -> list[str]:
    """Top-level names of the loaded modules (sys.modules) that are
    among ``names``, each compared whole (``soap3dp_tpu_torch`` is not
    ``soap3dp_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(modules or sys.modules)}
    return sorted(tops & set(names))


def rng_for(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), STREAMS[stream]])


def cache_dir(cell: Cell, cache_root: str) -> str:
    """Genome, index and reference tables are the deployment's: one
    directory for every configuration of one genome and index."""
    g = cell.config["genome"]
    args = "_".join(cell.config["index"]["build_args"]) or "default"
    return os.path.join(cache_root, f"genome{g['total_bp']}_s{g['seed']}_"
                        f"index-{args}")


def apply_env(cell: Cell) -> None:
    """The configuration's environment, and no JAX from ``transformers``."""
    os.environ["USE_FLAX"] = "0"
    for k, v in cell.config["env"].items():
        os.environ[k] = str(v)


def prepare(cell: Cell, cache_root: str):
    """(genome, index prefix for the port, the reference's K-mer table)."""
    from soap3dp_tpu_torch.cli.main import main as port_main

    cd = cache_dir(cell, cache_root)
    g = genome_mod.cached(cd, cell.config["genome"]["total_bp"],
                          cell.config["genome"]["seed"])
    fasta = os.path.join(cd, "genome.fa")
    done = os.path.join(cd, "index.done")
    if not os.path.exists(done):
        genome_mod.write_fasta(g, fasta)
        sink = io.StringIO()
        with contextlib.redirect_stderr(sink):
            rc = port_main(["build", fasta,
                            *cell.config["index"]["build_args"]])
        if rc != 0:
            raise RuntimeError("the port's index build failed:\n"
                               + sink.getvalue()[-4000:])
        os.remove(fasta)
        with open(done, "w") as fh:
            fh.write("done\n")
    return g, fasta + ".index", KmerIndex.cached(g, cd)


def write_ini(cell: Cell, work: str) -> list[str]:
    ini = cell.config["ini"]
    if not ini:
        return []
    path = os.path.join(work, "soap3-dp.ini")
    with open(path, "w") as fh:
        for section, keys in ini.items():
            fh.write(f"[{section}]\n")
            for k, v in keys.items():
                fh.write(f"{k}={v}\n")
    return ["--ini", path]


def run_job(argv: list[str]) -> dict:
    """One ``soap3dp-torch pair`` call; its stderr captured."""
    from soap3dp_tpu_torch.cli.main import main as port_main

    sink = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(sink):
        rc = port_main(argv)
    t1 = time.time()
    text = sink.getvalue()
    load = parse.index_seconds(text)
    return {"rc": rc, "start": t0, "end": t1, "stderr": text,
            "timers": parse.timers(text),
            "index_s": None if load is None else sum(load)}


def scan_sam(path: str, reads: reads_mod.Reads, chroms: dict) -> dict:
    """Every record of one job: primary records a read, and the ends
    (not random) whose primary record lies on their simulated
    chromosome within RECALL_TOL of their simulated position."""
    n = reads.pairs
    prim = np.zeros((2, n), np.int64)
    near = np.zeros((2, n), bool)
    with open(path, "rb") as fh:
        for line in fh:
            if line[:1] == b"@":
                continue
            f = line.split(b"\t", 4)
            flag = int(f[1])
            if flag & 0x900:
                continue
            e = 0 if flag & 0x40 else 1
            r = int(f[0][1:])
            prim[e, r] += 1
            if not flag & 0x4:
                c = chroms.get(f[2], -1)
                near[e, r] = (c == reads.chrom[e, r]
                              and abs(int(f[3]) - reads.pos[e, r])
                              <= RECALL_TOL)
    alive = ~reads.random
    return {"records_missing": int(np.abs(prim - 1).sum()),
            "recalled": int((near & alive).sum()),
            "recall_ends": int(alive.sum())}


def sample_pairs(cell: Cell, reads: reads_mod.Reads, seed: int) -> np.ndarray:
    """The pairs the reference judges, drawn from the seed."""
    S = min(int(cell.config["sample_pairs"]), reads.pairs)
    return np.sort(rng_for(seed, "sample").choice(reads.pairs, S,
                                                  replace=False))


def judge_jobs(cell, g, kidx, reads, sams, seed) -> tuple[dict, list, dict]:
    """The reference's numbers over a sample of pairs, in every job."""
    lib = judge_mod.Library.of(cell.config["guarantees"])
    sample = sample_pairs(cell, reads, seed)
    S = len(sample)
    ref = judge_mod.Reference(kidx, lib, reads.codes[:, sample])
    j = judge_mod.Judge(ref, g.names)
    names = [reads_mod.read_name(int(i)) for i in sample]
    wanted = set(names)
    for sam in sams:
        recs = judge_mod.collect(sam, wanted)
        for k, name in enumerate(names):
            j.pair(k, name, recs.get(name, []))
    nums = j.numbers()
    info = {"pairs_sampled": S, "pairs_judged": j.pair_judged,
            "dp_records_checked": j.dp_checked,
            "rescued_pairs_checked": j.rescue_checked,
            # the sampled ends pair_worse_pct does not rank (SEED_CAP)
            "unranked_ends_pct": 100.0 * float((~ref.seeded).mean())}
    return nums, j.faults + j.worse, info


def checks_of(nums: dict, limits: dict) -> dict:
    """Each number compared beside its limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def card_facts() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return res.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cache_root: str | None = None,
             log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    cache_root = cache_root or os.path.join(HERE, ".cache")
    apply_env(cell)
    g, index_prefix, kidx = prepare(cell, cache_root)
    reads = reads_mod.simulate(g, cell.mix, int(cell.config["job_pairs"]),
                               rng_for(seed, "reads"))
    warm = reads_mod.simulate(g, cell.mix, int(cell.config["warmup_pairs"]),
                              rng_for(seed, "warmup"))
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        fq = [os.path.join(work, f"reads_{e}.fq") for e in (1, 2)]
        wq = [os.path.join(work, f"warm_{e}.fq") for e in (1, 2)]
        reads_mod.write_fastq(reads, *fq)
        reads_mod.write_fastq(warm, *wq)
        opts = list(cell.config["cli"]) + write_ini(cell, work)
        if device != "cuda":
            opts += ["--device", device]

        def argv(fqs, prefix):
            return ["pair", index_prefix, *fqs, *opts, "-o", prefix]

        warm_job = run_job(argv(wq, os.path.join(work, "warm")))
        if warm_job["rc"] != 0:
            raise RuntimeError("the warm-up job failed:\n"
                               + warm_job["stderr"][-4000:])
        os.remove(os.path.join(work, "warm.sam"))
        jobs, sams = [], []
        traced = None
        t_first = time.time()
        while not jobs or time.time() - t_first < seconds:
            prefix = os.path.join(work, f"job{len(jobs)}")
            if trace and not jobs:
                from portbench.trace import Tracer
                tracer = Tracer()
                with tracer, tracer.job():
                    jobs.append(run_job(argv(fq, prefix)))
                traced = tracer
            else:
                jobs.append(run_job(argv(fq, prefix)))
            sams.append(prefix + ".sam")
            if jobs[-1]["rc"] != 0:
                break
        t_last = jobs[-1]["end"]
        for i, jb in enumerate(jobs):
            done = parse.summary(jb["stderr"])
            log(f"job {i}: {jb['end'] - jb['start']:.3f} s, index "
                f"{jb['index_s']} s, storm-gated batches "
                f"{jb['stderr'].count('host re-align skipped')}, {done}",
                file=sys.stderr)
        if device == "cuda":
            for d in range(cell.chips):
                torch.cuda.synchronize(d)
            peak = max(torch.cuda.max_memory_allocated(d)
                       for d in range(cell.chips))
        else:
            peak = 0
        found = loaded(FORBIDDEN)
        if found:
            raise ForbiddenModules(found)
        window_reads = 2 * reads.pairs * len(jobs)
        run = {"jobs": jobs, "window_reads": window_reads,
               "window_s": t_last - t_first}
        failed_jobs = [i for i, jb in enumerate(jobs) if jb["rc"] != 0]
        for i in failed_jobs:
            log(f"job {i} exited {jobs[i]['rc']}:\n{jobs[i]['stderr'][-3000:]}",
                file=sys.stderr)
        breakdown = None
        if traced is not None:
            run["trace"] = trace_facts(traced, cell, reads.pairs, device)
            breakdown = run["trace"].pop("breakdown")
        # correctness and recall, after the window
        chroms = {n.encode(): i for i, n in enumerate(g.names)}
        missing = recalled = ends = 0
        ok_sams = [s for i, s in enumerate(sams) if i not in failed_jobs]
        for sam in ok_sams:
            s = scan_sam(sam, reads, chroms)
            missing += s["records_missing"]
            recalled += s["recalled"]
            ends += s["recall_ends"]
        t_judge = time.time()
        nums, faults, info = judge_jobs(cell, g, kidx, reads, ok_sams, seed)
        info["judge_s"] = time.time() - t_judge
        info["setup_s"] = t_first - T_START
        for f in faults:
            log(f"judge: {f}", file=sys.stderr)
        log(f"judge: {json.dumps(info)}", file=sys.stderr)
        checks = checks_of(nums, cell.limits)
        checks["records_missing"] = {"value": missing, "limit": 0}
        checks["jobs_failed"] = {"value": len(failed_jobs), "limit": 0}
        result = {"correct": passes(checks),
                  "attempted": window_reads,
                  "failed": missing if not failed_jobs else window_reads,
                  "metrics": {}}
        if not trace:
            result["metrics"] = {
                "reads_per_s": {"value": window_reads / (t_last - t_first),
                                "unit": "reads/s"},
                "recall": {"value": recalled / max(ends, 1),
                           "unit": "fraction"},
                "setup_s": {"value": t_first - T_START, "unit": "s"},
            }
        else:
            for m in cell.per_layer:
                v = cell.readers[m["name"]](run)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": float(v),
                                                    "unit": m["unit"]}
        count = cell.chips if device == "cuda" else 1
        result["device"] = {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": count, "memory_peak_bytes": int(peak)}
        if traced is not None:
            result["device"]["busy_s"] = run["trace"]["busy_s"]
            result["device"]["window_s"] = run["trace"]["window_s"]
            result["breakdown"] = breakdown
        result["unranked_ends_pct"] = info["unranked_ends_pct"]
        for k, c in checks.items():
            log(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def trace_facts(tracer, cell: Cell, pairs: int, device: str) -> dict:
    """The profiled job's events, counters and their sums."""
    from portbench import roofline
    from portbench.trace import gap_owners, gaps, kernel_of, union_us

    tr = tracer.result()
    t0, t1 = tr["job_us"]
    cards = cell.chips if device == "cuda" else 1
    ev = [(d, max(a, t0), min(b, t1), n) for d, a, b, n in tr["device_events"]
          if b > t0 and a < t1]
    busy = [union_us([(a, b) for d, a, b, _ in ev if d == c])
            for c in range(cards)]
    by_op: dict[str, float] = {}
    for _d, a, b, n in ev:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    idle = gap_owners(gaps([(a, b) for d, a, b, _ in ev if d == 0], t0, t1),
                      tr["host_spans"])
    seen: dict[str, int] = {}
    for *_x, n in ev:
        k = kernel_of(n)
        if k:
            seen[k] = seen.get(k, 0) + 1
    print(f"trace: kernel events {json.dumps(seen)}; launches counted "
          f"{json.dumps(tr['expected_launches'])}", file=sys.stderr)
    top = lambda d: [[k, v / 1e6] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(tr, device_events=ev, window_us=(t0, t1), cards=cards,
                reads=2 * pairs, busy_s=sum(busy) / cards / 1e6,
                window_s=(t1 - t0) / 1e6,
                sm_clock_mhz=(roofline.sm_max_clock_mhz()
                              if device == "cuda" else 1980.0),
                breakdown={"device_ops": top(by_op), "idle_gaps": top(idle)})


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, PORT)):
        print(f"portbench: no {PORT} package beside portbench/",
              file=sys.stderr)
        return 2
    found = loaded(FORBIDDEN + (PORT,))
    if found:
        print(f"portbench: the harness, the readers or the reference "
              f"loaded {found}", file=sys.stderr)
        return 4
    cell = Cell(args.workload, ROOT)
    apply_env(cell)
    if args.trace:
        os.environ["SOAP3DP_TIMERS"] = "1"
    else:
        os.environ.pop("SOAP3DP_TIMERS", None)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"portbench: {cell.name} seed {args.seed}; {card_facts()}",
          file=sys.stderr)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        print(f"portbench: after the window sys.modules holds {e.args[0]}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
