"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card; no options

Phases, each printing one line, any failure exits non-zero:

1. device and build: the card's name and power limit, and the build of
   every kernel of the main path from csrc/;
2. each kernel against its plain-torch version on the card, at the main
   path's shapes (plus a long-read and a run-budget-overflow case),
   outputs exactly equal, both times printed;
3. golden SAM: the five paired-end golden cases of tests/golden rendered
   through the port on cuda, every record equal (@PG excepted);
4. end to end at a real size: a 250 Mbp genome, 100,000 read pairs,
   the port's `pair` CLI with default options (-u 500 -v 300); checks
   records, planted-locus recall, rescue counts and kernel launches,
   then runs it once more under torch.profiler (device busy share,
   top device events in chiprun_out/e2e_profile.txt).

Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}. Uses only soap3dp_tpu_torch and the
JAX-free shared modules of soap3dp_tpu; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[chip_smoke] {name}: {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------
# Phase 2 inputs: the DP problems of tests/test_dp.py, made with numpy
# ------------------------------------------------------------------

def _mutate(rng, seq, nsub, nins, ndel):
    out = list(seq)
    for _ in range(ndel):
        if len(out) > 4:
            del out[rng.integers(0, len(out))]
    for _ in range(nins):
        out.insert(rng.integers(0, len(out) + 1), rng.integers(0, 4))
    for _ in range(nsub):
        p = rng.integers(0, len(out))
        out[p] = (out[p] + rng.integers(1, 4)) % 4
    return np.asarray(out, dtype=np.uint8)


def make_problems(rng, P, Lr, Lw, with_anchor=False):
    """Reads cut from their windows with substitutions and small indels
    (the make_problems recipe of tests/test_dp.py)."""
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), dtype=np.uint8)
    rlens = np.zeros(P, dtype=np.int32)
    for p in range(P):
        off = rng.integers(0, Lw // 3)
        span = rng.integers(Lr // 2, Lr)
        piece = _mutate(rng, wins[p, off:off + span], rng.integers(0, 4),
                        rng.integers(0, 3), rng.integers(0, 3))[:Lr]
        reads[p, :len(piece)] = piece
        rlens[p] = len(piece)
    clip_l = rng.integers(0, 6, size=P).astype(np.int32)
    clip_r = rng.integers(0, 6, size=P).astype(np.int32)
    if with_anchor:
        anchor_l = rng.integers(2, Lw, size=P).astype(np.int32)
        anchor_r = rng.integers(0, Lw // 2, size=P).astype(np.int32)
    else:
        anchor_l = np.full(P, Lw + 1, dtype=np.int32)
        anchor_r = np.zeros(P, dtype=np.int32)
    wlens = np.full(P, Lw, dtype=np.int32)
    return reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r


def main_path_problems(rng, P, Lr, Lw):
    """Rescue-shaped problems: 100 bp reads placed in a window with
    mismatches and 3 bp indels, the rescue clips (49) and cutoff 0.3 L."""
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), np.uint8)
    rlens = np.full(P, Lr, np.int32)
    for p in range(P):
        off = rng.integers(0, Lw - Lr - 8)
        piece = _mutate(rng, wins[p, off:off + Lr + 4], rng.integers(0, 6),
                        rng.integers(0, 2) * 3, rng.integers(0, 2) * 3)
        if p % 7 == 0:
            piece = rng.integers(0, 4, Lr).astype(np.uint8)  # no placement
        piece = piece[:Lr]
        reads[p, :len(piece)] = piece
        rlens[p] = len(piece)
    clip = np.full(P, 49, np.int32)
    return (reads, rlens, wins, np.full(P, Lw, np.int32), clip, clip.copy(),
            np.full(P, Lw + 1, np.int32), np.zeros(P, np.int32),
            (rlens * 0.3).astype(np.int32))


def overflow_problems(rng, P, Lr, Lw):
    """Every other base mismatched, no free clips, a cutoff far below
    any score: each alignment has ~Lr runs, past the first run budget."""
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = wins[:, 20:20 + Lr].copy()
    reads[:, 1::2] = (reads[:, 1::2] + 1 + (np.arange(Lr)[1::2] % 3)) % 4
    z = np.zeros(P, np.int32)
    return (reads, np.full(P, Lr, np.int32), wins, np.full(P, Lw, np.int32),
            z, z.copy(), np.full(P, Lw + 1, np.int32), z.copy(),
            np.full(P, -100000, np.int32))


def _dp_equal(a, b) -> tuple[bool, int]:
    """Exact equality of two dp_align results (runs compared over each
    lane's nrun prefix); returns (equal, max |difference|)."""
    (sa, ia, ja, ca, oa, na, ra, ta, fa) = a
    (sb, ib, jb, cb, ob, nb, rb, tb, fb) = b
    err = 0
    for x, y in ((sa, sb), (ia, ib), (ja, jb), (ca, cb), (ra, rb),
                 (ta, tb), (fa, fb)):
        err = max(err, int(np.abs(np.asarray(x, np.int64)
                                  - np.asarray(y, np.int64)).max(initial=0)))
    for p in np.flatnonzero(np.asarray(ra) > 0):
        n = int(ra[p])
        if n > oa.shape[1] or n > ob.shape[1]:
            return False, max(err, 1)
        err = max(err, int(np.abs(oa[p, :n] - ob[p, :n]).max()),
                  int(np.abs(na[p, :n] - nb[p, :n]).max()))
    return err == 0, err


def _kernel_only_ms(bd, args, reps: int = 10) -> float:
    """Mean time of one banded_dp launch (no host copies), CUDA events."""
    import torch

    reads, rlens, wins, wlens, cl, cr, al, ar, cut = args
    params = torch.stack([rlens, wlens, cl, cr, al, ar, cut,
                          torch.zeros_like(rlens)], 1).to(torch.int32)
    mr = max(bd.MAX_RUNS, bd._max_runs_bound(reads.shape[1]))
    sc = bd.DPScores()
    bd._launch_dp(reads, wins, params.contiguous(), mr, sc)  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        bd._launch_dp(reads, wins, params.contiguous(), mr, sc)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev) -> list[dict]:
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rng = np.random.default_rng(20261016)
    cases = [
        ("Lr100_Lw256", main_path_problems(rng, 4096, 100, 256)),
        ("Lr100_Lw768", main_path_problems(rng, 4096, 100, 768)),
        ("anchors", make_problems(rng, 512, 100, 256, with_anchor=True)
         + (np.full(512, 10, np.int32),)),
        ("Lr1024_Lw1100", make_problems(rng, 64, 1024, 1100)
         + (np.full(64, 150, np.int32),)),
        ("overflow_Lr260", overflow_problems(rng, 256, 260, 360)),
    ]
    rows = []
    max_err = 0
    for name, prob in cases:
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in prob]
        n0 = bd.DP_KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = bd.dp_align(*args)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        n_launch = bd.DP_KERNEL.launches - n0
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bd.dp_align(*args)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = bd.dp_align_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ok, err = _dp_equal(got, want)
        npass = int((np.asarray(want[6]) > 0).sum())
        P, Lr, Lw = prob[0].shape[0], prob[0].shape[1], prob[2].shape[1]
        kms = _kernel_only_ms(bd, args)
        phase("kernel banded_dp",
              f"{name}: P={P} Lr={Lr} Lw={Lw} equal={ok} max_abs_err={err} "
              f"passing_lanes={npass} launches={n_launch} "
              f"first_ms={first_ms:.3f} ms={float(np.median(reps)):.3f} "
              f"kernel_only_ms={kms:.3f} "
              f"GCUPS={P * Lr * Lw / (kms * 1e6):.1f} "
              f"plain_ms={plain_ms:.3f}")
        if not ok:
            fail(f"banded_dp kernel disagrees with its plain version ({name})")
        if name.startswith("overflow") and n_launch != 2:
            fail("overflow case did not re-launch the DP kernel")
        max_err = max(max_err, err)
        rows.append({"case": name, "P": P, "Lr": Lr, "Lw": Lw,
                     "ms": float(np.median(reps)), "kernel_only_ms": kms,
                     "plain_ms": plain_ms})
    main = [r for r in rows if r["case"] == "Lr100_Lw768"][0]
    return [{"name": "banded_dp", "route": "cuda",
             "source": "soap3dp_tpu_torch/csrc/banded_dp.cu",
             "replaces": "soap3dp_tpu/kernels/banded_dp.py:606",
             "launches": 0, "max_abs_err": max_err,
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "cases": rows}]


def phase_golden(dev) -> None:
    """The five paired-end golden SAM cases through the port on ``dev``."""
    import io

    from soap3dp_tpu.io.sam import SamWriter
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.pipeline.pair import align_pair_batch

    for name, case in workloads.GOLDEN_PAIR_CASES:
        t0 = time.perf_counter()
        index, b1, b2 = workloads.golden_pair_workload(
            case.get("plant4", False))
        buf = io.BytesIO()
        w = SamWriter(buf, index)
        align_pair_batch(index, device_index(index, dev), b1, b2,
                         workloads.golden_options(case), w)
        got = [l for l in buf.getvalue().decode().splitlines()
               if not l.startswith("@PG")]
        path = os.path.join(ROOT, "tests", "golden", f"{name}.sam")
        with open(path) as fh:
            want = fh.read().splitlines()
        bad = [i for i, (g, x) in enumerate(zip(got, want))
               if g.split("\t") != x.split("\t")]
        phase("golden", f"{name}: {len(got)} lines vs {len(want)}, "
                        f"{len(bad)} differ ({time.perf_counter() - t0:.2f}s)")
        if len(got) != len(want) or bad:
            i = bad[0] if bad else min(len(got), len(want))
            fail(f"golden {name} line {i}:\n got: "
                 f"{got[i] if i < len(got) else None}\nwant: "
                 f"{want[i] if i < len(want) else None}")


class _Tee:
    """stderr that also keeps a copy (the CLI reports on stderr)."""

    def __init__(self, stream):
        self.stream = stream
        self.parts: list[str] = []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _device_spans(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device event of a profile."""
    out = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            out.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(out)


def _profiled_pass(cli_main, argv, wall_plain: float, out_dir: str) -> dict:
    """Run the CLI once more with torch.profiler recording device
    activity only; returns the device busy time (union of kernel and
    copy intervals) and writes the top device events to out_dir."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    sink = io.StringIO()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            contextlib.redirect_stderr(sink):
        rc = cli_main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"the profiled pair CLI exited {rc}")
    spans = _device_spans(prof)
    busy = 0.0
    cur = None
    for a, b, _ in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    copies = sum(b - a for a, b, n in spans if n.startswith("Mem"))
    by_name: dict[str, list] = {}
    for a, b, n in spans:
        by_name.setdefault(n, [0.0, 0])
        by_name[n][0] += b - a
        by_name[n][1] += 1
    with open(os.path.join(out_dir, "e2e_profile.txt"), "w") as fh:
        fh.write(f"profiled wall {wall:.3f}s (unprofiled {wall_plain:.3f}s); "
                 f"device busy {busy / 1e6:.3f}s, of which copies "
                 f"{copies / 1e6:.3f}s\n")
        for n, (us, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:30]:
            fh.write(f"{us / 1e3:10.2f} ms x{k:<7d} {n[:150]}\n")
        fh.write(sink.getvalue())
    res = {"profiled_wall_s": wall, "device_busy_s": busy / 1e6,
           "device_copy_s": copies / 1e6}
    if not spans:
        phase("e2e profile", "the profiler recorded no device events: "
                             "device busy share not measured")
        return res
    phase("e2e profile", f"profiled pass {wall:.2f}s; device busy "
                         f"{busy / 1e6:.3f}s ({copies / 1e6:.3f}s of it "
                         f"copies, mostly the index upload) = "
                         f"{busy / 1e6 / wall:.1%} of the profiled wall, "
                         f"{busy / 1e6 / wall_plain:.1%} of the unprofiled "
                         f"wall; top device events in e2e_profile.txt")
    return res


def phase_e2e(dev, genome_bp: int, n_pairs: int, card: str, work: str,
              out_dir: str, profile: bool = True) -> dict:
    """The port's `pair` CLI on ``dev`` over a seeded genome of
    ``genome_bp`` and ``n_pairs`` read pairs; checks records,
    planted-locus recall, rescue counts and DP kernel launches."""
    import contextlib
    import re

    from soap3dp_tpu.index.builder import build_index, load_index, save_index
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.cli.main import main as cli_main
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(20261016)
    genome = workloads.random_genome(rng, genome_bp, name="chr1")
    idx_path = os.path.join(work, f"genome_{genome_bp}.t3i")
    t0 = time.perf_counter()
    if os.path.exists(os.path.join(idx_path, "meta.json")):
        lut_k = load_index(idx_path).lut_k
        how = "cached"
    else:
        index = build_index(genome, sa_rate=2,
                            lut_k=13 if genome_bp >= 1_000_000 else None)
        lut_k = index.lut_k
        save_index(index, idx_path)
        del index
        how = "built"
    build_s = time.perf_counter() - t0
    r1, r2 = os.path.join(work, "r1.fq"), os.path.join(work, "r2.fq")
    p1, p2, rand = workloads.make_pe_fastq(rng, genome.codes, n_pairs, r1, r2)
    del genome
    phase("e2e setup", f"{genome_bp} bp genome, index {how} in {build_s:.1f}s "
                       f"(sa_rate=2, lut_k={lut_k}), "
                       f"{n_pairs} pairs of 100 bp written")

    out = os.path.join(work, "out")
    argv = ["pair", idx_path, r1, r2, "-u", "500", "-v", "300", "-o", out,
            "--device", str(dev)]
    tee = _Tee(sys.stderr)
    bd.DP_KERNEL.launches = 0  # count only the main path's launches
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        rc = cli_main(argv)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bd.DP_KERNEL.launches
    log = tee.text()
    with open(os.path.join(out_dir, "e2e_stderr.log"), "w") as fh:
        fh.write(log)
    if rc != 0:
        fail(f"the pair CLI exited {rc}")

    # every read has a record; recall of the primary records
    seen = np.zeros((2, n_pairs), bool)
    hit = np.zeros((2, n_pairs), bool)
    with open(out + ".sam") as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.split("\t", 4)
            flag = int(f[1])
            end = 0 if flag & 0x40 else 1
            r = int(f[0][1:])
            seen[end, r] = True
            if flag & 0x904:  # unmapped, secondary or supplementary
                continue
            planted = (p1 if end == 0 else p2)[r]
            hit[end, r] |= abs(int(f[3]) - int(planted)) <= 20
    if not seen.all():
        fail(f"{int((~seen).sum())} reads have no SAM record")
    recall = float(hit[~rand].mean())
    m = re.search(r"done: PairSummary\(([^)]*)\)", log)
    if m is None:
        fail("no run summary on stderr")
    summ = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m.group(1))}
    up = re.search(r"uploaded to \S+ in ([0-9.]+)s", log)
    load = re.search(r"index loaded in ([0-9.]+)s", log)
    batches = [float(x) for x in re.findall(r"BWT-paired \(([0-9.]+)s\)", log)]
    reads = 2 * n_pairs
    setup_s = float(load.group(1)) + float(up.group(1))
    res = {"reads": reads, "wall_s": wall, "reads_per_s": reads / wall,
           "reads_per_s_after_load": reads / max(wall - setup_s, 1e-9),
           "index_build_s": build_s, "index_load_s": float(load.group(1)),
           "index_upload_s": float(up.group(1)), "batch_s": batches,
           "recall": recall, "dp_launches": launches, "summary": summ,
           "card": card}
    phase("e2e", f"{reads} reads in {wall:.2f}s = {reads / wall:.0f} reads/s "
                 f"({res['reads_per_s_after_load']:.0f} after index load "
                 f"{res['index_load_s']:.2f}s + upload "
                 f"{res['index_upload_s']:.2f}s); batches {batches} s; "
                 f"recall {recall:.4f}; dp launches {launches}; {summ}; "
                 f"card: {card}")
    if recall < 0.95:
        fail(f"planted-locus recall {recall:.4f} < 0.95")
    if summ.get("paired_dp", 0) <= 0 or summ.get("single_rescued", 0) <= 0:
        fail("the rescue phases produced no DP-paired or salvaged reads")
    if launches <= 0 and dev.type == "cuda":
        fail("the main path never launched the banded DP kernel")
    if profile:
        res["profile"] = _profiled_pass(
            cli_main, argv[:-3] + [out + "_prof"] + argv[-2:], wall, out_dir)
    return res


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "one CUDA card")
    try:
        from soap3dp_tpu_torch.kernels import banded_dp as bd
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the root "
             "of a checkout")
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind} | torch {torch.__version__} cuda "
                    f"{torch.version.cuda} | nvidia-smi: {card}")

    t0 = time.perf_counter()
    bd.DP_KERNEL.function()
    phase("build", f"banded_dp.cu built and loaded in "
                   f"{time.perf_counter() - t0:.2f}s "
                   f"(nvcc {bd.DP_KERNEL.build_seconds:.2f}s)")
    with open(os.path.join(OUT_DIR, "nvcc_banded_dp.log"), "w") as fh:
        fh.write(bd.DP_KERNEL.build_log)
    for line in bd.DP_KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            phase("ptxas", line.strip())

    kernels = phase_kernels(dev)
    phase_golden(dev)
    e2e = phase_e2e(dev, 250_000_000, 100_000, card,
                    os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e"),
                    OUT_DIR)
    kernels[0]["launches"] = e2e["dp_launches"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": kernels, "e2e": e2e}, fh,
                  indent=1)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "cases"} for r in kernels]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
