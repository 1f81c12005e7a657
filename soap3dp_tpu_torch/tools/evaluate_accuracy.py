"""End-to-end alignment accuracy on simulated paired-end reads: the
port's copy of the repo's tools/evaluate_accuracy.py, driving
soap3dp_tpu_torch's pair pipeline.

Simulates reads from a genome with substitution SNPs, small indels and
Q30-equivalent sequencing errors, runs the FULL pair pipeline (seed
search, pairing, rescue phases B-E, host re-align, MAPQ: the path
`soap3dp-torch pair` drives) on the device of the DeviceIndex it is
given, and reports:

  - recall: fraction of read ends whose primary records land on the
    planted locus (+/- a small indel tolerance)
  - wrong-by-MAPQ: misplacement counts per MAPQ bucket (calibration:
    high-MAPQ records should essentially never be wrong; the
    reference's BWA-like scores have the same contract,
    BGS-IO.cpp:2415-2463)
  - unaligned / still-flagged counts

Usage (on a CUDA card unless ``--device cpu``):

  python -m soap3dp_tpu_torch.tools.evaluate_accuracy [n_pairs=20000] \
      [sub_rate=0.01] [indel_rate=0.001] [genome_mbp=5] [lut_k=13] \
      [--hg] [--device cuda]

``--hg`` aligns against the repeat-structured genome of
tools/repeat_genome.py, generated in process at ``genome_mbp``; without
it the genome is uniform random. The JAX package's cached 3.1 Gbp
index (its bench.py) has no counterpart here.

tests/test_torch_accuracy.py holds this harness to the JAX package's
at fixed seeds, result dict for result dict, with the same gates.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from soap3dp_tpu_torch.io.fastq import ReadBatch
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.pipeline.pair import (RescueQueue, align_pair_batch,
                                             dispatch_pair_search)


def simulate_pairs(codes: np.ndarray, n_pairs: int, read_len: int,
                   insert: int, sub_rate: float, indel_rate: float,
                   rng: np.random.Generator, excluded=None):
    """Returns (left, right, lens, true_pos1, true_pos2).

    Mutations model a diploid-ish donor: per-base substitutions at
    sub_rate, and per-read single 1-3bp indels at indel_rate, plus
    Q30-equivalent sequencing errors (1e-3) on top.
    """
    n = len(codes)
    L = read_len
    pos = rng.integers(0, n - insert - 1, n_pairs)
    if excluded is not None and len(excluded[0]):
        # real reads never come from assembly gaps (N runs): reject
        # inserts overlapping an excluded region and resample
        starts, ends = excluded
        for _ in range(64):
            i = np.searchsorted(ends, pos, side="right")
            bad = (i < len(starts)) & (
                starts[np.minimum(i, len(starts) - 1)] < pos + insert)
            nb = int(bad.sum())
            if not nb:
                break
            pos[bad] = rng.integers(0, n - insert - 1, nb)
    left = np.empty((n_pairs, L), np.uint8)
    right = np.empty((n_pairs, L), np.uint8)
    tp1 = pos.copy()
    tp2 = pos + insert - L
    for i in range(n_pairs):
        p = int(pos[i])
        seg = np.array(codes[p:p + insert], np.uint8)
        left[i] = seg[:L]
        right[i] = (3 - seg[insert - L:][::-1])

    def mutate(reads: np.ndarray) -> None:
        # substitutions (donor SNPs + sequencing error)
        rate = sub_rate + 1e-3
        m = rng.random(reads.shape) < rate
        reads[m] = (reads[m] + rng.integers(1, 4, int(m.sum()))) % 4
        # single small indel per selected read: delete d bases mid-read
        # and shift (read tail refills from noise — conservative: the
        # aligner must recover the locus from the intact prefix/suffix)
        sel = np.flatnonzero(rng.random(len(reads)) < indel_rate)
        for i in sel:
            d = int(rng.integers(1, 4))
            at = int(rng.integers(10, reads.shape[1] - 10 - d))
            reads[i, at:-d] = reads[i, at + d:].copy()
            reads[i, -d:] = rng.integers(0, 4, d)

    mutate(left)
    mutate(right)
    lens = np.full(n_pairs, L, np.int32)
    return left, right, lens, tp1, tp2


def run_eval(codes: np.ndarray, index, didx, n_pairs: int,
             sub_rate: float, indel_rate: float, read_len: int = 100,
             insert: int = 300, tol: int = 8, seed: int = 7,
             excluded=None, all_records: list | None = None) -> dict:
    """The harness's result dict. With ``all_records`` (a list), every
    record the pipeline writes is appended there as (qname, flag, chrom,
    pos, mapq, CIGAR, mate chrom, mate pos, TLEN, tags), its tags built,
    so two runs can be held to each other record for record; the dict
    is the same either way."""
    rng = np.random.default_rng(seed)
    left, right, lens, tp1, tp2 = simulate_pairs(
        codes, n_pairs, read_len, insert, sub_rate, indel_rate, rng,
        excluded=excluded)
    names = np.array([b"e%07d" % i for i in range(n_pairs)])
    b1 = ReadBatch(names=names, codes=left, lens=lens, quals=None)
    b2 = ReadBatch(names=names, codes=right, lens=lens.copy(), quals=None)
    opts = AlignOptions(min_insert=insert // 2, max_insert=insert * 2,
                        soap3_mismatch_allow=3)

    records = []  # (pair_idx, is_first, GLOBAL pos, mapq, flag)
    # record positions are chromosome-local; truth positions live in the
    # concatenated coordinate space — translate back through offsets
    # (single-chromosome genomes masked this before the multi-chromosome
    # repeat genome existed)
    offs = np.asarray(index.offsets, np.int64)

    class Collect:
        needs_seq = False
        needs_tags = all_records is not None

        def write(self, rec):
            if all_records is not None:
                all_records.append((
                    bytes(rec.qname), int(rec.flag), int(rec.chrom),
                    int(rec.pos), int(rec.mapq), rec.cigar,
                    int(rec.mate_chrom), int(rec.mate_pos), int(rec.tlen),
                    tuple(rec.tags)))
            if rec.flag & 0x4:
                return
            records.append((int(rec.qname[1:]), bool(rec.flag & 0x40),
                            int(offs[rec.chrom]) + rec.pos, rec.mapq,
                            rec.flag))

        def write_block(self, names_, flags, chroms, poss, mapqs, cigars,
                        nms, **kw):
            if all_records is not None:
                # as write() would see each record (SamWriter.write_block's
                # CIGAR and tags)
                tags = kw.get("tags")
                for j in range(len(names_)):
                    all_records.append((
                        bytes(names_[j]), int(flags[j]), int(chroms[j]),
                        int(poss[j]), int(mapqs[j]),
                        cigars[j] if cigars is not None
                        else f"{int(kw['seq_lens'][j])}M",
                        int(kw["mate_chroms"][j]), int(kw["mate_poss"][j]),
                        int(kw["tlens"][j]),
                        () if tags is None else (
                            f"X0:i:{int(tags[0][j])}",
                            f"X1:i:{int(tags[1][j])}",
                            f"XM:i:{int(tags[2][j])}", "XO:i:0", "XG:i:0")))
            for j in range(len(names_)):
                f = int(flags[j])
                if f & 0x4:
                    continue
                records.append((int(bytes(names_[j])[1:]), bool(f & 0x40),
                                int(offs[int(chroms[j])]) + int(poss[j]),
                                int(mapqs[j]), f))

    out = Collect()
    rq = RescueQueue(index, didx, opts)
    # same dispatch path as the CLI (phased search where the index
    # qualifies; pass a small lut_k to exercise it on a small genome)
    pend = dispatch_pair_search(didx, b1, b2, opts)
    summary = align_pair_batch(index, didx, b1, b2, opts, out,
                               pending_search=pend, rescue_queue=rq)
    summary.add(rq.flush(out))

    # primary record per (pair, end): first occurrence (phases emit
    # primary before XA-style extras; Collect sees only main records)
    best = {}
    for pid, is_first, pos_, mq, f in records:
        key = (pid, is_first)
        if key not in best:
            best[key] = (pos_, mq)
    buckets = [(0, 0), (1, 9), (10, 29), (30, 255)]
    stats = {f"mapq{lo}-{hi}": [0, 0] for lo, hi in buckets}
    found = wrong = missing = 0
    for pid in range(n_pairs):
        for is_first, want in ((True, tp1[pid]), (False, tp2[pid])):
            got = best.get((pid, is_first))
            if got is None:
                missing += 1
                continue
            pos_, mq = got
            okp = abs(int(pos_) - int(want)) <= tol
            found += okp
            wrong += not okp
            for lo, hi in buckets:
                if lo <= mq <= hi:
                    s = stats[f"mapq{lo}-{hi}"]
                    s[0] += okp
                    s[1] += not okp
    n_ends = 2 * n_pairs
    hi = stats["mapq30-255"]
    return {
        "n_ends": n_ends,
        "recall": found / n_ends,
        "wrong": wrong / n_ends,
        "unaligned": missing / n_ends,
        # the calibration contract: high-MAPQ records are ~never wrong
        # (BGS-IO.cpp:2415-2463); on repeat genomes overall `wrong`
        # includes legitimately ambiguous low-MAPQ placements
        "mapq30_wrong_rate": (hi[1] / max(hi[0] + hi[1], 1)),
        "mapq_buckets": {k: {"right": v[0], "wrong": v[1]}
                         for k, v in stats.items()},
        "still_flagged": int(getattr(summary, "still_flagged", 0)),
        "capped_anchors": int(getattr(summary, "capped_anchors", 0)),
        "summary": str(summary),
    }


def excluded_runs(genome) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the genome's N runs longer than 10 bp, the
    regions simulate_pairs keeps inserts out of."""
    st = genome.amb_starts.astype(np.int64)
    ln = genome.amb_lengths.astype(np.int64)
    keep = ln > 10
    return st[keep], st[keep] + ln[keep]


def main(argv=None) -> int:
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.cli.runner import resolve_device
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_pairs", nargs="?", type=int, default=20_000)
    ap.add_argument("sub_rate", nargs="?", type=float, default=0.01)
    ap.add_argument("indel_rate", nargs="?", type=float, default=0.001)
    ap.add_argument("genome_mbp", nargs="?", type=float, default=5)
    ap.add_argument("lut_k", nargs="?", type=int, default=13)
    ap.add_argument("--hg", action="store_true",
                    help="the repeat-structured genome, generated in process")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:K or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    excluded = None
    n = int(a.genome_mbp * 1e6)
    if a.hg:
        from soap3dp_tpu_torch.tools import repeat_genome
        genome = repeat_genome.generate(n, seed=5)
        excluded = excluded_runs(genome)
    else:
        genome = workloads.random_genome(np.random.default_rng(3), n,
                                         name="chr1")
    index = build_index(genome, sa_rate=2, lut_k=a.lut_k)
    didx = device_index(index, dev)
    res = run_eval(genome.codes, index, didx, a.n_pairs, a.sub_rate,
                   a.indel_rate, excluded=excluded)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
