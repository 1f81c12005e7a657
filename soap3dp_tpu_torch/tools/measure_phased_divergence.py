"""A/B the phased BWT search against the single-phase search: the
port's copy of parse_records, run_ab and divergence from the repo's
tools/measure_phased_divergence.py, over soap3dp_tpu_torch's pipeline.

The phased scheme (segments {0,1} first, escalate unresolved pairs;
pipeline/pair.py _phase1_range, the analog of the reference's staged
phases in alignment.cu:1119-1236) can resolve a pair in phase 1 with a
complete best-score hit set but an INCOMPLETE suboptimal set, so X1 can
undercount and MAPQ can read high for phase-1-resolved pairs. run_ab
aligns the same pairs with phased_search on and off and divergence
counts the records that differ in each SAM field.

Usage (on a CUDA card unless ``--device cpu``; phasing engages on
indexes whose LUT leaves segments to search, so not on LUT-only ones):

  python -m soap3dp_tpu_torch.tools.measure_phased_divergence \
      [n_pairs=100000] [--device cuda] [--genome-bp 250000000] [--lut-k 13]

aligns ``n_pairs`` pairs of make_pairs (the JAX package's bench.py
pairs: insert 400, 0.5% substitutions, numpy seed 17) over
seed_sensitivity.bench_genome's genome, indexed at sa_rate 2, and
prints a JSON line with the divergence rates.
tests/test_torch_phased.py drives these functions on the CPU against
the JAX package's.
"""

from __future__ import annotations

import argparse
import io
import json
import sys

import numpy as np

from soap3dp_tpu_torch.io.fastq import ReadBatch
from soap3dp_tpu_torch.io.sam import SamWriter
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.pipeline.pair import (Phase2Queue, RescueQueue,
                                             align_pair_batch,
                                             dispatch_pair_search)


def parse_records(sam_bytes: bytes) -> dict:
    """(qname, end) -> (pos, mapq, cigar, flag, X0, X1, XA)."""
    recs = {}
    for line in sam_bytes.decode().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        tags = dict(t.split(":", 2)[::2] for t in f[11:])
        key = (f[0], int(f[1]) & 0xC0)
        recs[key] = {
            "pos": int(f[3]), "mapq": int(f[4]), "cigar": f[5],
            "flag": int(f[1]), "x0": tags.get("X0"), "x1": tags.get("X1"),
            "xa": tags.get("XA"),
        }
    return recs


def run_ab(index, didx, b1, b2, opts_kw: dict) -> tuple[dict, dict]:
    """Align the same batch twice (phased on/off); return both record
    maps. Runs on the device of ``didx``."""
    out = {}
    for phased in (True, False):
        opts = AlignOptions(phased_search=phased, **opts_kw)
        buf = io.BytesIO()
        w = SamWriter(buf, index)
        rq = RescueQueue(index, didx, opts)
        p2q = Phase2Queue(index, didx, opts)
        pend = dispatch_pair_search(didx, b1, b2, opts)
        align_pair_batch(index, didx, b1, b2, opts, w,
                         pending_search=pend, rescue_queue=rq,
                         phase2_queue=p2q)
        p2q.process(w, rq)
        rq.flush(w)
        out[phased] = parse_records(buf.getvalue())
    return out[True], out[False]


def divergence(a: dict, b: dict) -> dict:
    keys = set(a) | set(b)
    n = max(len(keys), 1)
    miss = sum(1 for k in keys if k not in a or k not in b)
    fields = ("pos", "mapq", "cigar", "flag", "x0", "x1", "xa")
    diff = {f: 0 for f in fields}
    any_diff = 0
    for k in keys:
        if k not in a or k not in b:
            any_diff += 1
            continue
        d = False
        for f in fields:
            if a[k][f] != b[k][f]:
                diff[f] += 1
                d = True
        any_diff += d
    return {
        "records": len(keys), "missing_either": miss,
        "any_field_rate": round(any_diff / n, 6),
        **{f + "_rate": round(diff[f] / n, 6) for f in fields},
    }


READ_LEN = 100
INSERT = 400


def _sample_positions(rng, n_pos: int, hi: int, excluded) -> np.ndarray:
    """Insert start positions in [0, hi), resampled off excluded (N-run)
    spans: real reads never originate from assembly gaps."""
    pos = rng.integers(0, hi, n_pos)
    if excluded is None or not len(excluded[0]):
        return pos
    starts, ends = excluded
    for _ in range(64):
        # insert [pos, pos+INSERT) overlaps run i iff
        # starts[i] < pos+INSERT and ends[i] > pos
        i = np.searchsorted(ends, pos, side="right")
        bad = (i < len(starts)) & (starts[np.minimum(i, len(starts) - 1)]
                                   < pos + INSERT)
        nbad = int(bad.sum())
        if not nbad:
            break
        pos[bad] = rng.integers(0, hi, nbad)
    return pos


def make_pairs(codes, n_pairs, rng, excluded=None):
    """(end 1, end 2) ReadBatches of ``n_pairs`` pairs: READ_LEN-base
    ends of INSERT-base inserts, +/- strands, ~0.5% substitutions."""
    n = len(codes)
    pos = _sample_positions(rng, n_pairs, n - INSERT - 1, excluded)
    idx = pos[:, None] + np.arange(READ_LEN)
    left = np.asarray(codes)[idx]
    ridx = (pos + INSERT - READ_LEN)[:, None] + np.arange(READ_LEN)
    right = (3 - np.asarray(codes)[ridx])[:, ::-1]
    for mat in (left, right):
        mask = rng.random(mat.shape) < 0.005
        mat[mask] = (mat[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
    lens = np.full(n_pairs, READ_LEN, np.int32)
    names = [b"p%d" % i for i in range(n_pairs)]
    b1 = ReadBatch(names=names, codes=np.ascontiguousarray(left), lens=lens,
                   quals=None)
    b2 = ReadBatch(names=names, codes=np.ascontiguousarray(right),
                   lens=lens.copy(), quals=None)
    return b1, b2


def main(argv=None) -> int:
    from soap3dp_tpu_torch.cli.runner import resolve_device
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.tools.seed_sensitivity import bench_genome

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_pairs", nargs="?", type=int, default=100_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:K or cpu")
    ap.add_argument("--genome-bp", type=int, default=250_000_000)
    ap.add_argument("--lut-k", type=int, default=13,
                    help="the index's LUT k (13, the JAX tool's index)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    genome = bench_genome(a.genome_bp)
    index = build_index(genome, sa_rate=2, lut_k=a.lut_k)
    didx = device_index(index, dev)
    b1, b2 = make_pairs(genome.codes, a.n_pairs, np.random.default_rng(17))
    ra, rb = run_ab(index, didx, b1, b2,
                    dict(min_insert=INSERT // 2, max_insert=INSERT * 2,
                         soap3_mismatch_allow=3))
    print(json.dumps({"n_pairs": a.n_pairs, **divergence(ra, rb)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
