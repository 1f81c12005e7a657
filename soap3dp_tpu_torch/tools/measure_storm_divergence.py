"""A/B the storm-skip gate against complete host re-alignment: the
port's copy of the repo's tools/measure_storm_divergence.py, over
soap3dp_tpu_torch's pair pipeline.

The storm detector (`host_realign_budget`, default 256/batch,
fm/host_search.py) skips a whole batch's host re-alignment when more
reads flag than the budget: a deliberate divergence from the
reference, which completes every read under per-read occurrence caps
(CPUfunctions.cpp:1287-1299). This tool quantifies what that skip
changes: the same pairs are aligned twice, default vs
SOAP3DP_HOST_REALIGN_FULL=1 (unbounded complete enumeration), and the
primary records are diffed end by end on pos/flag/MAPQ plus the
per-end record count (XA-style extra emissions).

Reads are drawn in two pools: uniform over the genome, and a
repeat-enriched pool (inserts whose distinct-8mer fraction is in the
lowest quartile of a large sample: satellite/STR text), so the gate
is measured exactly where it fires.

Usage (on a CUDA card unless ``--device cpu``):

  python -m soap3dp_tpu_torch.tools.measure_storm_divergence \
      [n_pairs_per_pool=50000] [--hg | genome_mbp=8] [--device cuda] \
      [--lut-k 13]

The genome is tools/repeat_genome.py's, generated in process: at
``genome_mbp`` with seed 5, or with ``--hg`` at the human scale
(3.1 Gbp, the generator's default seed), which also writes the result
to STORM_DIVERGENCE_torch.json at the repo root.

tests/test_torch_storm_divergence.py holds this tool to the JAX
package's at fixed seeds, dict for dict and record map for record map.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from soap3dp_tpu_torch.io.fastq import ReadBatch

READ_LEN = 100
INSERT = 300
HUMAN_BP = 3_100_000_000
FULL_ENV = "SOAP3DP_HOST_REALIGN_FULL"  # read by fm/host_search.py


def _distinct_kmer_frac(codes: np.ndarray, pos: np.ndarray, k: int = 8,
                        span: int = INSERT) -> np.ndarray:
    """Fraction of distinct k-mers in each [pos, pos+span) window."""
    out = np.empty(len(pos), np.float32)
    mult = 4 ** np.arange(k, dtype=np.int64)
    for i, p in enumerate(pos):
        w = codes[p:p + span].astype(np.int64)
        # codes < 4, k = 8: values < 4^8
        km = np.convolve(w, mult, "valid")[: span - k + 1]
        out[i] = len(np.unique(km)) / len(km)
    return out


def sample_pools(codes: np.ndarray, n_per_pool: int, rng, excluded):
    """(uniform_pos, repeat_pos, distinct-8mer cut): repeat pool = the
    lowest-diversity quartile."""
    n = len(codes)

    def draw(n_pos):
        pos = rng.integers(0, n - INSERT - 1, n_pos)
        if excluded is not None and len(excluded[0]):
            starts, ends = excluded
            for _ in range(64):
                i = np.searchsorted(ends, pos, side="right")
                bad = (i < len(starts)) & (
                    starts[np.minimum(i, len(starts) - 1)] < pos + INSERT)
                nb = int(bad.sum())
                if not nb:
                    break
                pos[bad] = rng.integers(0, n - INSERT - 1, nb)
        return pos

    uni = draw(n_per_pool)
    # oversample, keep the least diverse quartile (satellite/STR text)
    cand = draw(4 * n_per_pool)
    div = _distinct_kmer_frac(codes, cand)
    order = np.argsort(div, kind="stable")
    rep = cand[order[:n_per_pool]]
    return uni, rep, float(div[order[n_per_pool - 1]])


def make_batches(codes, pos, rng):
    n = len(pos)
    L = READ_LEN
    left = np.empty((n, L), np.uint8)
    right = np.empty((n, L), np.uint8)
    for i, p in enumerate(pos):
        seg = np.asarray(codes[p:p + INSERT], np.uint8)
        left[i] = seg[:L]
        right[i] = 3 - seg[INSERT - L:][::-1]
    # 1% donor SNPs + Q30 sequencing error, like the accuracy harness
    for reads in (left, right):
        m = rng.random(reads.shape) < 0.011
        reads[m] = (reads[m] + rng.integers(1, 4, int(m.sum()))) % 4
    names = np.array([b"s%07d" % i for i in range(n)])
    lens = np.full(n, L, np.int32)
    return (ReadBatch(names=names, codes=left, lens=lens, quals=None),
            ReadBatch(names=names, codes=right, lens=lens.copy(),
                      quals=None))


class Collect:
    needs_seq = False
    needs_tags = False

    def __init__(self):
        self.primary = {}   # (pid, is_first) -> (pos, flag, mapq)
        self.counts = {}    # (pid, is_first) -> records emitted

    def _add(self, qname, flag, pos, mapq):
        pid = int(qname[1:])
        key = (pid, bool(flag & 0x40))
        self.counts[key] = self.counts.get(key, 0) + 1
        if key not in self.primary:
            self.primary[key] = (int(pos), int(flag), int(mapq))

    def write(self, rec):
        self._add(rec.qname, rec.flag, rec.pos if not (rec.flag & 0x4) else -1,
                  rec.mapq)

    def write_block(self, names_, flags, chroms, poss, mapqs, cigars,
                    nms, **kw):
        for j in range(len(names_)):
            f = int(flags[j])
            self._add(bytes(names_[j]), f,
                      int(poss[j]) if not (f & 0x4) else -1, int(mapqs[j]))


def align_once(index, didx, b1, b2) -> tuple[Collect, float, object]:
    from soap3dp_tpu_torch.pipeline.options import AlignOptions
    from soap3dp_tpu_torch.pipeline.pair import (RescueQueue,
                                                 align_pair_batch,
                                                 dispatch_pair_search)

    opts = AlignOptions(min_insert=INSERT // 2, max_insert=INSERT * 2,
                        soap3_mismatch_allow=3)
    out = Collect()
    t0 = time.time()
    rq = RescueQueue(index, didx, opts)
    pend = dispatch_pair_search(didx, b1, b2, opts)
    summary = align_pair_batch(index, didx, b1, b2, opts, out,
                               pending_search=pend, rescue_queue=rq)
    summary.add(rq.flush(out))
    return out, time.time() - t0, summary


def diff(a: Collect, b: Collect, n_pairs: int) -> dict:
    """Per-end divergence between default (a) and full-realign (b)."""
    pos_diff = flag_diff = mapq_diff = cnt_diff = 0
    a_unmapped = b_unmapped = both = 0
    for pid in range(n_pairs):
        for is_first in (True, False):
            key = (pid, is_first)
            pa = a.primary.get(key)
            pb = b.primary.get(key)
            if pa is None or pb is None:
                continue
            both += 1
            am, bm = bool(pa[1] & 0x4), bool(pb[1] & 0x4)
            a_unmapped += am
            b_unmapped += bm
            if pa[0] != pb[0]:
                pos_diff += 1
            if pa[1] != pb[1]:
                flag_diff += 1
            if pa[2] != pb[2]:
                mapq_diff += 1
            if a.counts.get(key, 0) != b.counts.get(key, 0):
                cnt_diff += 1
    n_ends = 2 * n_pairs
    return {
        "n_ends": n_ends,
        "pos_diff": pos_diff, "pos_diff_rate": pos_diff / n_ends,
        "flag_diff": flag_diff, "flag_diff_rate": flag_diff / n_ends,
        "mapq_diff": mapq_diff, "mapq_diff_rate": mapq_diff / n_ends,
        "record_count_diff": cnt_diff,
        "record_count_diff_rate": cnt_diff / n_ends,
        "unmapped_default": a_unmapped, "unmapped_full": b_unmapped,
    }


def run(index, codes, excluded, n_per_pool: int, seed: int = 11,
        didx=None, device=None) -> dict:
    """Both pools, each aligned in both arms (default, then
    SOAP3DP_HOST_REALIGN_FULL=1) on ``didx`` (default: ``index``
    uploaded to ``device``); the variable is removed after each arm,
    also when it raises. After each arm a ``[storm-ab] pool/arm:`` line
    (its wall and PairSummary) goes to stderr, after the arm's own
    lines."""
    if didx is None:
        from soap3dp_tpu_torch.fm.fmindex import device_index
        didx = device_index(index, device)
    rng = np.random.default_rng(seed)
    uni, rep, div_cut = sample_pools(codes, n_per_pool, rng, excluded)
    print(f"[storm-ab] pools drawn: {n_per_pool} uniform + {n_per_pool} "
          f"repeat-enriched (distinct-8mer frac <= {div_cut:.3f})",
          file=sys.stderr)
    out = {"n_per_pool": n_per_pool, "div_cut": div_cut}
    for pool, pos in (("uniform", uni), ("repeat", rep)):
        b1, b2 = make_batches(codes, pos, rng)
        res = {}
        for mode in ("default", "full"):
            os.environ.pop(FULL_ENV, None)
            if mode == "full":
                os.environ[FULL_ENV] = "1"
            try:
                col, dt, summary = align_once(index, didx, b1, b2)
            finally:
                os.environ.pop(FULL_ENV, None)
            res[mode] = (col, dt)
            print(f"[storm-ab] {pool}/{mode}: {dt:.1f}s  {summary}",
                  file=sys.stderr)
        d = diff(res["default"][0], res["full"][0], n_per_pool)
        d["time_default_s"] = round(res["default"][1], 2)
        d["time_full_s"] = round(res["full"][1], 2)
        out[pool] = d
        print(f"[storm-ab] {pool}: pos {d['pos_diff_rate']:.5f} "
              f"flag {d['flag_diff_rate']:.5f} mapq {d['mapq_diff_rate']:.5f} "
              f"records {d['record_count_diff_rate']:.5f} "
              f"({d['time_default_s']}s vs {d['time_full_s']}s)",
              file=sys.stderr)
    return out


def main(argv=None) -> int:
    from soap3dp_tpu_torch.cli.runner import resolve_device
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.tools import repeat_genome
    from soap3dp_tpu_torch.tools.evaluate_accuracy import excluded_runs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_per_pool", nargs="?", type=int, default=50_000)
    ap.add_argument("genome_mbp", nargs="?", type=float, default=8)
    ap.add_argument("--hg", action="store_true",
                    help="the 3.1 Gbp repeat genome, generated in process")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:K or cpu")
    ap.add_argument("--lut-k", type=int, default=13,
                    help="the index's LUT k (13, as the JAX tool builds)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    if a.hg:
        genome = repeat_genome.generate(HUMAN_BP)
    else:
        genome = repeat_genome.generate(int(a.genome_mbp * 1e6), seed=5)
    excluded = excluded_runs(genome)
    index = build_index(genome, sa_rate=2, lut_k=a.lut_k)
    result = run(index, genome.codes, excluded, a.n_per_pool,
                 didx=device_index(index, dev))
    print(json.dumps(result, indent=1))
    if a.hg:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        with open(os.path.join(root, "STORM_DIVERGENCE_torch.json"),
                  "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
