"""Seeded synthetic paired-end workloads (numpy only, no JAX).

* ``make_tiny_pair_workload``: the reference's tiny PE workload
  (__graft_entry__.make_tiny_pair_workload) that drives every pipeline
  phase: clean pairs (A), one-end indels (B/C half rescue), both-end
  indels (D deep DP), one garbage end (E salvage), random pairs.
* ``golden_pair_workload`` / ``golden_single_workload``: the data of the
  golden SAM cases (tests/test_golden_sam.py ``_workload``), with
  ``GOLDEN_PAIR_CASES`` and ``GOLDEN_SINGLE_CASES``.
* ``make_pe_fastq``: a genome and FASTQ pair at a realistic size for
  end-to-end runs, with the same class mix and the planted loci; the
  library's orientation and insert distribution are parameters (a
  paired-end +/- library, or a -/+ mate-pair library of 2-6 kbp).
"""

from __future__ import annotations

import numpy as np

from soap3dp_tpu_torch.index.packing import PackedGenome
from soap3dp_tpu_torch.utils import dna

GOLDEN_PAIR_CASES = [
    ("pair_h1_md", dict(output_mode=1, output_md=True)),
    ("pair_h2", dict(output_mode=2)),
    ("pair_h3", dict(output_mode=3)),
    ("pair_h4", dict(output_mode=4)),
    ("pair_h2_k4", dict(output_mode=2, mismatches=4, plant4=True)),
]
GOLDEN_SINGLE_CASES = [
    ("single_h2_md", dict(output_mode=2, output_md=True)),
    ("single_h1", dict(output_mode=1)),
]


def random_genome(rng: np.random.Generator, genome_bp: int,
                  name: str = "chrT") -> PackedGenome:
    codes = rng.integers(0, 4, genome_bp).astype(np.uint8)
    return PackedGenome(
        codes=codes, pac=dna.pack_codes(codes), length=genome_bp,
        names=[name], offsets=np.asarray([0, genome_bp], np.uint64),
        amb_starts=np.zeros(0, np.uint64), amb_lengths=np.zeros(0, np.uint64))


def make_tiny_pair_workload(genome_bp: int = 120_000, n_pairs: int = 48,
                            read_len: int = 64, insert: int = 200,
                            seed: int = 0):
    """(index, batch1, batch2, options): every pipeline phase fires."""
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.io.fastq import ReadBatch
    from soap3dp_tpu_torch.pipeline.options import AlignOptions

    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_bp)
    codes = genome.codes
    index = build_index(genome, sa_rate=4, lut_k=8)

    def indel(read):
        out = np.concatenate([read[:20], read[23:],
                              rng.integers(0, 4, 3).astype(np.uint8)])
        return out[:read_len]

    pos = rng.integers(0, genome_bp - insert - 1, n_pairs)
    left = np.stack([codes[p:p + read_len] for p in pos])
    right = np.stack([(3 - codes[p + insert - read_len:p + insert])[::-1]
                      for p in pos])
    for i in range(n_pairs):
        cls = i % 6
        if cls == 2:
            right[i] = indel(right[i])
        elif cls == 3:
            left[i] = indel(left[i])
            right[i] = indel(right[i])
        elif cls == 4:
            left[i] = rng.integers(0, 4, read_len)
            right[i] = indel(right[i])
        elif cls == 5:
            left[i] = rng.integers(0, 4, read_len)
            right[i] = rng.integers(0, 4, read_len)
    lens = np.full(n_pairs, read_len, np.int32)
    names = [b"p%d" % i for i in range(n_pairs)]
    b1 = ReadBatch(names=names, codes=np.ascontiguousarray(left),
                   lens=lens, quals=None)
    b2 = ReadBatch(names=names, codes=np.ascontiguousarray(right),
                   lens=lens.copy(), quals=None)
    opts = AlignOptions(min_insert=insert // 2, max_insert=insert * 2)
    return index, b1, b2, opts


def golden_pair_workload(plant4: bool = False):
    """(index, batch1, batch2) of the golden SAM cases."""
    index, b1, b2, _ = make_tiny_pair_workload(
        genome_bp=100_000, n_pairs=36, read_len=64, insert=200, seed=12)
    if plant4:
        # 4 substitutions spread over all 5 pigeonhole segments
        for b in (b1, b2):
            for i in range(12):
                for off in (7, 21, 38, 55):
                    b.codes[i, off] = (b.codes[i, off] + 1 + off % 3) % 4
    L = b1.codes.shape[1]
    q = (33 + 5 + (np.arange(L, dtype=np.uint8) % 36))[None, :]
    b1.quals = np.repeat(q, len(b1), axis=0)
    b2.quals = np.repeat(q[:, ::-1], len(b2), axis=0)
    return index, b1, b2


def golden_single_workload():
    """(index, batch) of the single-end golden SAM cases: end 1 of the
    paired golden workload."""
    index, b1, _ = golden_pair_workload()
    return index, b1


def golden_options(case: dict):
    from soap3dp_tpu_torch.pipeline.options import AlignOptions

    return AlignOptions(min_insert=100, max_insert=400,
                        output_mode=case["output_mode"],
                        output_md=case.get("output_md", False),
                        soap3_mismatch_allow=case.get("mismatches", 3),
                        random_seed=7)


def make_pe_fastq(rng: np.random.Generator, codes: np.ndarray, n_pairs: int,
                  path1: str, path2: str, read_len: int = 100,
                  insert: int = 400, sub_rate: float = 0.005,
                  orientation: str = "+/-", insert_sd: float = 0.0,
                  insert_range: tuple[int, int] | None = None):
    """Write a FASTQ pair sampled from ``codes``; returns (planted
    1-based leftmost position of end 1 and end 2, (2, n_pairs) mask of
    the random ends).

    End 1 is the leftmost leg. ``orientation`` is the ini's
    StrandArrangement: the strands of the leftmost and rightmost legs
    ("+/-" paired-end, "-/+" mate-pair). Inserts are ``insert``, or with
    ``insert_sd`` normal around it, rounded and clipped to
    ``insert_range``.

    Class mix (per pair): 10% a 3 bp indel in end 2, 3% in both ends,
    2% random (1% both ends, 1% end 1 only), the rest clean; every base
    of a non-random read is substituted with probability ``sub_rate``."""
    n = len(codes)
    ins = np.full(n_pairs, insert, np.int64)
    if insert_sd:
        ins = np.rint(rng.normal(insert, insert_sd, n_pairs)).astype(np.int64)
        ins = np.clip(ins, *(insert_range or (read_len, n // 2)))
    pos = rng.integers(0, n - int(ins.max()) - 1, n_pairs)
    cls = rng.random(n_pairs)
    one_indel = cls < 0.10
    two_indel = (cls >= 0.10) & (cls < 0.13)
    rand2 = (cls >= 0.13) & (cls < 0.14)
    rand1 = (cls >= 0.13) & (cls < 0.15)
    idx1 = pos[:, None] + np.arange(read_len)[None, :]
    idx2 = (pos + ins - read_len)[:, None] + np.arange(read_len)[None, :]
    left, right = codes[idx1], codes[idx2]
    if orientation[0] == "-":
        left = (3 - left)[:, ::-1]
    if orientation[2] == "-":
        right = (3 - right)[:, ::-1]

    def indel(m, sel):
        # 3 bp deletion after base 20, 3 random bases appended at the end
        tail = rng.integers(0, 4, (int(sel.sum()), 3)).astype(np.uint8)
        m[sel] = np.concatenate([m[sel][:, :20], m[sel][:, 23:], tail], axis=1)

    indel(right, one_indel | two_indel)
    indel(left, two_indel)
    for m, rand in ((left, rand1), (right, rand2)):
        sub = rng.random(m.shape) < sub_rate
        m[sub] = (m[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        m[rand] = rng.integers(0, 4, (int(rand.sum()), read_len))
    qual = b"I" * read_len
    for path, m in ((path1, left), (path2, right)):
        seqs = dna.CODE_TO_CHAR[m]
        with open(path, "wb") as fh:
            for i in range(n_pairs):
                fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))
    return pos + 1, pos + ins - read_len + 1, np.stack([rand1, rand2])
