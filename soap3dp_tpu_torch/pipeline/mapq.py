"""Mapping-quality scoring (port of soap3dp_tpu/pipeline/mapq.py; numpy,
with the port's OP_* codes).

Behavioral port of the reference's two MAPQ modes (BGS-IO.cpp:2280-2550):

* BWA-like (default, soap3-dp.ini [Score] BWALikeScore=1): single-end
  scores in [0, 37] from (x0, x1) via the g_log_n table
  (bwaLikeSingleQualScore, BGS-IO.cpp:2311-2329; table init
  bwase_initialize, CPUfunctions.cpp:3014); paired-end in [0, 60]
  combining both ends plus optimal/suboptimal pair scores
  (bwaLikePairQualScore, BGS-IO.cpp:2415-2463).
* table mode: maxMAPQ * f(#mismatches, avg mismatch quality) clamped to
  [minMAPQ, maxMAPQ] (getMapQualScoreSingle, BGS-IO.cpp:2331-2367).
* DP-result mode: ratios of best/second-best DP scores and x1 penalty
  tables (getMapQualScoreForSingleDP, BGS-IO.cpp:2370-2412).

x0 = number of best hits, x1 = number of suboptimal hits, as in BWA.
All functions are vectorized over numpy arrays.
"""

from __future__ import annotations

import numpy as np

# g_log_n[i] = int(4.343 * ln(i) + 0.5), i in [1, 255]
G_LOG_N = np.zeros(256, dtype=np.int32)
G_LOG_N[1:] = (4.343 * np.log(np.arange(1, 256)) + 0.5).astype(np.int32)

# mapping_score[#mismatches (capped 5)][avg mismatch qual bucket (2)]
MAPPING_SCORE = np.array(
    [[1.0, 1.0], [0.875, 0.85], [0.75, 0.7],
     [0.625, 0.55], [0.475, 0.4], [0.325, 0.25]])

# penalty for average mismatch base quality 0..40 (DP mode)
PENALTY_AVG_MIS_QUAL = np.array(
    [3, 2.85, 2.71, 2.57, 2.43, 2.3, 2.17, 2.04, 1.92, 1.8, 1.69, 1.58,
     1.47, 1.37, 1.27, 1.17, 1.08, 0.99, 0.91, 0.83, 0.75, 0.68, 0.61,
     0.54, 0.48, 0.42, 0.37, 0.32, 0.27, 0.23, 0.19, 0.15, 0.12, 0.09,
     0.07, 0.05, 0.03, 0.02, 0.01, 0, 0], dtype=np.float32)

# penalty ratio for x1 = 0..100 (DP mode)
PENALTY_RATIO_X1 = np.array(
    [1, 0.5, 0.33, 0.25, 0.2, 0.17, 0.14, 0.13, 0.11, 0.1] +
    [0.09, 0.08, 0.08, 0.07, 0.07, 0.06, 0.06, 0.06, 0.05, 0.05] +
    [0.05, 0.05] + [0.04] * 6 + [0.03] * 12 + [0.02] * 26 + [0.01] * 35,
    dtype=np.float32)
assert PENALTY_RATIO_X1.shape[0] == 101


def genome_codes_batch(index, tp: np.ndarray, L: int) -> np.ndarray:
    """(M, L) genome codes at each text position (host-side numpy
    mirror of fm.fmindex.extract_genome, word gather + funnel shift)."""
    pac = np.asarray(index.pac)
    tp = np.asarray(tp, np.int64)
    W = (L + 15) // 16 + 1
    w0 = tp >> 4
    j = np.arange(W, dtype=np.int64)
    words = pac[np.clip(w0[:, None] + j, 0, len(pac) - 1)]
    sh = (2 * (tp & 15)).astype(np.uint32)[:, None]
    lo = words[:, :-1] >> sh
    hi = np.where(sh == 0, 0,
                  words[:, 1:] << ((32 - sh) & 31)).astype(np.uint32)
    aligned = lo | hi
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = (aligned[:, :, None] >> shifts) & 3
    return codes.reshape(len(tp), -1)[:, :L].astype(np.uint8)


def avg_mismatch_qual(index, pos, strand, codes, lens, quals,
                      default: int = 20) -> np.ndarray:
    """Average base quality (phred) at the mismatch positions of each
    gapless primary alignment — the real input of the reference's
    table-mode MAPQ (getMapQualScoreSingle, BGS-IO.cpp:2331-2367),
    which averages the qualities of the mismatched bases.

    codes/quals are the FORWARD read matrices; pos/strand describe the
    placements. Without qualities (FASTA input) every read gets
    ``default``."""
    pos = np.asarray(pos, np.int64)
    M = len(pos)
    if quals is None or M == 0:
        return np.full(M, default, np.int32)
    L = codes.shape[1]
    lens = np.asarray(lens)
    strand = np.asarray(strand).astype(bool)
    i = np.arange(L, dtype=np.int64)[None, :]
    in_read = i < lens[:, None]
    # orient reads to the genome strand; track the original read
    # coordinate of each oriented position for the quality lookup
    src = np.where(strand[:, None],
                   np.clip(lens[:, None] - 1 - i, 0, L - 1), i)
    oriented = np.take_along_axis(codes, src, axis=1)
    oriented = np.where(strand[:, None], 3 - oriented, oriented)
    g = genome_codes_batch(index, pos, L)
    mism = (g != oriented) & in_read
    q = np.take_along_axis(quals.astype(np.int32), src, axis=1) - 33
    s = (np.maximum(q, 0) * mism).sum(axis=1)
    c = mism.sum(axis=1)
    return np.where(c > 0, s // np.maximum(c, 1), default).astype(np.int32)


def avg_mis_qual_from_runs(ops, cnts, nrun: int, rlen: int, strand: int,
                           quals_row, default: int = 20) -> int:
    """Average mismatch base quality of one DP alignment, replayed from
    its right-to-left CIGAR runs (the DP analog of avg_mismatch_qual;
    reference getMapQualScoreForSingleDP, BGS-IO.cpp:2370-2412)."""
    from soap3dp_tpu_torch.kernels.banded_dp import (
        OP_CLIP, OP_INS, OP_MATCH, OP_MISMATCH)

    if quals_row is None:
        return default
    p = rlen
    s = c = 0
    for r in range(nrun):
        op, n = int(ops[r]), int(cnts[r])
        if op in (OP_MATCH, OP_MISMATCH, OP_INS, OP_CLIP):
            if op == OP_MISMATCH:
                for i in range(p - n, p):
                    oi = rlen - 1 - i if strand else i
                    s += max(int(quals_row[oi]) - 33, 0)
                    c += 1
            p -= n
    return (s // c) if c else default


def bwa_like_single(x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """BWA-like single-end MAPQ in [0, 37]."""
    x0 = np.asarray(x0)
    x1 = np.asarray(x1)
    n = G_LOG_N[np.minimum(x1, 255)]
    score = np.where(x0 > 1, 0,
                     np.where(x1 == 0, 37, np.maximum(23 - n, 0)))
    return score.astype(np.int32)


def table_single(nmis, avg_mis_qual, x0, x1, max_mapq=40, min_mapq=1):
    """Table-driven single-end MAPQ (non-BWA mode)."""
    nmis = np.minimum(np.asarray(nmis), 5)
    qb = np.clip((np.asarray(avg_mis_qual) - 1) // 20, 0, 1)
    score = (max_mapq * MAPPING_SCORE[nmis, qb]).astype(np.int32)
    score = np.maximum(score, min_mapq)
    unique = (np.asarray(x0) == 1) & (np.asarray(x1) == 0)
    return np.where(unique, score, min_mapq).astype(np.int32)


def dp_single(max_dp_score, avg_mis_qual, x0, x1_t1, x1_t2,
              best, second_best, dp_thres,
              max_mapq=40, min_mapq=1, bwa_like=True):
    """MAPQ for DP-rescued single-end alignments."""
    if bwa_like:
        return bwa_like_single(x0, np.asarray(x1_t1) + np.asarray(x1_t2))
    x0 = np.asarray(x0)
    x1 = np.asarray(x1_t1) + np.asarray(x1_t2)
    best = np.asarray(best, dtype=np.float32)
    # guard: when 0.7*best <= dp_thres the ratio's denominator is <= 0
    # (best barely clears the threshold); any suboptimal hit then means
    # minimal confidence (r1 = 0) rather than a divide-by-zero/negative
    denom = 0.7 * best - dp_thres
    safe = np.where(denom > 0, denom, 1.0)
    ratio = np.clip(1.0 - (np.asarray(second_best) - dp_thres) / safe, 0.0, 1.0)
    r1 = np.where(np.asarray(x1_t2) > 0,
                  np.where(denom > 0, ratio, 0.0),
                  1.0)
    r2 = PENALTY_RATIO_X1[np.minimum(x1, 100)]
    r3 = (best - dp_thres) / (np.asarray(max_dp_score) - dp_thres)
    p = PENALTY_AVG_MIS_QUAL[np.clip(avg_mis_qual, 0, 40)]
    score = (max_mapq * r1 * r2 * r3 - p).astype(np.int32)
    score = np.maximum(score, min_mapq)
    return np.where((x0 > 1) | (np.asarray(x1_t1) > 0), min_mapq, score).astype(np.int32)


def bwa_like_pair(x0_0, x1_0, x0_1, x1_1, op_score, op_num,
                  subop_score, subop_num, readlen_0, readlen_1):
    """BWA-like paired-end MAPQ for both ends, in [0, 60].

    op/subop scores are in the reference's pair-score units (multiplied
    by 10 internally, BGS-IO.cpp:2421-2422).
    """
    m0 = bwa_like_single(x0_0, x1_0)
    m1 = bwa_like_single(x0_1, x1_1)
    ops = np.asarray(op_score) * 10
    subs = np.asarray(subop_score) * 10
    both = (m0 > 0) & (m1 > 0)
    mapq_p_both = np.minimum(m0 + m1, 60)

    # one or both ends ambiguous: pair-level evidence
    subop_capped = np.minimum(np.asarray(subop_num), 255)
    avg_len = (np.asarray(readlen_0) + np.asarray(readlen_1)) // 2
    mapq_p = np.where(
        np.asarray(op_num) == 1,
        np.where(np.asarray(subop_num) == 0, 29,
                 np.where(ops - subs > 0.3 * avg_len, 23,
                          np.maximum((ops - subs) // 2 - G_LOG_N[subop_capped], 0))),
        0)
    out0 = np.where(both, mapq_p_both,
                    np.where(m0 == 0, np.minimum(mapq_p + 7, m1), m0))
    out1 = np.where(both, mapq_p_both,
                    np.where(m1 == 0, np.minimum(mapq_p + 7, m0), m1))
    return out0.astype(np.int32), out1.astype(np.int32)
