"""The reference's own index: every ``STEP``-th K-mer of the genome,
sorted, and the exhaustive ungapped search built on it.

Pigeonhole: a read with at most ``k`` mismatches at a placement has an
exact segment among ``k + 1`` equal ones. A segment at least ``K +
STEP - 1`` bases long holds a genome position that is a multiple of
``STEP`` with its whole K-mer inside the segment, so looking up the K-mers
at the segment's first ``STEP`` offsets finds every such placement.
Every candidate is then counted base by base against the genome.
Plain NumPy; it shares nothing with the port's FM index.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.genome import Genome

K = 20
STEP = 8


def segments(L: int, k: int) -> list[int]:
    """Bounds of the k + 1 pigeonhole segments of a read of L bases,
    as the port's seed search cuts them (``j * L // (k + 1)``)."""
    return [i * L // (k + 1) for i in range(k + 2)]


def _pack(rows: np.ndarray) -> np.ndarray:
    """(m, K) codes -> (m,) uint64 keys, first base most significant."""
    key = np.zeros(len(rows), np.uint64)
    for i in range(K):
        key = (key << np.uint64(2)) | rows[:, i].astype(np.uint64)
    return key


class KmerIndex:
    def __init__(self, g: Genome, keys: np.ndarray, pos: np.ndarray):
        self.g = g
        self.codes = g.codes
        self.keys = keys
        self.pos = pos
        self.ex_starts, self.ex_ends = g.excluded()

    @classmethod
    def build(cls, g: Genome) -> "KmerIndex":
        codes = np.asarray(g.codes)
        p = np.arange(0, g.length - K + 1, STEP, dtype=np.int64)
        keys = np.zeros(len(p), np.uint64)
        for i in range(K):
            keys = (keys << np.uint64(2)) | codes[p + i].astype(np.uint64)
        order = np.argsort(keys, kind="stable")
        return cls(g, keys[order], p[order].astype(np.uint32))

    @classmethod
    def cached(cls, g: Genome, cache_dir: str) -> "KmerIndex":
        kp = os.path.join(cache_dir, "kmer_keys.npy")
        pp = os.path.join(cache_dir, "kmer_pos.npy")
        if os.path.exists(kp) and os.path.exists(pp):
            return cls(g, np.load(kp, mmap_mode="r"), np.load(pp, mmap_mode="r"))
        os.makedirs(cache_dir, exist_ok=True)
        idx = cls.build(g)
        for path, a in ((kp, idx.keys), (pp, idx.pos)):
            np.save(path + ".tmp.npy", a)
            os.replace(path + ".tmp.npy", path)
        return idx

    def window(self, starts: np.ndarray, L: int) -> np.ndarray:
        """(m, L) genome codes from each start (clamped to the genome)."""
        idx = np.minimum(starts[:, None] + np.arange(L)[None, :],
                         self.g.length - 1)
        return np.asarray(self.codes)[idx]

    def valid(self, starts: np.ndarray, L: int) -> np.ndarray:
        """Placements inside one chromosome and clear of excluded N runs
        (the port drops the others, README section 2.1)."""
        ends = starts + L
        c0 = np.searchsorted(self.g.offsets, starts, side="right")
        c1 = np.searchsorted(self.g.offsets, ends - 1, side="right")
        ok = (starts >= 0) & (ends <= self.g.length) & (c0 == c1)
        if len(self.ex_starts):
            i = np.searchsorted(self.ex_ends, starts, side="right")
            ok &= ~((i < len(self.ex_starts))
                    & (self.ex_starts[np.minimum(i, len(self.ex_starts) - 1)]
                       < ends))
        return ok

    def seed_hits(self, reads: np.ndarray, k: int) -> np.ndarray:
        """(m,) the most genome positions any pigeonhole segment of a
        read (either orientation) can occur at: for each segment the
        sampled hits of the K-mers at its first STEP offsets, which
        count every exact occurrence once, and more."""
        m, L = reads.shape
        seg = segments(L, k)
        most = np.zeros(m, np.int64)
        for o in (reads, 3 - reads[:, ::-1]):
            for a in seg[:-1]:
                tot = np.zeros(m, np.int64)
                for off in range(a, a + STEP):
                    key = _pack(o[:, off:off + K])
                    tot += (np.searchsorted(self.keys, key, "right")
                            - np.searchsorted(self.keys, key, "left"))
                most = np.maximum(most, tot)
        return most

    def placements(self, reads: np.ndarray, k: int):
        """Every ungapped placement of each read with at most k
        mismatches, on either strand.

        reads: (m, L) codes as sequenced. Returns (rid, start, strand,
        mismatches) arrays over all placements (start 0-based on the
        concatenated genome, strand 1 = reverse)."""
        m, L = reads.shape
        seg = segments(L, k)
        if min(b - a for a, b in zip(seg, seg[1:])) < K + STEP - 1:
            raise ValueError(f"reads of {L} bases are too short for "
                             f"{k} mismatches with {K}-mers every {STEP}")
        rid_l, start_l, strand_l = [], [], []
        for strand in (0, 1):
            o = reads if strand == 0 else (3 - reads[:, ::-1])
            for a in seg[:-1]:
                for off in range(a, a + STEP):
                    key = _pack(o[:, off:off + K])
                    lo = np.searchsorted(self.keys, key, "left")
                    hi = np.searchsorted(self.keys, key, "right")
                    cnt = (hi - lo).astype(np.int64)
                    tot = int(cnt.sum())
                    if not tot:
                        continue
                    rid = np.repeat(np.arange(m), cnt)
                    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
                    at = np.repeat(lo, cnt) + np.arange(tot) - first
                    rid_l.append(rid)
                    start_l.append(np.asarray(self.pos[at], np.int64) - off)
                    strand_l.append(np.full(tot, strand, np.int8))
        if not rid_l:
            e = np.zeros(0, np.int64)
            return e, e, e.astype(np.int8), e
        rid = np.concatenate(rid_l)
        start = np.concatenate(start_l)
        strand = np.concatenate(strand_l)
        # distinct (read, strand, start)
        key = (rid * 2 + strand) * (1 << 34) + (start + (1 << 32))
        key, first = np.unique(key, return_index=True)
        rid, start, strand = rid[first], start[first], strand[first]
        keep = self.valid(start, L)
        rid, start, strand = rid[keep], start[keep], strand[keep]
        mm = np.zeros(len(rid), np.int64)
        for s0 in range(0, len(rid), 1 << 16):
            sl = slice(s0, s0 + (1 << 16))
            o = np.where(strand[sl, None] == 1,
                         3 - reads[rid[sl]][:, ::-1], reads[rid[sl]])
            mm[sl] = (self.window(start[sl], L) != o).sum(axis=1)
        ok = mm <= k
        return rid[ok], start[ok], strand[ok], mm[ok]
