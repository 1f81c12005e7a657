"""The reference: its DP against a cell-by-cell recurrence, its index
against a scan of every placement, its answers against the truth, and
the judge against records with one fault planted each."""

from __future__ import annotations

import os

import numpy as np
import pytest

from portbench import genome, reads
from portbench.reference import dp
from portbench.reference import judge as J
from portbench.reference.index import KmerIndex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = -10**9


def slow_best(read, win, clip):
    """The DP's recurrence cell by cell (the port's semantics: free
    start row, fresh starts after up to ``clip`` skipped bases, a right
    clip of up to ``clip``, free window ends)."""
    L, W = len(read), len(win)
    H = [[NEG] * (W + 1) for _ in range(L + 1)]
    I = [[NEG] * (W + 1) for _ in range(L + 1)]
    D = [[NEG] * (W + 1) for _ in range(L + 1)]
    for j in range(W + 1):
        H[0][j] = 0
    best = NEG
    for i in range(1, L + 1):
        for j in range(0, W + 1):
            fresh = i - 1 <= clip
            I[i][j] = max(H[i - 1][j] + dp.GAP_OPEN, I[i - 1][j] + dp.GAP_EXT,
                          dp.GAP_OPEN if fresh else NEG)
            if j >= 1:
                D[i][j] = max(H[i][j - 1] + dp.GAP_OPEN,
                              D[i][j - 1] + dp.GAP_EXT)
                s = dp.MATCH if read[i - 1] == win[j - 1] else dp.MISMATCH
                diag = max(H[i - 1][j - 1] + s, s if fresh else NEG)
                H[i][j] = max(diag, D[i][j], I[i][j])
                if i >= L - clip:
                    best = max(best, H[i][j])
            else:
                H[i][j] = I[i][j]
    return best


def test_dp_against_the_recurrence():
    rng = np.random.default_rng(0)
    for _ in range(60):
        L, W = int(rng.integers(4, 14)), int(rng.integers(4, 18))
        read = rng.integers(0, 4, L).astype(np.uint8)
        win = rng.integers(0, 4, W).astype(np.uint8)
        clip = int(rng.integers(0, 4))
        got = dp.best_ends(read[None], win[None], np.array([W]), clip)[0][0]
        assert got == slow_best(read, win, clip)


def test_best_ends_against_the_recurrence():
    """The optimum and the columns where it ends, against the recurrence
    with the window cut at each column in turn."""
    rng = np.random.default_rng(7)
    for _ in range(40):
        L, W = int(rng.integers(4, 10)), int(rng.integers(4, 14))
        read = rng.integers(0, 4, L).astype(np.uint8)
        win = rng.integers(0, 4, W).astype(np.uint8)
        if rng.random() < 0.5:                      # a copy of the read
            at = int(rng.integers(0, max(W - L, 0) + 1))
            win[at:at + L] = read[:W - at]
        clip = int(rng.integers(0, 3))
        best, n, end = dp.best_ends(read[None], win[None], np.array([W]),
                                    clip)
        by = [slow_best_ending(read, win[:j], clip) for j in range(1, W + 1)]
        ends = [j + 1 for j, v in enumerate(by) if v == max(by)]
        assert best[0] == max(by) == slow_best(read, win, clip)
        assert n[0] == len(ends) and end[0] == ends[0]


def slow_best_ending(read, win, clip):
    """The recurrence's best over alignments that end at the window's
    last column."""
    L, W = len(read), len(win)
    H = [[NEG] * (W + 1) for _ in range(L + 1)]
    I = [[NEG] * (W + 1) for _ in range(L + 1)]
    D = [[NEG] * (W + 1) for _ in range(L + 1)]
    for j in range(W + 1):
        H[0][j] = 0
    best = NEG
    for i in range(1, L + 1):
        for j in range(0, W + 1):
            fresh = i - 1 <= clip
            I[i][j] = max(H[i - 1][j] + dp.GAP_OPEN, I[i - 1][j] + dp.GAP_EXT,
                          dp.GAP_OPEN if fresh else NEG)
            if j >= 1:
                D[i][j] = max(H[i][j - 1] + dp.GAP_OPEN,
                              D[i][j - 1] + dp.GAP_EXT)
                s = dp.MATCH if read[i - 1] == win[j - 1] else dp.MISMATCH
                diag = max(H[i - 1][j - 1] + s, s if fresh else NEG)
                H[i][j] = max(diag, D[i][j], I[i][j])
                if i >= L - clip and j == W:
                    best = max(best, H[i][j])
            else:
                H[i][j] = I[i][j]
    return best


def test_dp_hand_cases():
    rng = np.random.default_rng(1)
    g = rng.integers(0, 4, 140).astype(np.uint8)
    read = g[20:120].copy()
    win = g[20:120][None]
    assert dp.best_ends(read[None], win, np.array([100]))[0][0] == 100
    r1 = read.copy()
    r1[50] = (r1[50] + 1) % 4
    assert dp.best_ends(r1[None], win, np.array([100]))[0][0] == 97
    r0 = read.copy()
    r0[0] = (r0[0] + 1) % 4
    assert dp.best_ends(r0[None], win, np.array([100]))[0][0] == 99
    gap = np.concatenate([g[20:70], g[73:123]])    # a 3-base deletion
    w2 = g[20:123][None]
    s = dp.best_ends(gap[None], w2, np.array([103]))[0][0]
    assert s == 100 - 3 - 2
    c = dp.cigar_score(gap, g[20:123], dp.parse_cigar(b"50M3D50M"))
    assert c == {"score": 95, "mismatches": 0, "opens": 1, "extensions": 2,
                 "ref_span": 103, "read_span": 100}


@pytest.fixture(scope="module")
def small():
    """A random genome of 2 Mbp with a 100-base unit pasted 5 times."""
    rng = np.random.default_rng(2)
    n = 2_000_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    unit = codes[1000:1100].copy()
    for p in (300_000, 700_000, 900_000, 1_500_000):
        codes[p:p + 100] = unit
    codes[p + 10] = (codes[p + 10] + 1) % 4          # one copy off by one
    half = n // 2
    g = genome.Genome(codes=codes, names=["chrA", "chrB"],
                      offsets=np.array([0, half, n], np.int64),
                      amb_starts=np.array([1_800_000], np.int64),
                      amb_lengths=np.array([5000], np.int64))
    return g, KmerIndex.build(g)


def scan(g, read, k):
    """Every placement with at most k mismatches, by brute force."""
    out = []
    codes = np.asarray(g.codes)
    L = len(read)
    win = np.lib.stride_tricks.sliding_window_view(codes, L)
    for strand, o in ((0, read), (1, 3 - read[::-1])):
        mm = (win != o).sum(axis=1)
        for p in np.flatnonzero(mm <= k):
            out.append((int(p), strand, int(mm[p])))
    return out


def test_index_finds_every_placement(small):
    g, kidx = small
    rng = np.random.default_rng(3)
    rows = [np.asarray(g.codes[1000:1100])]
    for p in rng.integers(0, 1_900_000, 12):
        r = np.asarray(g.codes[p:p + 100]).copy()
        for at in rng.choice(100, int(rng.integers(0, 4)), replace=False):
            r[at] = (r[at] + 1) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        rows.append(r)
    reads_ = np.stack(rows)
    rid, start, strand, mm = kidx.placements(reads_, 2)
    for i, r in enumerate(reads_):
        want = {(p, s, m) for p, s, m in scan(g, r, 2)
                if kidx.valid(np.array([p]), 100)[0]}
        got = set(zip(start[rid == i].tolist(), strand[rid == i].tolist(),
                      mm[rid == i].tolist()))
        assert got == want
    assert len(start[rid == 0]) == 5


def test_reference_pairs_at_the_truth():
    g = genome.generate(8_000_000, 20240817, log=lambda m: None)
    kidx = KmerIndex.build(g)
    m = {"source": "test", "read_len": 100, "orientation": "+/-",
         "insert": [400, 40, 300, 500],
         "sub_rate": 0.004, "indel_reads": 0.0, "indel_len": [1, 3],
         "random_end_pairs": 0.0, "junction_reads": 0.0,
         "junction_len": [10, 40]}
    r = reads.simulate(g, m, 400, np.random.default_rng(4))
    lib = J.Library(300, 500, 0, 1, 2)
    ref = J.Reference(kidx, lib, r.codes)
    ok = 0
    for i in np.flatnonzero(ref.judged):
        for e in (0, 1):
            sel = (ref.end == e) & (ref.pair == i)
            truth = g.offsets[r.chrom[e, i]] + r.pos[e, i] - 1
            ok += truth in ref.start[sel]
    assert ok == 2 * int(ref.judged.sum()) and ref.judged.sum() > 150


# -- the judge, one planted fault a case ---------------------------------

def _pair(g, p1, p2, L=100):
    """A proper +/- pair of exact reads at p1 (+) and p2 (-)."""
    a = np.asarray(g.codes[p1:p1 + L])
    b = 3 - np.asarray(g.codes[p2:p2 + L])[::-1]
    return np.stack([a[None], b[None]])


def _records(g, codes, p1, p2, L=100):
    """The records the port would write for a unique exact pair."""
    def seq(c):
        return J.acgt_of(c)
    tl = p2 + L - p1
    base = dict(rname=b"chrA", mapq=60, cigar=b"100M", rnext=b"=")
    tags = {"X0": 1, "X1": 0, "XM": 0, "XO": 0, "XG": 0}
    r1 = J.Record(flag=0x1 | 0x2 | 0x20 | 0x40, pos=p1 + 1, pnext=p2 + 1,
                  tlen=tl, seq=seq(codes[0, 0]), tags=dict(tags), **base)
    r2 = J.Record(flag=0x1 | 0x2 | 0x10 | 0x80, pos=p2 + 1, pnext=p1 + 1,
                  tlen=-tl, seq=seq(3 - codes[1, 0][::-1]), tags=dict(tags),
                  **base)
    return [r1, r2]


@pytest.fixture(scope="module")
def judged_pair(small):
    g, kidx = small
    p1, p2 = 400_000, 400_300
    codes = _pair(g, p1, p2)
    ref = J.Reference(kidx, J.Library(300, 500, 0, 1, 2), codes)
    return g, ref, codes, p1, p2


def _judge(g, ref, recs):
    j = J.Judge(ref, g.names)
    j.pair(0, b"r00000000", recs)
    return j.numbers()


def test_judge_passes_the_right_records(judged_pair):
    g, ref, codes, p1, p2 = judged_pair
    nums = _judge(g, ref, _records(g, codes, p1, p2))
    assert all(v == 0 for v in nums.values()), nums


@pytest.mark.parametrize("fault,number", [
    ("drop", "missing"), ("seq", "seq_wrong"), ("pos", "tags_wrong"),
    ("xm", "tags_wrong"), ("pnext", "mate_wrong"), ("tlen", "mate_wrong"),
    ("strand", "mate_wrong"), ("x0", "pair_worse_pct"),
    ("mapq", "pair_worse_pct"), ("unpaired", "pair_worse_pct"),
    ("dp", "dp_wrong"), ("rescue_clip", "rescue_wrong"),
    ("rescue_out", "rescue_wrong"), ("rescue_strand", "rescue_wrong")])
def test_judge_sees_each_fault(judged_pair, fault, number):
    g, ref, codes, p1, p2 = judged_pair
    recs = _records(g, codes, p1, p2)
    r1, r2 = recs
    if fault == "drop":
        recs = [r1]
    elif fault == "seq":
        r1.seq = b"A" + r1.seq[1:] if r1.seq[:1] != b"A" else b"C" + r1.seq[1:]
    elif fault == "pos":
        r1.pos += 1
        r2.pnext += 1
    elif fault == "xm":
        r1.tags["XM"] = 1
    elif fault == "pnext":
        r1.pnext += 5
    elif fault == "tlen":
        r2.tlen -= 1
    elif fault == "strand":
        r1.flag ^= 0x20
    elif fault == "x0":
        r1.tags["X0"] = 2
    elif fault == "mapq":
        r2.mapq = 37
    elif fault == "unpaired":
        for r in recs:
            r.flag &= ~0x2
            del r.tags["X0"]
    elif fault == "dp":
        # a DP record (no X0) whose CIGAR is worse than the plain 100M
        del r1.tags["X0"]
        r1.cigar = b"50M1I49M"
        r1.tags.update(XM=0, XO=1, XG=0)
        read = codes[0, 0]
        s = dp.cigar_score(read, np.asarray(g.codes[p1:p1 + 99]),
                           dp.parse_cigar(b"50M1I49M"))
        r1.tags["XM"] = s["mismatches"]
        r1.tlen = r1.tlen - 1
        r2.tlen = -r1.tlen
    elif fault.startswith("rescue"):
        _rescued(r2)
        if fault == "rescue_clip":
            # its first 20 bases (genome order) clipped: the best in its
            # own span, 20 below the best in the window
            r2.cigar, r2.pos = b"20S80M", r2.pos + 20
            r1.pnext = r2.pos
        elif fault == "rescue_out":
            r2.pos += 400
            r1.pnext = r2.pos
        else:
            r2.flag ^= 0x10
            r1.flag ^= 0x20
            r2.seq = J._revcomp(r2.seq)
    nums = _judge(g, ref, recs)
    assert nums[number] > 0, nums


def _rescued(rec):
    """Make ``rec`` the DP end of a half rescue: no X0 or X1."""
    del rec.tags["X0"], rec.tags["X1"]


def test_judge_passes_a_right_rescue(judged_pair):
    g, ref, codes, p1, p2 = judged_pair
    r1, r2 = _records(g, codes, p1, p2)
    _rescued(r2)
    j = J.Judge(ref, g.names)
    j.pair(0, b"r00000000", [r1, r2])
    nums = j.numbers()
    assert j.rescue_checked == 1 and nums["rescue_wrong"] == 0, j.faults
    assert nums["dp_wrong"] == 0 and nums["tags_wrong"] == 0


def test_a_clipped_rescue_is_best_in_its_own_span(judged_pair):
    """What the rescue check adds: a record optimal in its own span and
    worse than the window's best."""
    g, ref, codes, p1, p2 = judged_pair
    r1, r2 = _records(g, codes, p1, p2)
    _rescued(r2)
    r2.cigar, r2.pos = b"20S80M", r2.pos + 20
    r1.pnext = r2.pos
    nums = _judge(g, ref, [r1, r2])
    assert nums["dp_wrong"] == 0 and nums["tags_wrong"] == 0
    assert nums["rescue_wrong"] == 1


@pytest.mark.parametrize("cell", ["chr1-pe100.wgs", "chr1-pe100.clean"])
def test_control_fails_where_the_program_passes(tmp_path, cell):
    """The control at a size a test run holds: the reference in the
    program's place, one mismatch allowed where the configuration states
    two, its answers written as SAM and put through the run's own judge
    at the cell's limits, comes out not correct on the cell's mix."""
    from portbench import run as R
    from portbench.cell import Cell

    c = Cell(cell, ROOT)
    g = genome.generate(8_000_000, 20240817, log=lambda m: None)
    kidx = KmerIndex.build(g)
    r = reads.simulate(g, c.mix, 4000, np.random.default_rng(6))
    lib = J.Library.of(c.config["guarantees"])
    sample = R.sample_pairs(c, r, 6)
    path = str(tmp_path / "control.sam")
    J.control_sam(kidx, lib, r.codes[:, sample],
                  [reads.read_name(int(i)) for i in sample], g.names, path)
    nums, faults, info = R.judge_jobs(c, g, kidx, r, [path], 6)
    checks = R.checks_of(nums, c.limits)
    assert not R.passes(checks), checks
    assert nums["pair_worse_pct"] > c.limits["pair_worse_pct"]
    assert all(v == 0 for k, v in nums.items() if k != "pair_worse_pct"), (
        faults)
    assert info["pairs_judged"] > 1000


def test_library_of_guarantees():
    lib = J.Library.of({"strand_arrangement": "-/+", "min_insert": 2000,
                        "max_insert": 6000, "mismatches": 2})
    assert (lib.left_strand, lib.right_strand) == (1, 0)
