"""The comparison that decides ``correct``: the SAM records the timed
jobs wrote, for a sample of pairs drawn from the seed, against the
reference's own answers over the same genome and reads.

Numbers compared (each with its limit in ``limits/<cell>.json``):

- ``missing``: sampled pairs without exactly one primary record per end.
- ``seq_wrong``: records whose SEQ is not the read as sequenced (reverse
  complemented under flag 0x10).
- ``tags_wrong``: aligned records whose alignment, replayed against the
  genome from RNAME, POS and CIGAR, does not give their XM, XO and XG,
  does not cover the read, or (a seed-search record, one with X0) is
  not ungapped within the mismatches allowed.
- ``mate_wrong``: pairs whose mate fields (RNEXT, PNEXT, mate strand on
  an aligned record, TLEN, the mate-unmapped flag) do not match the
  mate's record, or
  whose proper-pair flag breaks the library's strands or insert bounds.
- ``dp_wrong``: gapped or clipped records (the DP rescue's, no X0) that
  score below the best alignment of the read within the same stretch
  of the genome.
- ``rescue_wrong``: pairs the half rescue made (both ends proper, one by
  the seed search with X0, the other by DP without it) whose DP end is
  not the best alignment of its read in the whole insert window that
  the anchor and the library state: the window of the reference's
  HalfEndAlgnBatch (DV-DPfunctions.cu:2056-2106), on the opposite leg's
  strand, inside the anchor's chromosome. The end has to lie in that
  window, score its optimum, and, where one window column alone ends an
  alignment of that score, end there.
- ``pair_worse_pct``: of the sampled pairs that have a proper pair of
  ungapped placements within the mismatches allowed, and whose ends'
  seeds each occur at most ``SEED_CAP`` times (an end past it may keep
  a hit set that the port's budgets cut short, as the port documents),
  the share not reported as such a pair at the least total of
  mismatches, or reported with an X0 other than the number of best
  placements where those have at most one mismatch (the search is
  complete there), or, where each end has one placement within the
  mismatches allowed, with X0, X1 and MAPQ other than 1, 0 and 60
  (bwaLikePairQualScore of two unique ends, BGS-IO.cpp:2415-2463): the
  seed search, the pairing and MAPQ.

The control (``control_sam``) puts the reference in the program's place,
its search allowing one mismatch fewer than the configuration states,
and writes its answers as SAM records for this same judge.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import dp
from portbench.reference.index import KmerIndex

F_PAIRED, F_PROPER, F_UNMAPPED, F_MUNMAPPED = 0x1, 0x2, 0x4, 0x8
F_REVERSE, F_MREVERSE, F_FIRST, F_SECOND = 0x10, 0x20, 0x40, 0x80
F_NOT_PRIMARY = 0x100 | 0x800
NUMBERS = ("missing", "seq_wrong", "tags_wrong", "mate_wrong", "dp_wrong",
           "rescue_wrong", "pair_worse_pct")
# the port's first search round takes a seed that occurs at most this
# often (fm/search.py SearchConfig.occ_cap); an end with a seed past it
# may keep a hit set its budgets cut short, as the port documents
SEED_CAP = 16
ACGT = b"ACGT"


@dataclasses.dataclass
class Library:
    min_insert: int
    max_insert: int
    left_strand: int     # 0 '+', 1 '-'
    right_strand: int
    mismatches: int      # the seed search's allowance

    @classmethod
    def of(cls, guarantees: dict) -> "Library":
        """The library a configuration's ``guarantees`` state."""
        sa = guarantees["strand_arrangement"]
        return cls(min_insert=int(guarantees["min_insert"]),
                   max_insert=int(guarantees["max_insert"]),
                   left_strand=int(sa[0] == "-"),
                   right_strand=int(sa[2] == "-"),
                   mismatches=int(guarantees["mismatches"]))


@dataclasses.dataclass
class Record:
    flag: int
    rname: bytes
    pos: int
    mapq: int
    cigar: bytes
    rnext: bytes
    pnext: int
    tlen: int
    seq: bytes
    tags: dict


def parse_record(line: bytes) -> tuple[bytes, Record]:
    f = line.rstrip(b"\n").split(b"\t")
    tags = {}
    for t in f[11:]:
        key, typ, val = t.split(b":", 2)
        tags[key.decode()] = int(val) if typ == b"i" else val
    return f[0], Record(int(f[1]), f[2], int(f[3]), int(f[4]), f[5], f[6],
                        int(f[7]), int(f[8]), f[9], tags)


def collect(sam_path: str, names: set) -> dict:
    """name -> records of the sampled names, in file order."""
    out: dict[bytes, list] = {}
    with open(sam_path, "rb") as fh:
        for line in fh:
            if line[:1] == b"@":
                continue
            name = line[:line.index(b"\t")]
            if name in names:
                out.setdefault(name, []).append(parse_record(line)[1])
    return out


class Reference:
    """The reference's answers for a sample of pairs: every ungapped
    placement of both ends within ``lib.mismatches`` and the best
    proper pairs among them."""

    def __init__(self, kidx: KmerIndex, lib: Library, codes: np.ndarray,
                 seeded: np.ndarray | None = None):
        self.kidx = kidx
        self.g = kidx.g
        self.lib = lib
        self.codes = codes  # (2, S, L) the sampled pairs' reads
        S = codes.shape[1]
        flat = codes.reshape(2 * S, -1)
        if seeded is None:
            seeded = (kidx.seed_hits(flat, lib.mismatches)
                      <= SEED_CAP).reshape(2, S)
        self.seeded = seeded
        # placements of the ends whose seeds the port searches whole
        sel = np.flatnonzero(seeded.ravel())
        sub, start, strand, mm = kidx.placements(flat[sel], lib.mismatches)
        rid = sel[sub]
        self.end = (rid >= S).astype(np.int64)
        self.pair = rid % S
        self.start, self.strand, self.mm = start, strand, mm
        self.n_place = np.bincount(rid, minlength=2 * S).reshape(2, S)
        key, cnt = np.unique((rid * 8 + mm), return_counts=True)
        self._at = dict(zip(key.tolist(), cnt.tolist()))
        best = np.full(2 * S, 99, np.int64)
        np.minimum.at(best, rid, mm)
        self.best_mm = np.where(best == 99, -1, best).reshape(2, S)
        self.best_total, self.best_pick = self._best_pairs(S)
        self.judged = (self.best_total >= 0) & seeded.all(axis=0)

    def count_at(self, end: int, pair: int, mm: int) -> int:
        """Placements of one end with exactly mm mismatches."""
        S = self.codes.shape[1]
        return self._at.get((end * S + pair) * 8 + mm, 0)

    def _best_pairs(self, S: int) -> tuple[np.ndarray, np.ndarray]:
        """(S,) least total mismatches of a proper pair, -1 where none,
        and (S, 2) the placements of read 1 and read 2 of the first such
        pair found (-1 where none)."""
        lib = self.lib
        best = np.full(S, -1, np.int64)
        pick = np.full((S, 2), -1, np.int64)
        e1 = np.flatnonzero(self.end == 0)
        e2 = np.flatnonzero(self.end == 1)
        o2 = e2[np.argsort(self.pair[e2], kind="stable")]
        p2s = self.pair[o2]
        lo = np.searchsorted(p2s, self.pair[e1], "left")
        hi = np.searchsorted(p2s, self.pair[e1], "right")
        cnt = hi - lo
        tot = int(cnt.sum())
        if not tot:
            return best, pick
        a = np.repeat(e1, cnt)
        b = o2[np.repeat(lo, cnt) + np.arange(tot)
               - np.repeat(np.cumsum(cnt) - cnt, cnt)]
        L1 = self.codes.shape[2]
        p1, p2 = self.start[a], self.start[b]
        s1, s2 = self.strand[a], self.strand[b]
        left1 = p1 <= p2
        ok = np.where(left1, (s1 == lib.left_strand) & (s2 == lib.right_strand),
                      (s2 == lib.left_strand) & (s1 == lib.right_strand))
        ok |= (p1 == p2) & (s2 == lib.left_strand) & (s1 == lib.right_strand)
        ins = np.maximum(p1, p2) + L1 - np.minimum(p1, p2)
        ok &= (ins >= lib.min_insert) & (ins <= lib.max_insert)
        ok &= (np.searchsorted(self.g.offsets, p1, "right")
               == np.searchsorted(self.g.offsets, p2, "right"))
        tm = (self.mm[a] + self.mm[b])[ok]
        pid = self.pair[a][ok]
        for p, t, x, y in zip(pid.tolist(), tm.tolist(), a[ok].tolist(),
                              b[ok].tolist()):
            if best[p] < 0 or t < best[p]:
                best[p] = t
                pick[p] = (x, y)
        return best, pick


def _revcomp(seq: bytes) -> bytes:
    return seq[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


class Judge:
    def __init__(self, ref: Reference, chrom_names: list):
        self.ref = ref
        self.cid = {n.encode(): i for i, n in enumerate(chrom_names)}
        self.counts = {k: 0 for k in NUMBERS if k != "pair_worse_pct"}
        self.worse: list[str] = []
        self.pair_judged = 0
        self.pair_worse = 0
        self.dp_checked = 0
        self.rescue_checked = 0
        self.faults: list[str] = []

    def _fault(self, kind: str, name: bytes, why: str) -> None:
        self.counts[kind] += 1
        if len(self.faults) < 20:
            self.faults.append(f"{kind} {name.decode()}: {why}")

    def pair(self, i: int, name: bytes, recs: list) -> None:
        """Judge the records of sampled pair i."""
        ref, lib = self.ref, self.ref.lib
        prim = [r for r in recs if not r.flag & F_NOT_PRIMARY]
        ends = [[r for r in prim if r.flag & F_FIRST],
                [r for r in prim if r.flag & F_SECOND]]
        if len(ends[0]) != 1 or len(ends[1]) != 1 or len(prim) != 2:
            self._fault("missing", name, f"{len(ends[0])} and {len(ends[1])} "
                        "primary records")
            if ref.judged[i]:
                self.pair_judged += 1
                self.pair_worse += 1
            return
        r = [ends[0][0], ends[1][0]]
        span = [None, None]
        for e in (0, 1):
            read = acgt_of(ref.codes[e, i])
            want = _revcomp(read) if r[e].flag & F_REVERSE else read
            if r[e].seq != want:
                self._fault("seq_wrong", name, f"end {e + 1} SEQ differs")
            if not r[e].flag & F_UNMAPPED:
                span[e] = self._tags(name, e, r[e], ref.codes[e, i])
        self._mates(name, r, span)
        self._rescue(i, name, r, span)
        if ref.judged[i]:
            self.pair_judged += 1
            why = self._worse(i, r)
            if why:
                self.pair_worse += 1
                if len(self.worse) < 20:
                    self.worse.append(f"pair_worse {name.decode()}: {why}")

    def _tags(self, name, e, rec, read) -> tuple | None:
        """Replay one aligned record of ``read`` (codes as sequenced);
        returns (chrom, start0, ref span, score)."""
        c = self.cid.get(rec.rname)
        try:
            ops = dp.parse_cigar(rec.cigar)
        except ValueError:
            ops = None
        if c is None or ops is None or rec.pos < 1:
            self._fault("tags_wrong", name, f"end {e + 1} bad RNAME, POS or "
                        "CIGAR")
            return None
        g = self.ref.g
        L = len(read)
        start = int(g.offsets[c]) + rec.pos - 1
        span = sum(n for n, op in ops if op in (b"M", b"D"))
        if start + span > int(g.offsets[c + 1]):
            self._fault("tags_wrong", name, f"end {e + 1} runs past its "
                        "chromosome")
            return None
        oriented = 3 - read[::-1] if rec.flag & F_REVERSE else read
        genome = np.asarray(g.codes[start:start + span])
        s = dp.cigar_score(oriented, genome, ops)
        want = (s["mismatches"], s["opens"], s["extensions"])
        have = (rec.tags.get("XM"), rec.tags.get("XO"), rec.tags.get("XG"))
        if s["read_span"] != L or want != have:
            self._fault("tags_wrong", name, f"end {e + 1} {rec.cigar.decode()}"
                        f" at {rec.rname.decode()}:{rec.pos} replays to "
                        f"XM/XO/XG {want}, the record says {have}")
        elif "X0" in rec.tags:
            if rec.cigar != b"%dM" % L or s["mismatches"] > self.ref.lib.mismatches:
                self._fault("tags_wrong", name, f"end {e + 1} seed-search "
                            f"record {rec.cigar.decode()} XM {have[0]}")
        else:
            self.dp_checked += 1
            opt = int(dp.best_ends(oriented[None, :], genome[None, :],
                                   np.array([span]))[0][0])
            if opt > s["score"]:
                self._fault("dp_wrong", name, f"end {e + 1} scores "
                            f"{s['score']}, the best in its span {opt}")
        return c, start, span, s["score"]

    def _rescue(self, i, name, r, span) -> None:
        """Hold a pair the half rescue made to the best alignment of its DP
        end in the whole window that its anchor and the library give."""
        x0 = ["X0" in x.tags for x in r]
        if (span[0] is None or span[1] is None or x0[0] == x0[1]
                or not r[0].flag & r[1].flag & F_PROPER):
            return
        ref, lib = self.ref, self.ref.lib
        a = 0 if x0[0] else 1
        m = 1 - a
        self.rescue_checked += 1
        ca, pa, la, _ = span[a]
        cm, pm, lm, score = span[m]
        read = ref.codes[m, i]
        L = len(read)
        u, v = lib.max_insert, lib.min_insert
        sa = int(bool(r[a].flag & F_REVERSE))
        if sa == lib.left_strand:
            ws, we, ms = max(pa + v - L, pa), pa + u, lib.right_strand
        elif sa == lib.right_strand:
            ws, we, ms = pa + la - u, min(pa + la - v + L, pa + la - 1), \
                lib.left_strand
        else:
            self._fault("rescue_wrong", name, f"anchor end {a + 1} on no leg")
            return
        off = self.ref.g.offsets
        ws = int(np.clip(ws, off[ca], off[ca + 1]))
        we = int(np.clip(we, off[ca], off[ca + 1]))
        where = f"end {m + 1} at {pm} ({lm} bases), window [{ws}, {we})"
        if int(bool(r[m].flag & F_REVERSE)) != ms:
            self._fault("rescue_wrong", name, f"{where} on the anchor's leg's "
                        "strand")
            return
        if cm != ca or pm < ws or pm + lm > we:
            self._fault("rescue_wrong", name, f"{where}: outside it")
            return
        oriented = 3 - read[::-1] if ms else read
        win = np.asarray(self.ref.g.codes[ws:we])
        best, n_end, end = (int(x[0]) for x in dp.best_ends(
            oriented[None, :], win[None, :], np.array([we - ws])))
        if score != best:
            self._fault("rescue_wrong", name, f"{where} scores {score}, the "
                        f"window's best {best}")
        elif n_end == 1 and pm + lm - ws != end:
            self._fault("rescue_wrong", name, f"{where} ends at column "
                        f"{pm + lm - ws}, the one best end {end}")

    def _mates(self, name, r, span) -> None:
        lib = self.ref.lib
        bad = []
        for e in (0, 1):
            a, b = r[e], r[1 - e]
            if bool(a.flag & F_MUNMAPPED) != bool(b.flag & F_UNMAPPED):
                bad.append(f"end {e + 1} mate-unmapped flag")
            if not a.flag & F_PAIRED:
                bad.append(f"end {e + 1} not flagged paired")
            if b.flag & F_UNMAPPED:
                continue
            rnext = a.rname if a.rnext == b"=" else a.rnext
            if rnext != b.rname or a.pnext != b.pos:
                bad.append(f"end {e + 1} RNEXT/PNEXT")
            if (not a.flag & F_UNMAPPED
                    and bool(a.flag & F_MREVERSE) != bool(b.flag & F_REVERSE)):
                bad.append(f"end {e + 1} mate strand")
        both = span[0] is not None and span[1] is not None
        if both and r[0].tlen != -r[1].tlen:
            bad.append("TLEN not opposite")
        if r[0].flag & F_PROPER or r[1].flag & F_PROPER:
            if not both or not (r[0].flag & F_PROPER and r[1].flag & F_PROPER):
                bad.append("proper flag on one end")
            elif span[0][0] != span[1][0]:
                bad.append("proper pair across chromosomes")
            else:
                p = [span[0][1], span[1][1]]
                s = [bool(r[0].flag & F_REVERSE), bool(r[1].flag & F_REVERSE)]
                lft = 0 if p[0] <= p[1] else 1
                ok = (s[lft] == lib.left_strand and s[1 - lft] == lib.right_strand)
                ok |= p[0] == p[1] and (s[1] == lib.left_strand
                                         and s[0] == lib.right_strand)
                if not ok:
                    bad.append("proper pair against the strand arrangement")
                if all("X0" in x.tags for x in r):
                    L = [len(x.seq) for x in r]
                    ins = max(p[0] + L[0], p[1] + L[1]) - min(p)
                    if not lib.min_insert <= ins <= lib.max_insert:
                        bad.append(f"proper pair with insert {ins}")
                    if abs(r[0].tlen) != ins or (r[0].tlen > 0) != (p[0] <= p[1]):
                        bad.append(f"TLEN {r[0].tlen} for insert {ins}")
        if bad:
            self._fault("mate_wrong", name, "; ".join(bad))

    def _worse(self, i, r) -> str:
        """Why the records of judged pair i are not the reference's
        answer ("" where they are)."""
        ref = self.ref
        if not all("X0" in x.tags and not x.flag & F_UNMAPPED for x in r):
            return "not a seed-search pair"
        if not r[0].flag & F_PROPER:
            return "not proper"
        total = r[0].tags.get("XM", -1) + r[1].tags.get("XM", -1)
        if total != ref.best_total[i]:
            return f"{total} mismatches, the best pair {ref.best_total[i]}"
        for e in (0, 1):
            best = ref.best_mm[e, i]
            if best <= 1 and r[e].tags["X0"] != ref.count_at(e, i, best):
                return (f"end {e + 1} X0 {r[e].tags['X0']}, placements at its "
                        f"best ({best} mismatches) {ref.count_at(e, i, best)}")
        if (ref.n_place[:, i] == 1).all():
            got = [(x.tags["X0"], x.tags.get("X1"), x.mapq) for x in r]
            if got != [(1, 0, 60), (1, 0, 60)]:
                return f"unique ends with X0/X1/MAPQ {got}"
        return ""

    def numbers(self) -> dict:
        out = dict(self.counts)
        out["pair_worse_pct"] = (100.0 * self.pair_worse
                                 / max(self.pair_judged, 1))
        return out


def acgt_of(codes: np.ndarray) -> bytes:
    return np.frombuffer(ACGT, np.uint8)[codes].tobytes()


def control_sam(kidx: KmerIndex, lib: Library, codes: np.ndarray,
                names: list, chrom_names: list, path: str) -> None:
    """The control's answers for the pairs ``codes`` (2, S, L), named
    ``names``, as SAM records at ``path``: the reference in the program's
    place, its seed search allowing one mismatch fewer than the
    configuration states, over the ends the judge ranks (``SEED_CAP``
    at the configuration's mismatches). A pair is its best proper pair
    (X0 and X1 its ends' placements at their best and the next mismatch
    count, MAPQ 60 for an end with one placement and none a mismatch
    worse), or both ends unmapped."""
    S = codes.shape[1]
    ranked = (kidx.seed_hits(codes.reshape(2 * S, -1), lib.mismatches)
              <= SEED_CAP).reshape(2, S)
    low = dataclasses.replace(lib, mismatches=lib.mismatches - 1)
    ctl = Reference(kidx, low, codes, seeded=ranked)
    g = kidx.g
    L = codes.shape[2]
    qual = b"I" * L
    out = []
    for p, name in enumerate(names):
        reads_ = [acgt_of(codes[e, p]) for e in (0, 1)]
        x, y = ctl.best_pick[p]
        if x < 0:
            for e in (0, 1):
                out.append(b"\t".join([
                    name, b"%d" % (F_PAIRED | F_UNMAPPED | F_MUNMAPPED
                                   | (F_FIRST, F_SECOND)[e]),
                    b"*", b"0", b"0", b"*", b"*", b"0", b"0", reads_[e],
                    qual]))
            continue
        at = [int(ctl.start[x]), int(ctl.start[y])]
        st = [int(ctl.strand[x]), int(ctl.strand[y])]
        c = int(np.searchsorted(g.offsets, at[0], "right")) - 1
        left, right = min(at), max(at) + L
        t0 = (right - left) if at[0] <= at[1] else -(right - left)
        for e in (0, 1):
            best = int(ctl.best_mm[e, p])
            x0 = ctl.count_at(e, p, best)
            x1 = ctl.count_at(e, p, best + 1) if best < low.mismatches else 0
            flag = (F_PAIRED | F_PROPER | (F_FIRST, F_SECOND)[e]
                    | (F_REVERSE if st[e] else 0)
                    | (F_MREVERSE if st[1 - e] else 0))
            seq = _revcomp(reads_[e]) if st[e] else reads_[e]
            out.append(b"\t".join([
                name, b"%d" % flag, chrom_names[c].encode(),
                b"%d" % (at[e] - g.offsets[c] + 1),
                b"60" if (x0, x1) == (1, 0) else b"0", b"%dM" % L, b"=",
                b"%d" % (at[1 - e] - g.offsets[c] + 1),
                b"%d" % (t0 if e == 0 else -t0), seq, qual,
                b"X0:i:%d" % x0, b"X1:i:%d" % x1,
                b"XM:i:%d" % int(ctl.mm[(x, y)[e]]), b"XO:i:0", b"XG:i:0"]))
    with open(path, "wb") as fh:
        fh.write(b"\n".join(out) + b"\n")
