"""Paired-end alignment pipeline (port of soap3dp_tpu/pipeline/pair.py).

The host logic is the reference's, line for line; the device work goes
through the port's seed search, prescan and DP (torch on the index's
device, the Hopper DP kernel on CUDA).

The rebuild of soap3_dp_pair_align (alignment.cu:1896-2430), phases A-E:

A. BWT mismatch search of both ends + insert-size pairing
   (PEMappingOccurrences semantics, PEAlgnmt.cpp:480-598: the leftmost
   leg must be on strand_left_leg, the rightmost on strand_right_leg,
   and the outer distance in [min_insert, max_insert]).
B/C. half-aligned rescue: pairs with no valid BWT pairing but at least
   one aligned end — each anchor hit defines a mate window from the
   insert range (HalfEndAlgnBatch::pack geometry,
   DV-DPfunctions.cu:2027-2109) and the mate is banded-DP'd into it.
D. deep DP: both ends unaligned — seed both ends, pair candidate loci
   within the insert window, DP both ends (DeepDP_Space,
   DV-DPForBothUnalign.cu).
E. single-end salvage of leftover ends, emitted unpaired
   (DPForUnalignSingle2 call, alignment.cu:2388-2405).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from soap3dp_tpu_torch.fm.fmindex import DeviceIndex
from soap3dp_tpu_torch.fm.search import (SearchConfig, config_for,
                                   search_reads)
from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.io import sam
from soap3dp_tpu_torch.io.fastq import ReadBatch
from soap3dp_tpu_torch.io.ragged import offsets_of
from soap3dp_tpu_torch.io.sam import SamRecord, SamWriter
from soap3dp_tpu_torch.kernels.banded_dp import DPScores
from soap3dp_tpu_torch.pipeline import cigar as cig
from soap3dp_tpu_torch.pipeline import dp_rescue, hits, mapq
from soap3dp_tpu_torch.pipeline import options as opt
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.utils import rhash, shapes
from soap3dp_tpu_torch.utils import timers
from soap3dp_tpu_torch.pipeline.single import _genome_codes, _qual_bytes, _seq_bytes

# bound on candidate mates enumerated per anchor hit inside the insert
# window — only reachable in pathological repeats; truncation is logged
PAIRING_FANOUT_CAP = 2048


@dataclasses.dataclass
class PairSummary:
    num_pairs: int = 0
    paired_bwt: int = 0
    paired_dp: int = 0
    single_rescued: int = 0
    unaligned: int = 0
    num_records: int = 0
    # incompleteness counters (VERDICT r2 item 10): reads whose hit set
    # is still truncated after the round-3 escalation, and anchor hits
    # whose pairing fan-out hit PAIRING_FANOUT_CAP — surfaced per run so
    # silent truncation is visible (the reference instead re-aligns
    # such reads fully on the host, CPUfunctions.cpp:555)
    still_flagged: int = 0
    capped_anchors: int = 0

    def add(self, other: "PairSummary") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class PairCombos:
    """All valid pairings, flattened across the batch."""

    pair_id: np.ndarray   # (M,) int32
    row1: np.ndarray      # (M,) int64 row in table1
    row2: np.ndarray      # (M,) int64 row in table2
    insert: np.ndarray    # (M,) int64
    total_nm: np.ndarray  # (M,) int32
    start: np.ndarray     # (B+1,) group offsets (sorted by pair_id)
    capped: int = 0       # anchors whose mate window hit PAIRING_FANOUT_CAP


def pair_hits(t1: hits.HitTable, t2: hits.HitTable, B: int,
              lens1: np.ndarray, lens2: np.ndarray,
              opts: AlignOptions, offsets: np.ndarray | None = None
              ) -> PairCombos:
    """Insert-window pairing within each read pair (vectorized).

    The reference radix-sorts both ends' occurrence lists and
    merge-scans them for proper pairs (PEMappingOccurrences,
    PEAlgnmt.cpp:480); the equivalent here is a sorted window join:
    end-2 hits are sorted by (read, pos) and each end-1 hit looks up
    its [pos-u, pos+u] mate window with two searchsorted calls, so the
    work is proportional to the true near-pair count, never the
    n1*n2 cross product. Per-end hits honor MaxHitsEachEndForPairing
    (soap3-dp.ini, default 8000) like the reference.
    """
    cap = opts.max_hits_each_end_for_pairing
    n1 = np.minimum(t1.counts(), cap)
    n2 = np.minimum(t2.counts(), cap)
    empty = PairCombos(*(np.zeros(0, t) for t in
                         (np.int32, np.int64, np.int64, np.int64, np.int32)),
                       start=np.zeros(B + 1, np.int64))
    both = (n1 > 0) & (n2 > 0)
    if not both.any():
        return empty

    def expand(tab, n):
        rep = np.repeat(np.arange(B, dtype=np.int64), n)
        rk = np.arange(len(rep)) - np.repeat(
            np.concatenate(([0], np.cumsum(n)[:-1])), n)
        return rep, tab.start[rep] + rk

    # end-2 hits keyed by (read, pos) for the window join (the table is
    # (read, nmis, pos)-sorted, so a re-sort by position is needed)
    rep2, rows2 = expand(t2, np.where(both, n2, 0))
    key2 = (rep2 << 33) | t2.pos[rows2].astype(np.int64)
    o2 = np.argsort(key2, kind="stable")
    key2, rows2 = key2[o2], rows2[o2]

    rep1, row1e = expand(t1, np.where(both, n1, 0))
    p1e = t1.pos[row1e].astype(np.int64)
    u = int(opts.max_insert)
    lo = np.searchsorted(key2, (rep1 << 33) | np.maximum(p1e - u, 0))
    hi = np.searchsorted(key2, (rep1 << 33) | (p1e + u + 1))
    cnt = hi - lo
    over = cnt > PAIRING_FANOUT_CAP
    n_capped = int(over.sum())
    if n_capped:
        import sys
        print(f"[soap3dp] warning: pairing fan-out capped at "
              f"{PAIRING_FANOUT_CAP} mates for {n_capped} anchor "
              "hit(s) in repetitive regions", file=sys.stderr)
        # center the kept window on the anchor position so the true
        # mate (nearest the anchor) survives the cap, instead of
        # keeping the leftmost entries of the insert window
        mid = np.searchsorted(key2, (rep1 << 33) | p1e)
        lo = np.where(over, np.clip(mid - PAIRING_FANOUT_CAP // 2, lo,
                                    hi - PAIRING_FANOUT_CAP), lo)
        cnt = np.minimum(cnt, PAIRING_FANOUT_CAP)
    total = int(cnt.sum())
    if total == 0:
        return empty
    srcs = np.repeat(np.arange(len(rep1)), cnt)
    k = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt)
    row1 = row1e[srcs]
    row2 = rows2[lo[srcs] + k]
    pid = rep1[srcs].astype(np.int32)

    p1 = t1.pos[row1].astype(np.int64)
    p2 = t2.pos[row2].astype(np.int64)
    s1 = t1.strand[row1]
    s2 = t2.strand[row2]
    l1 = lens1[pid].astype(np.int64)
    l2 = lens2[pid].astype(np.int64)
    left1 = p1 <= p2  # end1 is the left leg
    # outer span = the |TLEN| emitted downstream (the old p2+l2-p1 form
    # understated it when one alignment contains the other)
    ins = np.maximum(p1 + l1, p2 + l2) - np.minimum(p1, p2)
    ok_strand = np.where(
        left1,
        (s1 == opts.strand_left_leg) & (s2 == opts.strand_right_leg),
        (s2 == opts.strand_left_leg) & (s1 == opts.strand_right_leg))
    # equal positions: either role may satisfy the arrangement
    eq = p1 == p2
    ok_strand |= eq & (
        (s2 == opts.strand_left_leg) & (s1 == opts.strand_right_leg))
    ok = ok_strand & (ins >= opts.min_insert) & (ins <= opts.max_insert)
    if offsets is not None and len(offsets) > 2:
        # both ends must land on the same chromosome: the genome is a
        # boundary-less concatenation, so a window join alone would
        # pair reads straddling a chromosome junction as FLAG_PROPER
        ok &= (np.searchsorted(offsets, p1, side="right")
               == np.searchsorted(offsets, p2, side="right"))
    if not ok.any():
        return empty
    pid, row1, row2, ins = pid[ok], row1[ok], row2[ok], ins[ok]
    tnm = (t1.nmis[row1] + t2.nmis[row2]).astype(np.int32)
    # sort by (pair, total_nm, pos1, pos2) for deterministic selection
    order = np.lexsort((t2.pos[row2], t1.pos[row1], tnm, pid))
    pid, row1, row2, ins, tnm = (pid[order], row1[order], row2[order],
                                 ins[order], tnm[order])
    start = np.searchsorted(pid, np.arange(B + 1)).astype(np.int64)
    return PairCombos(pair_id=pid, row1=row1, row2=row2, insert=ins,
                      total_nm=tnm, start=start, capped=n_capped)


@dataclasses.dataclass
class EndInfo:
    """Everything needed to emit one end of a pair."""

    chrom: int
    pos: int          # 0-based within chromosome
    strand: int
    cigar: str
    span: int         # reference span (for TLEN)
    mapq: int
    tags: list[str]


def align_pair_batch(
    index: Index,
    didx: DeviceIndex,
    b1: ReadBatch,
    b2: ReadBatch,
    opts: AlignOptions,
    writer: SamWriter,
    pending_search=None,
    rescue_queue: "RescueQueue | None" = None,
    phase2_queue: "Phase2Queue | None" = None,
) -> PairSummary:
    B = len(b1)
    summary = PairSummary(num_pairs=B)
    if phase2_queue is not None:
        # finish the PREVIOUS batch's escalated pairs first — their
        # phase-2 wire landed while this batch was parsed/dispatched
        summary.add(phase2_queue.process(writer, rescue_queue))
    lens1 = b1.lens.astype(np.int32)
    lens2 = b2.lens.astype(np.int32)
    max_len = int(max(lens1.max() if B else 0, lens2.max() if B else 0))
    k = opts.effective_mismatches(max_len)
    sc = DPScores(opts.match_score, opts.mismatch_score,
                  opts.gap_open_score, opts.gap_extend_score)

    if opts.skip_bwt_alignment:
        t1 = _empty_table(B)
        t2 = _empty_table(B)
    else:
        cfg = config_for(didx, k)
        with timers.stage("A.search"):
            h1, h2 = _search_both_ends(didx, b1, b2, lens1, lens2, cfg,
                                       pending=pending_search)
        if (np.asarray(h1.flagged).any() or np.asarray(h2.flagged).any()):
            # super-repetitive reads: host re-alignment (the reference's
            # ProcessReadDoubleStrand2 analog) replaces the round-3
            # truncated sets, occ-capped + batch-budgeted like the
            # reference's MaxHitsEachEndForPairing clamp
            from soap3dp_tpu_torch.fm import host_search
            with timers.stage("A.host_realign"):
                h1 = host_search.realign_flagged(
                    index, h1, b1.codes, lens1, k,
                    max_decode=opts.max_hits_each_end_for_pairing,
                    budget=opts.host_realign_budget)
                h2 = host_search.realign_flagged(
                    index, h2, b2.codes, lens2, k,
                    max_decode=opts.max_hits_each_end_for_pairing,
                    budget=opts.host_realign_budget)
        with timers.stage("A.tables"):
            t1 = hits.hits_to_table(h1, B, index, lens1)
            t2 = hits.hits_to_table(h2, B, index, lens2)
        summary.still_flagged += int(np.asarray(h1.flagged).sum()
                                     + np.asarray(h2.flagged).sum())
    with timers.stage("A.pairing"):
        st1 = hits.read_stats(t1, B)
        st2 = hits.read_stats(t2, B)
        combos = pair_hits(t1, t2, B, lens1, lens2, opts,
                           offsets=index.offsets)
        summary.capped_anchors += combos.capped

    done = np.zeros(B, bool)
    # ---- phase A: emit BWT pairs (vectorized batch emission) ----
    paired = np.flatnonzero(np.diff(combos.start) > 0)
    phased = (not opts.skip_bwt_alignment and pending_search is not None
              and getattr(pending_search, "seed_hi", k + 1) < k + 1)
    if phased and paired.size and opts.output_mode != opt.OUTPUT_RANDOM_BEST:
        # phase-1 hit sets are complete for <= 1 mismatch per end. The
        # reference's phase-1 success criterion (all_best_alignment,
        # alignment.cu:1236): a pair formable from the two ends'
        # <=1-mismatch sets stops there — e.g. a (1,1)-mismatch pair is
        # accepted at phase 1 and never sees 2-mismatch placements. The
        # analog here: resolve pairs with at least one combo whose BOTH
        # ends come from the <=1-complete region; the rest search the
        # remaining segments first. Random-best accepts any phase-1
        # pair (four_phases_alignment semantics, alignment.cu:1119).
        okc = ((t1.nmis[combos.row1] <= 1) & (t2.nmis[combos.row2] <= 1))
        has = np.bincount(combos.pair_id[okc], minlength=B) > 0
        resolved = paired[has[paired]]
    else:
        resolved = paired
    pend2 = sel2 = None
    if phased:
        todo_m = np.ones(B, bool)
        todo_m[resolved] = False
        todo = np.flatnonzero(todo_m)
        if todo.size:
            # dispatch segments {2..k} for the unresolved pairs NOW: the
            # device searches while phase-A emission runs on the host
            with timers.stage("pair.phase2_prep"):
                pend2, sel2, nb2 = _dispatch_phase2(didx, b1, b2, todo,
                                                    lens1, lens2, k)
    if resolved.size:
        with timers.stage("A.emit"):
            _emit_bwt_pairs_batch(index, writer, b1, b2, t1, t2, st1, st2,
                                  combos, resolved, lens1, lens2, opts)
        done[resolved] = True
        summary.paired_bwt += len(resolved)
        summary.num_records += 2 * len(resolved)

    todo = np.flatnonzero(~done)
    if pend2 is not None and todo.size:
        # ---- phase A2: merged-table retry of the escalated pairs ----
        # (union of phase-1 and phase-2 segments = the full pigeonhole
        # search: escalated pairs see exactly the complete <= k set)
        with timers.stage("pair.phase2_prep"):
            item = _Phase2Item(
                pend2=pend2, k=k, nt=len(todo), nb=nb2,
                sb1=_subset_batch(b1, sel2), sb2=_subset_batch(b2, sel2),
                l1=lens1[sel2], l2=lens2[sel2],
                t1sub=hits.subset_table(t1, todo),
                t2sub=hits.subset_table(t2, todo))
        if phase2_queue is not None:
            # deferred: fetched at the start of the NEXT batch's
            # align, hiding the device latency + D2H sync behind a
            # full batch of host work (same deferral as RescueQueue)
            phase2_queue.add(item)
        else:
            _phase2_finish(index, didx, item, opts, sc, writer,
                           rescue_queue, summary)
        return summary

    if todo.size and rescue_queue is not None:
        # phases B-E run deferred: failures from several input batches
        # flush as one large rescue batch (see RescueQueue)
        with timers.stage("pair.rescue_enqueue"):
            rescue_queue.add(b1, b2, todo, t1, t2)
    elif todo.size:
        _run_rescue_phases(index, didx, b1, b2, t1, t2, st1, st2, todo,
                           lens1, lens2, opts, sc, writer, summary)
    return summary


def _subset_batch(b: ReadBatch, ids: np.ndarray) -> ReadBatch:
    return b.take(ids)


def _trim_batch(b: ReadBatch, n: int) -> ReadBatch:
    return b.take(slice(None, n))


@dataclasses.dataclass
class _Phase2Item:
    """A dispatched phase-2 search with everything needed to finish it."""

    pend2: object          # PendingSearch over segments {2..k}
    k: int
    nt: int                # real escalated-pair count (rest is padding)
    nb: int                # bucketed/padded pair count
    sb1: ReadBatch         # padded subset batches (nb pairs)
    sb2: ReadBatch
    l1: np.ndarray
    l2: np.ndarray
    t1sub: hits.HitTable   # phase-1 hits of the escalated pairs (nt)
    t2sub: hits.HitTable


class Phase2Queue:
    """One-batch-deep pipeline for phase-2 completions: items added
    during batch i are finished at the start of batch i+1's align (and
    drained by the runner after the last batch)."""

    def __init__(self, index, didx, opts: AlignOptions):
        self.index = index
        self.didx = didx
        self.opts = opts
        self.sc = DPScores(opts.match_score, opts.mismatch_score,
                           opts.gap_open_score, opts.gap_extend_score)
        self._items: list[_Phase2Item] = []

    def add(self, item: _Phase2Item) -> None:
        self._items.append(item)

    def process(self, writer, rescue_queue=None) -> PairSummary:
        s = PairSummary()
        # pop each item only after it finishes: if _phase2_finish raises
        # (e.g. device OOM surfacing at the fetch), the failed item and
        # everything behind it stay queued, so the caller's retry path
        # (runner._align_backoff re-enters align_pair_batch, which calls
        # process() again) neither drops nor double-emits those pairs
        while self._items:
            _phase2_finish(self.index, self.didx, self._items[0], self.opts,
                           self.sc, writer, rescue_queue, s)
            self._items.pop(0)
        return s


def _phase2_finish(index, didx, it: _Phase2Item, opts, sc, writer,
                   rescue_queue, summary) -> None:
    """Fetch a dispatched phase-2 search and finish its pairs: merge
    with the phase-1 hits (hits.merge_tables drops cross-phase
    duplicates), re-pair, emit, and route leftovers to rescue."""
    cfg = config_for(didx, it.k)
    with timers.stage("A2.fetch"):
        h1b, h2b = _search_both_ends(didx, it.sb1, it.sb2, it.l1, it.l2,
                                     cfg, pending=it.pend2)
    if (np.asarray(h1b.flagged).any() or np.asarray(h2b.flagged).any()):
        from soap3dp_tpu_torch.fm import host_search
        with timers.stage("A.host_realign"):
            h1b = host_search.realign_flagged(
                index, h1b, it.sb1.codes, it.l1, it.k,
                max_decode=opts.max_hits_each_end_for_pairing,
                budget=opts.host_realign_budget)
            h2b = host_search.realign_flagged(
                index, h2b, it.sb2.codes, it.l2, it.k,
                max_decode=opts.max_hits_each_end_for_pairing,
                budget=opts.host_realign_budget)
    nt = it.nt
    with timers.stage("A2.tables"):
        # count only reads newly still-flagged in phase 2 (phase-1
        # stills were already counted when their batch was aligned)
        summary.still_flagged += int(
            (np.asarray(h1b.flagged)[:nt] & ~it.t1sub.flagged).sum()
            + (np.asarray(h2b.flagged)[:nt] & ~it.t2sub.flagged).sum())
        t1b = hits.hits_to_table(h1b, it.nb, index, it.l1)
        t2b = hits.hits_to_table(h2b, it.nb, index, it.l2)
        trim = np.arange(nt)
        mt1 = hits.merge_tables(it.t1sub, hits.subset_table(t1b, trim))
        mt2 = hits.merge_tables(it.t2sub, hits.subset_table(t2b, trim))
    sb1 = _trim_batch(it.sb1, nt)
    sb2 = _trim_batch(it.sb2, nt)
    sl1, sl2 = it.l1[:nt], it.l2[:nt]
    with timers.stage("A.pairing"):
        mst1 = hits.read_stats(mt1, nt)
        mst2 = hits.read_stats(mt2, nt)
        combos2 = pair_hits(mt1, mt2, nt, sl1, sl2, opts,
                            offsets=index.offsets)
        summary.capped_anchors += combos2.capped
    paired2 = np.flatnonzero(np.diff(combos2.start) > 0)
    if paired2.size:
        with timers.stage("A.emit"):
            _emit_bwt_pairs_batch(index, writer, sb1, sb2, mt1, mt2,
                                  mst1, mst2, combos2, paired2,
                                  sl1, sl2, opts)
        summary.paired_bwt += len(paired2)
        summary.num_records += 2 * len(paired2)
    left_m = np.ones(nt, bool)
    left_m[paired2] = False
    left = np.flatnonzero(left_m)
    if left.size:
        if rescue_queue is not None:
            with timers.stage("pair.rescue_enqueue"):
                rescue_queue.add(sb1, sb2, left, mt1, mt2)
        else:
            _run_rescue_phases(index, didx, sb1, sb2, mt1, mt2, mst1,
                               mst2, left, sl1, sl2, opts, sc, writer,
                               summary)


def _dispatch_phase2(didx, b1, b2, todo, lens1, lens2, k):
    """Async phase-2 search (segments {2..k}) over the unresolved
    pairs' reads, padded to a bucketed row count to stabilize compile
    shapes (pad rows repeat pair 0 and are trimmed after)."""
    from soap3dp_tpu_torch.fm.search import PendingSearch

    cfg = config_for(didx, k)
    nb = shapes.bucket(len(todo), min_size=512)
    sel = todo if len(todo) >= nb else np.concatenate(
        [todo, np.zeros(nb - len(todo), np.int64)])
    L = max(b1.codes.shape[1], b2.codes.shape[1])

    def pad(c):
        return shapes.pad_cols(c, L)

    reads = np.concatenate([pad(b1.codes)[sel], pad(b2.codes)[sel]])
    lens = np.concatenate([lens1[sel], lens2[sel]])
    return (PendingSearch(didx, reads, lens, cfg,
                          seed_range=(2, cfg.num_seeds)), sel, nb)




def _run_rescue_phases(index, didx, b1, b2, t1, t2, st1, st2, todo,
                       lens1, lens2, opts, sc, writer, summary) -> None:
    """Phases B-E over the pairs phase A could not pair (`todo`)."""
    B = len(b1)
    done = np.ones(B, bool)
    done[todo] = False
    if opts.dp_enabled:
        # ---- phase B/C: half-aligned rescue ----
        half = np.flatnonzero(~done & ((st1.best_nmis >= 0) | (st2.best_nmis >= 0)))
        if half.size:
            with timers.stage("BC.half_rescue"):
                n = _half_aligned_rescue(index, didx, b1, b2, t1, t2, st1, st2,
                                         half, lens1, lens2, opts, sc, writer)
            done[n] = True
            summary.paired_dp += len(n)
            summary.num_records += 2 * len(n)
        # ---- phase D: deep DP for both-unaligned ----
        # reference default ProceedDPForTooManyHits=0 (soap3-dp.ini:107;
        # CPUfunctions.cpp:2843 discards over-cap seeds): a pair whose
        # BOTH ends stayed over the occurrence budget contributes no
        # usable DP seeds and is emitted unmapped — on satellite/
        # microsatellite-dense genomes thousands of such pairs per
        # batch would otherwise flood the deep-DP engine with
        # meaningless candidates
        dp_able = ~done
        if not opts.dp_for_too_many_hits:
            dp_able &= ~(t1.flagged & t2.flagged)
        deep = np.flatnonzero(dp_able)
        if deep.size:
            with timers.stage("D.deep_dp"):
                n = _deep_dp_rescue(index, didx, b1, b2, deep, lens1, lens2,
                                    opts, sc, writer)
            done[n] = True
            summary.paired_dp += len(n)
            summary.num_records += 2 * len(n)
        # ---- phase E: single-end salvage, unpaired output ----
        # same ProceedDPForTooManyHits gate: both-ends-over-cap pairs
        # skip per-end DP salvage and fall to the unmapped emitter
        leftover = np.flatnonzero(dp_able & ~done)
        if leftover.size:
            with timers.stage("E.salvage"):
                n_records = _single_salvage_pairs(index, didx, b1, b2, leftover,
                                                  lens1, lens2, opts, sc, writer,
                                                  summary)
            done[leftover] = True
            summary.num_records += n_records

    for b in np.flatnonzero(~done):
        _emit_unmapped_pair(writer, b1, b2, b)
        summary.unaligned += 1
        summary.num_records += 2


class RescueQueue:
    """Cross-batch accumulator for the DP rescue phases B-E.

    Phase A pairs ~97% of typical data; the rescue phases then run on a
    few thousand pairs, where fixed dispatch/transfer latency per
    device call dwarfs the useful work. Queued failures from several
    input batches flush as ONE large rescue batch. Output is unsorted
    (SO:unsorted), so deferred emission is equivalent — the reference
    similarly holds records in its OCC caches and flushes unpaired
    output at its own boundaries (BGS-IO.h:69-76).
    """

    def __init__(self, index, didx, opts: AlignOptions,
                 flush_pairs: int = 16384):
        self.index = index
        self.didx = didx
        self.opts = opts
        self.flush_pairs = flush_pairs
        self._items: list[tuple] = []
        self._pending = 0

    def add(self, b1: ReadBatch, b2: ReadBatch, ids: np.ndarray,
            t1: hits.HitTable, t2: hits.HitTable) -> None:
        self._items.append((
            b1.take(ids), b2.take(ids),
            hits.subset_table(t1, ids), hits.subset_table(t2, ids)))
        self._pending += len(ids)

    @property
    def pending(self) -> int:
        return self._pending

    def should_flush(self) -> bool:
        return self._pending >= self.flush_pairs

    def drain(self) -> list[tuple]:
        """Atomically take everything queued (main-thread only); pass
        the result to flush_items — possibly on a worker thread."""
        items, self._items, self._pending = self._items, [], 0
        return items

    def flush(self, writer) -> PairSummary:
        """Run phases B-E on everything queued; returns their summary
        (num_pairs = 0: the pairs were already counted at phase A)."""
        return self.flush_items(self.drain(), writer)

    def flush_items(self, items: list[tuple], writer) -> PairSummary:
        """Phases B-E over a drained item list. Touches no queue state,
        so it may run on a worker thread (pipeline.overlap.AsyncFlusher)
        while the main loop keeps adding to the queue — the flush's
        device waits then overlap the next batches' host work. The
        writer must be thread-safe in that case (io.aio.AsyncWriter)."""
        summary = PairSummary()
        if not items:
            return summary
        cb1 = _concat_batches([it[0] for it in items])
        cb2 = _concat_batches([it[1] for it in items])
        t1 = hits.concat_tables([it[2] for it in items])
        t2 = hits.concat_tables([it[3] for it in items])
        B = len(cb1)
        lens1 = cb1.lens.astype(np.int32)
        lens2 = cb2.lens.astype(np.int32)
        st1 = hits.read_stats(t1, B)
        st2 = hits.read_stats(t2, B)
        sc = DPScores(self.opts.match_score, self.opts.mismatch_score,
                      self.opts.gap_open_score, self.opts.gap_extend_score)
        _run_rescue_phases(self.index, self.didx, cb1, cb2, t1, t2, st1, st2,
                           np.arange(B), lens1, lens2, self.opts, sc, writer,
                           summary)
        return summary


def _concat_batches(batches: list[ReadBatch]) -> ReadBatch:
    L = max(b.codes.shape[1] for b in batches)

    def pad(c):
        return shapes.pad_cols(c, L)

    names = np.concatenate([np.asarray(b.names, dtype="S")
                            for b in batches])
    quals = None
    if all(b.quals is not None for b in batches):
        quals = np.concatenate([pad(b.quals) for b in batches])
    return ReadBatch(names=names,
                     codes=np.concatenate([pad(b.codes) for b in batches]),
                     lens=np.concatenate([b.lens for b in batches]),
                     quals=quals)


def _phase1_range(didx, opts: AlignOptions, k: int) -> tuple[int, int] | None:
    """Segment range for the phased round-1 search, or None (full).

    Segments {0,1} of the k+1-segmentation are complete for <= 1
    mismatch; -h 1 (all-valid) needs the complete <= k set for every
    read, and k < 2 already searches <= 2 segments. Phasing only pays
    where seeds need FM extension steps past the LUT (genome larger
    than 4^lut_k): on LUT-only configs the search is too cheap to beat
    the extra phase-2 dispatch + sync (measured -15% at 40 Mbp vs
    +21% at 250 Mbp)."""
    import os

    from soap3dp_tpu_torch.fm.search import default_seed_q

    if (not opts.phased_search or os.environ.get("SOAP3DP_NO_PHASED")
            or opts.output_mode == opt.OUTPUT_ALL_VALID or k < 2):
        return None
    cfg = SearchConfig(k=k)
    if default_seed_q(didx, cfg) <= didx.lut_k:
        return None
    return (0, 2)


def dispatch_pair_search(didx, b1, b2, opts: AlignOptions):
    """Async-dispatch the combined both-ends search for a pair batch.

    The TPU analog of the reference's double-buffered batch loop
    (alignment.cu:554-561): call this for batch i+1 before doing batch
    i's host work, then hand the pending object to align_pair_batch.
    Under the phased scheme this is the phase-1 (segments {0,1}) search.
    """
    from soap3dp_tpu_torch.fm.search import PendingSearch

    lens1 = b1.lens.astype(np.int32)
    lens2 = b2.lens.astype(np.int32)
    B = len(b1)
    max_len = int(max(lens1.max() if B else 0, lens2.max() if B else 0))
    cfg = config_for(didx, opts.effective_mismatches(max_len))
    L = max(b1.codes.shape[1], b2.codes.shape[1])

    def pad(c):
        return shapes.pad_cols(c, L)

    reads_all = np.concatenate([pad(b1.codes), pad(b2.codes)])
    lens_all = np.concatenate([lens1, lens2])
    return PendingSearch(didx, reads_all, lens_all, cfg,
                         seed_range=_phase1_range(didx, opts, cfg.k))


def _search_both_ends(didx, b1, b2, lens1, lens2, cfg, pending=None):
    """One device search over both ends (2B reads): halves the dispatch
    and D2H-latency count vs per-end searches, then splits the flat hit
    arrays back into per-end HitArrays on the host."""
    from soap3dp_tpu_torch.fm.search import HitArrays

    B = len(b1)
    L = max(b1.codes.shape[1], b2.codes.shape[1])

    def pad(c):
        return shapes.pad_cols(c, L)

    if pending is None:
        reads_all = np.concatenate([pad(b1.codes), pad(b2.codes)])
        lens_all = np.concatenate([lens1, lens2])
        h = search_reads(didx, reads_all, lens_all, cfg)
    else:
        h = pending.result()
    with timers.stage("pair.split_hits"):
        row, tp, nm, va, flagged = h.to_host()
        B2 = 2 * B
        strand = (row >= B2) & va
        rid = np.where(va, row - strand * B2, 0)
        is2 = rid >= B
        out = []
        for endsel in (~is2, is2):
            m = va & endsel
            r = rid[m] - (B if endsel is is2 else 0) + strand[m] * B
            out.append(HitArrays(
                row=r.astype(np.int32), tp=tp[m], nmis=nm[m],
                valid=np.ones(r.shape[0], bool),
                flagged=flagged[:B] if endsel is not is2 else flagged[B:]))
    return out[0], out[1]


def _empty_table(B):
    return hits.HitTable(
        read_id=np.zeros(0, np.int32), strand=np.zeros(0, np.int8),
        pos=np.zeros(0, np.uint32), nmis=np.zeros(0, np.int32),
        start=np.zeros(B + 1, np.int64), flagged=np.zeros(B, bool))


def _emit_bwt_pairs_batch(index, writer, b1, b2, t1, t2, st1, st2, combos,
                          paired, lens1, lens2, opts):
    """Vectorized phase-A emission: all per-pair math is batched; the
    per-record loop only assembles the pre-computed columns. Pairs with
    XA alternates go through the block writer too where its block form
    takes them (``block_alternates``); under -p (MD/NM), for a writer
    without it, and for -h 3's unmapped ties, the per-record path."""
    mode = opts.output_mode
    s = combos.start
    tnm = combos.total_nm
    rid = combos.pair_id
    B = len(s) - 1
    first = s[paired]
    best = tnm[first]
    best_of = np.zeros(B, np.int32)
    best_of[paired] = best
    is_best = tnm == best_of[rid]
    n_best = np.bincount(rid[is_best], minlength=B)[paired].astype(np.int64)
    n_total = (s[1:] - s[:-1])[paired]

    if mode == opt.OUTPUT_RANDOM_BEST:
        # pick = f(seed, pair name): batch-layout invariant and exactly
        # uniform over the n_best equal-best combos (utils/rhash.py)
        ph = rhash.name_hashes(np.asarray(b1.names)[paired],
                               opts.random_seed)
        pick = rhash.unbiased_pick(ph, n_best)
        prim = first + pick
    else:
        prim = first
    ok = np.ones(len(paired), bool)
    if mode == opt.OUTPUT_UNIQUE_BEST:
        ok = n_best == 1

    has_sub = n_best < n_total
    sec = np.where(has_sub, tnm[np.minimum(first + n_best, len(tnm) - 1)], 0)
    l1 = lens1[paired].astype(np.int64)
    l2 = lens2[paired].astype(np.int64)
    if opts.bwa_like_score:
        opsc = (l1 + l2 - best) * opts.match_score + best * opts.mismatch_score
        subsc = (l1 + l2 - sec) * opts.match_score + sec * opts.mismatch_score
        mq1, mq2 = mapq.bwa_like_pair(
            st1.x0[paired], st1.x1[paired], st2.x0[paired], st2.x1[paired],
            opsc, n_best, subsc, np.maximum(n_total - n_best, 0), l1, l2)
    else:
        r1p = combos.row1[prim]
        r2p = combos.row2[prim]
        amq1 = mapq.avg_mismatch_qual(
            index, t1.pos[r1p], t1.strand[r1p], b1.codes[paired],
            lens1[paired], None if b1.quals is None else b1.quals[paired])
        amq2 = mapq.avg_mismatch_qual(
            index, t2.pos[r2p], t2.strand[r2p], b2.codes[paired],
            lens2[paired], None if b2.quals is None else b2.quals[paired])
        mq1 = mapq.table_single(
            np.maximum(t1.nmis[r1p], 0), amq1,
            st1.x0[paired], st1.x1[paired], opts.max_mapq, opts.min_mapq)
        mq2 = mapq.table_single(
            np.maximum(t2.nmis[r2p], 0), amq2,
            st2.x0[paired], st2.x1[paired], opts.max_mapq, opts.min_mapq)

    r1 = combos.row1[prim]
    r2 = combos.row2[prim]
    a1 = t1.pos[r1].astype(np.int64)
    a2 = t2.pos[r2].astype(np.int64)
    c1, o1 = sam.translate_pos(index, a1)
    c2, o2 = sam.translate_pos(index, a2)
    s1 = t1.strand[r1]
    s2 = t2.strand[r2]
    lo_ = np.minimum(a1, a2)
    hi_ = np.maximum(a1 + l1, a2 + l2)
    tl = hi_ - lo_
    tlen1 = np.where(a1 <= a2, tl, -tl)
    base = sam.FLAG_PAIRED | sam.FLAG_PROPER
    f1 = (base | sam.FLAG_FIRST | np.where(s1 == 1, sam.FLAG_REVERSE, 0)
          | np.where(s2 == 1, sam.FLAG_MATE_REVERSE, 0))
    f2 = (base | sam.FLAG_SECOND | np.where(s2 == 1, sam.FLAG_REVERSE, 0)
          | np.where(s1 == 1, sam.FLAG_MATE_REVERSE, 0))

    needs_tags = getattr(writer, "needs_tags", True) or opts.output_md
    # how many hits the mode reports per pair (alternates -> XA)
    if mode == opt.OUTPUT_ALL_VALID:
        n_sel = np.minimum(n_total, opts.max_output_per_pair)
    elif mode == opt.OUTPUT_ALL_BEST:
        n_sel = np.minimum(n_best, opts.max_output_per_pair)
    else:
        n_sel = np.ones(len(paired), np.int64)
    slow = (n_sel > 1) | opts.output_md

    def block(fi, xa=None):
        """Both records of the pairs paired[fi] in one write_block."""
        bsel = paired[fi]
        n1a = np.asarray(b1.names)[bsel]
        n2a = np.asarray(b2.names)[bsel]
        W = max(n1a.dtype.itemsize, n2a.dtype.itemsize)
        names = np.empty(2 * len(fi), f"S{W}")
        names[0::2] = n1a
        names[1::2] = n2a

        def inter(a, b_):
            return np.stack([np.asarray(a)[fi], np.asarray(b_)[fi]],
                            axis=1).reshape(-1)

        # cigars=None -> gapless "<len>M" formatted by the writer
        # (the SAM C path digits them from seq_lens; VERDICT r3 #4).
        # l1/l2 are already the per-`paired` lengths — `inter` indexes
        # with fi (positions in the paired subset), so full-batch
        # lens1/lens2 must NOT go through it (ADVICE r4 high).
        kw = {"seq_lens": inter(l1, l2)}
        if getattr(writer, "needs_seq", True):
            # two-source form: the full batch code/qual matrices go
            # down uncopied, seq_src picks rows (>=0 -> mate1, <0 ->
            # ~mate2); the old (2N, L) interleave copy cost ~0.26us/rec
            # on the emitting thread
            kw["seq_codes"] = (b1.codes, b2.codes)
            src = np.empty(2 * len(fi), np.int64)
            src[0::2] = bsel
            src[1::2] = ~bsel
            kw["seq_src"] = src
            if b1.quals is not None and b2.quals is not None:
                kw["quals"] = (b1.quals, b2.quals)
        if needs_tags:
            kw["tags"] = (inter(st1.x0[paired], st2.x0[paired]),
                          inter(st1.x1[paired], st2.x1[paired]),
                          inter(t1.nmis[r1], t2.nmis[r2]))
        if xa is not None:
            kw["xa"] = xa
        writer.write_block(
            names, inter(f1, f2), inter(c1, c2), inter(o1, o2),
            inter(mq1, mq2), None, np.zeros(2 * len(fi), np.int32),
            mate_chroms=inter(c2, c1), mate_poss=inter(o2, o1),
            tlens=inter(tlen1, -tlen1), **kw)

    # plain proper pairs go through the columnar block writer when the
    # output format supports it; pairs with alternates follow as a
    # second block, their XA as a column, where the writer formats it
    keep = np.ones(len(paired), bool)
    if hasattr(writer, "write_block"):
        fast = ok & ~slow
        if fast.any():
            block(np.flatnonzero(fast))
        keep = ~fast
        if getattr(writer, "block_alternates", False) and not opts.output_md:
            ti = np.flatnonzero(ok & (n_sel > 1))
            timers.count("pair.tie_block_pairs", len(ti))
            if len(ti):
                with timers.stage("pair.tie_emit"):
                    xa = _pair_alternates(index, t1, t2, combos, first[ti],
                                          n_sel[ti])
                    block(ti, xa)
                timers.count("pair.xa_entries", len(xa[1]))
            keep[ti] = False
    # the pairs with alternates left to the per-record loop: their XA
    # tags from the same alternates, formatted a record at a time
    ri = np.flatnonzero(keep & ok & (n_sel > 1))
    timers.count("pair.tie_record_pairs", len(ri))
    xa_tags = {}
    if len(ri):
        xa = _pair_alternates(index, t1, t2, combos, first[ri], n_sel[ri])
        timers.count("pair.xa_entries", len(xa[1]))
        lens = np.stack([l1[ri], l2[ri]], axis=1).reshape(-1)
        tags = _xa_tags(index, xa, lens)
        xa_tags = dict(zip(paired[ri].tolist(), zip(tags[0::2], tags[1::2])))

    cols = list(zip(
        paired[keep].tolist(), ok[keep].tolist(), prim[keep].tolist(),
        c1[keep].tolist(), o1[keep].tolist(), s1[keep].tolist(),
        int_list(mq1[keep]),
        c2[keep].tolist(), o2[keep].tolist(), s2[keep].tolist(),
        int_list(mq2[keep]),
        tlen1[keep].tolist(), f1[keep].tolist(), f2[keep].tolist(),
        t1.nmis[r1[keep]].tolist(), t2.nmis[r2[keep]].tolist(),
        st1.x0[paired[keep]].tolist(), st1.x1[paired[keep]].tolist(),
        st2.x0[paired[keep]].tolist(), st2.x1[paired[keep]].tolist()))
    for (b, okb, pr, ch1, of1, st1b, m1, ch2, of2, st2b, m2, tlb, fl1, fl2,
         nm1, nm2, x01, x11, x02, x12) in cols:
        if not okb:
            _emit_unmapped_pair(writer, b1, b2, b)
            continue
        rl1, rl2 = int(lens1[b]), int(lens2[b])
        if needs_tags:
            tags1 = [f"X0:i:{x01}", f"X1:i:{x11}", f"XM:i:{nm1}", "XO:i:0",
                     "XG:i:0"]
            tags2 = [f"X0:i:{x02}", f"X1:i:{x12}", f"XM:i:{nm2}", "XO:i:0",
                     "XG:i:0"]
        else:
            tags1 = []
            tags2 = []
        if opts.output_md:
            _md_tags(index, b1, b2, b, t1, t2, combos, pr, tags1, tags2,
                     rl1, rl2)
        if b in xa_tags:
            for tags, xt in zip((tags1, tags2), xa_tags[b]):
                if xt:
                    tags.append(xt)
        writer.write(SamRecord(
            qname=b1.names[b], flag=fl1, chrom=ch1, pos=of1, mapq=m1,
            cigar=f"{rl1}M", seq=_seq_bytes(b1, b, writer), qual=_qual_bytes(b1, b, writer),
            mate_chrom=ch2, mate_pos=of2, tlen=tlb, tags=tags1))
        writer.write(SamRecord(
            qname=b2.names[b], flag=fl2, chrom=ch2, pos=of2, mapq=m2,
            cigar=f"{rl2}M", seq=_seq_bytes(b2, b, writer), qual=_qual_bytes(b2, b, writer),
            mate_chrom=ch1, mate_pos=of1, tlen=-tlb, tags=tags2))


def int_list(x) -> list:
    return np.asarray(x).tolist()


def _md_tags(index, b1, b2, b, t1, t2, combos, prim, tags1, tags2, rl1,
             rl2):
    """Per-record extras under -p: NM first, MD last."""
    from soap3dp_tpu_torch.utils import dna

    for (batch, table, row, rl, tags) in ((b1, t1, combos.row1[prim], rl1, tags1),
                                          (b2, t2, combos.row2[prim], rl2, tags2)):
        codes = batch.codes[b, :rl]
        if table.strand[row]:
            codes = dna.revcomp_codes(codes)
        md, nm = sam.mismatch_md(index, int(table.pos[row]), codes)
        tags.insert(0, f"NM:i:{nm}")
        tags.append(f"MD:Z:{md}")


def _pair_alternates(index, t1, t2, combos, first, n_sel):
    """The XA alternates of T pairs, for write_block's ``xa``: one CSR
    group over their 2T records, end 1 and end 2 of each pair in turn.
    A pair's alternates are its combos first + 1 .. first + n_sel - 1
    (under -h 1 and -h 2 the primary is the first, and n_sel is already
    cut to max_output_per_pair); each end drops a (pos, strand) it has
    already listed, keeping the first."""
    T = len(first)
    n = np.asarray(n_sel, np.int64) - 1
    grp = np.repeat(np.arange(T, dtype=np.int64), n)
    rows = (np.repeat(first + 1 - offsets_of(n)[:-1], n)
            + np.arange(len(grp), dtype=np.int64))
    rec, pos, strand, nm = [], [], [], []
    for e, (t, crow) in enumerate(((t1, combos.row1), (t2, combos.row2))):
        r = crow[rows]
        p = t.pos[r].astype(np.int64)
        s = t.strand[r].astype(np.int64)
        # np.unique's index is each key's first occurrence
        keep = np.sort(np.unique((grp << 34) | (p << 1) | s,
                                 return_index=True)[1])
        rec.append(2 * grp[keep] + e)
        pos.append(p[keep])
        strand.append(s[keep])
        nm.append(t.nmis[r[keep]])
    rec = np.concatenate(rec)
    order = np.argsort(rec, kind="stable")
    chrom, off = sam.translate_pos(index, np.concatenate(pos)[order])
    return (offsets_of(np.bincount(rec, minlength=2 * T)), chrom,
            np.concatenate(strand)[order], off, np.concatenate(nm)[order])


def _gapless_end(index, batch, table, row, b, mq, st, opts) -> EndInfo:
    rlen = int(batch.lens[b])
    chrom, off = sam.translate_pos(index, np.asarray([table.pos[row]]))
    tags = [f"X0:i:{st.x0[b]}", f"X1:i:{st.x1[b]}",
            f"XM:i:{table.nmis[row]}", "XO:i:0", "XG:i:0"]
    if opts.output_md:
        codes = batch.codes[b, :rlen]
        if table.strand[row]:
            from soap3dp_tpu_torch.utils import dna
            codes = dna.revcomp_codes(codes)
        md, nm = sam.mismatch_md(index, int(table.pos[row]), codes)
        tags = [f"NM:i:{nm}"] + tags + [f"MD:Z:{md}"]
    return EndInfo(chrom=int(chrom[0]), pos=int(off[0]),
                   strand=int(table.strand[row]), cigar=f"{rlen}M",
                   span=rlen, mapq=mq, tags=tags)


def _xa_tags(index, xa, lens) -> list[str]:
    """Each record's "XA:Z:..." tag ("" for none) from _pair_alternates'
    group, in sam.xa_entry's form; lens gives each record's length."""
    off, chrom, strand, pos, nm = (np.asarray(a).tolist() for a in xa)
    names = [n.encode() for n in index.names]
    out = []
    for i, rl in enumerate(np.asarray(lens).tolist()):
        ents = "".join(sam.xa_entry(names[chrom[e]], strand[e], pos[e],
                                    f"{rl}M", nm[e])
                       for e in range(off[i], off[i + 1]))
        out.append("XA:Z:" + ents if ents else "")
    return out


def emit_pair(writer, b1, b2, b, e1: EndInfo, e2: EndInfo, proper: bool):
    """Write both records of a mapped pair with mate fields and TLEN."""
    base = sam.FLAG_PAIRED | (sam.FLAG_PROPER if proper else 0)
    f1 = base | sam.FLAG_FIRST | (sam.FLAG_REVERSE if e1.strand else 0) \
        | (sam.FLAG_MATE_REVERSE if e2.strand else 0)
    f2 = base | sam.FLAG_SECOND | (sam.FLAG_REVERSE if e2.strand else 0) \
        | (sam.FLAG_MATE_REVERSE if e1.strand else 0)
    if e1.chrom == e2.chrom:
        left = min(e1.pos, e2.pos)
        right = max(e1.pos + e1.span, e2.pos + e2.span)
        tlen = right - left
        t1 = tlen if e1.pos <= e2.pos else -tlen
        t2 = -t1 if t1 != 0 else 0
    else:
        t1 = t2 = 0
    writer.write(SamRecord(
        qname=b1.names[b], flag=f1, chrom=e1.chrom, pos=e1.pos,
        mapq=e1.mapq, cigar=e1.cigar, seq=_seq_bytes(b1, b, writer),
        qual=_qual_bytes(b1, b, writer), mate_chrom=e2.chrom, mate_pos=e2.pos,
        tlen=t1, tags=e1.tags))
    writer.write(SamRecord(
        qname=b2.names[b], flag=f2, chrom=e2.chrom, pos=e2.pos,
        mapq=e2.mapq, cigar=e2.cigar, seq=_seq_bytes(b2, b, writer),
        qual=_qual_bytes(b2, b, writer), mate_chrom=e1.chrom, mate_pos=e1.pos,
        tlen=t2, tags=e2.tags))


def _emit_unmapped_pair(writer, b1, b2, b):
    f = sam.FLAG_PAIRED | sam.FLAG_UNMAPPED | sam.FLAG_MATE_UNMAPPED
    writer.write(SamRecord(
        qname=b1.names[b], flag=f | sam.FLAG_FIRST, chrom=-1, pos=-1,
        mapq=0, cigar="", seq=_seq_bytes(b1, b, writer), qual=_qual_bytes(b1, b, writer)))
    writer.write(SamRecord(
        qname=b2.names[b], flag=f | sam.FLAG_SECOND, chrom=-1, pos=-1,
        mapq=0, cigar="", seq=_seq_bytes(b2, b, writer), qual=_qual_bytes(b2, b, writer)))


# ------------------------------------------------------------------
# Phase B/C: half-aligned rescue
# ------------------------------------------------------------------

MAX_ANCHORS = 8  # anchors tried per pair (best-first)


def _half_aligned_rescue(index, didx, b1, b2, t1, t2, st1, st2, half,
                         lens1, lens2, opts, sc, writer) -> np.ndarray:
    """DP the unaligned mate into windows derived from anchor hits.

    All (up to MAX_ANCHORS) anchors are packed into ONE DP batch and the
    best mate placement is selected globally — the reference's
    HalfEndAlgnBatch semantics (DV-DPfunctions.cu:2027-2109). Most
    pairs have one or two anchor hits, so a best-first escalation would
    barely shrink the DP batch while paying a whole extra
    dispatch/transfer round trip per batch.
    """
    rescued_all: list[np.ndarray] = []
    remaining = half
    # phase B analog (newSemiGlobalDP, DV-SemiDP.cu:345): seed the
    # hitless mate and DP narrow windows around seeded loci that
    # satisfy an anchor's insert range. Off by default: with the
    # full-window DP already batched, the extra seeding stage costs
    # more than it saves on this hardware (opts.half_rescue_seeded).
    if opts.half_rescue_seeded:
        got = _half_seeded_round(index, didx, b1, b2, t1, t2, st1, st2,
                                 remaining, lens1, lens2, opts, sc, writer)
        if got.size:
            rescued_all.append(got)
            remaining = np.setdiff1d(remaining, got, assume_unique=True)
    if remaining.size:
        got = _half_aligned_round(index, didx, b1, b2, t1, t2, st1, st2,
                                  remaining, lens1, lens2, opts, sc, writer,
                                  MAX_ANCHORS, skip_anchors=0)
        if got.size:
            rescued_all.append(got)
    return np.concatenate(rescued_all) if rescued_all else np.zeros(0, int)


def _half_seeded_round(index, didx, b1, b2, t1, t2, st1, st2, half,
                       lens1, lens2, opts, sc, writer) -> np.ndarray:
    """Seeded narrow-window mate rescue for pairs with exactly one
    hitless end."""
    u, v = opts.max_insert, opts.min_insert
    hitless1 = st1.best_nmis[half] < 0
    hitless2 = st2.best_nmis[half] < 0
    one = hitless1 ^ hitless2
    sel = half[one]
    if sel.size == 0:
        return np.zeros(0, int)
    mate_is_2 = hitless2[one]          # True: end2 is the hitless mate
    L = max(b1.codes.shape[1], b2.codes.shape[1])
    ns = len(sel)
    mreads = np.zeros((ns, L), np.uint8)
    mlens = np.zeros(ns, np.int32)
    m2i = np.flatnonzero(mate_is_2)
    m1i = np.flatnonzero(~mate_is_2)
    mreads[m2i, :b2.codes.shape[1]] = b2.codes[sel[m2i]]
    mreads[m1i, :b1.codes.shape[1]] = b1.codes[sel[m1i]]
    mlens[m2i] = lens2[sel[m2i]]
    mlens[m1i] = lens1[sel[m1i]]

    sp, sl = dp_rescue.single_dp_seed_matrix(mlens, L,
                                         halved=opts.dp_seed_1mm)
    cand = dp_rescue.seed_candidates(didx, mreads, mlens, sp, sl)
    if cand.read.size == 0:
        return np.zeros(0, int)

    # join candidates to the anchor table of the OTHER end: keep a
    # candidate when some anchor makes a proper pair with it
    keep = np.zeros(cand.read.shape[0], bool)
    arow = np.zeros(cand.read.shape[0], np.int64)
    anchors_t = np.where(mate_is_2[cand.read], 0, 1)  # 0: anchors in t1
    for which, tab in ((0, t1), (1, t2)):
        ci = np.flatnonzero(anchors_t == which)
        if not ci.size:
            continue
        pairs_b = sel[cand.read[ci]]
        cnt = np.minimum(tab.counts()[pairs_b], MAX_ANCHORS).astype(np.int64)
        rep = np.repeat(ci, cnt)
        rk = np.arange(len(rep)) - np.repeat(
            np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt)
        rows = tab.start[sel[cand.read[rep]]] + rk
        apos = tab.pos[rows].astype(np.int64)
        astr = tab.strand[rows].astype(np.int64)
        cpos = cand.pos[rep]
        cstr = cand.strand[rep].astype(np.int64)
        alen = np.where(anchors_t[rep] == 0, lens1[sel[cand.read[rep]]],
                        lens2[sel[cand.read[rep]]]).astype(np.int64)
        mlen = mlens[cand.read[rep]].astype(np.int64)
        left_a = apos <= cpos
        ins = (np.maximum(apos + alen, cpos + mlen)
               - np.minimum(apos, cpos))  # outer span, as in pair_hits
        okj = np.where(
            left_a,
            (astr == opts.strand_left_leg) & (cstr == opts.strand_right_leg),
            (cstr == opts.strand_left_leg) & (astr == opts.strand_right_leg))
        okj &= (ins >= v) & (ins <= u)
        # first matching anchor per candidate
        good = np.flatnonzero(okj)
        if good.size:
            firstg = np.unique(rep[good], return_index=True)[1]
            gi = good[firstg]
            keep[rep[gi]] = True
            arow[rep[gi]] = rows[gi]
    if not keep.any():
        return np.zeros(0, int)
    ki = np.flatnonzero(keep)
    cand2 = dp_rescue.Candidates(read=cand.read[ki], strand=cand.strand[ki],
                                 pos=cand.pos[ki])
    arow = arow[ki]
    margin = dp_rescue.dp_margin(mlens[cand2.read])
    ws = np.maximum(cand2.pos - margin, 0)
    wl = np.minimum(mlens[cand2.read] + 2 * margin,
                    int(index.n) - ws).astype(np.int32)
    M = len(ki)
    clip_l = np.where(cand2.strand == 1, opts.max_end_clip, opts.max_front_clip)
    clip_r = np.where(cand2.strand == 1, opts.max_front_clip, opts.max_end_clip)
    res = dp_rescue.run_banded_dp(
        didx, mreads, mlens, cand2, ws, wl, int(wl.max()), clip_l, clip_r,
        np.full(M, int(wl.max()) + 1, np.int32), np.zeros(M, np.int32),
        opts.dp_cutoff(mlens[cand2.read]), sc, index_host=index)
    if res.read.size == 0:
        return np.zeros(0, int)
    order = np.lexsort((res.pos, -res.score, res.read))
    rr = res.read[order]
    firstw = np.concatenate([[True], rr[1:] != rr[:-1]])
    rescued = []
    with timers.stage("rescue.half_emit"):
        for i in order[firstw]:
            ci = int(res.problem[i])
            sub = int(res.read[i])
            b = int(sel[sub])
            is2 = bool(mate_is_2[sub])     # True: mate = end2, anchor = end1
            ta_, sta, batch_a = (t1, st1, b1) if is2 else (t2, st2, b2)
            r = int(arow[ci])
            mq_a = int(mapq.bwa_like_single(sta.x0[b], sta.x1[b])[()]) \
                if opts.bwa_like_score else opts.max_mapq
            e_anchor = _gapless_end(index, batch_a, ta_, r, b, mq_a, sta, opts)
            e_mate = _dp_end(index, res, i, int(mlens[sub]), opts)
            e_mate.mapq = min(mq_a, 29)
            if is2:
                emit_pair(writer, b1, b2, b, e_anchor, e_mate, proper=True)
            else:
                emit_pair(writer, b1, b2, b, e_mate, e_anchor, proper=True)
            rescued.append(b)
    return np.asarray(rescued, int)


def _half_aligned_round(index, didx, b1, b2, t1, t2, st1, st2, half,
                        lens1, lens2, opts, sc, writer,
                        max_anchors: int, skip_anchors: int) -> np.ndarray:
    """One anchor round of the half-aligned rescue.

    Geometry per HalfEndAlgnBatch::pack (DV-DPfunctions.cu:2056-2106):
    anchor on the left leg -> mate window
      [anchor + min_insert - mate_len, anchor + max_insert), start
      clamped to >= anchor; anchor on the right leg -> window
      [aEnd - max_insert, aEnd - min_insert + mate_len), end clamped to
      < aEnd; the mate is DP'd on the opposite leg's strand.
    """
    u, v = opts.max_insert, opts.min_insert
    n = int(index.n)
    with timers.stage("rescue.windows"):
        parts = []  # (pair, anchor_end, anchor_row, win_start, win_len, strand)
        for (ta, anchor_end) in ((t1, 0), (t2, 1)):
            cnt = (np.minimum(ta.counts()[half], max_anchors)
                   - skip_anchors).clip(min=0).astype(np.int64)
            if not cnt.sum():
                continue
            rep = np.repeat(half, cnt).astype(np.int64)            # pair ids
            rk = skip_anchors + (np.arange(len(rep)) - np.repeat(
                np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt))  # rank in group
            rows = ta.start[rep] + rk                              # anchor rows
            apos = ta.pos[rows].astype(np.int64)
            astrand = ta.strand[rows].astype(np.int64)
            lens_a = (lens1 if anchor_end == 0 else lens2)[rep].astype(np.int64)
            mate_len = (lens2 if anchor_end == 0 else lens1)[rep].astype(np.int64)
            is_left = astrand == opts.strand_left_leg
            is_right = ~is_left & (astrand == opts.strand_right_leg)
            aend = apos + lens_a
            ws = np.where(is_left, np.maximum(apos + v - mate_len, apos), aend - u)
            we = np.where(is_left, apos + u,
                          np.minimum(aend - v + mate_len, aend - 1))
            mstr = np.where(is_left, opts.strand_right_leg, opts.strand_left_leg)
            # clamp the mate window to the ANCHOR's chromosome: the genome
            # is a boundary-less concatenation, so an unclamped window near
            # a junction would DP the mate into the neighboring chromosome
            # and emit a FLAG_PROPER cross-chromosome pair
            ci = np.searchsorted(index.offsets, apos, side="right")
            c_lo = index.offsets[np.maximum(ci - 1, 0)].astype(np.int64)
            c_hi = index.offsets[np.minimum(ci, len(index.offsets) - 1)
                                 ].astype(np.int64)
            ws = np.clip(ws, c_lo, c_hi)
            we = np.clip(we, c_lo, c_hi)
            ok = (is_left | is_right) & (we - ws >= mate_len // 2)
            if ok.any():
                parts.append((rep[ok].astype(np.int32),
                              np.full(int(ok.sum()), anchor_end, np.int8),
                              rows[ok].astype(np.int64),
                              ws[ok], (we - ws)[ok].astype(np.int32),
                              mstr[ok].astype(np.int8)))
        if not parts:
            return np.zeros(0, int)
        pair, anchor_end, anchor_row, win_start, win_len, mstrand = (
            np.concatenate([p[i] for p in parts]) for i in range(6))

        # build the mate-read subset: one problem per candidate
        L = max(b1.codes.shape[1], b2.codes.shape[1])
        mreads = np.zeros((len(pair), L), np.uint8)
        mlens = np.zeros(len(pair), np.int32)
        m0 = anchor_end == 0
        mreads[np.flatnonzero(m0), :b2.codes.shape[1]] = b2.codes[pair[m0]]
        mreads[np.flatnonzero(~m0), :b1.codes.shape[1]] = b1.codes[pair[~m0]]
        mlens[m0] = b2.lens[pair[m0]]
        mlens[~m0] = b1.lens[pair[~m0]]
        cand = dp_rescue.Candidates(
            read=np.arange(len(pair), dtype=np.int32),
            strand=mstrand, pos=win_start)
        max_win = int(win_len.max())
        clip_l = np.where(mstrand == 1, opts.max_end_clip, opts.max_front_clip)
        clip_r = np.where(mstrand == 1, opts.max_front_clip, opts.max_end_clip)
        cutoff = opts.dp_cutoff(mlens)

    # gapless mate prescan (VERDICT r2 item 3): a window holding a
    # 0-mismatch full-length placement scores the global max L*match —
    # no mismatch/indel/clip placement can beat it and ties resolve to
    # the same leftmost offset DP picks — so those candidates emit
    # without DP; only the gapless-implausible rest pays the full
    # insert-window DP (which the reference always runs,
    # DV-DPfunctions.cu:2027-2109)
    with timers.stage("BC.prescan"):
        pmm, poff, pn0 = dp_rescue.gapless_prescan(
            didx, mreads, mlens, cand, win_start, win_len, max_win)
    direct = (pmm == 0) & (mlens.astype(np.int64) * sc.match >= cutoff)
    if direct.any():
        dpos = (win_start + poff).astype(np.uint64)
        direct &= ~sam.crosses_boundary(index, dpos, mlens.astype(np.int64))
    dp_idx = np.flatnonzero(~direct)

    def _dp(sub, ws_s, wl_s):
        """Banded DP over a candidate subset; problem ids remapped to
        full-candidate space so all branches share one index space."""
        if not sub.size:
            return None
        mw = int(wl_s.max())
        r = dp_rescue.run_banded_dp(
            didx, mreads, mlens,
            dp_rescue.Candidates(read=cand.read[sub], strand=mstrand[sub],
                                 pos=ws_s),
            ws_s, wl_s, mw, clip_l[sub], clip_r[sub],
            np.full(len(sub), mw + 1, np.int32),
            np.zeros(len(sub), np.int32),
            cutoff[sub], sc, index_host=index)
        return dataclasses.replace(r, problem=sub[r.problem])

    import os as _os
    with timers.stage("rescue.dp"):
        pad_n = int(_os.environ.get("SOAP3DP_HALF_NARROW_PAD",
                                    opts.half_narrow_pad))
        if dp_idx.size and pad_n > 0:
            # narrow window centered on the gapless argmax: the prescan's
            # best offset tracks the DP optimum through mismatches, clips
            # and <= pad_n-base indels, at ~(len+2*pad)/insert-window the
            # diagonal cost (the dominant rescue device time at 3.1 Gbp:
            # BC.half_rescue 18s/pass full-window). Failures with a
            # plausibly-elsewhere placement (window min-mm <= fb_mm) re-run
            # on the full window.
            ml = mlens[dp_idx].astype(np.int64)
            base = win_start[dp_idx]
            off = poff[dp_idx].astype(np.int64)
            ns = np.maximum(base + off - pad_n, base)
            ne = np.minimum(base + off + ml + pad_n,
                            base + win_len[dp_idx].astype(np.int64))
            rn = _dp(dp_idx, ns, (ne - ns).astype(np.int32))
            ok = np.zeros(len(pair), bool)
            if rn is not None:
                ok[rn.problem] = True
            fb = dp_idx[~ok[dp_idx]
                        & (pmm[dp_idx] <= int(opts.half_narrow_fb_mm))]
            rf = _dp(fb, win_start[fb], win_len[fb].astype(np.int32))
            res = dp_rescue.concat_dpresults([rn, rf])
        else:
            res = _dp(dp_idx, win_start[dp_idx],
                      win_len[dp_idx].astype(np.int32)) if dp_idx.size \
                else None
            if res is None:
                res = dp_rescue.empty_dpresult()
    di = np.flatnonzero(direct)
    if di.size:
        from soap3dp_tpu_torch.kernels.banded_dp import OP_MATCH
        MR = max(res.ops.shape[1], 1)
        ops_d = np.zeros((len(di), MR), np.int32)
        cnts_d = np.zeros((len(di), MR), np.int32)
        ops_d[:, 0] = OP_MATCH
        cnts_d[:, 0] = mlens[di]
        res = dp_rescue.DPResult(
            read=np.concatenate([res.read, di.astype(np.int32)]),
            strand=np.concatenate([res.strand, mstrand[di]]),
            pos=np.concatenate([res.pos, win_start[di] + poff[di]]),
            score=np.concatenate([res.score,
                                  mlens[di].astype(res.score.dtype) * sc.match]),
            ops=np.concatenate([res.ops, ops_d]),
            cnts=np.concatenate([res.cnts, cnts_d]),
            nrun=np.concatenate([res.nrun, np.ones(len(di), np.int32)]),
            win_start=np.concatenate([res.win_start, win_start[di]]),
            n_best_cells=np.concatenate([res.n_best_cells, pn0[di]]),
            problem=np.concatenate([res.problem,
                                    di.astype(res.problem.dtype)]))
    if res.read.size == 0:
        return np.zeros(0, int)

    # best DP result per pair (highest mate score, then leftmost)
    order = np.lexsort((res.pos, -res.score, pair[res.read]))
    bb = pair[res.read][order]
    first = np.concatenate([[True], bb[1:] != bb[:-1]]) if len(bb) else \
        np.zeros(0, bool)
    rescued = []
    with timers.stage("rescue.half_emit"):
        for i in order[first]:
            ci = int(res.read[i])
            b = int(pair[ci])
            ae = int(anchor_end[ci])
            ta, sta, lens_a = (t1, st1, lens1) if ae == 0 else (t2, st2, lens2)
            batch_a, batch_m = (b1, b2) if ae == 0 else (b2, b1)
            lens_m = lens2 if ae == 0 else lens1
            r = int(anchor_row[ci])
            mq_a = int(mapq.bwa_like_single(sta.x0[b], sta.x1[b])[()]) \
                if opts.bwa_like_score else opts.max_mapq
            e_anchor = _gapless_end(index, batch_a, ta, r, b, mq_a,
                                    sta, opts)
            e_mate = _dp_end(index, res, i, int(lens_m[b]), opts)
            e_mate.mapq = min(mq_a, 29)  # mate rescued by anchor: capped quality
            if ae == 0:
                emit_pair(writer, b1, b2, b, e_anchor, e_mate, proper=True)
            else:
                emit_pair(writer, b1, b2, b, e_mate, e_anchor, proper=True)
            rescued.append(b)
    return np.asarray(rescued, int)


def _dp_end(index, res, i, rlen, opts) -> EndInfo:
    cigar = cig.runs_to_cigar(res.ops[i], res.cnts[i], int(res.nrun[i]))
    nm, mis, go, ge = cig.runs_stats(res.ops[i], res.cnts[i], int(res.nrun[i]))
    chrom, off = sam.translate_pos(index, np.asarray([res.pos[i]]))
    span = _cigar_ref_span(cigar)
    tags = [f"XM:i:{mis}", f"XO:i:{go}", f"XG:i:{ge}"]
    if opts.output_md:
        w0 = int(res.win_start[i])
        wlen = int(res.pos[i]) - w0 + rlen + 64
        wcodes = _genome_codes(index, w0, wlen)
        md = cig.runs_to_md(res.ops[i], res.cnts[i], int(res.nrun[i]),
                            wcodes, int(res.pos[i]) - w0)
        tags = [f"NM:i:{nm}"] + tags + [f"MD:Z:{md}"]
    return EndInfo(chrom=int(chrom[0]), pos=int(off[0]),
                   strand=int(res.strand[i]), cigar=cigar, span=span,
                   mapq=0, tags=tags)


def _cigar_ref_span(cigar: str) -> int:
    span = 0
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            if ch in "MD=XN":
                span += n
            n = 0
    return span


# ------------------------------------------------------------------
# Phase D: deep DP (both ends unaligned)
# ------------------------------------------------------------------

def _deep_dp_rescue(index, didx, b1, b2, deep, lens1, lens2, opts, sc,
                    writer) -> np.ndarray:
    """Two seeding rounds (the reference's DP2 round1/round2 staging,
    definitions.h:165-188): round 2 re-seeds still-unpaired pairs with
    the longer seed-length table."""
    rescued = []
    remaining = deep
    for round2 in (False, True):
        if remaining.size == 0:
            break
        got = _deep_dp_round(index, didx, b1, b2, remaining, lens1, lens2,
                             opts, sc, writer, round2)
        if got.size:
            rescued.append(got)
            remaining = np.setdiff1d(remaining, got, assume_unique=True)
    return np.concatenate(rescued) if rescued else np.zeros(0, int)


def _deep_dp_round(index, didx, b1, b2, deep, lens1, lens2, opts, sc,
                   writer, round2: bool) -> np.ndarray:
    """Seed both ends, pair candidate loci by insert window, DP both ends."""
    max_len = int(max(b1.codes.shape[1], b2.codes.shape[1]))  # static

    def pad(c):
        return shapes.pad_cols(c, max_len)

    sub1 = pad(b1.codes)[deep]
    sub2 = pad(b2.codes)[deep]
    sl1 = lens1[deep]
    sl2 = lens2[deep]
    Bd = len(deep)
    sp1, sl1s = dp_rescue.deep_dp_seed_matrix(sl1, max_len, round2,
                                          halved=opts.dp_seed_1mm)
    sp2, sl2s = dp_rescue.deep_dp_seed_matrix(sl2, max_len, round2,
                                          halved=opts.dp_seed_1mm)
    # one seeding batch over both ends (fewer dispatches/transfers)
    call = dp_rescue.seed_candidates(
        didx, np.concatenate([sub1, sub2]), np.concatenate([sl1, sl2]),
        np.concatenate([sp1, sp2]), np.concatenate([sl1s, sl2s]))
    in2 = call.read >= Bd
    c1 = dp_rescue.Candidates(read=call.read[~in2], strand=call.strand[~in2],
                              pos=call.pos[~in2])
    c2 = dp_rescue.Candidates(read=call.read[in2] - Bd,
                              strand=call.strand[in2], pos=call.pos[in2])
    if c1.read.size == 0 or c2.read.size == 0:
        return np.zeros(0, int)
    # pair candidate loci: for each end-1 locus, end-2 loci within the
    # insert window (positions are read-start estimates; allow the DP
    # margin both ways, DP2_MARGIN DV-DPfunctions.cu:2549). A sorted
    # window join — the vectorized analog of the reference's linear
    # pairEndMerge sweep (DV-DPfunctions.cu:2780-2879) — NOT a cross
    # join: repeat-heavy batches reach thousands of candidates per end
    # and n1*n2 materialization is quadratic (measured 810s host CPU on
    # one satellite-storm batch before this).
    u, v = opts.max_insert, opts.min_insert
    B_sub = len(deep)
    # c2 sorted by (read, pos) -> one u64 key; genome < 2^40
    o2 = np.lexsort((c2.pos, c2.read))
    p2s = c2.pos[o2].astype(np.uint64)
    key2 = (c2.read[o2].astype(np.uint64) << np.uint64(40)) | p2s
    mg1 = dp_rescue.dp_margin(np.maximum(sl1, sl2)).astype(np.int64)
    w = (u + mg1[c1.read]).astype(np.int64)
    base1 = c1.read.astype(np.uint64) << np.uint64(40)
    lo = np.searchsorted(
        key2, base1 | np.maximum(c1.pos - w, 0).astype(np.uint64))
    hi = np.searchsorted(key2, base1 | (c1.pos + w + 1).astype(np.uint64))
    fan = hi - lo
    # centered fan-out cap per end-1 locus (same policy as pair_hits)
    FAN_CAP = 16
    take = np.minimum(fan, FAN_CAP)
    total = int(take.sum())
    if total == 0:
        return np.zeros(0, int)
    toff = np.zeros(len(take) + 1, np.int64)
    np.cumsum(take, out=toff[1:])
    row1 = np.repeat(np.arange(len(take), dtype=np.int64), take)
    cix = np.arange(total, dtype=np.int64) - toff[row1]
    j2 = lo[row1] + np.maximum(fan[row1] - FAN_CAP, 0) // 2 + cix
    i1 = row1
    i2 = o2[j2]
    pid = c1.read[i1].astype(np.int64)
    p1 = c1.pos[i1]
    p2 = c2.pos[i2]
    s1c = c1.strand[i1]
    s2c = c2.strand[i2]
    l1 = sl1[pid].astype(np.int64)
    l2 = sl2[pid].astype(np.int64)
    left1 = p1 <= p2
    ins = np.maximum(p1 + l1, p2 + l2) - np.minimum(p1, p2)  # outer span
    okc = np.where(
        left1,
        (s1c == opts.strand_left_leg) & (s2c == opts.strand_right_leg),
        (s2c == opts.strand_left_leg) & (s1c == opts.strand_right_leg))
    margin = dp_rescue.dp_margin(np.maximum(l1, l2))
    okc &= (ins >= v - margin) & (ins <= u + margin)
    if len(index.offsets) > 2:
        # candidate loci must share a chromosome (see pair_hits)
        okc &= (np.searchsorted(index.offsets, p1, side="right")
                == np.searchsorted(index.offsets, p2, side="right"))
    if not okc.any():
        return np.zeros(0, int)
    sel = np.flatnonzero(okc)
    DEEP_DP_COMBO_CAP = 200_000
    if len(sel) > DEEP_DP_COMBO_CAP:
        import sys
        print(f"[soap3dp] warning: deep-DP candidate pairs capped at "
              f"{DEEP_DP_COMBO_CAP} (had {len(sel)})", file=sys.stderr)
        sel = sel[:DEEP_DP_COMBO_CAP]
    rd = pid[sel].astype(np.int32)
    i1 = i1[sel]
    i2 = i2[sel]

    # one DP batch over both ends' problems (end2 reads offset by Bd)
    M = len(rd)
    reads_cat = np.concatenate([sub1, sub2])
    lens_cat = np.concatenate([sl1, sl2])
    cread, cstrand, cpos, cws, cwl = [], [], [], [], []
    for (cc, sl, ii, off) in ((c1, sl1, i1, 0), (c2, sl2, i2, Bd)):
        mg = dp_rescue.dp_margin(sl[rd])
        pos = cc.pos[ii]
        # clamp each end's DP window to its candidate's chromosome
        # (same junction reasoning as the half-rescue windows)
        ci = np.searchsorted(index.offsets, pos, side="right")
        c_lo = index.offsets[np.maximum(ci - 1, 0)].astype(np.int64)
        c_hi = index.offsets[np.minimum(ci, len(index.offsets) - 1)
                             ].astype(np.int64)
        ws = np.clip(pos.astype(np.int64) - mg, c_lo, c_hi)
        wl = np.minimum(sl[rd] + 2 * mg, c_hi - ws).astype(np.int32)
        cread.append(rd + off)
        cstrand.append(cc.strand[ii])
        cpos.append(pos)
        cws.append(ws)
        cwl.append(wl)
    cand = dp_rescue.Candidates(
        read=np.concatenate(cread).astype(np.int32),
        strand=np.concatenate(cstrand), pos=np.concatenate(cpos))
    ws = np.concatenate(cws)
    wl = np.concatenate(cwl)
    max_win = int(wl.max())
    clip_l = np.where(cand.strand == 1, opts.max_end_clip, opts.max_front_clip)
    clip_r = np.where(cand.strand == 1, opts.max_front_clip, opts.max_end_clip)
    rlens_c = lens_cat[cand.read]
    res = dp_rescue.run_banded_dp(
        didx, reads_cat, lens_cat, cand, ws, wl, max_win, clip_l, clip_r,
        np.full(2 * M, max_win + 1, np.int32), np.zeros(2 * M, np.int32),
        opts.dp_cutoff(rlens_c), sc, index_host=index)
    e1 = res.problem < M
    r1 = _slice_dp(res, e1, 0)
    r2 = _slice_dp(res, ~e1, M)
    # both ends must pass for the same problem; best total score per pair
    common, ia, ib = np.intersect1d(r1.problem, r2.problem,
                                    return_indices=True)
    rescued = []
    if common.size == 0:
        return np.zeros(0, int)
    score = r1.score[ia].astype(np.int64) + r2.score[ib]
    b_subs = rd[common.astype(np.int64)]
    order = np.lexsort((-score, b_subs))
    firstm = np.concatenate([[True], b_subs[order][1:] != b_subs[order][:-1]])
    with timers.stage("rescue.deep_emit"):
        for m in order[firstm]:
            b_sub, i, j = int(b_subs[m]), int(ia[m]), int(ib[m])
            b = int(deep[b_sub])
            e1 = _dp_end(index, r1, i, int(lens1[b]), opts)
            e2 = _dp_end(index, r2, j, int(lens2[b]), opts)
            e1.mapq = e2.mapq = _deep_dp_mapq(r1, r2, i, j, opts)
            emit_pair(writer, b1, b2, b, e1, e2, proper=True)
            rescued.append(b)
    return np.asarray(rescued, int)


def _slice_dp(res, mask, problem_offset):
    """Boolean-slice a DPResult, shifting problem ids by -offset."""
    import dataclasses as dc

    sel = np.flatnonzero(mask)
    kw = {f.name: getattr(res, f.name)[sel] for f in dc.fields(res)}
    kw["problem"] = kw["problem"] - problem_offset
    return dp_rescue.DPResult(**kw)


def _deep_dp_mapq(r1, r2, i, j, opts) -> int:
    x0 = max(int(r1.n_best_cells[i]), 1) * max(int(r2.n_best_cells[j]), 1)
    return int(mapq.bwa_like_single(np.asarray(x0), np.asarray(0))[()])


# ------------------------------------------------------------------
# Phase E: single-end salvage for leftover pairs
# ------------------------------------------------------------------

def _single_salvage_pairs(index, didx, b1, b2, leftover, lens1, lens2,
                          opts, sc, writer, summary) -> int:
    """Try single-end DP on each end; emit unpaired or unmapped records."""
    n_records = 0
    # one seeding + DP batch over both ends' leftover reads
    Lc = max(b1.codes.shape[1], b2.codes.shape[1])

    def pad(c):
        return shapes.pad_cols(c, Lc)

    nlo = len(leftover)
    reads_c = np.concatenate([pad(b1.codes)[leftover], pad(b2.codes)[leftover]])
    lens_c = np.concatenate([lens1[leftover], lens2[leftover]]).astype(np.int32)
    got_all = _salvage_reads(index, didx, reads_c, lens_c, opts, sc)
    results = {
        0: {int(leftover[i]): e for i, e in got_all.items() if i < nlo},
        1: {int(leftover[i - nlo]): e for i, e in got_all.items() if i >= nlo},
    }
    with timers.stage("rescue.salvage_emit"):
        for b in leftover:
            got1 = results[0].get(int(b))
            got2 = results[1].get(int(b))
            for (end, batch, got, mate_got) in ((0, b1, got1, got2),
                                                (1, b2, got2, got1)):
                flag = sam.FLAG_PAIRED | (sam.FLAG_FIRST if end == 0 else sam.FLAG_SECOND)
                if got is None:
                    flag |= sam.FLAG_UNMAPPED
                    if mate_got is None:
                        flag |= sam.FLAG_MATE_UNMAPPED
                    writer.write(SamRecord(
                        qname=batch.names[b], flag=flag, chrom=-1, pos=-1,
                        mapq=0, cigar="", seq=_seq_bytes(batch, b, writer),
                        qual=_qual_bytes(batch, b, writer),
                        mate_chrom=mate_got.chrom if mate_got else -1,
                        mate_pos=mate_got.pos if mate_got else 0))
                else:
                    if mate_got is None:
                        flag |= sam.FLAG_MATE_UNMAPPED
                    else:
                        flag |= sam.FLAG_MATE_REVERSE if mate_got.strand else 0
                    flag |= sam.FLAG_REVERSE if got.strand else 0
                    writer.write(SamRecord(
                        qname=batch.names[b], flag=flag, chrom=got.chrom,
                        pos=got.pos, mapq=got.mapq, cigar=got.cigar,
                        seq=_seq_bytes(batch, b, writer), qual=_qual_bytes(batch, b, writer),
                        mate_chrom=mate_got.chrom if mate_got else -1,
                        mate_pos=mate_got.pos if mate_got else 0,
                        tags=got.tags))
                    summary.single_rescued += 1
                n_records += 1
            if got1 is None and got2 is None:
                summary.unaligned += 1
    return n_records


def _salvage_reads(index, didx, reads, sl, opts, sc) -> dict[int, EndInfo]:
    """Single-end DP salvage over a read matrix; keys = row indices."""
    max_len = int(reads.shape[1])  # static
    seed_pos, seed_len = dp_rescue.single_dp_seed_matrix(
        sl, max_len, halved=opts.dp_seed_1mm)
    cand = dp_rescue.seed_candidates(didx, reads, sl, seed_pos, seed_len)
    if cand.read.size == 0:
        return {}
    margin = dp_rescue.dp_margin(sl[cand.read])
    ws = np.maximum(cand.pos - margin, 0)
    wl = np.minimum(sl[cand.read] + 2 * margin, int(index.n) - ws).astype(np.int32)
    max_win = int(wl.max())
    M = cand.read.shape[0]
    clip_l = np.where(cand.strand == 1, opts.max_end_clip, opts.max_front_clip)
    clip_r = np.where(cand.strand == 1, opts.max_front_clip, opts.max_end_clip)
    res = dp_rescue.run_banded_dp(
        didx, reads, sl, cand, ws, wl, max_win, clip_l, clip_r,
        np.full(M, max_win + 1, np.int32), np.zeros(M, np.int32),
        opts.dp_cutoff(sl[cand.read]), sc, index_host=index)
    out: dict[int, EndInfo] = {}
    # dedupe identical placements, group per read best-first, and score
    # with the DP MAPQ (best/second-best ratio) — the same scheme the
    # SE salvage uses (_dp_salvage; getMapQualScoreForSingleDP analog,
    # BGS-IO.cpp:2370-2412), so phase-E salvaged ends no longer diverge
    with timers.stage("rescue.salvage_emit"):
        order = np.lexsort((res.pos, res.strand, -res.score, res.read))
        by_read: dict[int, list[int]] = {}
        seen: set[tuple] = set()
        for i in order:
            key = (int(res.read[i]), int(res.strand[i]), int(res.pos[i]))
            if key in seen:
                continue
            seen.add(key)
            by_read.setdefault(int(res.read[i]), []).append(int(i))
        for b, rows in by_read.items():
            best = int(res.score[rows[0]])
            x0 = sum(1 for i in rows if int(res.score[i]) == best)
            x1 = len(rows) - x0
            rlen = int(sl[b])
            e = _dp_end(index, res, rows[0], rlen, opts)
            e.mapq = int(mapq.dp_single(
                rlen * opts.match_score, 20, x0, 0, x1, best,
                int(res.score[rows[1]]) if len(rows) > 1 else 0,
                int(opts.dp_cutoff(rlen)), opts.max_mapq, opts.min_mapq,
                opts.bwa_like_score)[()])
            out[b] = e
    return out
