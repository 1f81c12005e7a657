"""Host re-alignment of super-repetitive reads (port of
soap3dp_tpu/fm/host_search.py; numpy, returning the port's HitArrays).

The rebuild's analog of the reference's host re-align of "super-bad"
reads (ProcessReadDoubleStrand2, CPUfunctions.cpp:555, invoked from
collect_all_answers CPUfunctions.cpp:1226): a read whose seeds stay
over the SA-interval budget even in the device's round-3 escalation
gets its <=k-mismatch placement set enumerated here, on the host,
against the same flat occ/bwt/mark/pac tables the device uses
(mmap'd, so this costs no extra resident memory).

Host work is bounded the same way the reference bounds it: the
per-read occurrence decode is clamped (``max_decode``, the analog of
MaxOutputPerRead/MaxHitsEachEndForPairing truncation at
CPUfunctions.cpp:1287-1299) and ``realign_flagged`` re-aligns at most
``budget`` reads per batch. On a uniform genome a handful of reads
land here per run; a repeat-structured genome can flag >5% of a batch
(centromeric satellite and microsatellite reads — some seed intervals
exceed 10^6 occurrences), and decoding those completely would cost
minutes of host time per batch. Beyond-cap reads keep their truncated
sets plus the ``flagged`` mark (surfaced in the run summary) and the
pair/single DP rescue engines — the reference's own route for
over-cap reads — recover their placements anchored on the mate.
SOAP3DP_HOST_REALIGN_FULL=1 restores unbounded complete enumeration;
``max_interval`` (a seed occurring more than ~a million times) still
guards even that.

Everything is vectorized numpy except the per-character backward-search
loop (segment length iterations of scalar interval updates).
"""

from __future__ import annotations

import numpy as np

from soap3dp_tpu_torch.index.builder import Index, _popcount_u32
from soap3dp_tpu_torch.utils import timers

_LANES = np.uint32(0x5555_5555)


def _match_bits(words: np.ndarray, c) -> np.ndarray:
    """One bit per 2-bit base slot of each word equal to base c
    (the numpy mirror of fmindex._match_bits)."""
    x = words ^ (np.uint32(c) * _LANES)
    return (~(x | (x >> np.uint32(1)))) & _LANES


def occ_host(index: Index, c: int, ks: np.ndarray) -> np.ndarray:
    """Occ(c, k) for an array of k values — numpy mirror of
    fmindex.occ (2bwt-lib/BWT.c BWTOccValue semantics)."""
    ks = np.asarray(ks, np.uint32)
    kp = ks - (ks > np.uint32(index.primary)).astype(np.uint32)
    w = (kp >> 4).astype(np.int64)
    words = np.asarray(index.bwt)[w]
    base = np.asarray(index.occ)[4 * w + c]
    q = kp & np.uint32(15)
    qm = np.where(q == 0, np.uint32(0),
                  _LANES >> (2 * (16 - q)).astype(np.uint32))
    return base + _popcount_u32(_match_bits(words, c) & qm)


def backward_interval(index: Index, seg: np.ndarray) -> tuple[int, int]:
    """Exact backward-search SA interval of a code segment."""
    l = np.zeros(1, np.uint32)
    r = np.full(1, index.n + 1, np.uint32)
    counts = np.asarray(index.counts)
    for c in seg[::-1]:
        c = int(c)
        l = counts[c] + occ_host(index, c, l)
        r = counts[c] + occ_host(index, c, r)
        if l[0] >= r[0]:
            return 0, 0
    return int(l[0]), int(r[0])


def occ_host_vec(index: Index, c: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """occ_host with a per-element base array (vectorized lanes)."""
    ks = np.asarray(ks, np.uint32)
    c = np.asarray(c)
    kp = ks - (ks > np.uint32(index.primary)).astype(np.uint32)
    w = (kp >> 4).astype(np.int64)
    words = np.asarray(index.bwt)[w]
    base = np.asarray(index.occ)[4 * w + c.astype(np.int64)]
    q = kp & np.uint32(15)
    qm = np.where(q == 0, np.uint32(0),
                  _LANES >> (2 * (16 - q)).astype(np.uint32))
    return base + _popcount_u32(_per_base_match(words, c) & qm)


def backward_intervals_batched(index: Index, segs: np.ndarray,
                               seg_lens: np.ndarray
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Backward-search SA intervals for M segments simultaneously.

    ``segs`` is (M, W) codes, segment i occupying columns
    [0, seg_lens[i]); consumed right-to-left. One vectorized occ pass
    per character step replaces M scalar python loops — this is what
    makes host re-alignment of hundreds of flagged reads per batch
    affordable (~100x over per-read backward_interval)."""
    M, W = segs.shape
    counts = np.asarray(index.counts)
    l = np.zeros(M, np.uint32)
    r = np.full(M, index.n + 1, np.uint32)
    for t in range(W - 1, -1, -1):
        active = (seg_lens > t) & (l < r)
        if not active.any():
            continue
        c = segs[:, t]
        ln = counts[c] + occ_host_vec(index, c, l)
        rn = counts[c] + occ_host_vec(index, c, r)
        l = np.where(active, ln, l).astype(np.uint32)
        r = np.where(active, rn, r).astype(np.uint32)
    return l, np.maximum(r, l)


def decode_rows(index: Index, rows: np.ndarray) -> np.ndarray:
    """Text positions of SA rows via the bounded LF walk — vectorized
    numpy mirror of fmindex.sa_decode (BWTSaValue, 2bwt-lib/BWT.c:1694)."""
    rows = np.asarray(rows, np.uint32).copy()
    sa_samples = np.asarray(index.sa_samples)
    if index.sa_rate == 1:
        return sa_samples[rows.astype(np.int64)]
    mark_words = np.asarray(index.mark_words)
    mark_rank = np.asarray(index.mark_rank)
    bwt = np.asarray(index.bwt)
    occ = np.asarray(index.occ)
    counts = np.asarray(index.counts)
    out = np.zeros(len(rows), np.uint32)
    done = np.zeros(len(rows), bool)
    for step in range(index.sa_rate):
        mw = (rows >> 5).astype(np.int64)
        words = mark_words[mw]
        bsel = rows & np.uint32(31)
        marked = ((words >> bsel) & 1).astype(bool)
        newly = marked & ~done
        if newly.any():
            below_mask = np.where(
                bsel == 0, np.uint32(0),
                np.uint32(0xFFFFFFFF) >> (np.uint32(32) - bsel))
            rank = mark_rank[mw] + _popcount_u32(words & below_mask)
            out[newly] = sa_samples[rank[newly].astype(np.int64)] + step
        done |= marked
        if done.all() or step == index.sa_rate - 1:
            break
        kp = rows - (rows > np.uint32(index.primary)).astype(np.uint32)
        w = (kp >> 4).astype(np.int64)
        bw = bwt[w]
        q = kp & np.uint32(15)
        c = (bw >> (2 * q)) & np.uint32(3)
        base = occ[4 * w + c.astype(np.int64)]
        qm = np.where(q == 0, np.uint32(0),
                      _LANES >> (2 * (16 - q)).astype(np.uint32))
        # per-element base c differs per row; _per_base_match handles it
        inword = _popcount_u32(_per_base_match(bw, c) & qm)
        lf = counts[c.astype(np.int64)] + base + inword
        rows = np.where(done, rows, lf.astype(np.uint32))
    return out


def _per_base_match(words: np.ndarray, c: np.ndarray) -> np.ndarray:
    """_match_bits with a per-element base array."""
    x = words ^ (c.astype(np.uint32) * _LANES)
    return (~(x | (x >> np.uint32(1)))) & _LANES


def genome_windows(index: Index, tps: np.ndarray, L: int) -> np.ndarray:
    """(M, L) genome codes at each tp — numpy mirror of
    fmindex.extract_genome."""
    pac = np.asarray(index.pac)
    tps = np.asarray(tps, np.int64)
    W = (L + 15) // 16 + 1
    w0 = tps >> 4
    j = np.arange(W, dtype=np.int64)[None, :]
    words = pac[np.clip(w0[:, None] + j, 0, len(pac) - 1)]
    sh = (2 * (tps & 15)).astype(np.uint32)[:, None]
    lo = words[:, :-1] >> sh
    hi = np.where(sh == 0, np.uint32(0),
                  words[:, 1:] << ((np.uint32(32) - sh) & np.uint32(31)))
    aligned = lo | hi
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = (aligned[:, :, None] >> shifts) & np.uint32(3)
    return codes.reshape(len(tps), -1)[:, :L].astype(np.uint8)


def complete_search(
    index: Index,
    read: np.ndarray,      # (L,) uint8 forward codes
    length: int,
    k: int,
    max_interval: int = 1 << 20,
    max_decode: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """<=k-mismatch placements of one read, both strands.

    Returns (strand, tp, nmis, overflow): parallel arrays of every
    placement found, and whether any seed interval was skipped
    (``max_interval``) or truncated (``max_decode``) — in which case
    placements may be missing and the caller should keep the read
    flagged.

    ``max_decode`` bounds the total occurrences decoded per strand,
    truncating an over-budget interval to its first ``remaining``
    rows — exactly the reference host search's occurrence cap
    (CPUfunctions.cpp:1287-1299 clamps r to MaxOutputPerRead). With
    max_decode=None the enumeration is COMPLETE: the read is split
    into k+1 full pigeonhole segments; any <=k-mismatch placement
    contains at least one exact segment, so decoding EVERY occurrence
    of every segment and verifying yields the full set — the guarantee
    the reference's host SRA model provides via exhaustive
    mismatch-case enumeration (2bwt-flex/SRA2BWTMdl.c).
    """
    from soap3dp_tpu_torch.utils import dna

    seq_f = np.asarray(read[:length], np.uint8)
    n = index.n
    S = k + 1
    out_strand: list[np.ndarray] = []
    out_tp: list[np.ndarray] = []
    out_nm: list[np.ndarray] = []
    overflow = False
    for strand, seq in ((0, seq_f), (1, dna.revcomp_codes(seq_f))):
        cand: list[np.ndarray] = []
        remaining = max_decode
        for s in range(S):
            st = s * length // S
            en = (s + 1) * length // S
            l, r = backward_interval(index, seq[st:en])
            width = r - l
            if width == 0:
                continue
            if width > max_interval:
                overflow = True
                continue
            take = width if remaining is None else min(width, remaining)
            if take < width:
                overflow = True
            if take == 0:
                continue
            if remaining is not None:
                remaining -= take
            pos = decode_rows(index, np.arange(l, l + take, dtype=np.uint32)
                              ).astype(np.int64) - st
            cand.append(pos[(pos >= 0) & (pos + length <= n)])
        if not cand:
            continue
        tps = np.unique(np.concatenate(cand))
        if tps.size == 0:
            continue
        g = genome_windows(index, tps, length)
        nm = (g != seq[None, :]).sum(axis=1).astype(np.int32)
        keep = nm <= k
        out_strand.append(np.full(int(keep.sum()), strand, np.int8))
        out_tp.append(tps[keep])
        out_nm.append(nm[keep])
    if not out_tp:
        z = np.zeros(0, np.int64)
        return z.astype(np.int8), z, z.astype(np.int32), overflow
    return (np.concatenate(out_strand), np.concatenate(out_tp),
            np.concatenate(out_nm).astype(np.int32), overflow)


def realign_flagged(index: Index, h, codes: np.ndarray, lens: np.ndarray,
                    k: int, max_interval: int = 1 << 20,
                    max_decode: int | None = None,
                    budget: int | None = None):
    """Replace still-flagged reads' truncated hit sets with
    host-enumerated ones; clears ``flagged`` except on
    max_interval/max_decode overflow. Returns a new HitArrays (host
    numpy).

    ``max_decode`` caps occurrences decoded per read per strand (the
    reference's MaxOutputPerRead / MaxHitsEachEndForPairing occurrence
    clamp, CPUfunctions.cpp:1287-1299 + soap3-dp.ini defaults
    1000/8000); None = complete enumeration. ``budget`` is a storm
    detector: when MORE than ``budget`` reads are flagged (a
    satellite/microsatellite-dense genome can flag >5% of a batch),
    the whole batch's re-alignment is skipped — at those rates the
    flagged reads are genuinely ambiguous, per-read completion adds no
    placement information, and the host work plus the decoded-hit
    bloat would dominate the pipeline. Skipped reads keep their
    device-truncated hit sets and stay flagged; the reference's own
    route for over-cap reads applies (ProceedDPForTooManyHits=0 →
    capped emission / unmapped). Env SOAP3DP_HOST_REALIGN_FULL=1
    restores the round-3 uncapped complete behavior."""
    import os
    import sys

    from soap3dp_tpu_torch.fm.search import HitArrays

    flagged = np.asarray(h.flagged)
    if not flagged.any() or os.environ.get("SOAP3DP_NO_HOST_REALIGN"):
        return h
    if os.environ.get("SOAP3DP_HOST_REALIGN_FULL"):
        max_decode = None
        budget = None
    sel = np.flatnonzero(flagged)
    if budget is not None and len(sel) > budget:
        print(f"[soap3dp] host re-align skipped: {len(sel)} flagged "
              f"read(s) exceed the {budget}-read storm threshold; "
              "device-truncated hit sets kept (see run summary)",
              file=sys.stderr)
        return h
    timers.count("search.host_realign_reads", len(sel))
    row, tp, nm, va, _ = h.to_host()
    B = len(flagged)
    read_of = np.where(row >= B, row - B, row)
    keep = va.copy()
    keep[va] = ~np.isin(read_of[va], sel)

    still = flagged.copy()
    # a read's placements do not depend on the batch: enumerate each
    # distinct read once (a phase-2 batch repeats its first pair in every
    # pad row) and give each copy its placements
    first, inv = _distinct_reads(codes, lens, sel)
    lane_read, lane_strand, tps, nms, over = _realign_batched(
        index, codes, lens, sel[first], k, max_interval, max_decode)
    if len(first) < len(sel):
        lane_read, take = _spread_lanes(lane_read, inv, len(first))
        lane_strand, tps, nms, over = (lane_strand[take], tps[take],
                                       nms[take], over[inv])
    still[sel] = over
    new_row = (sel[lane_read] + lane_strand.astype(np.int64) * B)
    print(f"[soap3dp] host re-align: {len(sel)} super-repetitive read(s) "
          f"re-aligned on host"
          + (f" (occ cap {max_decode}/strand)" if max_decode else "")
          + (f"; {int(still[sel].sum())} truncated at the cap"
             if still[sel].any() else ""),
          file=sys.stderr)
    return HitArrays(
        row=np.concatenate([row[keep], new_row]).astype(np.int32),
        tp=np.concatenate([tp[keep].astype(np.uint32),
                           tps.astype(np.uint32)]),
        nmis=np.concatenate([nm[keep], nms]).astype(np.int32),
        valid=np.ones(int(keep.sum()) + len(tps), bool),
        flagged=still)


def _distinct_reads(codes: np.ndarray, lens: np.ndarray, sel: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(first, inv): ``sel[first]`` are the distinct reads of ``sel``
    (codes up to each read's length), in ``sel``'s order, and
    ``sel[first][inv]`` is ``sel`` read for read."""
    rl = np.asarray(lens)[sel].astype(np.int64)
    rows = np.asarray(codes)[sel]
    rows = np.where(np.arange(rows.shape[1]) < rl[:, None], rows, 0)
    key = np.concatenate([rows.astype(np.uint8),
                          rl.astype("<i8").view(np.uint8).reshape(-1, 8)],
                         axis=1)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return first[order], rank[inv.reshape(-1)]


def _spread_lanes(lane_read: np.ndarray, inv: np.ndarray, n: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(lane_read, take) of the copies: the lanes of distinct read
    ``inv[i]`` (``lane_read``, sorted, over ``n`` distinct reads) given
    to read i, in read order; ``take`` indexes the distinct reads'
    lanes."""
    cnt = np.bincount(lane_read, minlength=n)
    start = np.cumsum(cnt) - cnt
    per = cnt[inv]
    out = np.repeat(np.arange(len(inv), dtype=np.int64), per)
    off = np.arange(int(per.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(per) - per, per)
    return out, start[inv][out] + off


def _realign_batched(index: Index, codes: np.ndarray, lens: np.ndarray,
                     sel: np.ndarray, k: int, max_interval: int,
                     max_decode: int | None):
    """Batched <=k-mismatch placement enumeration of the selected reads.

    Same semantics as per-read complete_search (pigeonhole segments,
    occurrence clamp CPUfunctions.cpp:1287-1299, max_interval guard)
    but every stage — segment backward search, SA decode, window
    verification — runs vectorized across ALL (read, strand, segment)
    lanes at once. Returns (read_idx into sel, strand, tp, nmis,
    overflow-per-selected-read)."""
    from soap3dp_tpu_torch.utils import dna

    R = len(sel)
    n = index.n
    S = k + 1
    if R == 0:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.int8), z, z.astype(np.int32), np.zeros(0, bool)
    rl = lens[sel].astype(np.int64)
    Lm = int(rl.max())
    # oriented sequence matrix: row 2i = forward, 2i+1 = revcomp
    seqs = np.zeros((2 * R, Lm), np.uint8)
    for i, b in enumerate(sel):  # R <= budget; gather cost negligible
        fwd = np.asarray(codes[b][:rl[i]], np.uint8)
        seqs[2 * i, :rl[i]] = fwd
        seqs[2 * i + 1, :rl[i]] = dna.revcomp_codes(fwd)
    # (2R*S) segment lanes: group g = oriented read, segment j
    g_len = np.repeat(rl, 2)                             # (2R,)
    j = np.arange(S, dtype=np.int64)
    seg_st = (g_len[:, None] * j) // S                   # (2R, S)
    seg_en = (g_len[:, None] * (j + 1)) // S
    seg_lens = (seg_en - seg_st).reshape(-1)
    W = int(seg_lens.max())
    col = np.arange(W, dtype=np.int64)
    src = np.minimum(seg_st[:, :, None] + col[None, None, :], Lm - 1)
    segs = np.take_along_axis(
        np.repeat(seqs, S, axis=0).reshape(2 * R, S, Lm), src, axis=2
    ).reshape(-1, W)
    l, r = backward_intervals_batched(index, segs, seg_lens)
    width = np.where(l < r, (r - l).astype(np.int64), 0)

    # occurrence clamp per oriented read, first-come across segments
    # (CPUfunctions.cpp:1287-1299); max_interval skips a segment whole
    width2 = width.reshape(2 * R, S)
    over_seg = width2 > max_interval
    usable = np.where(over_seg, 0, width2)
    if max_decode is None:
        take2 = usable
    else:
        before = np.cumsum(usable, axis=1) - usable     # decoded so far
        take2 = np.clip(max_decode - before, 0, usable)
    lane_over = over_seg.any(axis=1) | (take2 < usable).any(axis=1)
    over_read = lane_over.reshape(R, 2).any(axis=1)
    take = take2.reshape(-1)

    total = int(take.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return (z, z.astype(np.int8), z, z.astype(np.int32), over_read)
    toff = np.zeros(len(take) + 1, np.int64)
    np.cumsum(take, out=toff[1:])
    lane_of = np.repeat(np.arange(len(take), dtype=np.int64), take)
    rows = (l.astype(np.int64)[lane_of]
            + np.arange(total, dtype=np.int64) - toff[lane_of])
    pos = decode_rows(index, rows.astype(np.uint32)).astype(np.int64)
    tp = pos - seg_st.reshape(-1)[lane_of]
    orow = lane_of // S                                  # oriented read
    ok = (tp >= 0) & (tp + g_len[orow] <= n)
    orow, tp = orow[ok], tp[ok]

    # dedupe (oriented read, tp) BEFORE verification
    key = (orow.astype(np.uint64) << np.uint64(40)) | tp.astype(np.uint64)
    key = np.unique(key)
    orow = (key >> np.uint64(40)).astype(np.int64)
    tp = (key & np.uint64((1 << 40) - 1)).astype(np.int64)

    # verify in bounded chunks (window matrix is (chunk, Lm) bytes)
    CHUNK = 1 << 18
    out_keep = np.zeros(len(tp), bool)
    nms = np.zeros(len(tp), np.int32)
    colm = np.arange(Lm, dtype=np.int64)[None, :]
    for s0 in range(0, len(tp), CHUNK):
        sl = slice(s0, min(s0 + CHUNK, len(tp)))
        g = genome_windows(index, tp[sl], Lm)
        mism = ((g != seqs[orow[sl]])
                & (colm < g_len[orow[sl]][:, None])).sum(axis=1)
        out_keep[sl] = mism <= k
        nms[sl] = mism.astype(np.int32)
    orow, tp, nms = orow[out_keep], tp[out_keep], nms[out_keep]
    return (orow // 2, (orow & 1).astype(np.int8), tp, nms, over_read)
