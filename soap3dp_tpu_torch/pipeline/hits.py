"""Host-side hit post-processing: grouping, filtering, output modes.

Port of soap3dp_tpu/pipeline/hits.py: numpy, unchanged apart from the
HitArrays import.

The analog of the reference's host answer collection
(collect_all_answers, CPUfunctions.cpp:1226-1416) and per-class output
filtering (OutputBuffer::ready, DV-DPfunctions.h:367-412): the device
returns rectangular hit arrays; this module flattens them into a
sorted per-read table, drops hits that cross chromosome boundaries or
excluded ambiguity regions, computes per-read best/suboptimal stats
(X0/X1) and applies the -h output-mode selection with deterministic
tie-breaking (nmis, position, strand).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from soap3dp_tpu_torch.fm.search import HitArrays
from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.io.sam import crosses_boundary
from soap3dp_tpu_torch.pipeline import options as opt
from soap3dp_tpu_torch.utils import rhash


@dataclasses.dataclass
class HitTable:
    """Flat, read-grouped hit table. Rows sorted by (read, nmis, pos, strand)."""

    read_id: np.ndarray   # (M,) int32
    strand: np.ndarray    # (M,) int8 (0 = forward, 1 = reverse)
    pos: np.ndarray       # (M,) uint32 absolute text position
    nmis: np.ndarray      # (M,) int32
    start: np.ndarray     # (B+1,) int64 group offsets per read
    flagged: np.ndarray   # (B,) bool: over budget even in round 2

    def group(self, b: int) -> slice:
        return slice(self.start[b], self.start[b + 1])

    def counts(self) -> np.ndarray:
        return np.diff(self.start)




def _row_order(read, strand, pos, nmis) -> np.ndarray:
    """Sort order for (read, nmis, pos, strand) — a packed u64 key +
    one argsort (a 4-key lexsort = 4 stable sorts, measured 2.6x
    slower at table sizes). Bits: read 24 | nmis 7 | pos 32 | strand 1.
    """
    key = ((read.astype(np.uint64) << 40)
           | (np.clip(nmis, 0, 127).astype(np.uint64) << 33)
           | (pos.astype(np.uint64) << 1)
           | strand.astype(np.uint64))
    return np.argsort(key, kind="stable")



def hits_to_table(hits: HitArrays, num_reads: int, index: Index,
                  lens: np.ndarray) -> HitTable:
    rows, tp, nm, va, flagged = hits.to_host()
    B = num_reads
    rows = rows[va]
    pos = tp[va]
    nmis = nm[va].astype(np.int32)
    strand = (rows >= B).astype(np.int8)
    read = (rows - strand.astype(np.int32) * B).astype(np.int32)
    ok = ~crosses_boundary(index, pos, lens[read])
    read, strand, pos, nmis = read[ok], strand[ok], pos[ok], nmis[ok]
    order = _row_order(read, strand, pos, nmis)
    read, strand, pos, nmis = (read[order], strand[order], pos[order],
                               nmis[order])
    # dedupe placements found by several seeds (identical placements
    # have identical nmis, so duplicates are lexsort-adjacent)
    if read.size:
        dup = np.concatenate(
            [[False], (read[1:] == read[:-1]) & (pos[1:] == pos[:-1])
             & (strand[1:] == strand[:-1])])
        if dup.any():
            keep = ~dup
            read, strand, pos, nmis = (read[keep], strand[keep], pos[keep],
                                       nmis[keep])
    start = np.searchsorted(read, np.arange(B + 1)).astype(np.int64)
    return HitTable(read_id=read, strand=strand, pos=pos, nmis=nmis,
                    start=start, flagged=flagged)


def subset_table(t: HitTable, ids: np.ndarray) -> HitTable:
    """Sub-table for the given read ids, renumbered 0..len(ids)-1."""
    ids = np.asarray(ids, np.int64)
    cnt = t.counts()[ids]
    total = int(cnt.sum())
    rows = np.repeat(t.start[ids], cnt) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt))
    start = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(cnt, out=start[1:])
    return HitTable(
        read_id=np.repeat(np.arange(len(ids), dtype=np.int32), cnt),
        strand=t.strand[rows], pos=t.pos[rows], nmis=t.nmis[rows],
        start=start, flagged=t.flagged[ids])


def merge_tables(a: HitTable, b: HitTable) -> HitTable:
    """Row-union of two tables over the SAME read set (e.g. phase-1 +
    phase-2 hits of the phased search). Duplicate placements — found by
    segments of both phases — are dropped as in hits_to_table; identical
    (read, pos, strand) rows always carry identical nmis."""
    B = len(a.flagged)
    read = np.concatenate([a.read_id, b.read_id])
    strand = np.concatenate([a.strand, b.strand])
    pos = np.concatenate([a.pos, b.pos])
    nmis = np.concatenate([a.nmis, b.nmis])
    order = _row_order(read, strand, pos, nmis)
    read, strand, pos, nmis = (read[order], strand[order], pos[order],
                               nmis[order])
    if read.size:
        dup = np.concatenate(
            [[False], (read[1:] == read[:-1]) & (pos[1:] == pos[:-1])
             & (strand[1:] == strand[:-1])])
        if dup.any():
            keep = ~dup
            read, strand, pos, nmis = (read[keep], strand[keep], pos[keep],
                                       nmis[keep])
    start = np.searchsorted(read, np.arange(B + 1)).astype(np.int64)
    return HitTable(read_id=read, strand=strand, pos=pos, nmis=nmis,
                    start=start, flagged=a.flagged | b.flagged)


def replace_reads(t: HitTable, sub: HitTable, ids: np.ndarray) -> HitTable:
    """Replace the rows of reads `ids` in `t` with `sub`'s rows (sub is
    renumbered 0..len(ids)-1, e.g. a phase-2 merged sub-table)."""
    B = len(t.flagged)
    ids = np.asarray(ids, np.int64)
    inids = np.zeros(B, bool)
    inids[ids] = True
    keep = ~inids[t.read_id]
    read = np.concatenate([t.read_id[keep],
                           ids[sub.read_id].astype(np.int32)])
    strand = np.concatenate([t.strand[keep], sub.strand])
    pos = np.concatenate([t.pos[keep], sub.pos])
    nmis = np.concatenate([t.nmis[keep], sub.nmis])
    order = _row_order(read, strand, pos, nmis)
    read, strand, pos, nmis = (read[order], strand[order], pos[order],
                               nmis[order])
    start = np.searchsorted(read, np.arange(B + 1)).astype(np.int64)
    flagged = t.flagged.copy()
    flagged[ids] = sub.flagged
    return HitTable(read_id=read, strand=strand, pos=pos, nmis=nmis,
                    start=start, flagged=flagged)


def concat_tables(tables: list[HitTable]) -> HitTable:
    """Concatenate renumbered sub-tables along the read axis."""
    off_read = 0
    rid, starts = [], [np.zeros(1, np.int64)]
    off_row = 0
    for t in tables:
        rid.append(t.read_id + off_read)
        starts.append(t.start[1:] + off_row)
        off_read += len(t.flagged)
        off_row += len(t.read_id)
    return HitTable(
        read_id=np.concatenate(rid),
        strand=np.concatenate([t.strand for t in tables]),
        pos=np.concatenate([t.pos for t in tables]),
        nmis=np.concatenate([t.nmis for t in tables]),
        start=np.concatenate(starts),
        flagged=np.concatenate([t.flagged for t in tables]))


@dataclasses.dataclass
class ReadStats:
    """Per-read best-hit statistics (BWA X0/X1 semantics)."""

    best_nmis: np.ndarray  # (B,) int32, -1 when no hits
    x0: np.ndarray         # (B,) #hits with best nmis
    x1: np.ndarray         # (B,) #hits with worse nmis (suboptimal)


def read_stats(table: HitTable, num_reads: int) -> ReadStats:
    B = num_reads
    cnt = table.counts()
    best = np.full(B, -1, np.int32)
    has = cnt > 0
    # table sorted by (read, nmis, ...): the first hit of each group is best
    best[has] = table.nmis[table.start[:-1][has]]
    x0 = np.zeros(B, np.int64)
    if table.read_id.size:
        is_best = table.nmis == best[table.read_id]
        x0 = np.bincount(table.read_id[is_best], minlength=B)
    x1 = cnt - x0
    return ReadStats(best_nmis=best, x0=x0.astype(np.int32),
                     x1=np.maximum(x1, 0).astype(np.int32))


def select_output(table: HitTable, stats: ReadStats, num_reads: int,
                  mode: int, cap: int,
                  pick_hash: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Apply the -h output mode.

    Returns (selected, primary): `selected` is a bool mask over table
    rows (the hits to report, primary + XA alternates), `primary` is
    the table row index of the primary record per read (-1 = none).
    Groups are sorted by (nmis, pos, strand), so the first selected row
    of a group is the deterministic primary.

    `pick_hash` (required for OUTPUT_RANDOM_BEST): per-read uint64
    hashes of (seed, read name) — the pick is a pure function of the
    read identity, invariant under batch splitting (utils/rhash.py).
    """
    B = num_reads
    selected = np.zeros(table.pos.shape[0], bool)
    primary = np.full(B, -1, np.int64)
    if not table.pos.size:
        return selected, primary
    rid = table.read_id
    is_best = table.nmis == stats.best_nmis[rid]
    rank = np.arange(len(rid)) - table.start[rid]  # rank within group
    if mode == opt.OUTPUT_ALL_VALID:
        selected = rank < cap
    elif mode == opt.OUTPUT_ALL_BEST:
        selected = is_best & (rank < cap)
    elif mode == opt.OUTPUT_UNIQUE_BEST:
        selected = is_best & (stats.x0[rid] == 1)
    elif mode == opt.OUTPUT_RANDOM_BEST:
        if pick_hash is None:
            raise ValueError("OUTPUT_RANDOM_BEST needs per-read pick_hash "
                             "(utils/rhash.name_hashes)")
        pick = rhash.unbiased_pick(pick_hash, stats.x0)
        selected = is_best & (rank == pick[rid])
    else:
        raise ValueError(f"unknown output mode {mode}")
    sel_idx = np.flatnonzero(selected)
    if sel_idx.size:
        u, first = np.unique(rid[sel_idx], return_index=True)
        primary[u] = sel_idx[first]
    return selected, primary
