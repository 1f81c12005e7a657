"""Single-end alignment pipeline (port of soap3dp_tpu/pipeline/single.py).

The host logic is the reference's, line for line; the device work goes
through the port's seed search and DP (torch on the index's device, the
Hopper DP kernel on CUDA).

The rebuild of soap3_dp_single_align (alignment.cu:2433-2635): a BWT
mismatch phase over the whole batch, output-mode selection, then DP
salvage of unaligned reads (DPForUnalignSingle2,
DV-DPForSingleReads.cu) when DP is enabled (no -s flag).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from soap3dp_tpu_torch.fm.fmindex import DeviceIndex
from soap3dp_tpu_torch.fm.search import config_for, search_reads
from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.io import sam
from soap3dp_tpu_torch.io.fastq import ReadBatch
from soap3dp_tpu_torch.io.sam import SamRecord, SamWriter
from soap3dp_tpu_torch.kernels.banded_dp import DPScores
from soap3dp_tpu_torch.pipeline import cigar as cig
from soap3dp_tpu_torch.pipeline import dp_rescue, hits, mapq
from soap3dp_tpu_torch.pipeline import options as opt
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.utils import dna, rhash, timers


@dataclasses.dataclass
class BatchSummary:
    num_reads: int = 0
    aligned_bwt: int = 0
    aligned_dp: int = 0
    unaligned: int = 0
    num_records: int = 0
    # reads whose hit set is still truncated after round-3 escalation
    # (surfaced per run; see pair.PairSummary.still_flagged)
    still_flagged: int = 0

    def add(self, other: "BatchSummary") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


def _qual_bytes(batch: ReadBatch, b: int, writer=None) -> bytes | None:
    """Raw qualities — skipped when the output format ignores them
    (succinct binary does; decoding per record costs real time)."""
    if writer is not None and not getattr(writer, "needs_seq", True):
        return None
    if batch.quals is None:
        return None
    return batch.quals[b, : batch.lens[b]].tobytes()


def _seq_bytes(batch: ReadBatch, b: int, writer=None) -> bytes:
    if writer is not None and not getattr(writer, "needs_seq", True):
        return b"*"
    return dna.decode(batch.codes[b, : batch.lens[b]])


def dispatch_single_search(didx, batch: ReadBatch, opts: AlignOptions):
    """Async-dispatch the BWT search for a single-end batch (phase 1 of
    the phased scheme where it applies) — the same double-buffer
    pattern as dispatch_pair_search."""
    from soap3dp_tpu_torch.fm.search import PendingSearch
    from soap3dp_tpu_torch.pipeline.pair import _phase1_range

    lens = batch.lens.astype(np.int32)
    k = opts.effective_mismatches(int(lens.max()) if len(batch) else 0)
    return PendingSearch(didx, batch.codes, lens, config_for(didx, k),
                         seed_range=_phase1_range(didx, opts, k))


def _phase2_single_table(index, didx, batch, todo, t1, lens, k):
    """Synchronous phase-2 (the no-queue path, e.g. the embeddable
    API): dispatch + fetch + merge in place, splicing the complete
    <= k rows of the unresolved reads back into the full table."""
    it = _dispatch_phase2_single(didx, batch, todo, t1, lens, k)
    sub = _phase2_fetch_merge(index, it)
    return hits.replace_reads(t1, sub, todo)


@dataclasses.dataclass
class _SinglePhase2Item:
    """A dispatched SE phase-2 search + everything needed to finish it."""

    pend2: object
    k: int
    nt: int                # real escalated-read count (rest is padding)
    nb: int                # bucketed/padded read count
    sb: ReadBatch          # padded subset batch (nb reads)
    lens: np.ndarray
    tsub: hits.HitTable    # phase-1 hits of the escalated reads (nt)


class SinglePhase2Queue:
    """One-batch-deep pipeline for SE phase-2 completions (the SE
    analog of pair.Phase2Queue): items added during batch i finish at
    the start of batch i+1's align, hiding the phase-2 device time +
    D2H sync behind a full batch of host work."""

    def __init__(self, index, didx, opts: AlignOptions):
        self.index = index
        self.didx = didx
        self.opts = opts
        self._items: list[_SinglePhase2Item] = []

    def add(self, item: _SinglePhase2Item) -> None:
        self._items.append(item)

    def process(self, writer, salvage_queue=None) -> BatchSummary:
        s = BatchSummary()
        # pop each item only after it finishes (see Phase2Queue.process)
        while self._items:
            _phase2_single_finish(self.index, self.didx, self._items[0],
                                  self.opts, writer, salvage_queue, s)
            self._items.pop(0)
        return s


def _dispatch_phase2_single(didx, batch, todo, table, lens, k
                            ) -> _SinglePhase2Item:
    from soap3dp_tpu_torch.fm.search import PendingSearch
    from soap3dp_tpu_torch.utils import shapes

    cfg = config_for(didx, k)
    nb = shapes.bucket(len(todo), min_size=512)
    sel = todo if len(todo) >= nb else np.concatenate(
        [todo, np.zeros(nb - len(todo), np.int64)])
    sb = batch.take(sel)
    pend = PendingSearch(didx, sb.codes, lens[sel], cfg,
                         seed_range=(2, cfg.num_seeds))
    return _SinglePhase2Item(pend2=pend, k=k, nt=len(todo), nb=nb, sb=sb,
                             lens=lens[sel],
                             tsub=hits.subset_table(table, todo))


def _phase2_fetch_merge(index, it: _SinglePhase2Item,
                        summary: "BatchSummary | None" = None,
                        opts: "AlignOptions | None" = None) -> hits.HitTable:
    """Fetch a dispatched SE phase-2 search and merge with the phase-1
    hits of the escalated reads (renumbered 0..nt-1)."""
    with timers.stage("A2.single"):
        raw = it.pend2.result()
    if np.asarray(raw.flagged).any():
        from soap3dp_tpu_torch.fm import host_search
        from soap3dp_tpu_torch.pipeline.options import AlignOptions
        o = opts if opts is not None else AlignOptions()
        raw = host_search.realign_flagged(
            index, raw, it.sb.codes, it.lens, it.k,
            max_decode=o.max_output_per_read,
            budget=o.host_realign_budget)
    if summary is not None:
        # only reads newly still-flagged in phase 2 (phase-1 stills
        # were counted when their batch was aligned)
        summary.still_flagged += int(
            (np.asarray(raw.flagged)[:it.nt] & ~it.tsub.flagged).sum())
    tb = hits.hits_to_table(raw, it.nb, index, it.lens)
    return hits.merge_tables(it.tsub,
                             hits.subset_table(tb, np.arange(it.nt)))


def _phase2_single_finish(index, didx, it, opts, writer, salvage_queue,
                          summary) -> None:
    """Fetch a deferred SE phase-2 search, merge with the phase-1 hits
    and run the full emission tail on the escalated subset."""
    merged = _phase2_fetch_merge(index, it, summary, opts)
    _finish_single(index, didx, it.sb.take(slice(None, it.nt)), merged,
                   opts, writer, salvage_queue, summary)


def align_single_batch(
    index: Index,
    didx: DeviceIndex,
    batch: ReadBatch,
    opts: AlignOptions,
    writer: SamWriter,
    salvage_queue: "SalvageQueue | None" = None,
    pending_search=None,
    phase2_queue: "SinglePhase2Queue | None" = None,
) -> BatchSummary:
    B = len(batch)
    summary = BatchSummary(num_reads=B)
    if phase2_queue is not None:
        # finish the PREVIOUS batch's escalated reads first — their
        # phase-2 wire landed while this batch was parsed/dispatched
        summary.add(phase2_queue.process(writer, salvage_queue))
    lens = batch.lens.astype(np.int32)
    k = opts.effective_mismatches(int(lens.max()) if B else 0)

    if opts.skip_bwt_alignment:
        table = hits.HitTable(
            read_id=np.zeros(0, np.int32), strand=np.zeros(0, np.int8),
            pos=np.zeros(0, np.uint32), nmis=np.zeros(0, np.int32),
            start=np.zeros(B + 1, np.int64), flagged=np.zeros(B, bool))
    else:
        raw = pending_search.result() if pending_search is not None \
            else search_reads(didx, batch.codes, lens,
                              config_for(didx, k))
        if np.asarray(raw.flagged).any():
            # host re-alignment of super-repetitive reads, occ-capped +
            # batch-budgeted (ProcessReadDoubleStrand2 analog with the
            # reference's MaxOutputPerRead clamp; see fm/host_search.py)
            from soap3dp_tpu_torch.fm import host_search
            raw = host_search.realign_flagged(
                index, raw, batch.codes, lens, k,
                max_decode=opts.max_output_per_read,
                budget=opts.host_realign_budget)
        table = hits.hits_to_table(raw, B, index, lens)
        phased = (pending_search is not None
                  and getattr(pending_search, "seed_hi", k + 1) < k + 1)
        if phased:
            # phase-1 sets are complete for <= 1 mismatch: reads whose
            # best found hit is <= 1 are provably optimal with a
            # complete best-level set; the rest (no hit, or best >= 2)
            # search the remaining segments (the SE analog of the
            # reference's staged phases, soap3_dp_single_align)
            st0 = hits.read_stats(table, B)
            todo = np.flatnonzero((st0.best_nmis < 0)
                                  | (st0.best_nmis >= 2))
            if todo.size and phase2_queue is not None:
                # deferred path: dispatch phase 2 now, emit the
                # resolved reads now, finish the rest next batch
                item = _dispatch_phase2_single(didx, batch, todo, table,
                                               lens, k)
                phase2_queue.add(item)
                summary.still_flagged += int(
                    np.asarray(table.flagged).sum())
                res_m = np.ones(B, bool)
                res_m[todo] = False
                res = np.flatnonzero(res_m)
                _finish_single(index, didx, batch.take(res),
                               hits.subset_table(table, res), opts,
                               writer, salvage_queue, summary)
                return summary
            if todo.size:
                table = _phase2_single_table(index, didx, batch, todo,
                                             table, lens, k)
        summary.still_flagged += int(np.asarray(table.flagged).sum())
    _finish_single(index, didx, batch, table, opts, writer, salvage_queue,
                   summary)
    return summary


def _finish_single(index, didx, batch, table, opts, writer, salvage_queue,
                   summary) -> None:
    """Emission tail of the SE pipeline: output-mode selection, MAPQ,
    gapless emission, DP salvage routing, unmapped records."""
    B = len(batch)
    lens = batch.lens.astype(np.int32)
    stats = hits.read_stats(table, B)
    ph = (rhash.name_hashes(batch.names, opts.random_seed)
          if opts.output_mode == opt.OUTPUT_RANDOM_BEST else None)
    selected, primary = hits.select_output(
        table, stats, B, opts.output_mode, opts.max_output_per_read,
        pick_hash=ph)

    if opts.bwa_like_score:
        mq = mapq.bwa_like_single(stats.x0, stats.x1)
    else:
        # table mode scores with the REAL average mismatch base quality
        # of each primary placement (BGS-IO.cpp:2331-2367)
        amq = np.full(B, 20, np.int32)
        wp = np.flatnonzero(primary >= 0)
        if wp.size and batch.quals is not None:
            pr = primary[wp]
            amq[wp] = mapq.avg_mismatch_qual(
                index, table.pos[pr], table.strand[pr], batch.codes[wp],
                lens[wp], batch.quals[wp])
        mq = mapq.table_single(np.maximum(stats.best_nmis, 0), amq,
                               stats.x0, stats.x1,
                               opts.max_mapq, opts.min_mapq)

    emitted = np.zeros(B, bool)
    with_prim = np.flatnonzero(primary >= 0)
    if with_prim.size:
        _emit_gapless_batch(index, writer, batch, table, selected, stats,
                            with_prim, primary[with_prim], mq, opts)
        emitted[with_prim] = True
        summary.aligned_bwt += len(with_prim)
        summary.num_records += len(with_prim)

    # DP salvage for reads with no BWT hit at all
    no_hit = stats.best_nmis < 0
    if opts.dp_for_too_many_hits:
        no_hit |= table.flagged
    rescue = np.flatnonzero(no_hit & ~emitted) if opts.dp_enabled else np.zeros(0, int)
    if rescue.size and salvage_queue is not None:
        # deferred: failures from several batches flush as one large
        # salvage batch (same pattern as pair.RescueQueue)
        salvage_queue.add(batch, rescue)
        emitted[rescue] = True
    elif rescue.size:
        n = _dp_salvage(index, didx, batch, rescue, opts, writer)
        summary.aligned_dp += len(n)
        summary.num_records += len(n)
        emitted[n] = True

    for b in np.flatnonzero(~emitted):
        _emit_unmapped_single(writer, batch, b)
        summary.unaligned += 1
        summary.num_records += 1


def _emit_unmapped_single(writer, batch, b) -> None:
    writer.write(SamRecord(
        qname=batch.names[b], flag=sam.FLAG_UNMAPPED, chrom=-1, pos=-1,
        mapq=0, cigar="", seq=_seq_bytes(batch, b, writer),
        qual=_qual_bytes(batch, b, writer)))


class SalvageQueue:
    """Cross-batch accumulator for single-end DP salvage (the SE analog
    of pair.RescueQueue): per-batch salvage sets are tiny, so running
    the seeding + DP engines on them pays fixed dispatch/transfer
    latency; queued failures flush as one large batch."""

    def __init__(self, index, didx, opts: AlignOptions,
                 flush_reads: int = 16384):
        self.index = index
        self.didx = didx
        self.opts = opts
        self.flush_reads = flush_reads
        self._items: list[ReadBatch] = []
        self._pending = 0

    def add(self, batch: ReadBatch, ids: np.ndarray) -> None:
        self._items.append(batch.take(ids))
        self._pending += len(ids)

    @property
    def pending(self) -> int:
        return self._pending

    def should_flush(self) -> bool:
        return self._pending >= self.flush_reads

    def drain(self) -> list:
        """Atomically take everything queued (main-thread only)."""
        items, self._items, self._pending = self._items, [], 0
        return items

    def flush(self, writer) -> BatchSummary:
        return self.flush_items(self.drain(), writer)

    def flush_items(self, items: list, writer) -> BatchSummary:
        """Salvage over a drained item list; queue-state-free so it can
        run on a worker thread (pipeline.overlap.AsyncFlusher) with a
        thread-safe writer."""
        from soap3dp_tpu_torch.pipeline.pair import _concat_batches

        summary = BatchSummary()
        if not items:
            return summary
        cb = _concat_batches(items)
        n = _dp_salvage(self.index, self.didx, cb,
                        np.arange(len(cb)), self.opts, writer)
        summary.aligned_dp += len(n)
        summary.num_records += len(n)
        emitted = np.zeros(len(cb), bool)
        emitted[n] = True
        for b in np.flatnonzero(~emitted):
            _emit_unmapped_single(writer, cb, b)
            summary.unaligned += 1
            summary.num_records += 1
        return summary


def _emit_gapless_batch(index, writer, batch, table, selected, stats,
                        reads_sel, prim_rows, mq, opts):
    """Vectorized single-end emission: batch the coordinate translation
    and stats; per-record loop only assembles columns. MD and XA take a
    per-record slow path."""
    chrom, off = sam.translate_pos(index, table.pos[prim_rows])
    strands = table.strand[prim_rows]
    n_sel_per_read = np.bincount(
        table.read_id[selected], minlength=len(stats.x0)) if selected.any() \
        else np.zeros(len(stats.x0), np.int64)

    # fast path: single-placement records through the columnar block
    # writer (no XA/MD) when the output format supports it
    nsel_arr = n_sel_per_read[reads_sel]
    fast = (nsel_arr <= 1) & (not opts.output_md)
    if fast.any() and hasattr(writer, "write_block"):
        fi = np.flatnonzero(fast)
        bsel = reads_sel[fi]
        # cigars=None -> gapless "<len>M" from seq_lens; the batch code/
        # qual matrices pass down uncopied with seq_src row indices
        kw = {"seq_lens": batch.lens[bsel]}
        if getattr(writer, "needs_seq", True):
            kw["seq_codes"] = batch.codes
            kw["seq_src"] = bsel.astype(np.int64)
            if batch.quals is not None:
                kw["quals"] = batch.quals
        if getattr(writer, "needs_tags", True):
            kw["tags"] = (stats.x0[bsel], stats.x1[bsel],
                          table.nmis[prim_rows[fi]])
        writer.write_block(
            np.asarray(batch.names)[bsel],
            np.where(strands[fi] == 1, sam.FLAG_REVERSE, 0),
            chrom[fi], off[fi], np.asarray(mq)[bsel],
            None, np.zeros(len(fi), np.int32), **kw)
        keep = ~fast
    else:
        keep = np.ones(len(reads_sel), bool)

    cols = zip(reads_sel[keep].tolist(), prim_rows[keep].tolist(),
               chrom[keep].tolist(),
               off[keep].tolist(), strands[keep].tolist(),
               mq[reads_sel[keep]].tolist(), table.nmis[prim_rows[keep]].tolist(),
               stats.x0[reads_sel[keep]].tolist(),
               stats.x1[reads_sel[keep]].tolist(),
               n_sel_per_read[reads_sel[keep]].tolist())
    for b, p, ch, of, strand, m, nmis, x0, x1, nsel in cols:
        rlen = int(batch.lens[b])
        tags = [f"X0:i:{x0}", f"X1:i:{x1}", f"XM:i:{nmis}", "XO:i:0",
                "XG:i:0"]
        if opts.output_md:
            codes = batch.codes[b, :rlen]
            if strand:
                codes = dna.revcomp_codes(codes)
            md, nm = sam.mismatch_md(index, int(table.pos[p]), codes)
            tags = [f"NM:i:{nm}"] + tags + [f"MD:Z:{md}"]
        if nsel > 1:
            g = table.group(b)
            alts = [i for i in range(g.start, g.stop)
                    if selected[i] and i != p]
            entries = []
            for i in alts[: opts.max_output_per_read]:
                c2, o2 = sam.translate_pos(index, np.asarray([table.pos[i]]))
                entries.append(sam.xa_entry(
                    writer_name(index, int(c2[0])), int(table.strand[i]),
                    int(o2[0]), f"{rlen}M", int(table.nmis[i])))
            if entries:
                tags.append("XA:Z:" + "".join(entries))
        writer.write(SamRecord(
            qname=batch.names[b],
            flag=sam.FLAG_REVERSE if strand else 0,
            chrom=ch, pos=of, mapq=m,
            cigar=f"{rlen}M", seq=_seq_bytes(batch, b, writer),
            qual=_qual_bytes(batch, b, writer), tags=tags))


def writer_name(index: Index, chrom: int) -> bytes:
    return index.names[chrom].encode()


def _dp_salvage(index, didx, batch, rescue, opts, writer) -> np.ndarray:
    """DP-rescue the given read subset; returns read ids that aligned."""
    reads = batch.codes[rescue]
    lens = batch.lens[rescue].astype(np.int32)
    # static per run: seed geometry and window buckets derive from the
    # batch width, not the data, to avoid per-batch recompiles
    max_len = int(batch.codes.shape[1])
    seed_pos, seed_len = dp_rescue.single_dp_seed_matrix(
        lens, max_len, halved=opts.dp_seed_1mm)
    cand = dp_rescue.seed_candidates(didx, reads, lens, seed_pos, seed_len)
    if cand.read.size == 0:
        return np.zeros(0, int)
    margin = dp_rescue.dp_margin(lens[cand.read])
    win_start = np.maximum(cand.pos - margin, 0)
    win_len = (lens[cand.read] + 2 * margin).astype(np.int64)
    n = int(index.n)
    win_len = np.minimum(win_len, n - win_start).astype(np.int32)
    max_win = int(max_len + 2 * int(dp_rescue.dp_margin(max_len)))
    sc = DPScores(opts.match_score, opts.mismatch_score,
                  opts.gap_open_score, opts.gap_extend_score)
    M = cand.read.shape[0]
    clip_l = np.where(cand.strand == 1, opts.max_end_clip, opts.max_front_clip)
    clip_r = np.where(cand.strand == 1, opts.max_front_clip, opts.max_end_clip)
    res = dp_rescue.run_banded_dp(
        didx, reads, lens, cand, win_start, win_len, max_win,
        clip_l, clip_r,
        np.full(M, max_win + 1, np.int32), np.zeros(M, np.int32),
        opts.dp_cutoff(lens[cand.read]), sc, index_host=index)
    if res.read.size == 0:
        return np.zeros(0, int)
    # dedupe identical final placements, group per read, best-first
    order = np.lexsort((res.pos, res.strand, -res.score, res.read))
    aligned_reads = []
    by_read: dict[int, list[int]] = {}
    seen = set()
    for i in order:
        key = (int(res.read[i]), int(res.strand[i]), int(res.pos[i]))
        if key in seen:
            continue
        seen.add(key)
        by_read.setdefault(int(res.read[i]), []).append(int(i))
    for rsub, rows in by_read.items():
        b = int(rescue[rsub])
        best = res.score[rows[0]]
        x0 = sum(1 for i in rows if res.score[i] == best)
        x1 = len(rows) - x0
        rlen = int(batch.lens[b])
        amq = 20
        if not opts.bwa_like_score and batch.quals is not None:
            i0 = rows[0]
            amq = mapq.avg_mis_qual_from_runs(
                res.ops[i0], res.cnts[i0], int(res.nrun[i0]), rlen,
                int(res.strand[i0]), batch.quals[b])
        mq = int(mapq.dp_single(
            rlen * opts.match_score, amq, x0, 0, x1, best,
            res.score[rows[1]] if len(rows) > 1 else 0,
            int(opts.dp_cutoff(rlen)), opts.max_mapq, opts.min_mapq,
            opts.bwa_like_score)[()])
        rec = _dp_record(index, batch, res, rows, b, mq, x0, x1, opts, writer)
        writer.write(rec)
        aligned_reads.append(b)
    return np.asarray(aligned_reads, int)


def _dp_record(index, batch, res, rows, b, mq, x0, x1, opts, writer=None) -> SamRecord:
    i = rows[0]
    strand = int(res.strand[i])
    rlen = int(batch.lens[b])
    cigar = cig.runs_to_cigar(res.ops[i], res.cnts[i], int(res.nrun[i]))
    nm, mis, go, ge = cig.runs_stats(res.ops[i], res.cnts[i], int(res.nrun[i]))
    chrom, off = sam.translate_pos(index, np.asarray([res.pos[i]]))
    tags = [f"X0:i:{x0}", f"X1:i:{x1}", f"XM:i:{mis}", f"XO:i:{go}",
            f"XG:i:{ge}"]
    if opts.output_md:
        w0 = int(res.win_start[i])
        wlen = int(res.pos[i]) - w0 + rlen + 64
        wcodes = _genome_codes(index, w0, wlen)
        md = cig.runs_to_md(res.ops[i], res.cnts[i], int(res.nrun[i]),
                            wcodes, int(res.pos[i]) - w0)
        tags = [f"NM:i:{nm}"] + tags + [f"MD:Z:{md}"]
    if len(rows) > 1:
        entries = []
        for j in rows[1: opts.max_output_per_read]:
            c2, o2 = sam.translate_pos(index, np.asarray([res.pos[j]]))
            cg = cig.runs_to_cigar(res.ops[j], res.cnts[j], int(res.nrun[j]))
            nm2 = cig.runs_stats(res.ops[j], res.cnts[j], int(res.nrun[j]))[0]
            entries.append(sam.xa_entry(
                writer_name(index, int(c2[0])), int(res.strand[j]),
                int(o2[0]), cg, nm2))
        tags.append("XA:Z:" + "".join(entries))
    return SamRecord(
        qname=batch.names[b],
        flag=sam.FLAG_REVERSE if strand else 0,
        chrom=int(chrom[0]), pos=int(off[0]), mapq=mq, cigar=cigar,
        seq=_seq_bytes(batch, b, writer), qual=_qual_bytes(batch, b, writer), tags=tags)


def _genome_codes(index: Index, start: int, length: int) -> np.ndarray:
    w0, w1 = start // 16, (start + length + 15) // 16
    return dna.unpack_words(np.asarray(index.pac[w0:w1 + 1]),
                            (w1 + 1 - w0) * 16)[start % 16:][:length]
