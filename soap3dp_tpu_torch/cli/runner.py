"""CLI execution for the port: load the index onto one device, stream
batches through the double-buffered pipelines, write output.

Port of soap3dp_tpu/cli/runner.py (``run_single``, ``run_pair``,
``run_multi`` and their helpers; the multi-device and multi-host paths
are not ported yet).
"""

from __future__ import annotations

import sys
import time

import torch


def resolve_device(name: str) -> torch.device:
    """The torch device for ``--device``; a CUDA device must exist."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _hbm_budget(device: torch.device) -> int | None:
    """Device-memory byte budget for the index (80% of the card), or
    None off CUDA (reactive ladder only)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory * 0.8)


def _load(index_arg: str, device: torch.device):
    from soap3dp_tpu.index.builder import load_index
    from soap3dp_tpu_torch.fm.fmindex import device_index_ladder

    path = index_arg if index_arg.endswith(".t3i") else index_arg + ".t3i"
    t0 = time.time()
    index = load_index(path)
    t1 = time.time()
    didx, index = device_index_ladder(index, device,
                                      hbm_budget=_hbm_budget(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.time()
    print(f"[soap3dp] index loaded in {t1 - t0:.2f}s, uploaded to {device} "
          f"in {t2 - t1:.2f}s ({index.n} bp, {len(index.names)} sequences)",
          file=sys.stderr)
    return index, didx


def _fix_quals(opts, *batches):
    """Illumina 1.3+ (-I): shift phred+64 qualities to phred+33."""
    import numpy as np

    if not opts.illumina13:
        return
    for b in batches:
        if b.quals is not None:
            q = np.where(b.quals != 0,
                         np.maximum(b.quals.astype(np.int16) - 31, 33),
                         0).astype(b.quals.dtype)
            q.flags.writeable = False
            b.quals = q


def _align_backoff(align_one, summary_cls, batches, min_reads=1024,
                   pending=None):
    """Align one batch; on device OOM, halve and retry (recursively),
    down to ``min_reads`` (the reference's tryAlloc degradation)."""
    from soap3dp_tpu_torch.fm.fmindex import is_oom_error

    n = len(batches[0].names)
    try:
        return align_one(*batches, pending)
    except Exception as e:  # noqa: BLE001 — only OOM is handled
        if not is_oom_error(e) or n <= min_reads:
            raise
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    mid = n // 2
    print(f"[soap3dp] device OOM on a {n}-read batch; retrying as "
          f"2 x {mid}", file=sys.stderr)
    s = summary_cls()
    for sl in (slice(0, mid), slice(mid, None)):
        s.add(_align_backoff(align_one, summary_cls,
                             tuple(b.take(sl) for b in batches),
                             min_reads=min_reads))
    return s


def _writer(opts, index, path):
    from soap3dp_tpu.io.aio import AsyncWriter
    from soap3dp_tpu.io.sam import SamWriter
    from soap3dp_tpu.io.succinct import BamWriter, SuccinctWriter
    from soap3dp_tpu.pipeline import options as opt

    if opts.output_format == opt.FORMAT_SUCCINCT:
        w = SuccinctWriter(path + ".gout", index)
    elif opts.output_format == opt.FORMAT_BAM:
        w = BamWriter(path + ".bam", index, read_group=opts.read_group,
                      sample=opts.sample_name, rg_option=opts.rg_option)
    else:
        w = SamWriter(path + ".sam", index, read_group=opts.read_group,
                      sample=opts.sample_name, rg_option=opts.rg_option)
    return AsyncWriter(w)


def run_single(args) -> int:
    from soap3dp_tpu.cli.main import _build_options
    from soap3dp_tpu.io.aio import prefetch
    from soap3dp_tpu.io.fastq import read_single
    from soap3dp_tpu.utils import timers
    from soap3dp_tpu_torch.pipeline.overlap import AsyncFlusher
    from soap3dp_tpu_torch.pipeline.single import (BatchSummary,
                                                   SalvageQueue,
                                                   SinglePhase2Queue,
                                                   align_single_batch,
                                                   dispatch_single_search)

    device = resolve_device(args.torch_device)
    opts = _build_options(args, args.reads)
    index, didx = _load(args.index, device)
    total = BatchSummary()
    with _writer(opts, index, opts.output_prefix) as w:
        # double-buffered batch loop (as run_pair): batch i+1's search is
        # enqueued before batch i's host work; salvage failures queue
        # across batches and flush on a worker thread
        sq = SalvageQueue(index, didx, opts)
        spq = SinglePhase2Queue(index, didx, opts)
        flusher = AsyncFlusher(sq, w)
        it = prefetch(read_single(args.reads, opts.batch_size,
                                  opts.max_read_len))
        cur = next(it, None)
        if cur is not None:
            _fix_quals(opts, cur)
        pending = dispatch_single_search(didx, cur, opts) \
            if cur is not None else None
        while cur is not None:
            w.poll()
            nxt = next(it, None)
            if nxt is not None:
                _fix_quals(opts, nxt)
            with timers.stage("runner.dispatch"):
                nxt_pending = dispatch_single_search(didx, nxt, opts) \
                    if nxt is not None else None
            t0 = time.time()
            s = _align_backoff(
                lambda b, p: align_single_batch(index, didx, b, opts, w,
                                                salvage_queue=sq,
                                                pending_search=p,
                                                phase2_queue=spq),
                BatchSummary, (cur,), pending=pending)
            total.add(s)
            flusher.maybe_submit()
            print(f"[soap3dp] batch: {s.num_reads} reads, "
                  f"{s.aligned_bwt} BWT-aligned ({time.time() - t0:.2f}s)",
                  file=sys.stderr)
            cur, pending = nxt, nxt_pending
        # end-of-run drain: salvage backlog first (on the worker), then
        # the last batch's deferred escalations, then what those re-queued
        flusher.submit()
        total.add(spq.process(w, sq))
        flusher.submit()
        flusher.join(total.add)
    _summary(opts, total)
    return 0


def run_pair(args) -> int:
    from soap3dp_tpu.cli.main import _build_options
    from soap3dp_tpu.io.aio import prefetch
    from soap3dp_tpu.io.fastq import read_pairs
    from soap3dp_tpu.utils import timers
    from soap3dp_tpu_torch.pipeline.overlap import AsyncFlusher
    from soap3dp_tpu_torch.pipeline.pair import (PairSummary, Phase2Queue,
                                                 RescueQueue,
                                                 align_pair_batch,
                                                 dispatch_pair_search)

    device = resolve_device(args.torch_device)
    opts = _build_options(args, args.reads1)
    index, didx = _load(args.index, device)
    total = PairSummary()
    with _writer(opts, index, opts.output_prefix) as w:
        # double-buffered batch loop: batch i+1's search is enqueued on
        # the device before batch i's host work; rescue failures queue
        # across batches and flush on a worker thread
        rq = RescueQueue(index, didx, opts)
        p2q = Phase2Queue(index, didx, opts)
        it = prefetch(read_pairs(args.reads1, args.reads2, opts.batch_size,
                                 opts.max_read_len))

        def _report_flush(qn, fs):
            if qn:
                print(f"[soap3dp] rescue flush: {qn} pairs -> "
                      f"{fs.paired_dp} DP-paired, "
                      f"{fs.single_rescued} singly aligned, "
                      f"{fs.unaligned} unaligned", file=sys.stderr)

        flusher = AsyncFlusher(rq, w, on_flush=_report_flush)
        cur = next(it, None)
        if cur:
            _fix_quals(opts, *cur)
        pending = dispatch_pair_search(didx, *cur, opts) if cur else None
        while cur is not None:
            w.poll()
            b1, b2 = cur
            nxt = next(it, None)
            if nxt:
                _fix_quals(opts, *nxt)
            with timers.stage("runner.dispatch"):
                nxt_pending = dispatch_pair_search(didx, *nxt, opts) \
                    if nxt else None
            t0 = time.time()
            s = _align_backoff(
                lambda x1, x2, p: align_pair_batch(index, didx, x1, x2, opts,
                                                   w, pending_search=p,
                                                   rescue_queue=rq,
                                                   phase2_queue=p2q),
                PairSummary, (b1, b2), pending=pending)
            total.add(s)
            flusher.maybe_submit()
            cur, pending = nxt, nxt_pending
            print(f"[soap3dp] batch: {s.num_pairs} pairs, "
                  f"{s.paired_bwt} BWT-paired ({time.time() - t0:.2f}s)",
                  file=sys.stderr)
        # end-of-run drain: rescue backlog first (on the worker), then the
        # last batch's deferred escalations, then what those re-queued
        flusher.submit()
        total.add(p2q.process(w, rq))
        flusher.submit()
        flusher.join(total.add)
    _summary(opts, total)
    return 0


def run_multi(cmd: str, args) -> int:
    """Multi-file list mode: one line per read set (README section 2.2)."""
    import copy

    rc = 0
    with open(args.listfile) as fh:
        lines = [l.rstrip("\n").split("\t") for l in fh if l.strip()]
    for cols in lines:
        sub = copy.copy(args)
        if cmd == "pair-multi":
            sub.reads1, sub.reads2 = cols[0], cols[1]
            sub.min_insert, sub.max_insert = int(cols[2]), int(cols[3])
            sub.output_prefix = cols[4]
            if len(cols) > 5:
                sub.read_group = cols[5]
            if len(cols) > 6:
                sub.sample_name = cols[6]
            if len(cols) > 7:
                sub.rg_option = cols[7]
            rc |= run_pair(sub)
        else:
            sub.reads = cols[0]
            sub.output_prefix = cols[1] if len(cols) > 1 else cols[0]
            rc |= run_single(sub)
    return rc


def _summary(opts, total) -> None:
    from soap3dp_tpu.utils import timers

    timers.report()
    print(f"[soap3dp] done: {total}", file=sys.stderr)
    flagged = getattr(total, "still_flagged", 0)
    capped = getattr(total, "capped_anchors", 0)
    if flagged or capped:
        print(f"[soap3dp] warning: incomplete hit sets — "
              f"{flagged} read(s) still over the round-3 placement budget"
              + (f", {capped} anchor(s) hit the pairing fan-out cap"
                 if capped else ""),
              file=sys.stderr)
    with open(opts.output_prefix + ".done", "w") as fh:
        fh.write("done\n")
