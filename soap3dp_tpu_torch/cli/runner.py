"""CLI execution for the port: load the index onto one device or a
device mesh, stream batches through the double-buffered pipelines,
write output.

Port of soap3dp_tpu/cli/runner.py (``run_single``, ``run_pair``,
``run_multi`` and their helpers). ``--devices N`` replicates the index
over a mesh of N devices (distributed/mesh.py) and every pipeline stage
shards its work over it. ``--hosts N`` runs N processes, each taking
every Nth input batch and writing ``<prefix>.<host-id>`` outputs; their
summaries are summed with a torch.distributed all-reduce over gloo (the
only collective is a handful of host integers).
"""

from __future__ import annotations

import contextlib
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


def resolve_devices(name: str, count: int = 1) -> list[torch.device]:
    """The devices of a run: ``--device`` alone, or with ``--devices N``
    a mesh of N. On CUDA: min(N, cards) cards from --device's on, 0
    meaning all; on the CPU: N replicas (the tests' analog of several
    devices)."""
    dev = resolve_device(name)
    if count < 0:
        raise ValueError(f"--devices {count}: expected 0 (all) or more")
    if count == 1 or (dev.type == "cpu" and count == 0):
        return [dev]
    if dev.type == "cpu":
        return [dev] * count
    total = torch.cuda.device_count()
    n = total if count == 0 else min(count, total)
    first = dev.index or 0
    return [torch.device("cuda", (first + i) % total) for i in range(n)]


def host_config(args) -> tuple[int, int, str | None]:
    """(hosts, host id, coordinator) from the flags, else from
    SOAP3DP_NUM_HOSTS / SOAP3DP_HOST_ID / SOAP3DP_COORDINATOR. A run of
    more than one host needs a host id in [0, hosts) and a coordinator:
    raises ValueError, never carries on as a single process."""
    import os

    hosts = args.hosts
    if hosts is None:
        hosts = int(os.environ.get("SOAP3DP_NUM_HOSTS", "1"))
    if hosts <= 1:
        return 1, 0, None
    host_id = args.host_id
    if host_id is None and os.environ.get("SOAP3DP_HOST_ID"):
        host_id = int(os.environ["SOAP3DP_HOST_ID"])
    coord = args.coordinator or os.environ.get("SOAP3DP_COORDINATOR")
    if host_id is None or not coord:
        raise ValueError(f"--hosts {hosts} needs --host-id and --coordinator "
                         "host:port (or SOAP3DP_HOST_ID and "
                         "SOAP3DP_COORDINATOR)")
    if not 0 <= host_id < hosts:
        raise ValueError(f"--host-id {host_id} is not in [0, {hosts})")
    return hosts, host_id, coord


def _init_hosts(args) -> tuple[int, int]:
    """Multi-host mode: join the process group of ``host_config(args)``
    (once per process: run_multi calls the runners once per line). One
    process per host or card, each aligning its stride of the input
    batches into its own output shard, merged like the reference's
    per-process .gout.N files (README section 3)."""
    import torch.distributed as dist

    hosts, host_id, coord = host_config(args)
    if hosts > 1 and not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=hosts, rank=host_id)
        print(f"[soap3dp] multi-host: process {host_id}/{hosts}, "
              f"{max(torch.cuda.device_count(), 1)} local device(s)",
              file=sys.stderr)
    return hosts, host_id


def close_hosts() -> None:
    """Leave the multi-host process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _stride(it, hosts: int, host_id: int):
    """Each host takes every hosts-th input batch (its input shard)."""
    for i, item in enumerate(it):
        if i % hosts == host_id:
            yield item


def _merge_summary(total, hosts: int) -> None:
    """Sum the per-host summary counters across processes and print the
    global totals."""
    import dataclasses

    import torch.distributed as dist

    fields = [f.name for f in dataclasses.fields(total)]
    counts = torch.tensor([getattr(total, f) for f in fields],
                          dtype=torch.int64)
    dist.all_reduce(counts)
    merged = type(total)(**{f: int(v) for f, v in
                            zip(fields, counts.tolist())})
    print(f"[soap3dp] global (all {hosts} hosts): {merged}", file=sys.stderr)


def _hbm_budget(device: torch.device) -> int | None:
    """Device-memory byte budget for the index (80% of the card), or
    None off CUDA (reactive ladder only)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory * 0.8)


def _load(index_arg: str, devices: list[torch.device]):
    """(host index, device index): on one device with the OOM ladder; on
    several, replicated over their mesh (the ladder's budget then per
    device)."""
    from soap3dp_tpu_torch.index.builder import load_index
    from soap3dp_tpu_torch.distributed import mesh as dmesh
    from soap3dp_tpu_torch.fm.fmindex import device_index_ladder
    from soap3dp_tpu_torch.utils import timers

    path = index_arg if index_arg.endswith(".t3i") else index_arg + ".t3i"
    with timers.clocked("runner.load") as span:
        index = load_index(path)
        loaded = span.elapsed()
        upload = None
        if len(devices) > 1:
            mesh = dmesh.make_mesh(devices)
            upload = lambda ix: dmesh.replicate_index(ix, mesh)  # noqa: E731
        budgets = [_hbm_budget(d) for d in devices]
        didx, index = device_index_ladder(
            index, devices[0], upload=upload,
            hbm_budget=None if None in budgets else min(budgets))
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    if len(devices) > 1:
        print(f"[soap3dp] device mesh: {len(devices)} chips", file=sys.stderr)
    print(f"[soap3dp] index loaded in {loaded:.2f}s, uploaded to "
          f"{','.join(map(str, devices))} in {span.elapsed() - loaded:.2f}s "
          f"({index.n} bp, {len(index.names)} sequences)", file=sys.stderr)
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


def _align_backoff(align_one, summary_cls, batches, devices, min_reads=1024,
                   pending=None):
    """Align one batch on ``devices``; on device OOM, halve and retry
    (recursively), down to ``min_reads`` (the reference's tryAlloc
    degradation)."""
    from soap3dp_tpu_torch.fm.fmindex import is_oom_error

    n = len(batches[0].names)
    try:
        return align_one(*batches, pending)
    except Exception as e:  # noqa: BLE001 — only OOM is handled
        if not is_oom_error(e) or n <= min_reads:
            raise
    for d in set(devices):
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    mid = n // 2
    print(f"[soap3dp] device OOM on a {n}-read batch; retrying as "
          f"2 x {mid}", file=sys.stderr)
    s = summary_cls()
    for sl in (slice(0, mid), slice(mid, None)):
        s.add(_align_backoff(align_one, summary_cls,
                             tuple(b.take(sl) for b in batches), devices,
                             min_reads=min_reads))
    return s


def _writer(opts, index, path):
    from soap3dp_tpu_torch.io.aio import AsyncWriter
    from soap3dp_tpu_torch.io.sam import SamWriter
    from soap3dp_tpu_torch.io.succinct import BamWriter, SuccinctWriter
    from soap3dp_tpu_torch.pipeline import options as opt

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
    """The ``single`` command."""
    from soap3dp_tpu_torch.utils import timers

    try:
        with timers.stage("runner.job"):
            return _run_single(args)
    finally:
        timers.report()


def _run_single(args) -> int:
    hosts, host_id = _init_hosts(args)

    from soap3dp_tpu_torch.cli.main import _build_options
    from soap3dp_tpu_torch.io.aio import prefetch
    from soap3dp_tpu_torch.io.fastq import read_single
    from soap3dp_tpu_torch.utils import timers
    from soap3dp_tpu_torch.pipeline.overlap import AsyncFlusher
    from soap3dp_tpu_torch.pipeline.single import (BatchSummary,
                                                   SalvageQueue,
                                                   SinglePhase2Queue,
                                                   align_single_batch,
                                                   dispatch_single_search)

    devices = resolve_devices(args.torch_device, args.devices)
    opts = _build_options(args, args.reads)
    if hosts > 1:
        opts.output_prefix += f".{host_id}"
    index, didx = _load(args.index, devices)
    total = BatchSummary()
    with _writer(opts, index, opts.output_prefix) as w:
        # double-buffered batch loop (as run_pair): batch i+1's search is
        # enqueued before batch i's host work; salvage failures queue
        # across batches and flush on a worker thread
        sq = SalvageQueue(index, didx, opts)
        spq = SinglePhase2Queue(index, didx, opts)
        flusher = AsyncFlusher(sq, w)
        it = prefetch(_stride(read_single(args.reads, opts.batch_size,
                                          opts.max_read_len), hosts, host_id))
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
                BatchSummary, (cur,), devices, pending=pending)
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
    if hosts > 1:
        _merge_summary(total, hosts)
    return 0


def run_pair(args, devices: list[torch.device] | None = None) -> int:
    """The ``pair`` command; ``devices`` overrides --device/--devices."""
    from soap3dp_tpu_torch.utils import timers

    try:
        with timers.stage("runner.job"):
            return _run_pair(args, devices)
    finally:
        timers.report()


def _run_pair(args, devices: list[torch.device] | None) -> int:
    hosts, host_id = _init_hosts(args)

    from soap3dp_tpu_torch.cli.main import _build_options
    from soap3dp_tpu_torch.io.aio import prefetch
    from soap3dp_tpu_torch.io.fastq import read_pairs
    from soap3dp_tpu_torch.utils import timers
    from soap3dp_tpu_torch.pipeline.overlap import AsyncFlusher
    from soap3dp_tpu_torch.pipeline.pair import (PairSummary, Phase2Queue,
                                                 RescueQueue,
                                                 align_pair_batch,
                                                 dispatch_pair_search)

    devices = devices or resolve_devices(args.torch_device, args.devices)
    opts = _build_options(args, args.reads1)
    if hosts > 1:
        opts.output_prefix += f".{host_id}"
    index, didx = _load(args.index, devices)
    total = PairSummary()

    def _report_flush(qn, fs):
        if qn:
            print(f"[soap3dp] rescue flush: {qn} pairs -> "
                  f"{fs.paired_dp} DP-paired, "
                  f"{fs.single_rescued} singly aligned, "
                  f"{fs.unaligned} unaligned", file=sys.stderr)

    with contextlib.ExitStack() as job:
        with timers.stage("runner.setup"):
            w = job.enter_context(_writer(opts, index, opts.output_prefix))
            # double-buffered batch loop: batch i+1's search is enqueued
            # on the device before batch i's host work; rescue failures
            # queue across batches and flush on a worker thread
            rq = RescueQueue(index, didx, opts)
            p2q = Phase2Queue(index, didx, opts)
            it = prefetch(_stride(read_pairs(args.reads1, args.reads2,
                                             opts.batch_size,
                                             opts.max_read_len),
                                  hosts, host_id))
            flusher = AsyncFlusher(rq, w, on_flush=_report_flush)
            cur = next(it, None)
            if cur:
                _fix_quals(opts, *cur)
        with timers.stage("runner.dispatch"):
            pending = dispatch_pair_search(didx, *cur, opts) if cur else None
        ordinal = 0
        while cur is not None:
            with timers.batch(ordinal):
                with timers.stage("runner.poll"):
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
                    lambda x1, x2, p: align_pair_batch(
                        index, didx, x1, x2, opts, w, pending_search=p,
                        rescue_queue=rq, phase2_queue=p2q),
                    PairSummary, (b1, b2), devices, pending=pending)
                total.add(s)
                with timers.stage("runner.flush_submit"):
                    flusher.maybe_submit()
                cur, pending = nxt, nxt_pending
                print(f"[soap3dp] batch: {s.num_pairs} pairs, "
                      f"{s.paired_bwt} BWT-paired ({time.time() - t0:.2f}s)",
                      file=sys.stderr)
            ordinal += 1
        # end-of-run drain: rescue backlog first (on the worker), then the
        # last batch's deferred escalations, then what those re-queued,
        # then the writer's queue
        with timers.stage("runner.drain"):
            flusher.submit()
            total.add(p2q.process(w, rq))
            flusher.submit()
            flusher.join(total.add)
            w.close()
    _summary(opts, total)
    if hosts > 1:
        _merge_summary(total, hosts)
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
