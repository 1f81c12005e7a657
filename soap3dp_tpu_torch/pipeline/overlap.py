"""Overlap cross-batch flush work with the main batch loop (port of
soap3dp_tpu/pipeline/overlap.py).

AsyncFlusher runs the RescueQueue / SalvageQueue flushes on ONE worker
thread: drain() runs on the main thread (queue state is main-thread
only), the flush runs on the worker, and the main loop keeps
dispatching. Requires a thread-safe writer (io.aio.AsyncWriter).

One change from the reference: when two flushes are in flight, submit()
blocks on the unfinished ones only. The reference waits for the first
completion among every future it ever submitted; once one has finished
that wait returns at once, so the main thread spins, and the Python
interpreter lock it holds stalls the worker's host work (a plain-torch
DP salvage took 290 s instead of 0.3 s in a test). Output is the same.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable

from soap3dp_tpu_torch.utils import timers


class AsyncFlusher:
    """Run `queue.flush_items(queue.drain(), writer)` on a worker thread.

    ``queue`` must provide drain() -> items, flush_items(items, writer)
    -> summary, should_flush() and .pending. Summaries accumulate and
    are returned by join(). ``on_flush(queued_n, summary)`` (optional)
    runs on the worker after each flush — for per-flush logging.
    """

    def __init__(self, queue, writer, on_flush: Callable | None = None,
                 eager_min: int = 2048):
        self.queue = queue
        self.writer = writer
        self.on_flush = on_flush
        self.eager_min = eager_min
        self._ex = cf.ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="soap3dp-flush")
        self._futs: list = []
        # the runner batches whose work the queue holds (for the flush
        # spans), noted when its pending count has grown
        self._batches: list[int] = []
        self._seen = 0

    def _note_batch(self) -> None:
        if self.queue.pending > self._seen:
            b = timers.batch_id()
            if not self._batches or self._batches[-1] != b:
                self._batches.append(b)
        self._seen = self.queue.pending

    def maybe_submit(self) -> None:
        """Submit when the queue's own threshold fires, or eagerly when
        the worker is idle and at least ``eager_min`` items wait (keeps
        the end-of-run backlog near one batch's worth)."""
        self._note_batch()
        if self.queue.should_flush():
            self.submit()
        elif (self.queue.pending >= self.eager_min
              and all(f.done() for f in self._futs)):
            self.submit()

    def submit(self) -> None:
        """Drain the queue now and flush it on the worker (at most one
        flush runs while one more waits)."""
        while True:
            live = [f for f in self._futs if not f.done()]
            if len(live) < 2:
                break
            with timers.wait("overlap.submit_wait"):
                cf.wait(live, return_when=cf.FIRST_COMPLETED)
        self._note_batch()
        qn = self.queue.pending
        items = self.queue.drain()
        batches, self._batches, self._seen = self._batches, [], 0
        if not items:
            return
        self._futs.append(self._ex.submit(self._run, items, qn,
                                          timers.current(), batches))

    def _run(self, items, qn: int, parent: int, batches: list[int]):
        # the one span whose parent is on another thread: the batch
        # loop's span that submitted it
        with timers.linked("overlap.flush", parent, batches):
            s = self.queue.flush_items(items, self.writer)
            if self.on_flush is not None:
                self.on_flush(qn, s)
        return s

    def join(self, summary_add) -> None:
        """Wait for all flushes; fold their summaries via
        ``summary_add(s)``. Re-raises the first worker failure."""
        futs, self._futs = self._futs, []
        with timers.wait("overlap.join"):
            for f in futs:
                summary_add(f.result())
            self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # on error paths just stop the worker; callers join() on success
        self._ex.shutdown(wait=False, cancel_futures=True)
