"""Background-thread batch prefetch: the AIO double-buffer reader.

The reference dedicates a pthread to filling the next input buffer
while the main thread aligns the current one (AIOInputBuffer,
aio_thread.h:42-156). Here any batch iterator gets the same treatment:
a daemon thread runs the (gzip/parse/pack) producer and a bounded
queue hands finished batches to the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from soap3dp_tpu_torch.utils import timers

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` on a background thread, `depth` items ahead."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def run():
        try:
            i = iter(it)
            while True:
                # producer-side parse cost (reader-thread CPU time; on a
                # single-core host this competes with the align loop)
                with timers.stage("io.parse"):
                    item = next(i, _SENTINEL)
                if item is _SENTINEL:
                    return
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=run, daemon=True, name="soap3dp-aio")
    t.start()
    while True:
        # consumer-side wall time blocked waiting on the reader
        with timers.wait("io.reader_wait"):
            item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item


class AsyncWriter:
    """Run another writer on a dedicated thread: record serialization
    and file IO no longer block the batch loop — the analog of the
    reference's per-batch output pthreads (alignment.cu:1005-1027).

    Callers must not mutate arrays they pass in after the call. Most
    emitters build fresh arrays per block; the PE/SE fast paths ALSO
    pass the shared batch code/qual matrices down uncopied (the
    two-source seq_codes form), so the invariant extends to those:
    ReadBatch matrices are never mutated in place after construction
    (fastq.py marks them read-only to enforce it).

    The producer side is thread-safe: the main batch loop and an
    AsyncFlusher rescue worker (pipeline/overlap.py) may interleave
    write/write_block calls — a lock keeps each record chunk intact;
    cross-thread record ORDER is unspecified, which is fine for the
    SO:unsorted output contract. The single consumer thread still owns
    the underlying writer exclusively.
    """

    # per-record writes are batched before crossing the thread boundary:
    # a queue hand-off costs a context switch (~1ms+ when producer and
    # consumer share one core), so enqueuing single records serializes
    # the pipeline on the queue itself
    RECORD_CHUNK = 512

    def __init__(self, inner, depth: int = 16):
        self.inner = inner
        self.needs_seq = getattr(inner, "needs_seq", True)
        self.needs_tags = getattr(inner, "needs_tags", True)
        self.block_alternates = getattr(inner, "block_alternates", False)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []
        self._buf: list = []
        self._lock = threading.Lock()
        self._closed = False
        if hasattr(inner, "write_block"):
            self.write_block = self._make("write_block")
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="soap3dp-writer")
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            if self._err:
                continue  # drain + discard after first failure
            name, args, kw = item
            try:
                # serialization + file IO cost on the output thread (on a
                # single-core host this competes with the align loop)
                with timers.stage("io.write_worker"):
                    if name == "__records__":
                        for rec in args[0]:
                            self.inner.write(rec)
                    else:
                        getattr(self.inner, name)(*args, **kw)
            except BaseException as e:
                self._err.append(e)

    def poll(self) -> None:
        """Raise the worker's first failure now (e.g. ENOSPC) instead of
        at the next enqueue/close — callers check this once per batch so
        alignment work stops as soon as output is failing."""
        if self._err:
            raise self._err[0]

    def _put(self, name, args, kw):
        if self._err:
            raise self._err[0]
        try:
            self._q.put_nowait((name, args, kw))
        except queue.Full:
            with timers.wait("io.writer_put_wait"):
                self._q.put((name, args, kw))

    def _flush_buf(self):
        if self._buf:
            buf, self._buf = self._buf, []
            self._put("__records__", (buf,), {})

    def _make(self, name):
        def call(*args, **kw):
            with self._lock:
                self._flush_buf()  # keep record/block emission order
                self._put(name, args, kw)
        return call

    def write(self, rec):
        if self._err:
            raise self._err[0]
        with self._lock:
            self._buf.append(rec)
            if len(self._buf) >= self.RECORD_CHUNK:
                self._flush_buf()

    def close(self):
        """Write what is queued and close the writer; later calls do
        nothing."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            self._flush_buf()
        self._q.put(_SENTINEL)
        with timers.wait("io.writer_drain"):
            self._t.join()
        self.inner.close()
        if self._err:
            raise self._err[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
