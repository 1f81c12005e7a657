"""Per-record helpers of the single-end pipeline that the paired-end
pipeline uses (port of the matching functions of
soap3dp_tpu/pipeline/single.py). The single-end pipeline itself is not
ported yet."""

from __future__ import annotations

import numpy as np

from soap3dp_tpu.index.builder import Index
from soap3dp_tpu.io.fastq import ReadBatch
from soap3dp_tpu.utils import dna


def _qual_bytes(batch: ReadBatch, b: int, writer=None) -> bytes | None:
    """Raw qualities — skipped when the output format ignores them."""
    if writer is not None and not getattr(writer, "needs_seq", True):
        return None
    if batch.quals is None:
        return None
    return batch.quals[b, : batch.lens[b]].tobytes()


def _seq_bytes(batch: ReadBatch, b: int, writer=None) -> bytes:
    if writer is not None and not getattr(writer, "needs_seq", True):
        return b"*"
    return dna.decode(batch.codes[b, : batch.lens[b]])


def _genome_codes(index: Index, start: int, length: int) -> np.ndarray:
    w0, w1 = start // 16, (start + length + 15) // 16
    return dna.unpack_words(np.asarray(index.pac[w0:w1 + 1]),
                            (w1 + 1 - w0) * 16)[start % 16:][:length]
