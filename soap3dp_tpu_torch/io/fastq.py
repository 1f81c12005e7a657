"""Read input: FASTA/FASTQ (plain or gzip), single or paired, batched.

The analog of the reference's QueryParser (loadSingleReadsGz /
loadPairReadsGz2, QueryParser.cpp:27-995) and AIO double-buffer reader
(aio_thread.h:42-156). Format auto-detection works the same way: first
byte '>' = FASTA, '@' = FASTQ; gzip by magic number. Reads are packed
into rectangular (B, max_len) uint8 code matrices with vectorized
numpy (no per-read Python loop), the layout every device stage
consumes. Like the reference, non-ACGT read characters become G
(charmap, sample.cu:24-40); reads longer than max_len are truncated
(the reference errors instead — we clip and warn once).

Paired input follows the reference convention: two files read in
lockstep, or one interleaved/BAM-style stream with mates adjacent.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
import sys
from typing import Iterator

import numpy as np

from soap3dp_tpu_torch.utils import dna


@dataclasses.dataclass
class ReadBatch:
    names: np.ndarray    # (B,) 'S' fixed-width bytes (list[bytes] accepted)
    codes: np.ndarray    # (B, max_len) uint8 2-bit codes, zero-padded
    lens: np.ndarray     # (B,) int32
    quals: np.ndarray | None  # (B, max_len) uint8 raw phred+33 bytes, or None

    def __len__(self) -> int:
        return self.codes.shape[0]

    def seal(self) -> "ReadBatch":
        """Mark the code/qual matrices read-only. The PE/SE fast paths
        hand these matrices to AsyncWriter uncopied (two-source
        seq_codes), so in-place mutation after ingest would race the
        writer thread; sealing turns that bug class into an error."""
        for a in (self.codes, self.quals):
            if a is not None and a.flags.owndata:
                a.flags.writeable = False
        return self

    def take(self, ids) -> "ReadBatch":
        """Row subset (fancy index or slice), names coerced to array."""
        return ReadBatch(names=np.asarray(self.names)[ids],
                         codes=self.codes[ids], lens=self.lens[ids],
                         quals=None if self.quals is None
                         else self.quals[ids])


def _open(path):
    raw = open(path, "rb")
    if raw.peek(2)[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.open(raw))  # type: ignore[arg-type]
    return raw


def _pack_rect(seqs: list[bytes], max_len: int, warn_state: dict) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized list-of-bytes -> (B, max_len) uint8 matrix + lens."""
    B = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    if lens.size and lens.max() > max_len:
        if not warn_state.get("truncated"):
            print(f"[soap3dp] warning: reads longer than {max_len} bp truncated",
                  file=sys.stderr)
            warn_state["truncated"] = True
        seqs = [s[:max_len] for s in seqs]
        lens = np.minimum(lens, max_len)
    cat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    mat = np.zeros((B, max_len), dtype=np.uint8)
    mask = np.arange(max_len)[None, :] < lens[:, None]
    mat[mask] = cat
    return mat, lens


def _iter_records(path) -> Iterator[tuple[bytes, bytes, bytes | None]]:
    """Yield (name, seq, qual|None) from FASTA or FASTQ."""
    with _open(path) as fh:
        first = fh.peek(1)[:1]
        if first == b">":
            name, parts = None, []
            for line in fh:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(parts), None
                    name = line[1:].split()[0] if len(line) > 1 else b"read"
                    parts = []
                else:
                    parts.append(line)
            if name is not None:
                yield name, b"".join(parts), None
        elif first == b"@":
            while True:
                hdr = fh.readline()
                if not hdr:
                    break
                seq = fh.readline().rstrip(b"\r\n")
                fh.readline()  # '+'
                qual = fh.readline().rstrip(b"\r\n")
                name = hdr[1:].rstrip(b"\r\n").split()[0] if len(hdr) > 1 else b"read"
                yield name, seq, qual
        elif not first:
            return
        else:
            raise ValueError(f"{path}: not FASTA or FASTQ")


def _batchify(records, batch_size: int, max_len: int) -> Iterator[ReadBatch]:
    warn_state: dict = {}
    names: list[bytes] = []
    seqs: list[bytes] = []
    quals: list[bytes] = []
    has_qual = True
    for name, seq, qual in records:
        names.append(name)
        seqs.append(seq)
        if qual is None:
            has_qual = False
        else:
            quals.append(qual)
        if len(names) == batch_size:
            yield _make_batch(names, seqs, quals if has_qual else None, max_len, warn_state)
            names, seqs, quals = [], [], []
    if names:
        yield _make_batch(names, seqs, quals if has_qual else None, max_len, warn_state)


def _make_batch(names, seqs, quals, max_len, warn_state) -> ReadBatch:
    raw, lens = _pack_rect(seqs, max_len, warn_state)
    codes = dna.CHAR_TO_CODE[raw]
    codes[raw == 0] = 0  # padding stays 0 (== A, masked by lens everywhere)
    qmat = None
    if quals is not None:
        qmat, _ = _pack_rect(quals, max_len, warn_state)
    return ReadBatch(names=np.array(names, dtype="S"), codes=codes,
                     lens=lens, quals=qmat).seal()


def _batchify_precoded(records, batch_size: int, max_len: int
                       ) -> Iterator[ReadBatch]:
    """Batch (name, codes, qual) records that are already 2-bit coded
    (the BAM input path)."""
    names: list[bytes] = []
    rows: list[np.ndarray] = []
    quals: list[bytes] = []
    has_qual = True

    def flush():
        B = len(names)
        codes = np.zeros((B, max_len), np.uint8)
        lens = np.zeros(B, np.int32)
        for i, r in enumerate(rows):
            L = min(len(r), max_len)
            codes[i, :L] = r[:L]
            lens[i] = L
        qm = None
        if has_qual and quals:
            qm = np.zeros((B, max_len), np.uint8)
            for i, q in enumerate(quals):
                L = min(len(q), max_len)
                qm[i, :L] = np.frombuffer(q[:L], np.uint8)
        return ReadBatch(names=np.array(names, dtype="S"), codes=codes,
                         lens=lens, quals=qm).seal()

    for name, codes, qual in records:
        names.append(name)
        rows.append(codes)
        if qual is None:
            has_qual = False
        else:
            quals.append(qual)
        if len(names) == batch_size:
            yield flush()
            names, rows, quals = [], [], []
    if names:
        yield flush()


def _use_native(path) -> bool:
    if os.environ.get("SOAP3DP_NO_NATIVE"):
        return False
    if not isinstance(path, (str, os.PathLike)):
        return False
    from soap3dp_tpu_torch.io import fastq_native

    return fastq_native.available()


def _native_batches(path, batch_size, max_len) -> Iterator[ReadBatch]:
    from soap3dp_tpu_torch.io.fastq_native import NativeReader

    rd = NativeReader(os.fspath(path), batch_size, max_len)
    try:
        while True:
            got = rd.next_batch()
            if got is None:
                return
            names, codes, lens, quals = got
            yield ReadBatch(names=names, codes=codes, lens=lens,
                            quals=quals).seal()
    finally:
        rd.close()


def read_single(path, batch_size: int = 1 << 17, max_len: int = 128) -> Iterator[ReadBatch]:
    """Batches of single-end reads (native C++ parser when available,
    the analog of the reference's QueryParser). BAM input is decoded
    natively (loadBAMReads analog, QueryParser.cpp:996)."""
    from soap3dp_tpu_torch.io import bamread

    if isinstance(path, (str, os.PathLike)) and bamread.is_bam(path):
        yield from _batchify_precoded(bamread.iter_bam_reads(path),
                                      batch_size, max_len)
        return
    if _use_native(path):
        yield from _native_batches(path, batch_size, max_len)
        return
    yield from _batchify(_iter_records(path), batch_size, max_len)


def read_pairs(path1, path2=None, batch_size: int = 1 << 16, max_len: int = 128
               ) -> Iterator[tuple[ReadBatch, ReadBatch]]:
    """Batches of read pairs: two files in lockstep, or one interleaved
    file (FASTA/FASTQ/gzip/BAM; BAM mates must be adjacent)."""
    from soap3dp_tpu_torch.io import bamread

    if (path2 is None and isinstance(path1, (str, os.PathLike))
            and bamread.is_bam(path1)):
        single = _batchify_precoded(bamread.iter_bam_reads(path1),
                                    2 * batch_size, max_len)
        for b in single:
            if len(b) % 2:
                raise ValueError("interleaved BAM has an odd number of reads")
            sel1 = np.arange(0, len(b), 2)
            sel2 = sel1 + 1
            nm = np.asarray(b.names)
            yield (ReadBatch(nm[sel1], b.codes[sel1],
                             b.lens[sel1],
                             b.quals[sel1] if b.quals is not None else None),
                   ReadBatch(nm[sel2], b.codes[sel2],
                             b.lens[sel2],
                             b.quals[sel2] if b.quals is not None else None))
        return
    if path2 is not None:
        if _use_native(path1) and _use_native(path2):
            it1 = _native_batches(path1, batch_size, max_len)
            it2 = _native_batches(path2, batch_size, max_len)
        else:
            it1 = _batchify(_iter_records(path1), batch_size, max_len)
            it2 = _batchify(_iter_records(path2), batch_size, max_len)
        for b1, b2 in zip(it1, it2):
            if len(b1) != len(b2):
                raise ValueError("paired read files have different lengths")
            yield b1, b2
    else:
        def deinterleave():
            it = _iter_records(path1)
            while True:
                r1 = next(it, None)
                if r1 is None:
                    return
                r2 = next(it, None)
                if r2 is None:
                    raise ValueError("interleaved file has an odd number of reads")
                yield r1, r2
        pend: list = []
        for r1, r2 in deinterleave():
            pend.append((r1, r2))
            if len(pend) == batch_size:
                yield _pair_batch(pend, max_len)
                pend = []
        if pend:
            yield _pair_batch(pend, max_len)


def _pair_batch(pairs, max_len) -> tuple[ReadBatch, ReadBatch]:
    ws: dict = {}
    out = []
    for side in (0, 1):
        names = [p[side][0] for p in pairs]
        seqs = [p[side][1] for p in pairs]
        quals = [p[side][2] for p in pairs]
        hq = all(q is not None for q in quals)
        out.append(_make_batch(names, seqs, quals if hq else None, max_len, ws))
    return out[0], out[1]
