"""BAM input: BGZF decompression + BAM v1 record decoding.

The analog of the reference's loadBAMReads (QueryParser.cpp:996-1355),
which uses the vendored samtools; here the container is decoded
natively (zlib), no samtools needed. Yields (name, seq_codes, qual)
tuples; paired input expects mates adjacent (the reference requires
name-adjacent mates in BAM too).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator

import numpy as np

# BAM 4-bit nybble -> 2-bit code (non-ACGT -> G=2, as everywhere)
_NYB_TO_CODE = np.full(16, 2, np.uint8)
_NYB_TO_CODE[1] = 0   # A
_NYB_TO_CODE[2] = 1   # C
_NYB_TO_CODE[4] = 2   # G
_NYB_TO_CODE[8] = 3   # T

FLAG_REVERSE = 0x10


def is_bam(path) -> bool:
    try:
        with open(path, "rb") as fh:
            head = fh.read(18)
    except OSError:
        return False
    if len(head) < 18 or head[:2] != b"\x1f\x8b":
        return False
    if not head[3] & 0x04:  # no FEXTRA -> plain gzip, not BGZF
        return False
    try:
        data = _bgzf_blocks_head(path, 4)
    except (ValueError, zlib.error, struct.error):
        return False
    return data[:4] == b"BAM\x01"


def _bgzf_blocks_head(path, need: int) -> bytes:
    out = b""
    for block in bgzf_blocks(path):
        out += block
        if len(out) >= need:
            break
    return out


def bgzf_blocks(path) -> Iterator[bytes]:
    """Yield decompressed BGZF blocks."""
    with open(path, "rb") as fh:
        while True:
            header = fh.read(18)
            if len(header) < 18:
                return
            if header[:2] != b"\x1f\x8b":
                raise ValueError(f"{path}: not BGZF")
            xlen = struct.unpack_from("<H", header, 10)[0]
            extra = header[12:18] + fh.read(xlen - 6)
            bsize = None
            off = 0
            while off + 4 <= len(extra):
                si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from(
                    "<H", extra, off + 2)[0]
                if si1 == 66 and si2 == 67:
                    bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
                off += 4 + slen
            if bsize is None:
                raise ValueError(f"{path}: missing BGZF BC subfield")
            # consumed so far: 12-byte fixed header + xlen extra bytes
            cdata = fh.read(bsize - 12 - xlen)
            payload = cdata[:-8]
            isize = struct.unpack_from("<I", cdata, len(cdata) - 4)[0]
            if isize == 0:
                continue
            yield zlib.decompress(payload, -15)


class _Stream:
    """Byte cursor over the concatenated BGZF payload."""

    def __init__(self, path):
        self._blocks = bgzf_blocks(path)
        self._buf = b""
        self._pos = 0

    def read(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n:
            nxt = next(self._blocks, None)
            if nxt is None:
                break
            self._buf = self._buf[self._pos:] + nxt
            self._pos = 0
        out = self._buf[self._pos:self._pos + n]
        self._pos += len(out)
        return out


def iter_bam_reads(path) -> Iterator[tuple[bytes, np.ndarray, bytes | None]]:
    """Yield (name, 2-bit codes forward-strand, qual phred+33 or None).

    Reverse-flagged records are reverse-complemented back to the
    original read orientation, as the reference does when re-aligning
    from BAM.
    """
    s = _Stream(path)
    magic = s.read(4)
    if magic != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    (l_text,) = struct.unpack("<i", s.read(4))
    s.read(l_text)
    (n_ref,) = struct.unpack("<i", s.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", s.read(4))
        s.read(l_name + 4)
    while True:
        raw = s.read(4)
        if len(raw) < 4:
            return
        (block_size,) = struct.unpack("<i", raw)
        rec = s.read(block_size)
        if len(rec) < block_size:
            return
        l_read_name = rec[8]
        n_cigar = struct.unpack_from("<H", rec, 12)[0]
        flag = struct.unpack_from("<H", rec, 14)[0]
        l_seq = struct.unpack_from("<i", rec, 16)[0]
        off = 32
        name = rec[off:off + l_read_name - 1]
        off += l_read_name + 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(rec, np.uint8, nbytes, off)
        off += nbytes
        qual = np.frombuffer(rec, np.uint8, l_seq, off)
        nybs = np.empty(2 * nbytes, np.uint8)
        nybs[0::2] = packed >> 4
        nybs[1::2] = packed & 0x0F
        codes = _NYB_TO_CODE[nybs[:l_seq]]
        q = None if l_seq == 0 or qual[0] == 0xFF else (qual + 33).tobytes()
        if flag & FLAG_REVERSE:
            codes = (3 - codes[::-1]).astype(np.uint8)
            q = q[::-1] if q is not None else None
        yield name, codes, q
