"""SAM output: header, flags, records, tags.

Replaces the reference's samtools-backed SAM/BAM emission
(SAMOutputHeaderConstruct, SAM.cpp:82-140; record assembly + tags
BGS-IO.cpp:2131-2273). Same header shape (@HD VN:1.3 SO:unsorted, @RG,
@SQ per sequence, @PG) and the same optional-tag vocabulary:

  X0 (#best hits), X1 (#suboptimal hits), XM/XO/XG (mismatch / gap-open
  / gap-extend counts), XA:Z (alternative hits "chr,(+|-)pos,CIGAR,NM;"),
  and MD:Z + NM:i when the -p option is on.

Records are plain SAM text; BAM output is produced by piping through
the bgzf writer in soap3dp_tpu_torch.io.succinct (round-tripping via text).
"""

from __future__ import annotations

import dataclasses
import io
import os
from typing import Sequence

import numpy as np

from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.io.ragged import flatten_bytes, offsets_of, scatter_idx
from soap3dp_tpu_torch.utils import dna
from soap3dp_tpu_torch.version import __version__

# SAM flag bits
FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80

COMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def revcomp_ascii(seq: bytes) -> bytes:
    return seq.translate(COMP)[::-1]


@dataclasses.dataclass
class SamRecord:
    qname: bytes
    flag: int
    chrom: int          # chromosome id, -1 = unmapped
    pos: int            # 0-based within chromosome
    mapq: int
    cigar: str          # "" = *
    seq: bytes          # forward-strand read sequence (ASCII)
    qual: bytes | None
    mate_chrom: int = -1
    mate_pos: int = 0
    tlen: int = 0
    tags: list[str] = dataclasses.field(default_factory=list)


def _gather_pair(seq_codes, quals, seq_src):
    """Materialize the seq_src form into (N, L) matrices: row i comes
    from mate1[src] when seq_src[i] >= 0 else mate2[~src]. A bare
    matrix (the single-source SE form) acts as mate1 with no mate2."""
    if not isinstance(seq_codes, tuple):
        seq_codes = (seq_codes, np.zeros((0, 1), np.uint8))
        if quals is not None:
            quals = (quals, np.zeros((0, 1), np.uint8))
    m1, m2 = (np.asarray(m, np.uint8) for m in seq_codes)
    src = np.asarray(seq_src, np.int64)
    L = max(m1.shape[1], m2.shape[1])
    out = np.zeros((len(src), L), np.uint8)
    one = src >= 0
    out[one, :m1.shape[1]] = m1[src[one]]
    out[~one, :m2.shape[1]] = m2[~src[~one]]
    if quals is None:
        return out, None
    q1, q2 = (np.asarray(m, np.uint8) for m in quals)
    qo = np.zeros((len(src), L), np.uint8)
    qo[one, :q1.shape[1]] = q1[src[one]]
    qo[~one, :q2.shape[1]] = q2[~src[~one]]
    return out, qo


class SamWriter:
    """Streaming SAM text writer."""

    # write_block takes xa, each record's XA alternates as a column;
    # emitters keep a writer without it on the per-record path
    block_alternates = True

    def __init__(self, out, index: Index, read_group: str = "default",
                 sample: str = "default", rg_option: str = ""):
        self._own = isinstance(out, (str, os.PathLike))
        self._fh = open(out, "wb") if self._own else out
        # SAM text is the biggest output stream (~560B/record); on a
        # 1-core host the kernel's dirty-page throttling otherwise
        # stalls the writer thread at unpredictable points. Every
        # _ADVISE_CHUNK bytes the already-written range is handed to
        # writeback and dropped from the page cache (the reference
        # leans on 3 output pthreads instead, alignment.cu:1005-1027).
        self._advise_from = 0
        self._written = 0
        self._can_advise = self._own and hasattr(os, "posix_fadvise")
        self.index = index
        self.names = [n.encode() for n in index.names]
        # chrom-name table for the native columnar formatter
        self._rname_off = np.zeros(len(self.names) + 1, np.int64)
        np.cumsum([len(n) for n in self.names], out=self._rname_off[1:])
        self._rname_buf = np.frombuffer(b"".join(self.names), np.uint8) \
            if self.names else np.zeros(0, np.uint8)
        lens = np.diff(index.offsets).astype(np.int64)
        header = [b"@HD\tVN:1.3\tSO:unsorted"]
        rg = f"@RG\tID:{read_group}\tSM:{sample}"
        if rg_option:
            rg += "\t" + rg_option
        header.append(rg.encode())
        for name, ln in zip(self.names, lens):
            header.append(b"@SQ\tSN:" + name + f"\tLN:{ln}".encode())
        header.append(f"@PG\tID:soap3dp-tpu\tPN:soap3dp-tpu\tVN:{__version__}".encode())
        self._fh.write(b"\n".join(header) + b"\n")

    _ADVISE_CHUNK = 64 << 20

    def _advance(self, nbytes: int) -> None:
        if not self._can_advise:
            return
        self._written += nbytes
        if self._written - self._advise_from >= self._ADVISE_CHUNK:
            try:
                self._fh.flush()
                os.posix_fadvise(self._fh.fileno(), self._advise_from,
                                 self._written - self._advise_from,
                                 os.POSIX_FADV_DONTNEED)
            except OSError:
                self._can_advise = False
            self._advise_from = self._written

    def write(self, rec: SamRecord) -> None:
        rname = self.names[rec.chrom] if rec.chrom >= 0 else b"*"
        if rec.mate_chrom < 0:
            rnext, pnext = b"*", 0
        elif rec.mate_chrom == rec.chrom:
            rnext, pnext = b"=", rec.mate_pos + 1
        else:
            rnext, pnext = self.names[rec.mate_chrom], rec.mate_pos + 1
        if rec.flag & FLAG_REVERSE and not rec.flag & FLAG_UNMAPPED:
            seq = revcomp_ascii(rec.seq)
            qual = rec.qual[::-1] if rec.qual else b"*"
        else:
            seq = rec.seq
            qual = rec.qual if rec.qual else b"*"
        fields = [
            rec.qname,
            str(rec.flag).encode(),
            rname,
            str(rec.pos + 1 if rec.chrom >= 0 else 0).encode(),
            str(rec.mapq).encode(),
            rec.cigar.encode() if rec.cigar else b"*",
            rnext,
            str(pnext).encode(),
            str(rec.tlen).encode(),
            seq,
            qual,
        ]
        fields.extend(t.encode() for t in rec.tags)
        rec_bytes = b"\t".join(fields) + b"\n"
        self._fh.write(rec_bytes)
        self._advance(len(rec_bytes))

    def write_block(self, names, flags, chroms, poss, mapqs, cigars, nms, *,
                    mate_chroms=None, mate_poss=None, tlens=None,
                    seq_codes=None, seq_lens=None, quals=None,
                    tags=None, seq_src=None, xa=None) -> None:
        """Columnar bulk write of N gapless records (the SAM-text analog
        of the succinct block writer; the reference buffers via its OCC
        cache, OCCFlushCacheSAMAPI): every field is assembled with
        vectorized numpy scatters, no per-record Python.

        seq_codes is a (N, L) FORWARD 2-bit code matrix; reverse-flagged
        records are reverse-complemented in bulk. tags = (x0, x1, xm)
        arrays for the standard X0/X1/XM/XO/XG block. nms is accepted
        for writer-protocol compatibility (NM is only emitted by the
        -p slow path).

        Hot-path forms (VERDICT r3 #4): cigars=None emits gapless
        "<seq_len>M"; seq_codes/quals may be (mate1, mate2) matrix
        pairs with seq_src per-record row indices (src >= 0 ->
        mate1[src], src < 0 -> mate2[~src]) so PE emitters skip the
        (2N, L) interleave copy.

        xa = (off, chrom, strand, pos, nm) gives the records' XA:Z
        alternates as a CSR group: record i's are entries off[i] ..
        off[i+1] - 1, written after the X0..XG block in sam.xa_entry's
        form with "<seq_len>M" as their cigar; a record with none gets
        no XA tag.
        """
        N = len(names)
        if N == 0:
            return
        del nms
        flags = np.asarray(flags, np.int64)
        chroms = np.asarray(chroms, np.int64)
        poss = np.asarray(poss, np.int64)

        from soap3dp_tpu_torch.io import sam_native
        if sam_native.available():
            from soap3dp_tpu_torch.utils import timers
            with timers.stage("io.sam.format"):
                text = sam_native.format_block(
                    names, flags, self._rname_buf, self._rname_off, chroms,
                    poss, mapqs, cigars, mate_chroms, mate_poss, tlens,
                    seq_codes, seq_lens, quals, tags, seq_src=seq_src,
                    xa=xa)
            if text is not None:
                with timers.stage("io.sam.fwrite"):
                    self._fh.write(text)
                    self._advance(len(text))
                return

        # numpy fallback: materialize the hot-path forms first
        if seq_codes is not None and seq_src is not None:
            seq_codes, quals = _gather_pair(seq_codes, quals, seq_src)
        if cigars is None:
            cigars = np.char.add(
                np.asarray(seq_lens).astype("S11"), b"M")

        def dec(a):
            return np.char.mod(b"%d", np.asarray(a))

        # each line is assembled as ONE fixed-width 'S' array via a
        # np.char.add chain, then compacted with a single ragged copy
        # (scattering per column measured 30x slower at 200k records)
        name_tab = np.array(self.names)
        tab = b"\t"

        def sarr(x):
            a = np.asarray(x)
            return a if a.dtype.kind == "S" else np.array(list(x))

        parts = [sarr(names), tab, dec(flags), tab,
                 name_tab[np.maximum(chroms, 0)], tab, dec(poss + 1), tab,
                 dec(np.asarray(mapqs)), tab, sarr(cigars)]
        if mate_chroms is None:
            parts.append(b"\t*\t0\t0\t")
        else:
            mate_chroms = np.asarray(mate_chroms, np.int64)
            rnext = np.where(mate_chroms < 0, b"*",
                             np.where(mate_chroms == chroms, b"=",
                                      name_tab[np.maximum(mate_chroms, 0)]))
            parts += [tab, rnext.astype("S"), tab,
                      dec(np.where(mate_chroms < 0, 0,
                                   np.asarray(mate_poss, np.int64) + 1)),
                      tab, dec(np.asarray(tlens, np.int64)), tab]
        # SEQ/QUAL, bulk reverse-complemented where FLAG_REVERSE;
        # zero-padded tails act as the 'S' terminator
        if seq_codes is None:
            parts.append(b"*\t*")
        else:
            seq_codes = np.asarray(seq_codes)
            L = seq_codes.shape[1]
            lens_a = np.asarray(seq_lens, np.int64)
            rev = ((flags & FLAG_REVERSE) != 0)[:, None]
            i = np.arange(L, dtype=np.int64)[None, :]
            in_read = i < lens_a[:, None]
            if (lens_a == L).all():
                src = None
                oc = np.where(rev, seq_codes[:, ::-1], seq_codes)
            else:
                src = np.where(rev, np.clip(lens_a[:, None] - 1 - i, 0, L - 1), i)
                oc = np.take_along_axis(seq_codes, src, axis=1)
            oc = np.where(rev, 3 - oc, oc)
            ascii_m = np.where(in_read, dna.CODE_TO_CHAR[oc], 0)
            parts += [ascii_m.view(f"S{L}")[:, 0], tab]
            if quals is None:
                parts.append(b"*")
            else:
                q = np.asarray(quals)
                qm = np.where(rev, q[:, ::-1], q) if src is None else \
                    np.take_along_axis(q, src, axis=1)
                parts.append(np.where(in_read, qm, 0).view(f"S{L}")[:, 0])
        if tags is not None:
            x0, x1, xm = (np.asarray(t) for t in tags)
            parts += [b"\tX0:i:", dec(x0), b"\tX1:i:", dec(x1),
                      b"\tXM:i:", dec(xm), b"\tXO:i:0\tXG:i:0"]
        if xa is None:
            parts.append(b"\n")

        line = parts[0]
        for p in parts[1:]:
            line = np.char.add(line, p)
        ln, flat = flatten_bytes(line)
        if xa is not None:
            flat, ln = self._append_xa(flat, ln, xa, seq_lens, name_tab)
        data = flat.tobytes()
        self._fh.write(data)
        self._advance(len(data))

    @staticmethod
    def _append_xa(flat, ln, xa, seq_lens, name_tab):
        """(flat, ln) of ragged lines with each one's XA tag and the
        newline appended: the numpy form of the C formatter's."""
        off, chrom, strand, pos, nm = (np.asarray(a, np.int64) for a in xa)
        cnt = np.diff(off)
        rec = np.repeat(np.arange(len(ln)), cnt)
        ent = name_tab[chrom]
        for p in (b",", np.where(strand != 0, b"-", b"+"),
                  np.char.mod(b"%d", pos + 1), b",",
                  np.char.mod(b"%d", np.asarray(seq_lens, np.int64)[rec]),
                  b"M,", np.char.mod(b"%d", nm), b";"):
            ent = np.char.add(ent, p)
        eln, ebuf = flatten_bytes(ent)
        eoff = offsets_of(eln)
        xln = eoff[off[1:]] - eoff[off[:-1]]
        head = 6 * (cnt > 0)
        out_ln = ln + head + xln + 1
        start = offsets_of(out_ln)[:-1]
        out = np.empty(int(out_ln.sum()), np.uint8)
        out[scatter_idx(start, ln)] = flat
        out[scatter_idx(start + ln, head)] = np.tile(
            np.frombuffer(b"\tXA:Z:", np.uint8), int((cnt > 0).sum()))
        out[scatter_idx(start + ln + head, xln)] = \
            ebuf[eoff[off[0]]:eoff[off[-1]]]
        out[start + out_ln - 1] = ord("\n")
        return out, out_ln

    def close(self) -> None:
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def translate_pos(index: Index, tp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Absolute text position -> (chrom id, 0-based offset)."""
    tp = np.asarray(tp, dtype=np.uint64)
    chrom = (np.searchsorted(index.offsets, tp, side="right") - 1).astype(np.int32)
    off = (tp - index.offsets[np.maximum(chrom, 0)]).astype(np.int64)
    return chrom, off


def crosses_boundary(index: Index, tp: np.ndarray, length: np.ndarray) -> np.ndarray:
    """True where [tp, tp+length) spans a chromosome boundary or an
    excluded ambiguity region (README.md section 2.1: regions with more
    than 10 invalid characters are not aligned against)."""
    tp = np.asarray(tp, dtype=np.uint64)
    end = tp + np.asarray(length, dtype=np.uint64) - 1
    c1 = np.searchsorted(index.offsets, tp, side="right")
    c2 = np.searchsorted(index.offsets, end, side="right")
    bad = c1 != c2
    if len(index.amb_starts):
        # overlap if tp <= amb_end-1 and end >= amb_start
        i1 = np.searchsorted(index.amb_ends, tp, side="right")
        i2 = np.searchsorted(index.amb_starts, end, side="right")
        bad |= i2 > i1
    return bad


def mismatch_md(index: Index, tp: int, read_codes: np.ndarray) -> tuple[str, int]:
    """MD string + NM for a gapless alignment at absolute position tp."""
    L = len(read_codes)
    w0, w1 = int(tp) // 16, (int(tp) + L + 15) // 16
    gcodes = dna.unpack_words(np.asarray(index.pac[w0:w1 + 1]),
                              (w1 + 1 - w0) * 16)[int(tp) % 16:][:L]
    mism = np.flatnonzero(gcodes != read_codes)
    md = []
    last = 0
    for p in mism:
        md.append(str(p - last))
        md.append(chr(dna.CODE_TO_CHAR[gcodes[p]]))
        last = p + 1
    md.append(str(L - last))
    return "".join(md), len(mism)


def xa_entry(chrom_name: bytes, strand: int, pos: int, cigar: str, nm: int) -> str:
    """One XA:Z alternative-hit entry."""
    return f"{chrom_name.decode()},{'-' if strand else '+'}{pos + 1},{cigar},{nm};"
