"""Embeddable in-memory alignment API of the PyTorch port (port of
soap3dp_tpu/api.py; the one change is ``load``'s ``device``).

The analog of the reference's module interface (soap3-dp-module.h:
57-73: alignPairR / alignSingleR return AlgnResultArrays instead of
writing files; param structs soap3-dp-module.h:24-52). The caller
supplies reads as arrays or sequences and gets alignment records back
as a structured list — no file I/O.

    from soap3dp_tpu_torch import api
    idx = api.load("hg.index")                  # device="cuda" by default
    results = api.align_single_r(idx, ["ACGT...", ...])
    results = api.align_pair_r(idx, reads1, reads2, min_insert=100,
                               max_insert=500)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from soap3dp_tpu_torch.index.builder import Index, load_index
from soap3dp_tpu_torch.io.fastq import ReadBatch
from soap3dp_tpu_torch.io.sam import SamRecord
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.utils import dna
from soap3dp_tpu_torch.fm.fmindex import DeviceIndex, device_index


@dataclasses.dataclass
class Alignment:
    """One alignment record (the occRec/AlgnResult analog,
    AlgnResult.h:92-160)."""

    read_id: int
    name: bytes
    chrom: str        # "" = unmapped
    pos: int          # 0-based
    strand: int       # 0 fwd, 1 rev
    flag: int
    mapq: int
    cigar: str
    tags: list[str]
    mate_chrom: str = ""
    mate_pos: int = -1
    tlen: int = 0

    @property
    def mapped(self) -> bool:
        return not self.flag & 0x4


@dataclasses.dataclass
class LoadedIndex:
    index: Index
    didx: DeviceIndex


def load(path: str, device: str = "cuda") -> LoadedIndex:
    """Load an index and upload it to ``device`` (INDEXLoad +
    GPUINDEXUpload analog). ``cuda`` raises when no CUDA device exists,
    as the CLI's --device does; pass ``cpu`` to run on the CPU."""
    from soap3dp_tpu_torch.cli.runner import resolve_device

    dev = resolve_device(device)
    index = load_index(path if str(path).endswith(".t3i") else str(path) + ".t3i")
    return LoadedIndex(index=index, didx=device_index(index, dev))


class _Collector:
    """Writer that keeps records in memory instead of serializing."""

    needs_seq = False
    needs_tags = True

    def __init__(self, index: Index):
        self.names = index.names
        self.records: list[SamRecord] = []

    def write(self, rec: SamRecord) -> None:
        self.records.append(rec)

    def close(self) -> None:
        pass


def _to_batch(reads, max_len: int | None = None) -> ReadBatch:
    """Accept a (B, L) uint8 code matrix + lens, or a list of
    str/bytes sequences."""
    if isinstance(reads, ReadBatch):
        return reads
    if isinstance(reads, tuple) and len(reads) == 2:
        codes, lens = reads
        codes = np.asarray(codes, np.uint8)
        lens = np.asarray(lens, np.int32)
        names = [b"read%d" % i for i in range(codes.shape[0])]
        return ReadBatch(names=names, codes=codes, lens=lens, quals=None)
    seqs = [s.encode() if isinstance(s, str) else bytes(s) for s in reads]
    L = max_len or max((len(s) for s in seqs), default=0)
    B = len(seqs)
    codes = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        c = dna.encode(s[:L])
        codes[i, : len(c)] = c
        lens[i] = len(c)
    names = [b"read%d" % i for i in range(B)]
    return ReadBatch(names=names, codes=codes, lens=lens, quals=None)


def _collect(index: Index, recs: list[SamRecord], names: list[bytes]
             ) -> list[Alignment]:
    by_name = {n: i for i, n in enumerate(names)}
    out = []
    for r in recs:
        out.append(Alignment(
            read_id=by_name.get(r.qname, -1), name=r.qname,
            chrom=index.names[r.chrom] if r.chrom >= 0 else "",
            pos=r.pos, strand=1 if r.flag & 0x10 else 0, flag=r.flag,
            mapq=r.mapq, cigar=r.cigar, tags=list(r.tags),
            mate_chrom=index.names[r.mate_chrom] if r.mate_chrom >= 0 else "",
            mate_pos=r.mate_pos, tlen=r.tlen))
    return out


def align_single_r(loaded: LoadedIndex, reads, **options) -> list[Alignment]:
    """Align single-end reads, returning in-memory records
    (alignSingleR analog)."""
    from soap3dp_tpu_torch.pipeline.single import align_single_batch

    batch = _to_batch(reads)
    opts = AlignOptions(**options)
    coll = _Collector(loaded.index)
    align_single_batch(loaded.index, loaded.didx, batch, opts, coll)
    return _collect(loaded.index, coll.records, batch.names)


def align_pair_r(loaded: LoadedIndex, reads1, reads2, **options
                 ) -> list[Alignment]:
    """Align read pairs, returning in-memory records (alignPairR analog)."""
    from soap3dp_tpu_torch.pipeline.pair import align_pair_batch

    b1 = _to_batch(reads1)
    b2 = _to_batch(reads2)
    opts = AlignOptions(**options)
    coll = _Collector(loaded.index)
    align_pair_batch(loaded.index, loaded.didx, b1, b2, opts, coll)
    return _collect(loaded.index, coll.records, b1.names)
