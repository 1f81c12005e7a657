"""FASTA -> packed genome with annotation and ambiguity tables.

Mirrors the semantics of the reference's HSP packed genome
(2bwt-lib/HSP.c, HSPParseFASTAToPacked):

* all chromosomes are concatenated into one coordinate space,
* non-ACGT characters are replaced by G (README.md section 2.1),
* runs of invalid characters are recorded as ambiguity regions; the
  reference excludes regions with more than 10 invalid characters from
  alignment (README.md section 2.1) — we record every run and filter
  hits that overlap runs longer than `AMBIGUITY_EXCLUDE_THRESHOLD`,
* per-chromosome (name, offset, length) annotation is kept for
  translating absolute positions to SAM coordinates (the reference's
  .ann/.tra files).

Restrictions inherited from the reference: at most 65,000 sequences
and 4 Gbp total (32-bit position space), README.md section 2.1.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os

import numpy as np

from soap3dp_tpu_torch.utils import dna

AMBIGUITY_EXCLUDE_THRESHOLD = 10  # README.md section 2.1
MAX_SEQUENCES = 65000
MAX_TOTAL_LENGTH = 4_000_000_000


@dataclasses.dataclass
class PackedGenome:
    """Concatenated 2-bit packed genome plus coordinate metadata."""

    codes: np.ndarray        # (n,) uint8, 2-bit codes (kept for building; large)
    pac: np.ndarray          # (ceil(n/16),) uint32 packed words
    length: int              # n
    names: list[str]         # chromosome names (first word of FASTA header)
    offsets: np.ndarray      # (num_chrom + 1,) uint64: start of each chrom, end sentinel
    amb_starts: np.ndarray   # (num_amb,) uint64: start of each invalid-char run
    amb_lengths: np.ndarray  # (num_amb,) uint64

    @property
    def num_chromosomes(self) -> int:
        return len(self.names)

    def chrom_of(self, pos: np.ndarray) -> np.ndarray:
        """Absolute position -> chromosome id (int32)."""
        return (np.searchsorted(self.offsets, pos, side="right") - 1).astype(np.int32)

    def excluded_region_mask(self) -> tuple[np.ndarray, np.ndarray]:
        """(starts, ends) of ambiguity runs long enough to be excluded."""
        keep = self.amb_lengths > AMBIGUITY_EXCLUDE_THRESHOLD
        starts = self.amb_starts[keep]
        return starts, starts + self.amb_lengths[keep]


def _open_maybe_gzip(path: str | os.PathLike) -> io.BufferedReader:
    raw = open(path, "rb")
    magic = raw.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return gzip.open(raw)  # type: ignore[return-value]
    return raw


def pack_fasta(path: str | os.PathLike) -> PackedGenome:
    """Parse a (possibly gzipped) multi-FASTA file into a PackedGenome."""
    names: list[str] = []
    chunks: list[np.ndarray] = []
    valid_chunks: list[np.ndarray] = []
    offsets = [0]
    total = 0
    with _open_maybe_gzip(path) as fh:
        data = fh.read()
    # Split on '>' headers. Vectorized: find header line spans.
    if not data.startswith(b">"):
        raise ValueError(f"{path}: not a FASTA file")
    records = data.split(b">")[1:]
    if len(records) > MAX_SEQUENCES:
        raise ValueError(f"too many sequences ({len(records)} > {MAX_SEQUENCES})")
    for rec in records:
        nl = rec.find(b"\n")
        header = rec[:nl].split()
        names.append(header[0].decode() if header else f"seq{len(names)}")
        body = rec[nl + 1:].translate(None, b"\r\n \t")
        arr = np.frombuffer(body, dtype=np.uint8)
        chunks.append(dna.CHAR_TO_CODE[arr])
        valid_chunks.append(dna.IS_ACGT[arr])
        total += arr.shape[0]
        offsets.append(total)
    if total > MAX_TOTAL_LENGTH:
        raise ValueError(f"genome too large ({total} > {MAX_TOTAL_LENGTH})")
    codes = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
    valid = np.concatenate(valid_chunks) if valid_chunks else np.zeros(0, dtype=bool)

    # Ambiguity runs: maximal runs of invalid characters.
    amb_starts, amb_lengths = _runs_of(~valid)

    return PackedGenome(
        codes=codes,
        pac=dna.pack_codes(codes),
        length=total,
        names=names,
        offsets=np.asarray(offsets, dtype=np.uint64),
        amb_starts=amb_starts,
        amb_lengths=amb_lengths,
    )


def _runs_of(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Start/length of each maximal run of True values in a bool array."""
    if mask.size == 0 or not mask.any():
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    padded = np.concatenate(([False], mask, [False]))
    diff = np.diff(padded.astype(np.int8))
    starts = np.flatnonzero(diff == 1)
    ends = np.flatnonzero(diff == -1)
    return starts.astype(np.uint64), (ends - starts).astype(np.uint64)
