"""DNA alphabet encoding utilities.

Conventions (shared by index builder, read loader and all kernels):

* 2-bit codes: A=0, C=1, G=2, T=3.
* Any non-ACGT character (N, IUPAC ambiguity codes, ...) is encoded as
  G (code 2). This matches the reference, which replaces invalid
  characters with G both in the genome (README.md section 2.1) and in
  reads via its char map (sample.cu:24-40).
* Packed layout: 16 bases per uint32 word, base j of a word occupying
  bits [2*j, 2*j+1] (LSB-first). The reference packs 2-bit DNA too
  (2bwt-lib HSP packed genome), but uses an MSB-first convention;
  LSB-first is chosen here because it turns base extraction into
  `(word >> (2*j)) & 3`, which vectorizes cleanly on the TPU VPU.
"""

from __future__ import annotations

import numpy as np

# 2-bit base codes.
A, C, G, T = 0, 1, 2, 3

BASES_PER_WORD = 16  # uint32 words hold 16 2-bit codes

# byte -> 2-bit code lookup (256 entries), invalid -> G (=2).
CHAR_TO_CODE = np.full(256, G, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T)):
    CHAR_TO_CODE[ord(_ch)] = _code
    CHAR_TO_CODE[ord(_ch.lower())] = _code

CODE_TO_CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)

# Mask of positions that hold a *valid* (ACGT) character, used to track
# ambiguity ("N") regions like the reference's .amb file.
IS_ACGT = np.zeros(256, dtype=bool)
for _ch in "ACGTacgt":
    IS_ACGT[ord(_ch)] = True


def encode(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII bytes -> 2-bit codes (uint8), non-ACGT -> G."""
    buf = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return CHAR_TO_CODE[buf]


def decode(codes: np.ndarray) -> bytes:
    """2-bit codes -> ASCII bytes."""
    return CODE_TO_CHAR[codes].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space: complement(x) == 3 - x."""
    return (3 - codes[..., ::-1]).astype(codes.dtype)


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack a 1-D uint8 code array into uint32 words, 16 codes/word, LSB-first.

    The tail word is zero-padded (padding bases read back as A; callers
    must mask by length).
    """
    n = codes.shape[0]
    n_words = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros(n_words * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    lanes = padded.reshape(n_words, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def unpack_words(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_codes: uint32 words -> first n 2-bit codes (uint8)."""
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    codes = (words[:, None] >> shifts) & np.uint32(3)
    return codes.reshape(-1)[:n].astype(np.uint8)
