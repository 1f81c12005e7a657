"""Affine-gap semi-global alignment scores, plain NumPy.

The scoring and the freedoms are the configuration's (soap3-dp.ini
``[DP]`` and ``[Clipping]``, the defaults the port runs): a match +1, a
mismatch -2, a gap of g bases ``open + (g - 1) * extend`` (-3, -1); the
read may skip up to ``clip`` bases at either end for nothing; the
window's ends are free. At its left end the read may also start with
an insertion right after its skipped bases. ``best_ends`` is the
optimum of each read over its own window and the window columns where
it ends; ``cigar_score`` scores one alignment as a SAM record states it.
"""

from __future__ import annotations

import re

import numpy as np

MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, -2, -3, -1
CLIP = 49
NEG = -(1 << 20)
_CIGAR = re.compile(rb"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: bytes) -> list[tuple[int, bytes]]:
    ops = [(int(n), op) for n, op in _CIGAR.findall(cigar)]
    if b"".join(b"%d%s" % (n, op) for n, op in ops) != cigar:
        raise ValueError(f"bad CIGAR {cigar!r}")
    return ops


def cigar_score(read: np.ndarray, ref: np.ndarray, ops) -> dict:
    """The alignment of ``read`` (genome orientation) at the start of
    ``ref`` under ``ops``: its score, mismatches, gap opens, gap
    extensions (bases past each gap's first), reference span and the
    read bases it covers."""
    qi = ri = 0
    score = mism = opens = exts = 0
    for n, op in ops:
        if op == b"M":
            same = read[qi:qi + n] == ref[ri:ri + n]
            if len(same) != n:
                raise ValueError("alignment runs past its reference")
            mism += int(n - same.sum())
            score += int(same.sum()) * MATCH + int(n - same.sum()) * MISMATCH
            qi += n
            ri += n
        elif op in (b"I", b"D"):
            opens += 1
            exts += n - 1
            score += GAP_OPEN + (n - 1) * GAP_EXT
            if op == b"I":
                qi += n
            else:
                ri += n
        elif op == b"S":
            qi += n
        else:
            raise ValueError(f"CIGAR op {op!r} not expected")
    return {"score": score, "mismatches": mism, "opens": opens,
            "extensions": exts, "ref_span": ri, "read_span": qi}


def best_ends(reads: np.ndarray, wins: np.ndarray, wlens: np.ndarray,
              clip: int = CLIP) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each read (P, L) against its window (P, W), of which the first
    wlens bases are real: (the optimum, the number of window columns
    where an alignment of that score ends, the first of them), each
    (P,). An alignment that ends at column j covers the window up to its
    base j - 1."""
    P, L = reads.shape
    W = wins.shape[1]
    cols = np.arange(W + 1)
    real = cols[None, 1:] <= wlens[:, None]
    win = np.where(real, wins, 255).astype(np.int16)
    H = np.zeros((P, W + 1), np.int32)        # row 0: the free start
    I = np.full((P, W + 1), NEG, np.int32)
    colbest = np.full((P, W + 1), NEG, np.int32)
    endable = (cols[None, :] >= 1) & (cols[None, :] <= wlens[:, None])
    for i in range(1, L + 1):
        fresh = i - 1 <= clip
        dist = np.where(win == reads[:, i - 1:i], MATCH, MISMATCH)
        diag = np.full((P, W + 1), NEG, np.int32)
        diag[:, 1:] = H[:, :-1] + dist
        if fresh:
            diag[:, 1:] = np.maximum(diag[:, 1:], dist)
        I = np.maximum(H + GAP_OPEN, I + GAP_EXT)
        if fresh:
            I = np.maximum(I, GAP_OPEN)
        Hp = np.maximum(diag, I)
        Hp[:, 0] = np.maximum(I[:, 0], NEG)
        # window gaps: D[j] = max over k < j of Hp[k] + open + (j-k-1) ext
        t = Hp - GAP_EXT * cols[None, :]
        run = np.maximum.accumulate(t, axis=1)
        D = np.full((P, W + 1), NEG, np.int32)
        D[:, 1:] = run[:, :-1] + GAP_OPEN + GAP_EXT * (cols[None, 1:] - 1)
        H = np.maximum(Hp, D)
        H = np.maximum(H, NEG)
        I = np.maximum(I, NEG)
        if i >= L - clip:
            colbest = np.maximum(colbest, np.where(endable, H, NEG))
    best = colbest.max(axis=1).astype(np.int64)
    at = colbest == best[:, None]
    return best, at.sum(axis=1), at.argmax(axis=1)
