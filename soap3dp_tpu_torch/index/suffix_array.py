"""Suffix array construction.

The reference builds its BWT with an incremental blockwise algorithm
(2bwt-lib/BWTConstruct.c:113, BWTIncConstructFromPacked) driven by the
Larsson-Sadakane qsufsort (2bwt-lib/QSufSort.c:53). We instead build a
plain suffix array and derive the BWT from it, because on the rebuild
the index is an offline artifact and the aligner consumes flat arrays.

This module provides a vectorized prefix-doubling (Manber-Myers)
construction in numpy — O(n log^2 n) but with O(n)-sized vector ops
only, which is adequate for bacterial-scale genomes and for tests.
Whole-human-scale construction is delegated to the optional C++ SA-IS
extension in csrc/host/ (see soap3dp_tpu_torch.index.sais_native), with this
implementation as the portable fallback and correctness oracle.

Convention: the returned suffix array is over T + '$' (sentinel
smaller than every base), so it has n+1 entries and SA[0] == n.
"""

from __future__ import annotations

import numpy as np


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes + sentinel. Returns uint32 array of length n+1.

    Uses the native SA-IS extension when available (O(n), built from
    csrc/host/sais.cpp on first use); falls back to numpy prefix doubling.
    """
    n = int(codes.shape[0])
    if n == 0:
        return np.zeros(1, dtype=np.uint32)
    if n >= 1 << 14:  # native path worth the call overhead
        from soap3dp_tpu_torch.index import sais_native
        sa = sais_native.suffix_array_sais(codes)
        if sa is not None:
            return sa
    # rank[i] = rank of suffix i's current-depth prefix; sentinel gets 0.
    rank = np.zeros(n + 1, dtype=np.int64)
    rank[:n] = codes.astype(np.int64) + 1
    k = 1
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    rank = _rerank(sa, rank, np.zeros(n + 1, dtype=np.int64))
    while rank[sa[-1]] != n:
        second = np.zeros(n + 1, dtype=np.int64)
        second[: n + 1 - k] = rank[k:]
        # Single combined key: safe because ranks are < n+1 <= 2^32 and
        # (n+2)^2 < 2^63 for any genome within the 4 Gbp limit.
        key = rank * np.int64(n + 2) + second
        sa = np.argsort(key, kind="stable")
        rank = _rerank(sa, rank, second)
        k *= 2
    return sa.astype(np.uint32)


def _rerank(sa: np.ndarray, rank: np.ndarray, second: np.ndarray) -> np.ndarray:
    """Assign dense ranks after a sort round."""
    kf = rank[sa]
    ks = second[sa]
    changed = np.empty(sa.shape[0], dtype=bool)
    changed[0] = True
    changed[1:] = (kf[1:] != kf[:-1]) | (ks[1:] != ks[:-1])
    new = np.empty_like(rank)
    new[sa] = np.cumsum(changed) - 1
    return new


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """Derive the BWT from the suffix array.

    Returns (bwt_codes, primary): bwt_codes has length n (the sentinel
    row is removed) and primary is the row index of the sentinel in the
    conceptual (n+1)-row BWT — the reference's inverseSa0
    (2bwt-lib/BWT.h:67-90).
    """
    primary = int(np.flatnonzero(sa == 0)[0])
    rows = np.concatenate([sa[:primary], sa[primary + 1:]])
    # every remaining row is >= 1, so uint32 subtraction never wraps and
    # the gather stays in 4-byte indices (halves the peak at 3.1 Gbp)
    rows -= 1
    return codes[rows], primary
