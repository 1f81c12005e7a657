"""Shared ragged-bytes flattening for the columnar writers.

Every block writer (SAM text, succinct, BAM) needs the same transform:
a column of byte strings -> (per-item lengths, flat uint8 buffer).
Fixed-width numpy 'S' arrays take a fully vectorized path (one masked
ragged copy); lists of bytes fall back to a Python join.
"""

from __future__ import annotations

import numpy as np


def flatten_bytes(items) -> tuple[np.ndarray, np.ndarray]:
    """(lengths int64, flat uint8 source) for a bytes column."""
    a = items if isinstance(items, np.ndarray) else np.asarray(items)
    if a.dtype.kind == "S":
        ln = np.char.str_len(a).astype(np.int64)
        W = a.dtype.itemsize
        if W == 0:
            return ln, np.zeros(0, np.uint8)
        m = np.ascontiguousarray(a).view(np.uint8).reshape(len(a), W)
        keep = np.arange(W, dtype=np.int64)[None, :] < ln[:, None]
        return ln, m[keep]
    n = len(items)
    ln = np.fromiter((len(x) for x in items), np.int64, count=n)
    buf = np.frombuffer(b"".join(items), np.uint8) if int(ln.sum()) \
        else np.zeros(0, np.uint8)
    return ln, buf


def offsets_of(lengths: np.ndarray) -> np.ndarray:
    """Exclusive-prefix offsets (length n+1) for ragged lengths."""
    off = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    return off


def scatter_idx(base: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat destination indices for a ragged copy: item i's bytes land
    at base[i], base[i]+1, ... base[i]+lengths[i]-1."""
    total = int(lengths.sum())
    return np.repeat(base, lengths) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths))
