"""Static-shape bucketing utilities.

Everything dispatched to the accelerator must have shapes drawn from a
small, fixed set, or each batch pays a fresh XLA compile (disastrous
when compilation is remote). Dynamic sizes (round-2 read subsets, DP
candidate counts, window lengths) are padded up to the next bucket; the
wasted lanes are masked out.
"""

from __future__ import annotations

import numpy as np


def bucket(n: int, min_size: int = 256) -> int:
    """Next power of two >= n (at least min_size)."""
    if n <= min_size:
        return min_size
    return 1 << (int(n) - 1).bit_length()


def bucket_quarter(n: int, min_size: int = 256) -> int:
    """Next {1, 1.25, 1.5, 1.75} x 2^k >= n (at least min_size).

    Power-of-two buckets waste up to 2x padded work right above a
    boundary (a 44.5k flagged-read escalation padded to 65.5k); quarter
    steps bound padding at 25% for 4 jit shapes per octave."""
    if n <= min_size:
        return min_size
    base = 1 << (int(n) - 1).bit_length() - 1  # largest power of two < 2n
    for frac in (4, 5, 6, 7):
        c = base * frac // 4
        if c >= n:
            return c
    return base * 2


def bucket_multiple(n: int, quantum: int = 128, min_size: int = 128) -> int:
    """Round n up to a multiple of quantum (at least min_size)."""
    return max(min_size, -(-int(n) // quantum) * quantum)


def pad_rows(arr: np.ndarray, size: int, fill_from_first: bool = True) -> np.ndarray:
    """Pad axis 0 of arr to `size` rows (repeating row 0, or zeros)."""
    n = arr.shape[0]
    if n == size:
        return arr
    pad_shape = (size - n,) + arr.shape[1:]
    if fill_from_first and n > 0:
        pad = np.broadcast_to(arr[:1], pad_shape)
    else:
        pad = np.zeros(pad_shape, dtype=arr.dtype)
    return np.concatenate([np.asarray(arr), pad], axis=0)


def pad_cols(arr: np.ndarray, width: int) -> np.ndarray:
    """Zero-pad axis 1 of a 2-D array to `width` columns (code 0 = 'A',
    masked by per-read lengths in every consumer)."""
    if arr.shape[1] == width:
        return arr
    return np.pad(arr, ((0, 0), (0, width - arr.shape[1])))
