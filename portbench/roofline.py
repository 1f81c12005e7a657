"""The roofline arithmetic of the DP kernels: a frozen copy of
``chip_smoke.py`` (commit ba71ec9, lines 428-522: ``OPS_PER_CELL``,
``int32_peak_ops``, ``forward_peak``, ``bound_ms``, ``k1_bound``,
``k2_bound``, ``tb_bound``, ``dw_bound``), taking a launch's shape and
its problems' cells in place of the problems themselves, so that the
traced run reads them from the launch's arguments.

What a bound leaves out is left out on the safe side: K1's and TB's run
words and TB's moves are not known from the arguments, so their bytes
count only what every launch reads and writes; a share computed on
these bounds can only read low.
"""

from __future__ import annotations

import subprocess

# add, max and select operations per cell of the recurrence as the
# port's `_dp_forward_scan` writes it: D (2 adds, max, clamp: 4), I (2
# adds, the fresh-start select, 2 max, clamp: 6), H (substitution
# select, diagonal add, 3 max, clamp, the fresh-diagonal select: 7): 17
OPS_PER_CELL = 17
HBM_BYTES_PER_S = 3.35e12
# dp_wavefront.cuh `fits16`: reads of at most this many bases and scores
# of magnitude at most SCORE16_MAX take the two-cells-per-register form
READ16_MAX, SCORE16_MAX = 255, 15
SMS, INT32_LANES = 132, 64


def sm_max_clock_mhz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(res.stdout.strip().splitlines()[0])


def int32_peak_ops(clock_mhz: float) -> float:
    """The card's int32 rate: 132 SMs x 64 int32 lanes x the SM clock
    nvidia-smi reports as its maximum (operations per second)."""
    return SMS * INT32_LANES * clock_mhz * 1e6


def forward_peak(Lr: int, scores: tuple, int32_peak: float) -> float:
    """The operations peak of the forward at read width Lr under scores
    (match, mismatch, gap open, gap extend): the 16x2 form at twice the
    int32 peak, the 32-bit form at the int32 peak."""
    match, mismatch, go, ge = scores
    vals = (match, mismatch, go, ge, go - ge)
    if Lr <= READ16_MAX and all(abs(v) <= SCORE16_MAX for v in vals):
        return 2 * int32_peak
    return int32_peak


def bound_ms(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of the operations
    over the operations peak and the bytes over the memory rate."""
    return max(ops / peak_ops, nbytes / HBM_BYTES_PER_S) * 1e3


def k1_bound(P: int, Lr: int, Lw: int, cells: int, peak: float) -> float:
    """K1: the recurrence's operations on the cells its problems need;
    reads, windows and (P, 8) parameters read once, (P, 8) stats
    written once."""
    return bound_ms(cells * OPS_PER_CELL, P * (Lr + Lw + 32 + 32), peak)


def k2_bound(P: int, Lr: int, Lw: int, cells: int, peak: float) -> float:
    """K2: the same operations; inputs read once, its 4 stats words and
    the whole direction tensor (Lr+Lw, P, Lr+1) written once."""
    nbytes = P * (Lr + Lw + 32 + 16) + (Lr + Lw) * P * (Lr + 1)
    return bound_ms(cells * OPS_PER_CELL, nbytes, peak)


def tb_bound(P: int) -> float:
    """TB: each problem's rlen, clip_l and cutoff, score and best cell
    read once and its 4 stats words written once."""
    return bound_ms(0, P * (12 + 12 + 16), 1.0)


def dw_bound(n: int) -> float:
    """DW: each lane's score, nrun, overflow flag and cutoff read once,
    the header written."""
    return bound_ms(0, 16 * n + 16, 1.0)
