"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card; no options

Phases, each printing one line, any failure exits non-zero:

1. device and build: the card's name and power limit, and the build of
   every kernel from csrc/ (one nvcc per source, started together:
   banded_dp.cu, dp_forward.cu, fm_search.cu) with its registers and
   spills;
2. each kernel against its plain-torch version on the card, outputs
   exactly equal, both times printed with each kernel's bound and
   share (a kernel's time is its device time, torch.profiler's device
   events, with the CUDA-event time of a call in a loop of calls
   beside it): K1 (the fused DP) at the main path's shapes, then at the edges
   of the forward (reads of 31, 32, 33, 127, 128 and 2047 bases, ties
   on the best score across diagonals, anchors, a run-budget overflow
   that re-launches K1); K2 (forward only) at K1's main shape (the
   difference is K1's traceback and scratch share) and, with TB (its
   traceback), at the mate-pair rescue window, an edge shape and a case
   that re-launches TB, where dp_align's wide route is also held
   against K1 at the same shape and TB's window rule is replayed on K2's
   directions (every cell a walk visits inside the bytes its warp
   fetched; the windows and 32-byte sectors counted for TB's bound);
   then K1 and K2 (every dirs byte) at
   the edges of the forward's two forms: reads of 255 bases at scores
   of magnitude 15 (the 16-bit form's limits: every base mismatched,
   the top score, long gaps), the same with one score at 16, and scores
   past 15 at the main path's shape, with anchors and at a K2 window
   (the 32-bit form). Then the seed search's kernels, FS1 (backward
   search), FS2 (SA decode: of ready rows; with the search's lane
   expansion, expand_decode, "FS2x"; with the DP seeding's,
   seed_expand_decode, "FS2s"), FS3 (packed verify) and FS4 (the hash
   dedupe), every output
   element equal to the plain version's, with each kernel's device time,
   its bound and share (bytes and 32-byte sectors of the reference's
   separate occ and BWT tables, and the sectors of the occ blocks the
   kernels read), its time when it read the separate tables (quoted
   from PERF.md) and the plain version's: the
   calls of the main path on phase 4's index (a 65,536-pair batch's
   search, the index built and cached here, and phase 4's largest
   deep-DP seeding, 107,648 lanes), each FS1 branch at its edges, FS2
   at sa_rate 1, 2 and 8 and with the SA split over a two-replica mesh,
   the expansion's edges at the search's K (a total of 0, past K and
   equal to K, one lane holding every slot), the seeding expansion's
   (interval widths of 0, 1, 63, 64, 65 and 200, seeds at read offset 0
   and at the read's end, totals past K, equal to K and 0), the occ
   blocks' edges (every SA row of small indexes whose last block holds
   4, 2 or 3 words; seeds that decode below their start), FS3 at its
   edges, FS4 at its edges (uniq above and equal to K2, no pos_ok, K at
   the 1,024-slot table with collisions forced so that same-key losers
   survive, whose count must be above 0, and K of 2^22), FS1-FS3 on a
   synthetic 3.2 Gbp index (rows, bounds and positions past 2^31), and
   a repeat genome's search (rounds 2 and 3) on the card and the CPU
   with equal hits. Then GP (the half rescue's gapless prescan,
   dp_rescue._prescan_impl) against _prescan_plain, every output
   element: phase 4's and phase 5's largest calls and the plain
   version's full chunk at phase 5's window on phase 4's index (each
   beside the grouped conv1d that computes the same counts), the edges
   of tests/test_torch_prescan.py on a 40 kbp genome with a run of A,
   and windows past 2^31 on the synthetic index, with GP's device time,
   its bound (int32 operations, popcounts or bytes) and share. Then PK
   (the DP rescue's problem pack, dp_rescue._pack_problems) against
   _pack_problems_plain, every byte of both outputs: phase 4's and phase
   5's pack calls on phase 4's index, the edges of
   tests/test_torch_pack.py on the same 40 kbp genome, and windows past
   2^31 on the synthetic index, with PK's device time, its bound (bytes)
   and share, and the plain version's time;
3. golden SAM: the five paired-end and two single-end golden cases of
   tests/golden rendered through the port on cuda, every record equal
   (@PG excepted);
4. end to end at a real size: a 250 Mbp genome, 100,000 read pairs,
   the port's `pair` CLI with default options (-u 500 -v 300); checks
   records, planted-locus recall, rescue counts and kernel launches (K1
   and the path's FS kernels: FS1, FS2x, FS2s, FS3 and FS4, GP and PK,
   and no K2: its windows are narrow; no plain search primitive, no
   plain prescan and no plain pack on the card) with a histogram of the
   launch shapes (phases 5, 6 and 7a likewise), the run's stage timers
   (SOAP3DP_TIMERS=1: BC.prescan beside BC.half_rescue, dp.pack beside
   dp.align; phase 5 likewise), then
   runs it once more under torch.profiler (device busy share, top device
   events in the output directory's e2e_profile.txt), and searches its
   first batch alone under torch.profiler (the search's device items
   beside PR 7's total, search_profile.txt; no cummax scan and no
   scatter-min);
5. mate-pair: a -/+ library of 2-6 kbp inserts aligned with
   -v 2000 -u 6000 and SOAP3DP_HALF_NARROW_PAD=0 (the half rescue over
   the whole insert window, where dp_align takes K2 + TB). First 200
   pairs on a 200 kbp genome, on cuda and on cpu, SAM records equal;
   then 100,000 pairs on phase 4's 250 Mbp index, checking records,
   recall and the launches of K1, K2, TB, GP and PK;
6. single-end: the port's `single` CLI over phase 4's end-1 reads on the
   same index, checking records, recall and K1 and PK launches
   (salvage);
7. several devices and processes, on phase 4's inputs: (a) the runner's
   pair loop on an in-process mesh of max(2, cards) index replicas (two
   on one card), records and summary equal to phase 4's, K1 and the
   path's FS kernels (FS4 and FS2s among them) launched on each card,
   GP on the card of the index replica the prescan is given, PK on each
   replica's card,
   and dp_align(mesh=) at the mate-pair window equal to one device's,
   K2 and TB launched; (b) two `pair --hosts 2` processes (process i on
   card i % cards), merged records and global summary equal to phase
   4's; (c) with two cards or more, `--devices 0` and a search and both
   DP routes on the last card while card 0 is current; on one card it
   prints "not run: 1 card".

Then one JSON line with the kernels (K1, K2, TB, FS1, FS2, FS2x, FS3,
FS4, FS2s, GP, PK, each with its device time, its bound on this card,
the share of the bound it reaches and the operations peak the bound
used: int16x2, twice the int32 peak, where the 16-bit forward runs),
and the last line
{"ok": true, "device": {...}}. Uses only soap3dp_tpu_torch (its own
index builder, readers and writers); imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[chip_smoke] {name}: {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------
# Phase 2 inputs: the DP problems of tests/test_dp.py, made with numpy
# ------------------------------------------------------------------

def _mutate(rng, seq, nsub, nins, ndel):
    out = list(seq)
    for _ in range(ndel):
        if len(out) > 4:
            del out[rng.integers(0, len(out))]
    for _ in range(nins):
        out.insert(rng.integers(0, len(out) + 1), rng.integers(0, 4))
    for _ in range(nsub):
        p = rng.integers(0, len(out))
        out[p] = (out[p] + rng.integers(1, 4)) % 4
    return np.asarray(out, dtype=np.uint8)


def make_problems(rng, P, Lr, Lw, with_anchor=False):
    """Reads cut from their windows with substitutions and small indels
    (the make_problems recipe of tests/test_dp.py)."""
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), dtype=np.uint8)
    rlens = np.zeros(P, dtype=np.int32)
    for p in range(P):
        off = rng.integers(0, Lw // 3)
        span = rng.integers(Lr // 2, Lr)
        piece = _mutate(rng, wins[p, off:off + span], rng.integers(0, 4),
                        rng.integers(0, 3), rng.integers(0, 3))[:Lr]
        reads[p, :len(piece)] = piece
        rlens[p] = len(piece)
    clip_l = rng.integers(0, 6, size=P).astype(np.int32)
    clip_r = rng.integers(0, 6, size=P).astype(np.int32)
    if with_anchor:
        anchor_l = rng.integers(2, Lw, size=P).astype(np.int32)
        anchor_r = rng.integers(0, Lw // 2, size=P).astype(np.int32)
    else:
        anchor_l = np.full(P, Lw + 1, dtype=np.int32)
        anchor_r = np.zeros(P, dtype=np.int32)
    wlens = np.full(P, Lw, dtype=np.int32)
    return reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r


def main_path_problems(rng, P, Lr, Lw, read_len=None):
    """Rescue-shaped problems: reads of ``read_len`` (default Lr) bases
    in an Lr-wide matrix, placed in a window with mismatches and 3 bp
    indels, the rescue clips (49) and cutoff 0.3 L."""
    L = read_len or Lr
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), np.uint8)
    rlens = np.full(P, L, np.int32)
    for p in range(P):
        off = rng.integers(0, Lw - L - 8)
        piece = _mutate(rng, wins[p, off:off + L + 4], rng.integers(0, 6),
                        rng.integers(0, 2) * 3, rng.integers(0, 2) * 3)
        if p % 7 == 0:
            piece = rng.integers(0, 4, L).astype(np.uint8)  # no placement
        piece = piece[:L]
        reads[p, :len(piece)] = piece
        rlens[p] = len(piece)
    clip = np.full(P, 49, np.int32)
    return (reads, rlens, wins, np.full(P, Lw, np.int32), clip, clip.copy(),
            np.full(P, Lw + 1, np.int32), np.zeros(P, np.int32),
            (rlens * 0.3).astype(np.int32))


def overflow_problems(rng, P, Lr, Lw):
    """Every other base mismatched, no free clips, a cutoff far below
    any score: each alignment has ~Lr runs, past the first run budget."""
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = wins[:, 20:20 + Lr].copy()
    reads[:, 1::2] = (reads[:, 1::2] + 1 + (np.arange(Lr)[1::2] % 3)) % 4
    z = np.zeros(P, np.int32)
    return (reads, np.full(P, Lr, np.int32), wins, np.full(P, Lw, np.int32),
            z, z.copy(), np.full(P, Lw + 1, np.int32), z.copy(),
            np.full(P, -100000, np.int32))


def relaunch_problems(rng, P, Lr, Lw):
    """All-A reads against A-x-A-x windows under gap open = extend = -1
    (DPScores(1, -2, -1, -1)): the best path alternates a match and a
    1-base deletion, ~2 Lr runs, past the traceback's first run budget;
    the cutoff is far below any score."""
    wins = rng.integers(1, 4, (P, Lw)).astype(np.uint8)
    wins[:, ::2] = 0
    z = np.zeros(P, np.int32)
    return (np.zeros((P, Lr), np.uint8), np.full(P, Lr, np.int32), wins,
            np.full(P, Lw, np.int32), z, z.copy(), np.full(P, Lw + 1, np.int32),
            z.copy(), np.full(P, -100000, np.int32))


def tie_problems(rng, P, Lr, Lw):
    """Each read planted twice, exactly, at two window offsets (and a
    third, mismatched copy on some): equal best scores on several
    diagonals, so the fold's tie-breaks (smaller j, then smaller i) and
    its tie count decide the result."""
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = rng.integers(0, 4, size=(P, Lr)).astype(np.uint8)
    for p in range(P):
        a, b = sorted(rng.choice(np.arange(0, Lw - Lr, Lr + 3), 2,
                                 replace=False))
        wins[p, a:a + Lr] = reads[p]
        wins[p, b:b + Lr] = reads[p]
        if p % 3 == 0:
            wins[p, b + Lr // 2] = (wins[p, b + Lr // 2] + 1) % 4
    z = np.zeros(P, np.int32)
    return (reads, np.full(P, Lr, np.int32), wins, np.full(P, Lw, np.int32),
            z, z.copy(), np.full(P, Lw + 1, np.int32), z.copy(),
            np.full(P, Lr // 2, np.int32))


def edge_cases(rng) -> list[tuple[str, tuple]]:
    """The edges of K1's forward, as dp_align inputs: reads of 31, 32,
    33, 127, 128 and 2047 bases (one lane's worth, word and lane
    boundaries of the cells per lane), ties on the best score across
    diagonals, anchors, and a run-budget overflow (K1 re-launches)."""
    out = []
    for Lr in (31, 32, 33, 127, 128):
        out.append((f"Lr{Lr}", make_problems(rng, 256, Lr, Lr + 300)
                    + (np.full(256, Lr // 4, np.int32),)))
    out.append(("Lr2047", make_problems(rng, 8, 2047, 2100)
                + (np.full(8, 300, np.int32),)))
    out.append(("ties", tie_problems(rng, 256, 60, 400)))
    out.append(("anchors_Lr33", make_problems(rng, 256, 33, 200,
                                              with_anchor=True)
                + (np.full(256, 5, np.int32),)))
    out.append(("overflow_Lr260", overflow_problems(rng, 256, 260, 360)))
    return out


def extreme_problems(rng, P, Lr, Lw):
    """Reads of Lr bases at the extremes of the forward's values: a
    quarter with every base mismatched against an all-A window, a
    quarter planted exactly (the top score, Lr x match), a quarter
    planted across a deletion of 100-400 bases and a quarter with an
    insertion of 100 bases or more; no free clips and a cutoff far
    below any score, so every lane is traced back."""
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), np.uint8)
    for p in range(P):
        off = int(rng.integers(0, Lw - Lr - 420))
        kind = p % 4
        if kind == 0:
            wins[p] = 0
            reads[p] = rng.integers(1, 4, Lr)
        elif kind == 1:
            reads[p] = wins[p, off:off + Lr]
        elif kind == 2:
            cut = int(rng.integers(20, Lr - 20))
            gap = int(rng.integers(100, 400))
            reads[p, :cut] = wins[p, off:off + cut]
            reads[p, cut:] = wins[p, off + cut + gap:off + gap + Lr]
        else:
            cut = int(rng.integers(20, Lr - 130))
            ins = int(rng.integers(100, Lr - cut - 10))
            reads[p, :cut] = wins[p, off:off + cut]
            reads[p, cut:cut + ins] = rng.integers(0, 4, ins)
            reads[p, cut + ins:] = wins[p, off + cut:off + Lr - ins]
    z = np.zeros(P, np.int32)
    return (reads, np.full(P, Lr, np.int32), wins, np.full(P, Lw, np.int32),
            z, z.copy(), np.full(P, Lw + 1, np.int32), z.copy(),
            np.full(P, -100000, np.int32))


# scores (match, mismatch, gap open, gap extend) past the 16-bit
# forward's bound of magnitude 15, at sizes the main path uses
BIG_SCORES = (16, -20, -30, -9)


def range_cases(rng) -> list[tuple[str, tuple, tuple[int, int, int, int]]]:
    """The edges of the two forward forms, as dp_align inputs with their
    scores (match, mismatch, gap open, gap extend), for K1 and K2 both:
    reads of 255 bases (the top of the 16-bit form and of 8 cells a
    lane) at scores of magnitude 15, with every base mismatched, the
    top score and long gaps (gap extend -15 drives the D chains along
    the 2400-base windows to the -32000 floor; -1 makes the DP take the
    long gaps); the same with one
    score at 16, which takes the 32-bit form at 8 cells a lane; and
    scores past the bound at the main path's shape, with anchors, and at
    a K2 window."""
    out = []
    for name, sc in (("r16_Lr255_ext15", (15, -15, -15, -15)),
                     ("r16_Lr255_ext1", (15, -15, -15, -1)),
                     ("r32_Lr255_match16", (16, -15, -15, -15)),
                     ("r32_Lr255_ext16", (15, -15, -15, -16))):
        out.append((name, extreme_problems(rng, 64, 255, 2400), sc))
    out.append(("r32_main", main_path_problems(rng, 256, 100, 768),
                BIG_SCORES))
    out.append(("r32_anchors", make_problems(rng, 128, 60, 200, True)
                + (np.full(128, 10, np.int32),), BIG_SCORES))
    out.append(("r32_window4224", make_problems(rng, 32, 100, 4224, True)
                + (np.full(32, 30, np.int32),), BIG_SCORES))
    return out


# add, max and select operations per cell of the recurrence as
# `_dp_forward_scan` writes it: D (2 adds, max, clamp: 4), I (2 adds, the
# fresh-start select, 2 max, clamp: 6), H (substitution select, diagonal
# add, 3 max, clamp, the fresh-diagonal select: 7): 17
OPS_PER_CELL = 17
HBM_BYTES_PER_S = 3.35e12
# dp_wavefront.cuh `fits16`: reads of at most this many bases and scores
# of magnitude at most SCORE16_MAX take the two-cells-per-register form
READ16_MAX, SCORE16_MAX = 255, 15


def sm_max_clock_mhz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(res.stdout.strip().splitlines()[0])


def int32_peak_ops() -> float:
    """The card's int32 rate: 132 SMs x 64 int32 lanes x the SM clock
    that nvidia-smi reports as its maximum (operations per second)."""
    return 132 * 64 * sm_max_clock_mhz() * 1e6


def forward_peak(Lr: int, sc, int32_peak: float) -> tuple[float, str]:
    """The operations peak of the forward that K1 and K2 run at read
    width Lr under scores ``sc`` (DPScores): the 16x2 form (VIADD.16x2,
    VIMNMX.S16x2, VIMNMX3.S16x2 issue at the int32 rate and do two
    cells' operations each) at twice the int32 peak, the 32-bit form at
    the int32 peak."""
    vals = (sc.match, sc.mismatch, sc.gap_open, sc.gap_ext, sc.gap_init)
    if Lr <= READ16_MAX and all(abs(v) <= SCORE16_MAX for v in vals):
        return 2 * int32_peak, "int16x2"
    return int32_peak, "int32"


def bound_ms(ops: float, nbytes: float, peak_ops: float
             ) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the operations peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dp_cells(prob) -> int:
    """Sum of rlen x wlen over the problems: the cells the DP needs."""
    return int((np.asarray(prob[1], np.int64)
                * np.asarray(prob[3], np.int64)).sum())


def k1_bound(prob, mr: int, peak_ops: float) -> tuple[float, str]:
    """K1: the recurrence's operations; inputs (reads, windows, the
    (P, 8) parameters) read once and outputs (stats (P, 8), runs and
    counts (P, MR)) written once. Its direction scratch is internal."""
    P, Lr = prob[0].shape
    nbytes = P * (Lr + prob[2].shape[1] + 32 + 32 + 8 * mr)
    return bound_ms(dp_cells(prob) * OPS_PER_CELL, nbytes, peak_ops)


def k2_bound(prob, peak_ops: float) -> tuple[float, str]:
    """K2: the same operations; inputs read once, stats (P, 4) and the
    whole direction tensor (Lr+Lw, P, Lr+1), its output, written once."""
    P, Lr = prob[0].shape
    Lw = prob[2].shape[1]
    nbytes = P * (Lr + Lw + 32 + 16) + (Lr + Lw) * P * (Lr + 1)
    return bound_ms(dp_cells(prob) * OPS_PER_CELL, nbytes, peak_ops)


def tb_bound(moves: int, P: int, mr: int, peak_ops: float,
             path_bytes: int | None = None) -> tuple[float, str]:
    """TB: the direction byte of each cell on this run's paths (the
    walks' moves), its (P, 4) parameters and active mask read once, runs
    and counts (P, MR) and (P, 4) meta written once; a few operations
    per move. With ``path_bytes`` (the sectors its windows fetch) in
    place of the moves, the time of this design's own fetch volume,
    which is not a bound on the function."""
    nbytes = (moves if path_bytes is None else path_bytes) \
        + P * (16 + 1 + 8 * mr + 16)
    return bound_ms(moves * OPS_PER_CELL, nbytes, peak_ops)


def _dp_equal(a, b) -> tuple[bool, int]:
    """Exact equality of two dp_align results (runs compared over each
    lane's nrun prefix); returns (equal, max |difference|)."""
    (sa, ia, ja, ca, oa, na, ra, ta, fa) = a
    (sb, ib, jb, cb, ob, nb, rb, tb, fb) = b
    err = 0
    for x, y in ((sa, sb), (ia, ib), (ja, jb), (ca, cb), (ra, rb),
                 (ta, tb), (fa, fb)):
        err = max(err, int(np.abs(np.asarray(x, np.int64)
                                  - np.asarray(y, np.int64)).max(initial=0)))
    for p in np.flatnonzero(np.asarray(ra) > 0):
        n = int(ra[p])
        if n > oa.shape[1] or n > ob.shape[1]:
            return False, max(err, 1)
        err = max(err, int(np.abs(oa[p, :n] - ob[p, :n]).max()),
                  int(np.abs(na[p, :n] - nb[p, :n]).max()))
    return err == 0, err


def _events_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` after one warm-up call, CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int = 1) -> tuple[object, float]:
    """(last result, median wall ms) of ``fn()`` ending in a synchronize."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


# profiles _kernel_device_ms takes before it gives up on the profiler
PROFILE_TRIES = 5


def _timed(fn, reps: int, symbol: str, per_call: int = 1
           ) -> tuple[float, float, str]:
    """(device ms, call ms, the device time's timer) of ``fn()``, the
    launch of ``per_call`` kernels named ``symbol``: their mean device
    duration (torch.profiler's device events, _kernel_device_ms) and the
    mean time of a call in a loop of calls (CUDA events, the wrapper's
    host work included). Where no profile holds such an event, the
    device time is the call's, and its timer says so."""
    call_ms = _events_ms(fn, reps)
    ms = _kernel_device_ms(fn, reps, symbol, per_call)
    if ms > 0:
        return ms, call_ms, "torch.profiler"
    phase("timer", f"torch.profiler recorded no {symbol} event in "
                   f"{PROFILE_TRIES} profiles: its time is the CUDA-event "
                   "time of a call, the host's work included")
    return call_ms, call_ms, "CUDA events"


def _k1_ms(bd, args, reps: int = 10, sc=None
           ) -> tuple[float, float, str]:
    """(device ms, call ms, timer) of one K1 launch (no host copies),
    _timed."""
    reads, rlens, wins, wlens, cl, cr, al, ar, cut = args
    params = bd._params(rlens, wlens, cl, cr, al, ar, cut)
    mr = max(bd.MAX_RUNS, bd._max_runs_bound(reads.shape[1]))
    sc = sc or bd.DPScores()
    return _timed(lambda: bd._launch_dp(reads, wins, params, mr, sc), reps,
                  "dp_align_kernel")


K1_SEED, WIDE_SEED = 20261016, 20261017  # phase 2's K1 and wide cases


def k1_cases(rng) -> list[tuple[str, tuple]]:
    """K1's cases, as dp_align inputs: the main shapes, anchors, long
    reads, edge_cases and the shapes phase 4 gives K1."""
    return [
        ("Lr100_Lw256", main_path_problems(rng, 4096, 100, 256)),
        ("Lr100_Lw768", main_path_problems(rng, 4096, 100, 768)),
        ("anchors", make_problems(rng, 512, 100, 256, with_anchor=True)
         + (np.full(512, 10, np.int32),)),
        ("Lr1024_Lw1100", make_problems(rng, 64, 1024, 1100)
         + (np.full(64, 150, np.int32),)),
    ] + edge_cases(rng) + [
        # the shapes phase 4 gives K1 (its launch-shape histogram): reads
        # of 100 bases in 120-wide rows, 256-wide windows
        ("path_P8192", main_path_problems(rng, 8192, 120, 256, read_len=100)),
        ("path_P16384", main_path_problems(rng, 16384, 120, 256,
                                           read_len=100)),
    ]


def phase_kernels(dev, peak_ops: float) -> list[dict]:
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rows = []
    max_err = 0
    for name, prob in k1_cases(np.random.default_rng(K1_SEED)):
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in prob]
        n0 = bd.DP_KERNEL.launches
        got, first_ms = _host_ms(lambda: bd.dp_align(*args))
        n_launch = bd.DP_KERNEL.launches - n0
        _, ms = _host_ms(lambda: bd.dp_align(*args), 3)
        want, plain_ms = _host_ms(lambda: bd.dp_align_plain(*args))
        ok, err = _dp_equal(got, want)
        npass = int((np.asarray(want[6]) > 0).sum())
        P, Lr, Lw = prob[0].shape[0], prob[0].shape[1], prob[2].shape[1]
        kms, kcall, ktimer = _k1_ms(bd, args)
        mr = max(bd.MAX_RUNS, bd._max_runs_bound(Lr))
        peak, pname = forward_peak(Lr, bd.DPScores(), peak_ops)
        bms, by = k1_bound(prob, mr, peak)
        phase("kernel banded_dp",
              f"{name}: P={P} Lr={Lr} Lw={Lw} equal={ok} max_abs_err={err} "
              f"passing_lanes={npass} launches={n_launch} "
              f"first_ms={first_ms:.3f} dp_align_ms={ms:.3f} "
              f"kernel_ms={kms:.4f} ({ktimer}) call_ms={kcall:.4f} "
              f"GCUPS={dp_cells(prob) / (kms * 1e6):.1f} "
              f"bound_ms={bms:.4f} ({by}, {pname} peak) "
              f"share={bms / kms:.1%} plain_ms={plain_ms:.3f}")
        if not ok:
            fail(f"banded_dp kernel disagrees with its plain version ({name})")
        if name.startswith("overflow") and n_launch != 2:
            fail("overflow case did not re-launch the DP kernel")
        max_err = max(max_err, err)
        rows.append({"case": name, "P": P, "Lr": Lr, "Lw": Lw,
                     "dp_align_ms": ms, "kernel_ms": kms, "call_ms": kcall,
                     "timer": ktimer,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "peak": pname})
        if name == "Lr100_Lw768":
            # K2 on the same problems: what K1 adds is its traceback and
            # its direction scratch
            params = bd._params(args[1], args[3], *args[4:8])
            dirs = torch.empty((Lr + Lw, P, Lr + 1), dtype=torch.uint8,
                               device=dev)
            k2_ms, _, _ = _timed(lambda: bd._launch_forward(
                args[0], args[2], params, dirs, bd.DPScores()), 10,
                "dp_forward_kernel")
            del dirs
            phase("kernel banded_dp",
                  f"K2 at K1's main shape (P={P} Lr={Lr} Lw={Lw}): "
                  f"kernel_ms={k2_ms:.4f} against K1's {kms:.4f}: "
                  f"K1 - K2 = {kms - k2_ms:.4f} ms (K1's traceback and "
                  f"scratch, less K2's writes of its direction tensor)")
            rows[-1]["k2_same_problems_ms"] = k2_ms
    # the main path's most frequent K1 launch (phase 4's histogram)
    main = [r for r in rows if r["case"] == "path_P8192"][0]
    return [{"name": "banded_dp", "route": "cuda",
             "source": "soap3dp_tpu_torch/csrc/banded_dp.cu",
             "replaces": "soap3dp_tpu/kernels/banded_dp.py:606",
             "launches": 0, "max_abs_err": max_err,
             "ms": main["kernel_ms"], "timer": main["timer"],
             "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "peak": main["peak"], "library_ms": None,
             "call_ms": main["call_ms"], "cases": rows}]


def phase_range_cases(dev) -> tuple[int, int]:
    """K1 and K2 at the edges of the two forward forms (range_cases),
    each exactly equal to its plain version: K1's dp_align result, K2's
    stats and every byte of its direction tensor. Returns K1's and K2's
    max |difference| (0)."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    k1_err = k2_err = 0
    for name, prob, scores in range_cases(np.random.default_rng(20261018)):
        sc = bd.DPScores(*scores)
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in prob]
        P, Lr, Lw = prob[0].shape[0], prob[0].shape[1], prob[2].shape[1]
        n0 = bd.DP_KERNEL.launches
        ok, e1 = _dp_equal(bd.dp_align_cuda(*args, sc=sc),
                           bd.dp_align_plain(*args, sc=sc))
        n_k1 = bd.DP_KERNEL.launches - n0
        fwd = bd.dp_forward(*args[:8], sc=sc)
        plain = bd._dp_forward_scan(*args[:8], sc=sc)
        e2 = max(int((a.long() - b.long()).abs().max())
                 for a, b in zip(fwd[:4], plain[:4]))
        ndiff = int((fwd[4] != plain[4]).sum())
        del fwd, plain
        form = forward_peak(Lr, sc, 1.0)[1]
        phase("kernel range",
              f"{name}: P={P} Lr={Lr} Lw={Lw} scores={scores} form={form} "
              f"K1 equal={ok} max_abs_err={e1} launches={n_k1}; K2 stats "
              f"max_abs_err={e2} dirs bytes differing={ndiff}")
        if not ok or e2 or ndiff:
            fail(f"K1 or K2 disagrees with its plain version ({name})")
        if form != ("int16x2" if name.startswith("r16") else "int32"):
            fail(f"{name} does not take the forward form it names")
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    return k1_err, k2_err


def wide_cases(rng, small: bool = False) -> list[tuple[str, tuple, object]]:
    """The wide route's cases, as dp_align inputs with their DPScores:
    the mate-pair rescue window (2048 x 120 x 4224, reads of 100), an
    edge shape (256 x 127 x 8192) and a case whose runs pass TB's first
    budget (a re-launch); with ``small`` the same problems at a few
    problems and windows of a few hundred bases, for the CPU."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    P1, Lw1, P2, Lw2, P3, Lw3 = ((16, 600, 16, 500, 4, 400) if small else
                                 (2048, 4224, 256, 8192, 64, 4096))
    edge = make_problems(rng, P2, 127, Lw2)
    return [
        ("mate_window", main_path_problems(rng, P1, 120, Lw1, read_len=100),
         bd.DPScores()),
        ("edge", edge + ((edge[1] * 0.3).astype(np.int32),), bd.DPScores()),
        ("tb_relaunch", relaunch_problems(rng, P3, 127, Lw3),
         bd.DPScores(1, -2, -1, -1)),
    ]


TB_WINDOW = 32  # diagonals of one TB window (csrc/dp_forward.cu)


def tb_replay(dirs, hit_i, hit_j, active):
    """TB's walk over ``dirs`` (ND, P, Lr+1) by the kernel's window rule,
    all problems in step: a problem's window opens at diagonal dtop = i + j
    of its walk, where the aligned 4-byte words holding bytes
    max(0, i - k) .. i of row dtop - 1 - k are fetched for each k below
    TB_WINDOW, and the walk takes its moves there until
    i + j <= dtop - TB_WINDOW. Fails unless every cell the
    walk visits lies in the bytes fetched for its row. Returns what
    banded_dp._traceback_scan returns (each problem's op on each
    diagonal, and (i, j, done, startj, clip) where the walks stopped),
    the windows fetched and the distinct 32-byte sectors they touch (the
    dirs tensor starting on a sector)."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    ND, P, Lr1 = dirs.shape
    dev = dirs.device
    prob = torch.arange(P, device=dev)
    lane = torch.arange(TB_WINDOW, device=dev)
    i = torch.where(active, hit_i.long(), 0)
    j = torch.where(active, hit_j.long(), 0)
    zero = torch.zeros(P, dtype=torch.int64, device=dev)
    state, startj, clip, top, itop = (zero.clone() for _ in range(5))
    done = ~active
    opseq = torch.zeros((ND, P), dtype=torch.int8, device=dev)
    live = active & (i > 0) & (j > 0) & (i + j <= ND) & (i < Lr1)
    windows, sectors = 0, [zero[:0]]
    while bool(live.any()):
        new = live & ((top == 0) | (i + j <= top - TB_WINDOW))
        top = torch.where(new, i + j, top)
        itop = torch.where(new, i, itop)
        row = (i + j)[new, None] - 1 - lane
        lo = (i[new, None] - lane).clamp(min=0)
        base = (row * P + prob[new, None]) * Lr1
        first = (base + lo) // 4 * 4
        last = (base + i[new, None]) // 4 * 4 + 3
        sectors += [(first // 32)[row >= 0], (last // 32)[row >= 0]]
        windows += int(new.sum())
        k = top - i - j
        inside = (k >= 0) & (k < TB_WINDOW) & (i >= itop - k) & (i <= itop)
        if not bool(inside[live].all()):
            fail("TB's walk left the window its warp fetched")
        byte = dirs[(i + j - 1).clamp(0, ND - 1), prob,
                    i.clamp(0, Lr1 - 1)].long()
        dH, dD, dI = byte & 3, (byte >> 2) & 1, (byte >> 3) & 3
        mop = torch.where(((byte >> 5) & 1) == 1, bd.OP_MATCH, bd.OP_MISMATCH)
        do_diag = live & (state == 0) & (dH == bd.DH_DIAG)
        do_sm = live & (state == 0) & (dH == bd.DH_SM)
        do_d = live & ((state == 1) | ((state == 0) & (dH == bd.DH_D)))
        do_i = live & ((state == 2) | ((state == 0) & (dH == bd.DH_I)))
        i_fresh = do_i & (dI == bd.DI_FRESH)
        op = torch.where(do_diag | do_sm, mop,
                         torch.where(do_d, bd.OP_DEL, bd.OP_INS))
        opseq[(i + j - 1)[live], prob[live]] = op[live].to(torch.int8)
        nstate = torch.where(
            do_d, torch.where(dD == bd.DD_OPEN, 0, 1),
            torch.where(do_i & ~i_fresh, torch.where(dI == bd.DI_OPEN, 0, 2),
                        0))
        state = torch.where(live, nstate, state)
        exit_now = do_sm | i_fresh
        clip = torch.where(exit_now, i - 1, clip)
        startj = torch.where(do_sm, j - 1, torch.where(i_fresh, j, startj))
        done = done | exit_now
        ni = torch.where(do_diag | (do_i & ~i_fresh), i - 1, i)
        nj = torch.where(do_diag | do_sm | do_d, j - 1, j)
        i, j = torch.where(live, ni, i), torch.where(live, nj, j)
        live = live & ~done & (i > 0) & (j > 0)
    nsec = int(torch.unique(torch.cat(sectors)).numel())
    return opseq, (i, j, done, startj, clip), windows, nsec


def tb_replay_matches(dirs, rlens, hit_i, hit_j, clip_l, active,
                      want) -> tuple[int, int]:
    """tb_replay's runs (its op stream and exit state through
    banded_dp._walk_runs) against ``want``, the plain traceback's
    (banded_dp._dp_traceback_plain) on the same directions, every
    output. Returns (the windows, the distinct sectors)."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    act = torch.as_tensor(np.asarray(active), device=dirs.device)
    ops, state, windows, sectors = tb_replay(dirs, hit_i.to(dirs.device),
                                             hit_j.to(dirs.device), act)
    got = bd._walk_runs((ops, state), rlens, hit_i, clip_l, active)
    if not all(np.shape(a) == np.shape(b) and np.array_equal(a, b)
               for a, b in zip(got, want)):
        fail("TB's window replay disagrees with the plain traceback")
    return windows, sectors


def phase_wide_kernels(dev, peak_ops: float) -> list[dict]:
    """K2 and TB against their plain versions, and dp_align's wide route
    against the plain dp_align and K1 at the same shape (wide_cases);
    TB's window rule replayed on K2's directions (tb_replay)."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rows = []
    max_err = 0
    for name, prob, sc in wide_cases(np.random.default_rng(WIDE_SEED)):
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in prob]
        P, Lr, Lw = prob[0].shape[0], prob[0].shape[1], prob[2].shape[1]
        # K2 against the plain forward: stats and every dirs byte
        fwd = bd.dp_forward(*args[:8], sc=sc)
        plain, plain_fwd_ms = _host_ms(
            lambda: bd._dp_forward_scan(*args[:8], sc=sc))
        err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                  for a, b in zip(fwd[:4], plain[:4]))
        ndiff = int((fwd[4] != plain[4]).sum())
        del plain
        # TB against the plain sweep + host RLE, on the same dirs
        act_t = fwd[0] >= args[8]
        act = act_t.cpu().numpy()
        tb_args = (args[1], fwd[1], fwd[2], args[4], act)
        tb = bd.dp_traceback(fwd[4], args[0], args[1], args[2], *tb_args[1:4],
                             act)
        tbp, plain_tb_ms = _host_ms(
            lambda: bd._dp_traceback_plain(fwd[4], *tb_args))
        tb_err = max(int(np.abs(np.asarray(x, np.int64)
                                - np.asarray(y, np.int64)).max(initial=0))
                     if np.shape(x) == np.shape(y) else 1
                     for x, y in zip(tb, tbp))
        t0 = time.perf_counter()
        windows, sectors = tb_replay_matches(fwd[4], *tb_args, tbp)
        replay_s = time.perf_counter() - t0
        # kernel times on the whole problem set
        params = bd._params(args[1], args[3], *args[4:8])
        fwd_ms, fwd_call, fwd_timer = _timed(lambda: bd._launch_forward(
            args[0], args[2], params, fwd[4], sc), 3, "dp_forward_kernel")
        tbq = torch.stack([args[1], fwd[1], fwd[2], args[4]], 1).to(
            torch.int32).contiguous()
        actd = act_t.to(torch.uint8).contiguous()
        mr = max(bd.MAX_RUNS, bd._max_runs_bound(Lr))
        tb_ms, tb_call, tb_timer = _timed(lambda: bd._launch_traceback(
            fwd[4], tbq, actd, None, P, mr), 10, "dp_traceback_kernel")
        del fwd
        # dp_align's wide route against the plain dp_align and K1
        n_f, n_t = bd.FORWARD_KERNEL.launches, bd.TRACEBACK_KERNEL.launches
        got = bd.dp_align(*args, sc=sc)
        n_f = bd.FORWARD_KERNEL.launches - n_f
        n_t = bd.TRACEBACK_KERNEL.launches - n_t
        _, call_ms = _host_ms(lambda: bd.dp_align(*args, sc=sc), 3)
        want, plain_ms = _host_ms(lambda: bd.dp_align_plain(*args, sc=sc))
        k1, k1_ms = _host_ms(lambda: bd.dp_align_cuda(*args, sc=sc), 3)
        k1_kernel_ms, _, _ = _k1_ms(bd, args, 3, sc)
        ok_plain, e1 = _dp_equal(got, want)
        ok_k1, e2 = _dp_equal(got, k1)
        npass = int((np.asarray(want[6]) > 0).sum())
        f_peak, f_pname = forward_peak(Lr, sc, peak_ops)
        f_bms, f_by = k2_bound(prob, f_peak)
        ops_t, cnt_t = np.asarray(tb[0]), np.asarray(tb[1])
        moves = int(cnt_t[(ops_t >= 1) & (ops_t <= 4)].sum())
        t_bms, t_by = tb_bound(moves, P, mr, peak_ops)
        t_fetch = tb_bound(moves, P, mr, peak_ops, SECTOR * sectors)[0]
        phase("kernel dp_forward+dp_traceback",
              f"{name}: P={P} Lr={Lr} Lw={Lw} fwd stats max_abs_err={err} "
              f"dirs bytes differing={ndiff} tb max_abs_err={tb_err} "
              f"dp_align==plain {ok_plain} dp_align==K1 {ok_k1} "
              f"passing_lanes={npass} launches fwd={n_f} tb={n_t} "
              f"dp_align_ms={call_ms:.3f} kernel_ms (fwd {fwd_timer}, tb "
              f"{tb_timer}) fwd={fwd_ms:.4f} tb={tb_ms:.4f} "
              f"call_ms fwd={fwd_call:.4f} "
              f"tb={tb_call:.4f} GCUPS={dp_cells(prob) / (fwd_ms * 1e6):.1f} "
              f"bound_ms fwd={f_bms:.4f} ({f_by}, {f_pname} peak, share "
              f"{f_bms / fwd_ms:.1%}) "
              f"tb={t_bms:.4f} ({t_by}, int32 peak, share "
              f"{t_bms / tb_ms:.1%}); tb windows={windows} "
              f"sectors={sectors} fetch_ms={t_fetch:.4f} (those sectors "
              f"over the memory rate, the design's fetch volume, not a "
              f"bound: {t_fetch / tb_ms:.1%} of tb) "
              f"replay_s={replay_s:.2f} moves={moves} "
              f"plain_ms={plain_ms:.3f} (fwd {plain_fwd_ms:.3f}, "
              f"tb {plain_tb_ms:.3f}) K1 dp_align_ms={k1_ms:.3f} "
              f"K1 kernel_ms={k1_kernel_ms:.4f}")
        if err or ndiff or tb_err or not ok_plain or not ok_k1:
            fail(f"K2 / TB disagree with their plain versions ({name})")
        if name == "tb_relaunch" and n_t <= n_f:
            fail("the low-cutoff case did not re-launch the traceback kernel")
        if name != "tb_relaunch" and n_t != n_f:
            fail(f"the traceback kernel re-launched in {name}")
        max_err = max(max_err, err, tb_err, e1, e2)
        rows.append({"case": name, "P": P, "Lr": Lr, "Lw": Lw,
                     "dp_align_ms": call_ms, "fwd_ms": fwd_ms,
                     "fwd_call_ms": fwd_call, "tb_ms": tb_ms,
                     "fwd_timer": fwd_timer, "tb_timer": tb_timer,
                     "tb_call_ms": tb_call, "plain_ms": plain_ms,
                     "plain_fwd_ms": plain_fwd_ms,
                     "plain_tb_ms": plain_tb_ms, "k1_dp_align_ms": k1_ms,
                     "k1_kernel_ms": k1_kernel_ms, "fwd_bound_ms": f_bms,
                     "fwd_bound_by": f_by, "fwd_peak": f_pname,
                     "tb_bound_ms": t_bms, "tb_bound_by": t_by,
                     "tb_fetch_ms": t_fetch, "tb_moves": moves,
                     "tb_windows": windows, "tb_sectors": sectors,
                     "tb_replay_s": replay_s})
    main = rows[0]
    common = {"route": "cuda", "source": "soap3dp_tpu_torch/csrc/dp_forward.cu",
              "launches": 0, "max_abs_err": max_err, "library_ms": None}
    return [dict(common, name="dp_forward",
                 replaces="soap3dp_tpu/kernels/banded_dp.py:238",
                 ms=main["fwd_ms"], call_ms=main["fwd_call_ms"],
                 timer=main["fwd_timer"],
                 plain_ms=main["plain_fwd_ms"],
                 bound_ms=main["fwd_bound_ms"], bound_by=main["fwd_bound_by"],
                 peak=main["fwd_peak"], cases=rows),
            dict(common, name="dp_traceback",
                 replaces="soap3dp_tpu/kernels/banded_dp.py:409",
                 ms=main["tb_ms"], call_ms=main["tb_call_ms"],
                 timer=main["tb_timer"],
                 plain_ms=main["plain_tb_ms"],
                 bound_ms=main["tb_bound_ms"], bound_by=main["tb_bound_by"],
                 peak="int32", fetch_ms=main["tb_fetch_ms"],
                 windows=main["tb_windows"], sectors=main["tb_sectors"])]


# ------------------------------------------------------------------
# Phase 2, the seed search's kernels: FS1 backward search, FS2 SA
# decode (with the search's and the DP seeding's lane expansions), FS3
# packed verify, FS4 hash dedupe (kernels/fm_search.py,
# csrc/fm_search.cu)
# ------------------------------------------------------------------

# The fmindex entry points of the kernels. Each takes a CUDA tensor to
# its kernel; its plain version (plain_of) runs a case's same inputs.
# FS2 has three entries: sa_decode of ready rows ("FS2"), the search's
# expand_decode, which expands the lanes into slots first ("FS2x"), and
# the DP seeding's seed_expand_decode ("FS2s"); FS4 is the search's hash
# dedupe.
FS_FUNCTIONS = {"seed_intervals": "FS1", "backward_search": "FS1",
                "backward_search_packed": "FS1", "sa_decode": "FS2",
                "expand_decode": "FS2x", "seed_expand_decode": "FS2s",
                "count_mismatches_rows": "FS3",
                "count_mismatches_packed": "FS3", "dedupe": "FS4"}
# an entry's plain version, where it is not the entry's name + "_plain"
FS_PLAIN = {"seed_expand_decode": "seed_expand_plain"}


def plain_of(fn: str) -> str:
    """The name in fmindex of the plain version of entry ``fn``."""
    return FS_PLAIN.get(fn, fn + "_plain")
# integer operations, as the plain versions write them: one FM step
# (both bounds: the sentinel skip, word and occ indices, the match
# mask of 5, the lane mask, popcount, two adds: 18 each), a lane's
# jumpstart (the k-mer or extension word, ~4 per base of 16), an SA
# probe (mark word index, bit test, partial mask, popcount) and LF step
# (the sentinel skip, indices, base extraction, the occ count), a
# verified word (funnel shift 4, xor, fold 3, mask 3, popcount, add)
OPS_FM_STEP, OPS_FM_LANE = 36, 64
OPS_SA_PROBE, OPS_SA_LF = 10, 22
OPS_VERIFY_WORD = 14
# a dedupe slot: the hash twice (3 products, xor, shift), the atomic,
# the winner's two compares, the ballot and its popcounts
OPS_DEDUPE_SLOT = 16
SECTOR = 32  # bytes the card moves for one scattered load
# the kernels' times at round 1 before their redesign, quoted from
# PERF.md section 6 in the summary lines only: FS1 and FS2 when they read
# the separate occ and BWT tables (FS2 then decoded ready rows after a
# plain-torch compaction of about 0.66 ms a launch, which FS2x now
# does), FS3 when it read a reverse complement base by base
BEFORE_REDESIGN_MS = {"FS1": 0.127, "FS2": 0.035, "FS3": 0.055}
# the search's scatter-min before FS4 (PR 7's run, PERF.md section 5)
SCATTER_MIN_BEFORE_MS = 0.219
# the search's device items of phase 4's first batch before FS4 (PR 7)
SEARCH_DEVICE_BEFORE_MS = 0.681


def sample_reads(rng, codes: np.ndarray, B: int, L: int, lens=None,
                 sub: float = 0.005, random_share: float = 0.0):
    """(reads (B, L) uint8, lens (B,) int32): reads cut from ``codes`` at
    random places, half reverse complemented, ``sub`` of their bases
    substituted, the first ``random_share`` of them random; zero past
    each read's length."""
    lens = np.full(B, L, np.int32) if lens is None else np.asarray(lens,
                                                                   np.int32)
    pos = rng.integers(0, len(codes) - L, B)
    reads = codes[pos[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    rc = rng.random(B) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    m = rng.random(reads.shape) < sub
    reads[m] = (reads[m] + rng.integers(1, 4, int(m.sum()))) % 4
    nrand = int(B * random_share)
    reads[:nrand] = rng.integers(0, 4, (nrand, L))
    reads[np.arange(L)[None, :] >= lens[:, None]] = 0
    return reads, lens


def fs_search_cases(rng, didx, codes: np.ndarray, dev, B: int = 256,
                    L: int = 100) -> list[tuple[str, str, tuple]]:
    """FS1 at the edges each branch of _search_batch must reproduce:
    reads of variable length (some shorter than lut_k, one of 1 base)
    with their reverse-complement rows, as code bytes and as packed
    words, and a uniform-length batch; segments shorter than lut_k in
    every mode (the LUT-only branch reads the A-padded k-mer at the
    start, the packed branch clamps the k-mer tail and the extension
    offset, the general branch clamps every base and takes no LUT),
    starts past the read and past L; and the public backward_search /
    backward_search_packed entries."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.fm.search import pack_read_matrix

    k = didx.lut_k
    lens = rng.integers(max(k - 3, 1), L + 1, B)
    lens[:4] = [L, k, k - 1, 1]
    reads, lens = sample_reads(rng, codes, B, L, lens)
    reads[-8:] = rng.integers(0, 4, (8, L))  # seeds absent from the genome

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    lens_t = t(lens)
    sources = {"codes": t(reads),
               "packed": t(pack_read_matrix(reads).view(np.int32))}
    S = 3
    N = 2 * B * S
    cases = []
    for mode, top, steps in (("lut", k + 16, 0), ("packed", k + 18, 16),
                             ("general", 48, 48)):
        start = rng.integers(0, L + 2, N)
        length = rng.integers(0, top + 1, N)
        length[::5] = rng.integers(0, k, len(length[::5]))
        for src, reads_t in sources.items():
            ori = fmindex.OrientedReads.of(reads_t, lens_t, L)
            cases.append((f"{mode}_{src}", "seed_intervals",
                          (didx, ori, S, t(start), t(length), steps, mode)))
    # a uniform-length batch of 90 bases in 100-wide rows: the reverse
    # complements of revcomp_reads_uniform
    uni, _ = sample_reads(rng, codes, B, L, np.full(B, 90))
    ori_u = fmindex.OrientedReads.of(
        t(pack_read_matrix(uni).view(np.int32)), t(np.full(B, 90, np.int32)),
        L, uniform_len=90)
    start = rng.integers(0, 60, N)
    length = rng.integers(0, k + 17, N)
    cases.append(("packed_uniform", "seed_intervals",
                  (didx, ori_u, S, t(start), t(length), 16, "packed")))
    # the public entries, on the materialized rows of the last source
    ori = fmindex.OrientedReads.of(sources["codes"], lens_t, L)
    oriented = ori.matrix
    rows = torch.arange(2 * B, device=dev).repeat_interleave(S)
    start = t(rng.integers(0, L + 2, N))
    length = t(rng.integers(0, 40, N))
    cases.append(("api_backward_search", "backward_search",
                  (didx, oriented[rows].contiguous(), start, length, 40)))
    cases.append(("api_backward_search_packed", "backward_search_packed",
                  (didx, fmindex.rolling_kmer_codes(oriented, 16), rows,
                   start, length.clamp(max=k + 16), 16)))
    return cases


def decode_rows(rng, n: int, primary: int, N: int) -> np.ndarray:
    """N SA rows in [0, n]: the first row, the rows around the sentinel
    (primary), around 16- and 32-row word boundaries, the last row, and
    random rows."""
    edge = [0, 1, 15, 16, 17, 31, 32, 33, primary - 1, primary, primary + 1,
            n - 1, n]
    words = rng.integers(1, max(n // 32, 2), 64) * 32
    edge += list((words[:, None] + np.array([-1, 0, 1, 16])[None, :]).ravel())
    rows = np.concatenate([np.asarray(edge, np.int64),
                           rng.integers(0, n + 1, max(N - len(edge), 0))])
    return np.clip(rows, 0, n)[:N]


def fs_decode_case(rng, name: str, didx, dev, N: int = 65536
                   ) -> tuple[str, str, tuple]:
    """FS2 on ``didx`` over decode_rows, a fifth of them invalid."""
    import torch

    rows = decode_rows(rng, didx.n, didx.primary, N)
    valid = rng.random(N) < 0.8
    return (name, "sa_decode", (didx, torch.from_numpy(rows).to(dev),
                                torch.from_numpy(valid).to(dev)))


EXPANSION_EDGES = ("zeros", "total_0", "total_gt_K", "total_eq_K",
                   "one_lane")


def expansion_cases(rng, didx, dev, RS: int, S: int, K: int,
                    name: str = "expand", edges=EXPANSION_EDGES
                    ) -> list[tuple[str, str, tuple]]:
    """FS2's expand_decode at the edges of the lane expansion, RS lanes
    (RS / S rows of S segments) into K slots: a third of the lanes
    empty (as empty and overflowing lanes are) and a total of 3K/4
    ("zeros"), a total of 0, of 5K/4 (past K) and of K, and one lane
    holding all K slots; intervals anywhere in the SA, segment starts
    and read lengths of reads in 120-wide rows."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n = didx.n
    olens = t(rng.integers(20, 121, RS // S))
    sstart = t(rng.integers(0, 80, RS))
    totals = {"zeros": 3 * K // 4, "total_0": 0, "total_gt_K": 5 * K // 4,
              "total_eq_K": K, "one_lane": K}
    cases = []
    for edge in edges:
        if edge == "one_lane":
            cnt = np.zeros(RS, np.int64)
            cnt[rng.integers(0, RS)] = K
        else:
            live = rng.choice(RS, 2 * RS // 3, replace=False)
            cnt = np.bincount(live[rng.integers(0, len(live), totals[edge])],
                              minlength=RS).astype(np.int64)
        l = rng.integers(0, n + 1 - np.minimum(cnt, n))
        cases.append((f"{name}_{edge}", "expand_decode",
                      (didx, t(l), t(np.cumsum(cnt)), sstart, olens, S, K)))
    return cases


# the DP seeding's interval widths at the edges of its 64 slots a lane
SEED_WIDTHS = (0, 1, 63, 64, 65, 200)
SEED_EDGES = ("widths", "total_gt_K", "total_eq_K", "total_0")


def seed_expand_cases(rng, didx, dev, RS: int, S: int, name: str = "seed",
                      edges=SEED_EDGES, occ_cap: int = 64, read_end: int = 74
                      ) -> list[tuple[str, str, tuple]]:
    """FS2's seed_expand_decode at the edges of the DP seeding's
    expansion, RS lanes (RS / S rows of S seeds): interval widths of
    SEED_WIDTHS (min(width, occ_cap) slots each) anywhere in the SA,
    seeds at read offset 0, at the read's end (``read_end``: a 26-base
    seed of a 100-base read) and between; K past the total ("widths"),
    below it, equal to it, and a total of 0."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n = didx.n
    width = rng.choice(SEED_WIDTHS, RS)
    sp = rng.choice([0, read_end, -1], RS)
    sp = np.where(sp < 0, rng.integers(1, read_end, RS), sp)
    l = rng.integers(0, n + 1 - width)
    cases = []
    for edge in edges:
        cnt = np.minimum(width, occ_cap) * (edge != "total_0")
        total = int(cnt.sum())
        K = {"widths": total + total // 4 + 1, "total_gt_K": 3 * total // 4,
             "total_eq_K": total, "total_0": 1024}[edge]
        cases.append((f"{name}_{edge}", "seed_expand_decode",
                      (didx, t(l), t(np.cumsum(cnt)), t(sp), S, K)))
    return cases


def _slot_of(krow: np.ndarray, ktp: np.ndarray, hb: int) -> np.ndarray:
    """The dedupe's table slot of each key (fmindex.dedupe_plain)."""
    m = np.uint64(0xFFFFFFFF)
    h = (((krow.astype(np.uint64) * np.uint64(0x9E3779B1)) & m)
         ^ ((ktp.astype(np.uint64) * np.uint64(0x85EBCA77)) & m))
    return ((h * np.uint64(0xC2B2AE3D)) & m) >> np.uint64(32 - hb)


def dedupe_keys(rng, K: int, distinct: int, ok_share: float = 0.9):
    """K placement keys as FS2x writes them: (row, tp) drawn from
    ``distinct`` keys (so most recur), pos_ok for ``ok_share`` of the
    slots, the sentinel elsewhere."""
    rows = rng.integers(0, 1 << 20, distinct)
    tps = rng.integers(0, 1 << 32, distinct)
    pick = rng.integers(0, distinct, K)
    ok = rng.random(K) < ok_share
    sentinel = 0xFFFFFFFF
    return (np.where(ok, rows[pick], sentinel),
            np.where(ok, tps[pick], sentinel), ok)


def collision_keys(rng, K: int = 512, groups: int = 40):
    """K keys (a 1,024-slot table) with forced collisions: ``groups``
    pairs of distinct keys A, B that share a table slot (found by brute
    force), placed A, B, B in slot order, so A wins the slot and both
    B's survive; random keys between them."""
    hb = max((K - 1).bit_length() + 1, 10)
    pool_r = rng.integers(0, 1 << 20, 20000)
    pool_t = rng.integers(0, 1 << 32, 20000)
    slot = _slot_of(pool_r, pool_t, hb)
    order = np.argsort(slot, kind="stable")
    same = np.flatnonzero(np.diff(slot[order]) == 0)
    pairs = order[np.stack([same, same + 1], axis=1)]
    pairs = pairs[np.unique(slot[pairs[:, 0]], return_index=True)[1]]
    pairs = pairs[rng.permutation(len(pairs))[:groups]]
    krow, ktp, ok = dedupe_keys(rng, K, K // 2, 0.7)
    at = np.sort(rng.choice(K, 3 * len(pairs), replace=False)).reshape(-1, 3)
    for (a, b), (i, j, k) in zip(pairs, at):
        krow[[i, j, k]] = pool_r[[a, b, b]]
        ktp[[i, j, k]] = pool_t[[a, b, b]]
        ok[[i, j, k]] = True
    return krow, ktp, ok


def dedupe_cases(rng, dev, path_args=None, K: int = 524288,
                 big: int = 1 << 22) -> list[tuple[str, str, tuple]]:
    """FS4 at its edges: the path's keys (``path_args``, else K keys of
    dedupe_keys) with K2 half the firsts (uniq > K2: the regrowth of
    PendingSearch) and equal to them; no pos_ok at all; K at the
    table's 1,024-slot floor with forced collisions (collision_keys);
    and a K of ``big``."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if path_args is None:
        krow, ktp, ok = dedupe_keys(rng, K, K // 3)
        path_args = (t(krow), t(ktp), t(ok), K // 2)
    krow, ktp, ok = path_args[:3]
    uniq = int(fmindex.dedupe_plain(*path_args)[3])
    none = torch.full_like(krow, 0xFFFFFFFF)
    cases = [("dedupe_uniq_gt_K2", "dedupe", (krow, ktp, ok, uniq // 2)),
             ("dedupe_uniq_eq_K2", "dedupe", (krow, ktp, ok, uniq)),
             ("dedupe_no_pos_ok", "dedupe",
              (none, none, torch.zeros_like(ok), path_args[3])),
             ("dedupe_collide_1024", "dedupe",
              tuple(map(t, collision_keys(rng))) + (256,))]
    cases.append((f"dedupe_K_{big}", "dedupe",
                  tuple(map(t, dedupe_keys(rng, big, big // 3))) + (big // 2,)))
    return cases


def block_edge_cases(rng, dev, m: int = 1000, B: int = 256, L: int = 100
                     ) -> list[tuple[str, str, tuple]]:
    """The occ blocks' edges on three small indexes (sa_rate 4, lut_k 8)
    whose last block holds 4, 2 or 3 BWT words (nw % 4 of 0, 2, 3; phase
    4's index has 1): FS2 over every SA row (every block edge and the
    sentinel's block), expand_decode with one slot a row, and FS1's
    general branch over reads cut from the genome."""
    import torch

    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.index.builder import build_index

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    S = 3
    cases = []
    for r in (0, 2, 3):
        n = 16 * (4 * m + r - 1) + 5
        genome = workloads.random_genome(rng, n, name="chrB")
        didx = fmindex.device_index(build_index(genome, sa_rate=4, lut_k=8),
                                    dev)
        rows = torch.arange(n + 1, device=dev)
        ones = torch.ones_like(rows)
        cases.append((f"blocks_nw{r}_decode", "sa_decode",
                      (didx, rows, ones.bool())))
        cases.append((f"blocks_nw{r}_expand", "expand_decode",
                      (didx, rows, torch.cumsum(ones, 0),
                       torch.zeros_like(rows), ones, 1, n + 1)))
        reads, lens = sample_reads(rng, genome.codes, B, L)
        ori = fmindex.OrientedReads.of(t(reads), t(lens), L)
        start = t(rng.integers(0, L, 2 * B * S))
        length = t(rng.integers(0, 41, 2 * B * S))
        cases.append((f"blocks_nw{r}_search", "seed_intervals",
                      (didx, ori, S, start, length, 40, "general")))
        # on a 64 kbp text, seeds at the read's end often decode below
        # their start
        cases += seed_expand_cases(rng, didx, dev, 2 * B * S, S,
                                   f"blocks_nw{r}_seed", ("widths",))
    return cases


# reverse-complement lengths at the edges of FS3's two-word window (one
# base, either side of one and two words) and L
RC_EDGES = (1, 15, 16, 17, 31, 32)


def fs_verify_cases(rng, didx, codes: np.ndarray, dev, B: int = 256,
                    L: int = 100, M: int = 8192
                    ) -> list[tuple[str, str, tuple]]:
    """FS3 at its edges: placements at packed-word boundaries (tp a
    multiple of 16: no funnel shift), in the genome's last word and past
    its end (the pac index clamped), and random, of forward and
    reverse-complement rows of variable length (code bytes and packed
    words), reverse complements of RC_EDGES and L bases each placed at
    least once, a uniform-length batch of reads shorter than L, packed
    rows of 256 and 300 bases, and the public count_mismatches_packed on
    (M, W) words."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.fm.search import pack_read_matrix

    n = didx.n
    lens = rng.integers(1, L + 1, B)
    edges = (L,) + RC_EDGES
    lens[:len(edges)] = edges
    reads, lens = sample_reads(rng, codes, B, L, lens)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rows = rng.integers(0, 2 * B, M)
    rows[8:8 + 2 * len(edges)] = np.concatenate(
        [np.arange(len(edges)), B + np.arange(len(edges))])
    olens = np.concatenate([lens, lens])
    tp = rng.integers(0, n, M)
    tp[: M // 4] = rng.integers(0, n // 16, M // 4) * 16
    tp[M // 4: M // 4 + 64] = n - olens[rows[M // 4: M // 4 + 64]]
    tp[M // 4 + 64: M // 4 + 128] = n - rng.integers(1, 40, 64)
    # the last word (its 16 positions) and those just before it
    tp[M // 4 + 128: M // 4 + 192] = (n // 16) * 16 + rng.integers(-16, 16, 64)
    tp[:8] = [0, 16, 15, 17, n - 16, n - 1, (n // 16) * 16, n - 100]
    cases = []
    packed = pack_read_matrix(reads).view(np.int32)
    for src, reads_t in (("codes", t(reads)), ("packed", t(packed))):
        ori = fmindex.OrientedReads.of(reads_t, t(lens), L)
        cases.append((f"verify_{src}", "count_mismatches_rows",
                      (didx, t(tp), ori, t(rows), t(olens[rows]))))
    words = fmindex.pack_reads(ori.matrix)[t(rows)]
    # reads of 90 bases in 100-wide rows, their reverse complements of
    # revcomp_reads_uniform
    uni, ulens = sample_reads(rng, codes, B, L, np.full(B, L - 10))
    ori_u = fmindex.OrientedReads.of(t(pack_read_matrix(uni).view(np.int32)),
                                     t(ulens), L, uniform_len=L - 10)
    cases.append(("verify_uniform", "count_mismatches_rows",
                  (didx, t(tp), ori_u, t(rows), t(np.full(M, L - 10)))))
    # the kernel's other widths, packed: 256-base rows (16 words, the
    # unrolled form's widest) and 300 (the runtime-width form)
    for Lx in (256, 300):
        lx = rng.integers(1, Lx + 1, B)
        lx[:len(edges)] = (Lx,) + RC_EDGES
        rx, lx = sample_reads(rng, codes, B, Lx, lx)
        ori_x = fmindex.OrientedReads.of(
            t(pack_read_matrix(rx).view(np.int32)), t(lx), Lx)
        cases.append((f"verify_L{Lx}", "count_mismatches_rows",
                      (didx, t(tp), ori_x, t(rows),
                       t(np.concatenate([lx, lx])[rows]))))
    cases.append(("api_count_mismatches_packed", "count_mismatches_packed",
                  (didx, t(tp), words, t(olens[rows]))))
    return cases


def synthetic_table_sizes(n: int, sa_rate: int, lut_k: int) -> dict:
    """Elements of each table of an n-base index: 16 bases a BWT and a
    genome word (row n + 1 skips the sentinel to BWT position n), 8 an
    occ block of 4 BWT words, 32 rows a mark word and its rank, one
    sample every sa_rate rows, 4^lut_k LUT entries."""
    nw = n // 16 + 1
    return {"occ_blocks": 8 * -(-nw // 4), "mark_words": n // 32 + 1,
            "mark_rank": n // 32 + 1, "sa_samples": n // sa_rate + 1,
            "pac": n // 16 + 1, "lut_lo": 4 ** lut_k, "lut_hi": 4 ** lut_k}


def synthetic_index(dev, n: int, sa_rate: int = 8, lut_k: int = 13,
                    seed: int = 31):
    """A DeviceIndex of an n-base text with every table at its true size
    for ``sa_rate`` and ``lut_k`` (random content, made on ``dev``),
    its values in range: counts C[c] = 1 + c n/4 and occ-block counts
    below n/4 - 64, so every FM bound and LF row (an occ block's count
    plus up to 63 matches) stays in [0, n]; LUT intervals of up to 64
    rows; samples anywhere in [0, 2^32). At n = 3.2e9 (a human genome)
    rows, bounds and positions pass 2^31."""
    import torch

    from soap3dp_tpu_torch.fm.fmindex import DeviceIndex

    g = torch.Generator(device=dev).manual_seed(seed)
    q = n // 4
    size = synthetic_table_sizes(n, sa_rate, lut_k)
    nb, nmw, n_sa = size["occ_blocks"] // 8, size["mark_words"], \
        size["sa_samples"]

    def bits(size):
        return torch.randint(-(1 << 31), 1 << 31, (size,), generator=g,
                             dtype=torch.int32, device=dev)

    def below(hi, size):
        """Values in [0, hi) as int32 bit patterns of the uint32 tables."""
        if hi <= 1 << 31:
            return torch.randint(0, hi, (size,), generator=g,
                                 dtype=torch.int32, device=dev)
        x = torch.randint(0, hi, (size,), generator=g, dtype=torch.int64,
                          device=dev)
        return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)

    lut_lo = below(n - 64, 4 ** lut_k)
    lut_hi = (lut_lo.long() & 0xFFFFFFFF) + torch.randint(
        0, 65, (4 ** lut_k,), generator=g, device=dev)
    lut_hi = ((lut_hi + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
    occ_blocks = torch.cat([below(q - 64, 4 * nb).view(nb, 4),
                            bits(4 * nb).view(nb, 4)], dim=1)
    return DeviceIndex(
        occ_blocks=occ_blocks, mark_rank=below(n_sa, nmw),
        mark_words=bits(nmw), sa_samples=bits(n_sa),
        counts=torch.tensor([1, 1 + q, 1 + 2 * q, 1 + 3 * q, n + 1],
                            dtype=torch.int64, device=dev),
        pac=bits(size["pac"]), lut_lo=lut_lo, lut_hi=lut_hi,
        primary=n // 3, n=n, sa_rate=sa_rate, lut_k=lut_k)


def synthetic_cases(rng, didx, dev, B: int = 4096, L: int = 100
                    ) -> list[tuple[str, str, tuple]]:
    """All three kernels on a synthetic_index: random packed reads and
    their reverse complements, segments in each FS1 mode (LUT intervals
    anywhere in [0, n]), SA rows and placements over the whole text, a
    quarter of them past 2^31 or in the text's last words."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    n, k = didx.n, didx.lut_k

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    words = rng.integers(-(1 << 31), 1 << 31, (B, (L + 15) // 16),
                         dtype=np.int64).astype(np.int32)
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    ori = fmindex.OrientedReads.of(t(words), t(lens), L)
    S = 4
    N = 2 * B * S
    cases = []
    for mode, top, steps in (("lut", k + 16, 0), ("packed", k + 16, 16),
                             ("general", 40, 40)):
        start = t(rng.integers(0, L, N))
        length = t(rng.integers(0, top + 1, N))
        cases.append((f"synthetic_{mode}", "seed_intervals",
                      (didx, ori, S, start, length, steps, mode)))
    cases.append(fs_decode_case(rng, "synthetic_decode", didx, dev))
    M = 65536
    tp = rng.integers(0, n, M)
    tp[: M // 4] = rng.integers(min(1 << 31, n // 2), n, M // 4)
    tp[M // 4: M // 4 + 64] = n - rng.integers(1, 200, 64)
    rows = rng.integers(0, 2 * B, M)
    olens = np.concatenate([lens, lens])
    cases.append(("synthetic_verify", "count_mismatches_rows",
                  (didx, t(tp), ori, t(rows), t(olens[rows]))))
    return cases


def repeat_genome(rng, genome_bp: int, unit: int, copies: int,
                  sub: float = 0.002):
    """(genome, repeat starts): a random genome with ``copies`` copies of
    one random ``unit``-base sequence pasted at random non-overlapping
    places, each copy with ``sub`` of its bases substituted."""
    import dataclasses

    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.utils import dna

    genome = workloads.random_genome(rng, genome_bp, name="chrR")
    codes = genome.codes
    rep = rng.integers(0, 4, unit).astype(np.uint8)
    starts = np.sort(rng.choice(genome_bp // unit - 1, copies,
                                replace=False)) * unit
    for s in starts:
        c = rep.copy()
        m = rng.random(unit) < sub
        c[m] = (c[m] + rng.integers(1, 4, int(m.sum()))) % 4
        codes[s:s + unit] = c
    return dataclasses.replace(genome, codes=codes,
                               pac=dna.pack_codes(codes)), starts


class _Recorder:
    """Within ``with``: every call of an fmindex entry point of the three
    kernels (FS_FUNCTIONS) is recorded, (name, args), and goes through;
    every call of a plain search primitive whose index lies on a card is
    counted in ``plain_on_card``, every call of the plain prescan
    (dp_rescue._prescan_plain) with CUDA tensors in
    ``prescan_plain_on_card`` and of the plain pack
    (dp_rescue._pack_problems_plain) in ``pack_plain_on_card`` (a CUDA
    tensor never takes a plain version)."""

    def __init__(self, record: bool = True):
        self.record = record
        self.calls: list[tuple[str, tuple]] = []
        self.plain_on_card = 0
        self.prescan_plain_on_card = 0
        self.pack_plain_on_card = 0
        self._saved = {}

    def __enter__(self):
        from soap3dp_tpu_torch.fm import fmindex
        from soap3dp_tpu_torch.pipeline import dp_rescue

        plain = self._prescan_plain = dp_rescue._prescan_plain

        def prescan_plain(*args, **kw):
            self.prescan_plain_on_card += args[1].device.type == "cuda"
            return plain(*args, **kw)

        dp_rescue._prescan_plain = prescan_plain
        pack = self._pack_plain = dp_rescue._pack_problems_plain

        def pack_plain(*args, **kw):
            self.pack_plain_on_card += args[1].device.type == "cuda"
            return pack(*args, **kw)

        dp_rescue._pack_problems_plain = pack_plain
        for name in FS_FUNCTIONS:
            for fn_name in ((name, plain_of(name)) if self.record
                            else (plain_of(name),)):
                fn = getattr(fmindex, fn_name)
                self._saved[fn_name] = fn
                setattr(fmindex, fn_name, self._wrap(fn_name, fn))
        return self

    def _wrap(self, fn_name, fn):
        def call(*args, **kw):
            if fn_name.endswith("_plain"):
                if args[0].device.type == "cuda":
                    self.plain_on_card += 1
            else:
                self.calls.append((fn_name, args))
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        from soap3dp_tpu_torch.fm import fmindex
        from soap3dp_tpu_torch.pipeline import dp_rescue

        dp_rescue._prescan_plain = self._prescan_plain
        dp_rescue._pack_problems_plain = self._pack_plain
        for fn_name, fn in self._saved.items():
            setattr(fmindex, fn_name, fn)
        return False


def _gathered(gathers: dict) -> tuple[int, int]:
    """(bytes, sectors) of the distinct 4-byte table elements in
    ``gathers`` (table name -> the element indices of every lane and
    step): an element that several lanes or steps read counts once, and
    so does each 32-byte sector holding one (every table starts on a
    sector: the allocator aligns each tensor)."""
    import torch

    nbytes = sectors = 0
    for parts in gathers.values():
        u = torch.unique(torch.cat([p.reshape(-1) for p in parts]))
        nbytes += 4 * u.numel()
        sectors += SECTOR * torch.unique(u // (SECTOR // 4)).numel()
    return nbytes, sectors


def _fs1_lanes(fn: str, args: tuple) -> tuple:
    """An FS1 call as (code rows (R, L) int64, each lane's row, start,
    length, max_steps, mode) and the bytes of its inputs and outputs,
    each read or written once (the C array's 40 included)."""
    import torch

    if fn == "seed_intervals":
        ori, S, start, length, steps, mode = args[1:]
        codes = ori.matrix
        rows = torch.arange(codes.shape[0],
                            device=codes.device).repeat_interleave(S)
        src = (ori.reads.numel() * ori.reads.element_size()
               + ori.rc_len.numel() * 8)
    elif fn == "backward_search":
        codes, start, length, steps = args[1:]
        rows = torch.arange(codes.shape[0], device=codes.device)
        mode, src = "general", codes.numel() * codes.element_size()
    else:
        roll16, rows, start, length, steps = args[1:]
        codes = (roll16 >> 30) & 3
        mode, src = "packed", roll16.numel() * 8 + rows.numel() * 8
    lanes = (codes.long(), rows.long(), start.long(), length.long(), steps,
             mode)
    return lanes, start.shape[0] * 32 + src + 40


def fs1_replay(idx, codes, rows, start, length, max_steps: int, mode: str):
    """FS1 lane by lane over its code rows, as the kernel walks them:
    (l, r), the FM steps the lanes take (a lane stops at an empty
    interval or at the end of its segment) and the LUT elements they
    gather, the occ and BWT elements a step of l and r reads in the
    separate tables ("occ", "bwt") and the occ blocks the kernel reads
    ("occ_blocks", element 8j for block j), each branch with its edges
    (fs_search_cases)."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    last = codes.shape[1] - 1
    k = idx.lut_k

    def word16(p):
        """The 16 bases from p of each lane's row, MSB first, A past L."""
        w = torch.zeros_like(p)
        for j in range(16):
            q = p + j
            w |= torch.where(q <= last, codes[rows, q.clamp(max=last)],
                             0) << (2 * (15 - j))
        return w

    if mode == "general":
        m = torch.zeros_like(start)
        for j in range(k):
            m = (m << 2) | codes[rows, (start + length - k + j).clamp(0, last)]
    else:
        p = start if mode == "lut" else start + length - k
        m = word16(p.clamp(0, last)) >> (2 * (16 - k))
    can = length >= k if mode != "lut" else torch.ones_like(length, dtype=bool)
    zero = torch.zeros_like(start)
    l = torch.where(can, fmindex._u32(idx.lut_lo[m]), zero)
    r = torch.where(can, fmindex._u32(idx.lut_hi[m]), zero + idx.n + 1)
    gathers = {"lut_lo": [m[can]], "lut_hi": [m[can]], "occ": [zero[:0]],
               "bwt": [zero[:0]], "occ_blocks": [zero[:0]]}
    steps = 0
    if mode == "lut":
        return l, r, steps, gathers
    rem = torch.where(can, length - k, length)
    wext = word16(start.clamp(0, last))
    for s in range(max_steps):
        act = (s < rem) & (l < r)
        if mode == "packed":
            c = (wext >> (2 * (15 - (rem - 1 - s).clamp(0, 15)))) & 3
        else:
            c = codes[rows, (start + rem - 1 - s).clamp(0, last)]
        for bound in (l, r):
            kp = (bound - (bound > idx.primary).long())[act]
            gathers["bwt"].append(kp >> 4)
            gathers["occ"].append(4 * (kp >> 4) + c[act])
            gathers["occ_blocks"].append(8 * (kp >> 6))
        steps += int(act.sum())
        l2, r2 = fmindex.backward_extend(idx, l, r, c)
        l, r = torch.where(act, l2, l), torch.where(act, r2, r)
    return l, r, steps, gathers


def fs2_replay(idx, rows, valid):
    """FS2 row by row, as the kernel walks it: each valid row's text
    position, the mark probes and LF steps the valid rows take (a row
    stops at its first marked row), and the mark, rank and sample
    elements they gather (the samples of a split table are the owner
    routing's, not the kernel's), with the occ and BWT elements of each
    LF step in the separate tables and the occ block the kernel reads
    (as fs1_replay)."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    u32 = fmindex._u32
    rows = rows.long()[valid]
    zero = torch.zeros_like(rows)
    gathers = {key: [zero[:0]] for key in ("mark_words", "mark_rank", "occ",
                                           "bwt", "occ_blocks", "sa_samples")}
    probes = lf = 0
    rank, t_hit = rows, zero
    if idx.sa_rate > 1:
        done = torch.zeros_like(rows, dtype=bool)
        mw_hit = below_hit = zero
        for t in range(idx.sa_rate):
            live = ~done
            mw, bsel = rows >> 5, rows & 31
            gathers["mark_words"].append(mw[live])
            probes += int(live.sum())
            word = u32(idx.mark_words[mw])
            newly = live & (((word >> bsel) & 1) == 1)
            below = fmindex.popcount32(word & torch.where(
                bsel == 0, zero, fmindex.MASK32 >> (32 - bsel)))
            mw_hit = torch.where(newly, mw, mw_hit)
            below_hit = torch.where(newly, below, below_hit)
            t_hit = torch.where(newly, zero + t, t_hit)
            done = done | newly
            if t == idx.sa_rate - 1:
                break
            live = ~done
            kp = rows - (rows > idx.primary).long()
            w, q = kp >> 4, kp & 15
            word_b = u32(idx.occ_blocks[kp >> 6, 4 + (w & 3)])
            c = (word_b >> (2 * q)) & 3
            gathers["bwt"].append(w[live])
            gathers["occ"].append((4 * w + c)[live])
            gathers["occ_blocks"].append(8 * (kp >> 6)[live])
            lf += int(live.sum())
            rows = torch.where(live, fmindex.lf_step(idx, rows), rows)
        gathers["mark_rank"].append(mw_hit)
        rank = u32(idx.mark_rank[mw_hit]) + below_hit
    if not idx.sa_parts:
        gathers["sa_samples"].append(
            rank.clamp(max=idx.sa_samples.shape[0] - 1))
    out = torch.zeros(valid.shape[0], dtype=torch.int64, device=rows.device)
    out[valid] = (fmindex._sa_value(idx, rank) + t_hit) & fmindex.MASK32
    return out, probes, lf, gathers


def fs2x_replay(idx, l, incl, sstart, olens, S: int, K: int):
    """FS2's expand_decode slot by slot, as the kernel walks it: each
    slot below the total count finds its lane (the first whose inclusive
    count exceeds it) and walks its row (fs2_replay); returns the dedupe
    keys (krow, ktp, pos_ok), the probes and LF steps, the gathers, the
    slots walked, the distinct lanes and rows they read and the binary
    search's levels."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    RS = l.shape[0]
    k = torch.arange(min(K, int(incl[-1])), device=l.device)
    lane = torch.searchsorted(incl, k, right=True)
    off = torch.where(lane > 0, incl[(lane - 1).clamp(min=0)], 0)
    valid = torch.ones_like(k, dtype=torch.bool)
    pos, probes, lf, gathers = fs2_replay(idx, l[lane] + k - off, valid)
    out = fmindex._placements(idx, valid, pos, lane, sstart, olens, S)
    keys = [torch.full((K,), fmindex.SENTINEL, dtype=torch.int64,
                       device=l.device) for _ in range(2)]
    keys.append(torch.zeros(K, dtype=torch.bool, device=l.device))
    for full, part in zip(keys, out):
        full[:k.shape[0]] = part
    lanes = torch.unique(lane)
    return (tuple(keys), probes, lf, gathers, k.shape[0], lanes.numel(),
            torch.unique(lanes // S).numel(), max(RS - 1, 1).bit_length())


def fs2s_replay(idx, l, incl, sp, S: int, K: int):
    """FS2's seed_expand_decode slot by slot, as the kernel walks it (the
    lanes found as fs2x_replay finds them); returns the candidates (row,
    pos, valid), the probes and LF steps, the gathers, the slots walked,
    the distinct lanes they read, the binary search's levels and the
    walked slots whose position lies below their seed's start."""
    import torch

    RS = l.shape[0]
    k = torch.arange(min(K, int(incl[-1])), device=l.device)
    lane = torch.searchsorted(incl, k, right=True)
    off = torch.where(lane > 0, incl[(lane - 1).clamp(min=0)], 0)
    pos, probes, lf, gathers = fs2_replay(
        idx, l[lane] + k - off, torch.ones_like(k, dtype=torch.bool))
    st = sp[lane]
    ok = pos >= st
    out = [torch.zeros(K, dtype=torch.int64, device=l.device)
           for _ in range(2)]
    out.append(torch.zeros(K, dtype=torch.bool, device=l.device))
    out[0][:k.shape[0]] = lane // S
    out[1][:k.shape[0]] = torch.where(ok, pos - st, 0)
    out[2][:k.shape[0]] = ok
    return (tuple(out), probes, lf, gathers, k.shape[0],
            torch.unique(lane).numel(), max(RS - 1, 1).bit_length(),
            int((~ok).sum()))


def dedupe_work(krow, ktp, pos_ok, K2: int, want) -> dict:
    """FS4's counts: the table's size (hb), the firsts (uniq), the
    pos_ok slots whose table slot another key won ("collided") and the
    firsts of a key already among the earlier firsts ("surviving_dups":
    same-key losers of a slot another key won, which the host's
    hits_to_table removes)."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    K = krow.shape[0]
    hb = max((K - 1).bit_length() + 1, 10)
    slot = fmindex.mul32(fmindex.mul32(krow, 0x9E3779B1)
                         ^ fmindex.mul32(ktp, 0x85EBCA77),
                         0xC2B2AE3D) >> (32 - hb)
    idxs = torch.arange(K, device=krow.device)
    win = torch.full((1 << hb,), K, dtype=torch.int64, device=krow.device)
    win.scatter_reduce_(0, slot, torch.where(pos_ok, idxs, K), "amin")
    w = win[slot].clamp(max=K - 1)
    collided = int((pos_ok & ((krow[w] != krow) | (ktp[w] != ktp))).sum())
    urow, utp, uvalid, uniq = want
    firsts = (urow * (1 << 32) + utp)[uvalid]
    return {"slots": K, "K2": K2, "hb": hb, "pos_ok": int(pos_ok.sum()),
            "uniq": int(uniq), "collided": collided,
            "surviving_dups": firsts.numel() - torch.unique(firsts).numel()}


def _split_tables(gathers: dict) -> tuple[dict, dict]:
    """(the gathers from the reference's tables, occ and BWT separate;
    the gathers from the occ blocks in their place)."""
    ref = {k: v for k, v in gathers.items() if k != "occ_blocks"}
    blocks = {k: v for k, v in gathers.items() if k not in ("occ", "bwt")}
    return ref, blocks


def fs_work(fn: str, args: tuple, want) -> dict:
    """The operations, bytes and 32-byte sectors the call needs on this
    run's data: each input element read once and each output written
    once (as bytes), and each distinct table element the lanes gather
    once (bytes: 4 an element; sectors: 32 a distinct sector) in the
    reference's tables (occ and BWT separate), and
    the distinct 32-byte sectors the kernel's walk touches with the occ
    blocks in their place ("block_sectors"). FS1 and FS2 count from
    their replay (fs1_replay, fs2_replay, fs2x_replay, fs2s_replay),
    which must give the plain version's output ``want``; FS3 the genome
    words up to each read's length; FS4 its keys (8 + 8 + 1 B each), its
    table written and read once (4 B a slot each way) and its K2
    outputs (17 B each) and count."""
    import torch

    idx = args[0]
    label = FS_FUNCTIONS[fn]
    if label == "FS1":
        lanes, io = _fs1_lanes(fn, args)
        l, r, steps, gathers = fs1_replay(idx, *lanes)
        if not (torch.equal(l, want[0].long())
                and torch.equal(r, want[1].long())):
            fail(f"FS1's replay disagrees with {fn}_plain")
        N = l.shape[0]
        ops = N * OPS_FM_LANE + steps * OPS_FM_STEP
        counts = {"lanes": N, "steps": steps}
    elif label == "FS2":
        rows, valid = args[1], args[2]
        out, probes, lf, gathers = fs2_replay(idx, rows, valid)
        if not torch.equal(out, want.long()):
            fail(f"FS2's replay disagrees with {fn}_plain")
        N = rows.shape[0]
        io = N * (17 + (8 if idx.sa_parts else 0)) + 40
        ops = probes * OPS_SA_PROBE + lf * OPS_SA_LF
        counts = {"rows": N, "lf_steps": lf}
    elif label == "FS2x":
        l, incl, sstart, olens, S, K = args[1:]
        out, probes, lf, gathers, walked, lanes, rows, levels = fs2x_replay(
            idx, l.long(), incl.long(), sstart.long(), olens.long(), S, K)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail(f"FS2's expansion replay disagrees with {fn}_plain")
        RS = l.shape[0]
        # the cumsum once (its last element alone when no slot is
        # walked); l and sstart once a walked lane, olens once a walked
        # row (the split entry reads l alone); the three keys (or lane,
        # rank and step) once a slot
        io = ((RS * 8 if walked else 8) + 40
              + (lanes * 8 if idx.sa_parts else lanes * 16 + rows * 8)
              + K * (24 if idx.sa_parts else 17))
        ops = (probes * OPS_SA_PROBE + lf * OPS_SA_LF
               + walked * (4 * levels + OPS_SA_PROBE))
        counts = {"slots": K, "lanes": RS, "walked": walked, "lf_steps": lf}
    elif label == "FS2s":
        l, incl, sp, S, K = args[1:]
        out, probes, lf, gathers, walked, lanes, levels, below = fs2s_replay(
            idx, l.long(), incl.long(), sp.long(), S, K)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail(f"FS2's seeding replay disagrees with {plain_of(fn)}")
        RS = l.shape[0]
        # the cumsum once (its last element alone when no slot is
        # walked); l and sp once a walked lane (the split entry reads l
        # alone); the three outputs (or lane, rank and step) once a slot
        io = ((RS * 8 if walked else 8) + 40
              + lanes * (8 if idx.sa_parts else 16)
              + K * (24 if idx.sa_parts else 17))
        ops = (probes * OPS_SA_PROBE + lf * OPS_SA_LF
               + walked * (4 * levels + OPS_SA_PROBE))
        counts = {"slots": K, "lanes": RS, "walked": walked, "lf_steps": lf,
                  "below_start": below}
    elif label == "FS4":
        krow, ktp, pos_ok, K2 = args
        counts = dedupe_work(krow, ktp, pos_ok, K2, want)
        io = 17 * counts["slots"] + 8 * (1 << counts["hb"]) + 17 * K2 + 8
        ops = counts["slots"] * OPS_DEDUPE_SLOT
        gathers = {}
    else:
        tp, M = args[1].long(), args[1].shape[0]
        if fn == "count_mismatches_rows":
            ori, lens = args[2], args[4]
            W = (ori.L + 15) // 16
            io = (M * 32 + ori.reads.numel() * ori.reads.element_size()
                  + ori.rc_len.numel() * 8)
        else:
            lens, W = args[3], args[2].shape[1]
            io = M * 24 + args[2].numel() * 8
        nwords = (lens.long().clamp(0, 16 * W) + 15) // 16
        j = torch.arange(W + 1, device=tp.device)
        span = (j[None, :] <= nwords[:, None]) & (nwords[:, None] > 0)
        pac = ((tp >> 4)[:, None] + j).clamp(0, idx.pac.shape[0] - 1)
        gathers = {"pac": [pac[span]]}
        words = int(nwords.sum())
        ops = words * OPS_VERIFY_WORD
        counts = {"placements": M, "words": words}
    ref, blocks = _split_tables(gathers)
    nbytes, sectors = _gathered(ref)
    _, block_sectors = _gathered(blocks)
    return {"ops": ops, "bytes": io + nbytes, "sectors": io + sectors,
            "block_sectors": io + block_sectors, **counts}


def _fs_diff(got, want) -> tuple[int, int]:
    """(max |difference|, elements differing) of two outputs (a tensor
    or a tuple of tensors), shapes and dtypes included."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = ndiff = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            return 1 << 62, max(a.numel(), b.numel())
        if a.numel():
            d = (a.long() - b.long()).abs()
            err = max(err, int(d.max()))
            ndiff += int((d != 0).sum())
    return err, ndiff


# the kernels' symbols, as torch.profiler names their device events (a
# part of the name every kernel of the call holds), and the kernels a
# call launches: FS4 is five (dedupe_clear, _scatter, _first, _scan,
# _write)
FS_SYMBOLS = {"FS1": "fm_search_kernel", "FS2": "sa_decode_kernel",
              "FS2x": "expand_decode_kernel", "FS2s": "seed_expand_kernel",
              "FS3": "verify_kernel", "FS4": "dedupe_"}
FS_KERNELS_PER_CALL = {"FS4": 5}


def _kernel_device_ms(fn, reps: int, symbol: str, per_call: int = 1
                      ) -> float:
    """Mean device duration of a call's ``per_call`` kernels named
    ``symbol`` over ``reps`` calls of ``fn`` (torch.profiler's device
    events; a call of tens of microseconds is shorter than its wrapper's
    host work, so CUDA events around a loop of calls would time the
    host). A profile now and then holds no device event, and a run of
    them has held none three times in a row: up to PROFILE_TRIES
    profiles, each of twice the last one's calls, a pause between. NaN
    if none holds such an event. In a long run most profiles hold only
    some of the calls' events, and one that lost some once held cut
    ones (a PK case read half its time): a call of one kernel takes the
    median of the events held, of several kernels their mean times
    ``per_call``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps << t):
                fn()
            torch.cuda.synchronize()
        durs = [b - a for a, b, n in _device_spans(prof) if symbol in n]
        if durs:
            mid = np.median(durs) if per_call == 1 else np.mean(durs)
            return float(mid) * per_call / 1e3
        time.sleep(0.5)
    return float("nan")


def run_fs_case(name: str, fn: str, args: tuple, peak_ops: float,
                reps: int = 20) -> dict:
    """One FS case on the card: the kernel's output against the plain
    version's, every element; the kernel's device time (torch.profiler,
    _timed) and its call's (CUDA events around a loop of wrapper calls, host
    work included), the plain version's, the bound (operations over the
    int32 peak or bytes over the memory rate, the larger), the same
    bound with every scattered gather a 32-byte sector, and with the
    sectors the kernel's walk touches in the occ blocks."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    kern, plain = getattr(fmindex, fn), getattr(fmindex, plain_of(fn))
    label = FS_FUNCTIONS[fn]
    counter = _kernels()[label]
    t0 = time.perf_counter()
    n0, shapes0 = counter.launches, dict(counter.shapes)
    got = kern(*args)
    torch.cuda.synchronize()
    launched = counter.launches - n0
    shape = [s for s, c in counter.shapes.items() if c > shapes0.get(s, 0)]
    want = plain(*args)
    err, ndiff = _fs_diff(got, want)
    ms, call_ms, timer = _timed(lambda: kern(*args), reps,
                                FS_SYMBOLS[label],
                                FS_KERNELS_PER_CALL.get(label, 1))
    plain_ms = _events_ms(lambda: plain(*args), max(1, reps // 10))
    work = fs_work(fn, args, want)
    counts = {k: v for k, v in work.items()
              if k not in ("ops", "bytes", "sectors", "block_sectors")}
    bms, by = bound_ms(work["ops"], work["bytes"], peak_ops)
    sms = max(work["ops"] / peak_ops * 1e3,
              work["sectors"] / HBM_BYTES_PER_S * 1e3)
    bsms = max(work["ops"] / peak_ops * 1e3,
               work["block_sectors"] / HBM_BYTES_PER_S * 1e3)
    shape_s = "x".join(map(str, shape[0])) if shape else "none"
    phase(f"kernel fm_search {label}",
          f"{name}: {fn} shape={shape_s} equal={err == 0 and ndiff == 0} "
          f"max_abs_err={err} differing={ndiff} launches={launched} "
          f"ms={ms:.4f} ({timer}) call_ms={call_ms:.4f} "
          f"bound_ms={bms:.4f} ({by}, int32 peak) "
          f"share={bms / ms:.1%} sector_bound_ms={sms:.4f} "
          f"sector_share={sms / ms:.1%} block_sector_bound_ms={bsms:.4f} "
          f"block_sector_share={bsms / ms:.1%} plain_ms={plain_ms:.3f} "
          f"work={counts} wall_s={time.perf_counter() - t0:.2f}")
    if err or ndiff:
        fail(f"{label} disagrees with its plain version ({name})")
    if launched != 1:
        fail(f"{label} launched {launched} times for one call ({name})")
    return {"case": name, "kernel": label, "fn": fn, "shape": shape_s,
            "ms": ms, "call_ms": call_ms, "timer": timer, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "sector_bound_ms": sms,
            "block_sector_bound_ms": bsms, "max_abs_err": err,
            "wall_s": time.perf_counter() - t0, **work}


def phase_repeat_search(dev, genome_bp: int = 3_000_000, unit: int = 2000,
                        copies: int = 600, n_reads: int = 4096):
    """A repeat-structured genome (repeat_genome: a ``unit``-base
    sequence pasted ``copies`` times, 0.2% substituted; lut_k 11, built
    at sa_rate 1, searched at 8) whose PendingSearch under
    SOAP3DP_ESCALATE=1 runs rounds 2 and 3 on ``dev`` and on the CPU:
    hits equal. Run twice, with SOAP3DP_REPEAT_HEAVY 0 (round 1
    LUT-only) and 1 (round 1 packed); rounds 2 and 3 take the general
    branch. Returns the rate-1 index on ``dev`` (FS2's sa_rate 1 case)
    and the result."""
    import torch

    from soap3dp_tpu_torch.fm import search as fsearch
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index, resample_sa

    rng = np.random.default_rng(20261019)
    t0 = time.perf_counter()
    genome, starts = repeat_genome(rng, genome_bp, unit, copies)
    index1 = build_index(genome, sa_rate=1, lut_k=11)
    index8 = resample_sa(index1, 8)
    build_s = time.perf_counter() - t0
    reads, lens = sample_reads(rng, genome.codes, n_reads, 100,
                               random_share=0.05)
    # half of the reads from the repeat copies
    half = n_reads // 2
    pos = starts[rng.integers(0, len(starts), half)] + rng.integers(
        0, unit - 100, half)
    reads[n_reads - half:] = genome.codes[pos[:, None] + np.arange(100)]
    out = {"genome_bp": genome_bp, "unit": unit, "copies": copies,
           "reads": n_reads, "build_s": build_s}
    saved = {k: os.environ.get(k) for k in ("SOAP3DP_ESCALATE",
                                            "SOAP3DP_REPEAT_HEAVY")}
    orig = fsearch._run_compacted
    try:
        os.environ["SOAP3DP_ESCALATE"] = "1"
        for heavy in ("0", "1"):
            os.environ["SOAP3DP_REPEAT_HEAVY"] = heavy
            res = {}
            for d in (dev, torch.device("cpu")):
                caps = []

                def run(*a, **kw):
                    caps.append(a[4])
                    return orig(*a, **kw)

                fsearch._run_compacted = run
                didx = device_index(index8, d)
                cfg = fsearch.config_for(didx, 2)
                t1 = time.perf_counter()
                h = fsearch.PendingSearch(didx, reads, lens, cfg).result()
                row, tp, nm, va, fl = h.to_host()
                res[d.type] = ((row[va], tp[va], nm[va], fl), caps,
                               time.perf_counter() - t1)
                fsearch._run_compacted = orig
            (a, caps_a, s_a), (b, caps_b, s_b) = res[dev.type], res["cpu"]
            same = all(np.array_equal(x, y) for x, y in zip(a, b))
            rounds = len(set(caps_a))
            phase("kernel fm_search repeat genome",
                  f"{genome_bp} bp, {copies} copies of a {unit} bp repeat, "
                  f"lut_k 11, sa_rate 8, repeat_heavy={heavy}: {n_reads} "
                  f"reads, {len(a[0])} hits, round-2/3 caps {caps_a} "
                  f"({dev.type}) / {caps_b} (cpu), {int(a[3].sum())} reads "
                  f"still flagged; {dev.type} == cpu: {same} "
                  f"({s_a:.2f}s / {s_b:.2f}s; build {build_s:.1f}s)")
            if not same or caps_a != caps_b:
                fail("the repeat genome's search differs between "
                     f"{dev.type} and cpu (repeat_heavy={heavy})")
            if rounds < 2:
                fail("the repeat genome's search did not run rounds 2 and 3")
            out[f"repeat_heavy_{heavy}"] = {"hits": len(a[0]),
                                           "caps": caps_a, "equal": same}
    finally:
        fsearch._run_compacted = orig
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return device_index(index1, dev), out


def path_calls(didx, codes: np.ndarray, B: int = 65536, seed_reads=13456
               ) -> list[tuple[str, tuple]]:
    """The kernels' calls, with their arguments, of the main path on
    ``didx``: a phase-4 batch (B pairs: 2B reads of 100 bases in the
    120-wide rows phase 4's reader gives, both ends searched together
    over segments {0, 1} as dispatch_pair_search does, rounds and
    escalation included) and a deep-DP seeding of ``seed_reads`` of them
    (deep_dp_seed_matrix at the rows' width, as _deep_dp_round seeds:
    4 seeds a read, so 13,456 reads are phase 4's largest seeding call,
    107,648 lanes)."""
    from soap3dp_tpu_torch.fm import search as fsearch
    from soap3dp_tpu_torch.pipeline import dp_rescue

    rng = np.random.default_rng(20261020)
    reads, lens = sample_reads(rng, codes, 2 * B, 120, np.full(2 * B, 100),
                               random_share=0.01)
    with _Recorder() as rec:
        cfg = fsearch.config_for(didx, 2)
        fsearch.PendingSearch(didx, reads, lens, cfg,
                              seed_range=(0, 2)).result()
        sp, sl = dp_rescue.deep_dp_seed_matrix(lens[:seed_reads], 120)
        dp_rescue.seed_candidates(didx, reads[:seed_reads],
                                  lens[:seed_reads], sp, sl)
    return rec.calls


def phase_fm_kernels(dev, peak_ops: float, work: str,
                     genome_bp: int = 250_000_000, path_pairs: int = 65536,
                     synthetic_n: int = 3_200_000_000
                     ) -> tuple[list[dict], list[dict], dict]:
    """FS1-FS4 against their plain versions, every element of every
    output: the main path's calls on phase 4's index (built here and
    cached for phase 4); the edges of each FS1 branch; FS2 at sa_rate 1
    (the repeat genome), 2 (phase 4's index) and 8 (it re-sampled with
    resample_sa), and with the SA split over a two-replica mesh, of
    ready rows and with the search's and the DP seeding's lane
    expansions at their edges; the occ blocks' edges; FS3's edges; FS4's
    edges (uniq above and equal to K2, no pos_ok, forced collisions at
    the 1,024-slot table, K of 2^22); FS1-FS3 on a synthetic index of
    ``synthetic_n`` bases; the repeat genome's search on the card and
    the CPU. Returns (the kernels' rows of the JSON line, every case's
    row, the repeat genome's result)."""
    import torch

    from soap3dp_tpu_torch.distributed import mesh as dmesh
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import load_index, resample_sa

    _, genome, idx_path, how, build_s, lut_k = _genome_index(genome_bp, work)
    index = load_index(idx_path)
    didx = device_index(index, dev)
    phase("fm setup", f"{genome_bp} bp index {how} in {build_s:.1f}s "
                      f"(sa_rate {index.sa_rate}, lut_k {lut_k})")
    rng = np.random.default_rng(20261021)
    calls = path_calls(didx, genome.codes, path_pairs)
    cases = [(f"path{i}", fn, args) for i, (fn, args) in enumerate(calls)]
    # the LUT-only branch at round 1's shape: what round 1 runs on a
    # genome that 4^lut_k covers (seeds truncated to lut_k, no FM step)
    a = calls[0][1]
    cases.append(("path_lut", "seed_intervals",
                  (a[0], a[1], a[2], a[3], a[4].clamp(max=lut_k), 0, "lut")))
    cases += fs_search_cases(rng, didx, genome.codes, dev)
    cases += fs_verify_cases(rng, didx, genome.codes, dev)
    index8 = resample_sa(index, 8)
    didx8 = device_index(index8, dev)
    cases.append(fs_decode_case(rng, f"decode_sa{index.sa_rate}", didx, dev))
    cases.append(fs_decode_case(rng, "decode_sa8", didx8, dev))
    mesh = dmesh.replicate_index(index8, dmesh.make_mesh([dev, dev]),
                                 shard_sa=True)
    cases.append(fs_decode_case(rng, "decode_sa8_split", mesh.replicas[0],
                                dev))
    # the expansion's edges at the round-1 search's lanes and K, on
    # phase 4's index, at sa_rate 8 and with the SA split over the mesh
    a = next(args for fn, args in calls if fn == "expand_decode")
    RS, S, K = a[1].shape[0], a[5], a[6]
    cases += expansion_cases(rng, didx, dev, RS, S, K)
    cases += expansion_cases(rng, didx8, dev, RS, S, K, "expand_sa8",
                             ("zeros",))
    cases += expansion_cases(rng, mesh.replicas[0], dev, RS, S, K,
                             "expand_sa8_split")
    # the DP seeding's expansion at the largest seeding call's lanes
    a = next(args for fn, args in calls if fn == "seed_expand_decode")
    RSs, Ss = a[1].shape[0], a[4]
    cases += seed_expand_cases(rng, didx, dev, RSs, Ss)
    cases += seed_expand_cases(rng, didx8, dev, RSs, Ss, "seed_sa8",
                               ("widths",))
    cases += seed_expand_cases(rng, mesh.replicas[0], dev, RSs, Ss,
                               "seed_sa8_split")
    cases += dedupe_cases(rng, dev, next(args for fn, args in calls
                                         if fn == "dedupe"))
    didx1, repeat = phase_repeat_search(dev)
    cases.append(fs_decode_case(rng, "decode_sa1", didx1, dev))
    cases += expansion_cases(rng, didx1, dev, RS, S, K, "expand_sa1",
                             ("zeros",))
    cases += seed_expand_cases(rng, didx1, dev, RSs, Ss, "seed_sa1",
                               ("widths",))
    cases += block_edge_cases(rng, dev)
    rows = [run_fs_case(name, fn, args, peak_ops) for name, fn, args in cases]
    collide = next(r for r in rows if r["case"] == "dedupe_collide_1024")
    if collide["surviving_dups"] <= 0:
        fail("the forced collisions left no same-key loser of a slot "
             "another key won")
    del cases, calls, didx8, mesh, didx1, a
    torch.cuda.empty_cache()
    gp_rows = phase_prescan(dev, peak_ops, didx, genome.codes)
    pk_rows = phase_pack(dev, didx, genome.codes)
    del didx
    torch.cuda.empty_cache()
    syn = synthetic_index(dev, synthetic_n)
    rows += [run_fs_case(name, fn, args, peak_ops, reps=5)
             for name, fn, args in synthetic_cases(rng, syn, dev)]
    gp_rows.append(run_prescan_case(
        "synthetic", prescan_synthetic_case(rng, syn, dev), syn, dev,
        peak_ops, reps=5))
    pk_rows.append(run_pack_case("synthetic", pack_synthetic_case(rng, syn),
                                 syn, dev, reps=5))
    del syn
    torch.cuda.empty_cache()
    return (fs_kernel_rows(rows) + [gp_kernel_row(gp_rows),
                                    pk_kernel_row(pk_rows)],
            rows + gp_rows + pk_rows, repeat)


FS_ROWS = {  # label: (name in the JSON line, the TPU-side code it replaces)
    "FS1": ("fm_backward_search", "soap3dp_tpu/fm/fmindex.py:391"),
    "FS2": ("fm_sa_decode", "soap3dp_tpu/fm/fmindex.py:509"),
    "FS2x": ("fm_expand_decode", "soap3dp_tpu/fm/search.py:247"),
    "FS3": ("fm_packed_verify", "soap3dp_tpu/fm/fmindex.py:653"),
    "FS4": ("fm_hash_dedupe", "soap3dp_tpu/fm/search.py:275"),
    "FS2s": ("fm_seed_expand_decode",
             "soap3dp_tpu/pipeline/dp_rescue.py:176")}


def fs_kernel_rows(rows: list[dict]) -> list[dict]:
    """The JSON line's rows of FS1, FS2 (sa_decode of ready rows), FS2x
    (FS2's expand_decode), FS3, FS4 (the dedupe) and FS2s (FS2's
    seed_expand_decode): each kernel's largest main-path call (FS1,
    FS2x, FS3 and FS4: the round-1 search of a phase-4 batch; FS2s: the
    deep-DP seeding; FS2, on no path since FS2s took the seeding: its
    largest case), with the largest difference over every case of that
    kernel and the bound with the sectors of the occ blocks; each
    printed on one line beside what ran before it, quoted from PERF.md
    (BEFORE_REDESIGN_MS, SCATTER_MIN_BEFORE_MS)."""
    out = []
    for label, (name, replaces) in FS_ROWS.items():
        mine = [r for r in rows if r["kernel"] == label]
        path = [r for r in mine if r["case"].startswith("path")]
        main = max(path or mine, key=lambda r: r.get("slots", r.get(
            "lanes", r.get("rows", r.get("placements", 0)))))
        row = {"name": name, "route": "cuda",
               "source": "soap3dp_tpu_torch/csrc/fm_search.cu",
               "replaces": replaces, "launches": 0,
               "max_abs_err": max(r["max_abs_err"] for r in mine),
               "ms": main["ms"], "timer": main["timer"],
               "plain_ms": main["plain_ms"],
               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "peak": "int32", "sector_bound_ms": main["sector_bound_ms"],
               "block_sector_bound_ms": main.get("block_sector_bound_ms"),
               "library_ms": None, "shape": main["shape"],
               "case": main["case"]}
        out.append(row)
        block = row["block_sector_bound_ms"]
        before = BEFORE_REDESIGN_MS
        was = {"FS2x": f"before its redesign: FS2 {before['FS2']:.3f} ms "
                       "after the plain-torch compaction, PERF.md",
               "FS4": "before it: plain torch, whose scatter-min alone "
                      f"took {SCATTER_MIN_BEFORE_MS:.3f} ms of PR 7's search, "
                      "PERF.md",
               "FS2s": "before it: plain torch (a slot mask of 64 a lane, "
                       "its nonzero, FS2)"}.get(
            label, f"before its redesign: {before.get(label, 0):.3f} ms, "
                   "PERF.md")
        phase(f"kernel fm_search {label} summary",
              f"{main['case']} ({main.get('fn')}, {main['shape']}): "
              f"{row['ms']:.4f} ms ({was}); "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
              f"{row['bound_ms'] / row['ms']:.1%}; sectors "
              f"{row['sector_bound_ms']:.4f} ms "
              f"{row['sector_bound_ms'] / row['ms']:.1%}; occ-block sectors "
              + (f"{block:.4f} ms {block / row['ms']:.1%}" if block else "-")
              + f"; plain {row['plain_ms']:.3f} ms; {len(mine)} cases in "
              f"{sum(r['wall_s'] for r in mine):.2f} s")
    return out


# ------------------------------------------------------------------
# GP: the DP rescue's gapless prescan against its plain version
# ------------------------------------------------------------------

# the largest gapless_prescan call of phases 4 and 5, (M candidates,
# max_win), both in 120-wide rows of 100-base reads (compare_prescan.py
# on the parent, PERF.md section 5), and the plain version's full chunk
# at phase 5's window
PRESCAN_PATH = {"path_phase4": (8532, 300), "path_phase5": (8655, 4100),
                "chunk_phase5": (16384, 4100)}
# the edges' genome: its bases and its run of A (start, length)
PRESCAN_GENOME_N, PRESCAN_POLY_A = 40_000, (12_000, 800)
PRESCAN_MIXED = (1, 15, 16, 17, 31, 32, 33, 100, 120, 250)
PRESCAN_EDGES = ("mixed_lengths", "rc_length_apart", "no_valid",
                 "full_room", "poly_a", "genome_end", "shared_read", "one",
                 "above_chunk")
# int32 operations a valid offset's read word: funnel shift, XOR, fold
# (shift and or), mask; and the add of its popcount
OPS_PRESCAN_WORD = 5


def prescan_genome():
    """The edges' genome (a PackedGenome): seeded, PRESCAN_GENOME_N bases
    with a run of A at PRESCAN_POLY_A."""
    import dataclasses

    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.utils import dna

    genome = workloads.random_genome(np.random.default_rng(41),
                                     PRESCAN_GENOME_N, name="chrP")
    codes = genome.codes.copy()
    s, n = PRESCAN_POLY_A
    codes[s:s + n] = 0
    return dataclasses.replace(genome, codes=codes, pac=dna.pack_codes(codes))


def _planted(rng, codes, rlens, L, O, strand, room):
    """Reads of ``rlens`` bases (rows of L) cut from ``codes`` at a random
    offset of a window of rlen + room bases, m % 3 substitutions in read
    m, reverse-complemented where ``strand`` is 1 (so that the
    prescan's orientation finds them); returns (reads, ws, wlens)."""
    M = len(rlens)
    reads = np.zeros((M, L), np.uint8)
    wlens = (rlens + room).astype(np.int32)
    ws = rng.integers(0, len(codes) - O - L - 1, M).astype(np.int64)
    for m, n in enumerate(rlens):
        o = int(rng.integers(0, max(min(room[m], O - 1), 0) + 1))
        seg = _mutate(rng, codes[ws[m] + o:ws[m] + o + n], m % 3, 0, 0)
        reads[m, :n] = 3 - seg[::-1] if strand[m] == 1 else seg
    return reads, ws, wlens


def _prescan_inputs(reads, lens_rows, read_idx, strand, ws, rlens, wlens,
                    O: int) -> dict:
    L = reads.shape[1]
    return {"reads": np.ascontiguousarray(reads, np.uint8),
            "lens_rows": np.asarray(lens_rows, np.int32),
            "read_idx": np.asarray(read_idx, np.int64),
            "strand": np.asarray(strand, np.int8),
            "ws": np.asarray(ws, np.int64),
            "rlens": np.asarray(rlens, np.int32),
            "wlens": np.asarray(wlens, np.int32), "O": O,
            "W": O + ((L + 127) // 128) * 128}


def prescan_edge_case(name: str, codes: np.ndarray, seed: int = 7) -> dict:
    """The inputs of dp_rescue._prescan_impl (reads (B, L) uint8,
    lens_rows (B,), read_idx, strand, ws, rlens, wlens (M,), O, W) at the
    edge ``name`` of PRESCAN_EDGES, on prescan_genome's ``codes``: reads
    of PRESCAN_MIXED bases in one call, both strands; reverse
    complements of other lengths than the counted ones (some past the
    row); no valid offset; every offset valid (wlens - rlens = O - 1 and
    more); a poly-A read on a poly-A window (every valid offset ties at
    0); windows that end at the genome's last base, and one past it;
    one read behind two candidates of different lengths; one candidate;
    more candidates than the plain version's chunk."""
    from soap3dp_tpu_torch.pipeline import dp_rescue

    rng = np.random.default_rng(seed)
    N = len(codes)
    O = 384
    if name in ("mixed_lengths", "rc_length_apart"):
        rlens = np.array(PRESCAN_MIXED * 4, np.int32)
        L, M = 256, len(rlens)
        if name == "mixed_lengths":
            strand = (np.arange(M) // len(PRESCAN_MIXED)) % 2
        else:
            strand = np.ones(M, np.int8)
        reads, ws, wlens = _planted(rng, codes, rlens, L, O, strand,
                                    rng.integers(0, O + 40, M))
        lens_rows = rlens.copy()
        if name == "mixed_lengths":  # a quarter on a random window
            ws[::4] = rng.integers(0, N - O - L, len(ws[::4]))
        else:
            lens_rows = np.clip(rlens + rng.integers(-3, 4, M), 0, L)
            lens_rows[::5] = L + 5  # past the row: clamped
        return _prescan_inputs(reads, lens_rows, np.arange(M), strand, ws,
                               rlens, wlens, O)
    if name in ("no_valid", "full_room"):
        rlens = np.array(PRESCAN_MIXED[3:], np.int32).repeat(3)
        L, M = 256, len(rlens)
        strand = np.arange(M) % 2
        room = (np.tile([O - 1, O, O + 300], M // 3) if name == "full_room"
                else -rng.integers(1, 50, M))
        reads, ws, _ = _planted(rng, codes, rlens, L, O, strand,
                                np.maximum(room, 0))
        wlens = rlens + room
        if name == "no_valid":
            wlens[0] = 0
        return _prescan_inputs(reads, rlens, np.arange(M), strand, ws,
                               rlens, wlens, O)
    if name == "poly_a":
        rlens = np.array([1, 16, 33, 100, 120, 100], np.int32)
        reads = np.zeros((len(rlens), 120), np.uint8)
        reads[-1] = 3  # poly-T: its reverse complement is poly-A
        ws = PRESCAN_POLY_A[0] + rng.integers(0, 50, len(rlens))
        return _prescan_inputs(reads, rlens, np.arange(len(rlens)),
                               [0, 0, 0, 0, 0, 1], ws, rlens,
                               [300, 200, 500, 700, 500, O - 1 + 100], O)
    if name == "genome_end":
        rlens = np.array([100, 120, 17, 16, 1, 100], np.int32)
        wlens = np.array([400, 130, 17, 300, O - 1, 200], np.int32)
        ws = (N - wlens).astype(np.int64)
        ws[-1] = N - 50  # past the last base: the last word again
        strand = np.array([0, 1, 0, 1, 0, 0])
        reads = np.zeros((len(rlens), 120), np.uint8)
        for m, n in enumerate(rlens[:-1]):
            seg = codes[N - n:]  # the genome's last n bases
            reads[m, :n] = 3 - seg[::-1] if strand[m] == 1 else seg
        reads[-1] = rng.integers(0, 4, 120)
        return _prescan_inputs(reads, rlens, np.arange(len(rlens)), strand,
                               ws, rlens, wlens, O)
    if name == "shared_read":  # read 0 behind three candidates
        reads, ws, _ = _planted(rng, codes, np.array([100, 100]), 120, O,
                                [0, 1], np.array([200, 250]))
        return _prescan_inputs(reads, [100, 100], [0, 0, 1, 1, 0],
                               [0, 0, 1, 1, 1], ws[[0, 0, 1, 1, 0]],
                               [100, 60, 100, 31, 120],
                               [300, 300, 350, 350, 300], O)
    if name == "one":
        reads, ws, wlens = _planted(rng, codes, np.array([100]), 120, O,
                                    [1], np.array([300]))
        return _prescan_inputs(reads, [100], [0], [1], ws, [100], wlens, O)
    if name == "above_chunk":
        O, L, B = 128, 20, 64
        M = dp_rescue._PRESCAN_CHUNK + 37
        rlens = rng.integers(1, L + 1, M)
        return _prescan_inputs(
            rng.integers(0, 4, (B, L)), np.full(B, L), rng.integers(0, B, M),
            rng.integers(0, 2, M), rng.integers(0, N - O - L, M), rlens,
            rlens + rng.integers(-5, O + 10, M), O)
    raise ValueError(f"no prescan edge {name!r}")


def prescan_path_case(rng, codes: np.ndarray, M: int, max_win: int,
                      L: int = 120, read_len: int = 100) -> dict:
    """A gapless_prescan chunk as the half rescue makes it (one row a
    candidate, reads of ``read_len`` bases in rows of L, windows of
    max_win bases, a tenth of them shorter) on the genome ``codes``: the
    mate cut from its window at a random offset, 0.5% of its bases
    substituted, 10% of them with a 3-base deletion, 2% random, half on
    the reverse strand."""
    from soap3dp_tpu_torch.utils import shapes

    rlens = np.full(M, read_len, np.int32)
    wlens = np.full(M, max_win, np.int32)
    short = rng.random(M) < 0.1
    wlens[short] = rng.integers(read_len // 2, max_win, int(short.sum()))
    ws = rng.integers(0, len(codes) - max_win - L, M).astype(np.int64)
    off = (rng.random(M) * np.maximum(wlens - read_len - 3, 0)).astype(int)
    at = ws + off
    reads = codes[at[:, None] + np.arange(read_len + 3)].astype(np.uint8)
    dele = rng.random(M) < 0.1
    cut = rng.integers(10, read_len - 10, M)
    src = np.arange(read_len)[None, :] + np.where(
        dele[:, None] & (np.arange(read_len)[None, :] >= cut[:, None]), 3, 0)
    reads = np.take_along_axis(reads, src, 1)
    sub = rng.random(reads.shape) < 0.005
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    rand = rng.random(M) < 0.02
    reads[rand] = rng.integers(0, 4, (int(rand.sum()), read_len))
    strand = (rng.random(M) < 0.5).astype(np.int8)
    reads[strand == 1] = 3 - reads[strand == 1][:, ::-1]
    rows = np.zeros((M, L), np.uint8)
    rows[:, :read_len] = reads
    return _prescan_inputs(rows, rlens, np.arange(M), strand, ws, rlens,
                           wlens, shapes.bucket_multiple(max_win, 128))


def prescan_synthetic_case(rng, didx, dev, M: int = 8192,
                           max_win: int = 4100) -> dict:
    """A path-like chunk on a synthetic_index: windows past 2^31 (a
    quarter ending at the text's last base), the reads cut from its
    packed genome (read back from the card) as prescan_path_case cuts
    them, half of them planted at a random offset."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.utils import shapes

    n, L, rl = didx.n, 120, 100
    ws = rng.integers(min(1 << 31, n // 2), n - max_win, M).astype(np.int64)
    ws[: M // 4] = n - max_win
    off = rng.integers(0, max_win - rl + 1, M)
    seg = fmindex.extract_genome(
        didx, torch.from_numpy(ws + off).to(dev), rl).cpu().numpy()
    seg[M // 2:] = rng.integers(0, 4, (M - M // 2, rl))
    strand = (rng.random(M) < 0.5).astype(np.int8)
    seg[strand == 1] = 3 - seg[strand == 1][:, ::-1]
    reads = np.zeros((M, L), np.uint8)
    reads[:, :rl] = seg
    rlens = np.full(M, rl, np.int32)
    return _prescan_inputs(reads, rlens, np.arange(M), strand, ws, rlens,
                           np.full(M, max_win, np.int32),
                           shapes.bucket_multiple(max_win, 128))


def prescan_args(c: dict, didx, dev) -> tuple:
    """The arguments of dp_rescue._prescan_impl of case ``c`` on
    ``dev``."""
    import torch

    def t(k):
        return torch.from_numpy(np.ascontiguousarray(c[k])).to(dev)

    return (didx, t("reads"), t("lens_rows"), t("read_idx"), t("strand"),
            t("ws"), t("rlens"), t("wlens"), c["O"], c["W"])


def prescan_work(c: dict) -> dict:
    """What GP needs on case ``c``: the valid offsets of each candidate
    (min(O - 1, wlens - rlens) + 1, at least 0) times the words of its
    counted bases (ceil(min(rlen, L) / 16)), OPS_PRESCAN_WORD int32
    operations and a popcount each; bytes: each window's W / 16 genome
    words, each read row referenced and the (M, 3) output once, and the
    candidates' inputs (read, strand, ws, rlens, wlens)."""
    L = c["reads"].shape[1]
    rl = c["rlens"].astype(np.int64)
    valid = np.clip(np.minimum(c["O"] - 1, c["wlens"] - rl) + 1, 0, None)
    words = int((valid * ((np.clip(rl, 0, L) + 15) // 16)).sum())
    M = len(rl)
    rows = len(np.unique(c["read_idx"]))
    nbytes = M * (c["W"] // 16) * 4 + rows * (L + 4) + M * (24 + 8 + 1 + 16)
    return {"candidates": M, "valid_offsets": int(valid.sum()),
            "words": words, "ops": OPS_PRESCAN_WORD * words,
            "popcounts": words, "bytes": nbytes}


def prescan_bound(work: dict, peak_ops: float) -> tuple[float, str]:
    """GP's bound: the larger of its int32 operations over the int32
    peak, its popcounts over the popcount rate (16 lanes an SM, a
    quarter of the int32 peak) and its bytes over the memory rate."""
    t = {"operations": work["ops"] / peak_ops * 1e3,
         "popcounts": work["popcounts"] / (peak_ops / 4) * 1e3,
         "bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def _distinct_words(w0: np.ndarray, nw: int, n_pac: int) -> int:
    """The distinct pac words of the ranges [w0, w0 + nw] (each word
    index clamped to [0, n_pac - 1], as aligned_genome_words clamps it):
    the size of the union of the clamped ranges."""
    w0 = np.sort(w0)
    lo, hi = np.clip(w0, 0, n_pac - 1), np.clip(w0 + nw, 0, n_pac - 1)
    before = np.maximum.accumulate(np.concatenate([[-1], hi[:-1]]))
    return int(np.maximum(hi - np.maximum(lo, before + 1) + 1, 0).sum())


def pack_work(c: dict) -> dict:
    """What PK (the DP rescue's problem pack, dp_rescue._pack_problems)
    needs on case ``c`` (reads (B, L), cread, win_start (P,), max_win,
    n_pac): the (P, L) oriented reads and (P, max_win) window codes
    written once; each distinct pac word of the windows (ceil(max_win /
    16) + 1 words from win_start // 16, clamped) read once; each
    distinct read row named (its L code bytes and its 8-byte length) read
    once; and the problems' cread (8 B), strand (1 B) and win_start (8 B).
    No arithmetic to speak of: bytes only."""
    L = c["reads"].shape[1]
    P, W = len(c["cread"]), int(c["max_win"])
    nw = (W + 15) // 16
    words = _distinct_words(np.asarray(c["win_start"], np.int64) >> 4, nw,
                            int(c["n_pac"])) if P and W else 0
    rows = len(np.unique(c["cread"]))
    nbytes = P * (L + W) + 4 * words + rows * (L + 8) + P * (8 + 1 + 8)
    return {"problems": P, "pac_words": words, "read_rows": rows,
            "bytes": nbytes}


def pack_bound(work: dict) -> tuple[float, str]:
    """PK's bound: its bytes over the memory rate."""
    return work["bytes"] / HBM_BYTES_PER_S * 1e3, "bytes"


def prescan_conv1d(args: tuple):
    """The one PyTorch call that computes the same mismatch counts: a
    grouped conv1d of the windows' one-hot codes (1, 4M, W) with the
    masked one-hot oriented reads (M, 4, Lr), groups=M (matches at every
    offset; the counted bases less them give mm). Returns (the call,
    the (M, 3) output its counts give, for a check)."""
    import torch
    import torch.nn.functional as F

    from soap3dp_tpu_torch.fm import fmindex

    idx, reads, lens_rows, read_idx, strand, ws, rlens, wlens, O, W = args
    M, L = read_idx.shape[0], reads.shape[1]
    ori = torch.where(strand[:, None] == 1,
                      fmindex.revcomp_reads(reads, lens_rows)[read_idx],
                      reads[read_idx])
    keep = torch.arange(L, device=ws.device)[None, :] \
        < rlens.long()[:, None]
    rd = (F.one_hot(ori.long().clamp(max=4), 5)[..., :4] * keep[..., None]
          ).permute(0, 2, 1).float().contiguous()
    x = F.one_hot(fmindex.extract_genome(idx, ws, W).long(), 4).permute(
        0, 2, 1).reshape(1, 4 * M, W).float()

    def call():
        return F.conv1d(x, rd, groups=M)

    mm = keep.sum(1)[:, None] - call()[0, :, :O].round().long()
    o = torch.arange(O, device=ws.device)[None, :]
    mm = torch.where(o <= (wlens.long() - rlens.long())[:, None], mm,
                     1 << 20)
    mn = mm.min(1).values
    out = torch.stack([mn, (mm == mn[:, None]).int().argmax(1),
                       (mm == 0).sum(1)], 1)
    return call, out


def run_prescan_case(name: str, c: dict, didx, dev, peak_ops: float,
                     reps: int = 20, library: bool = False) -> dict:
    """One GP case on the card: dp_rescue._prescan_impl (GP) against
    _prescan_plain on the same tensors, every element; GP's device time
    (torch.profiler, _timed), the plain version's (CUDA events), the
    bound (prescan_bound) and, with ``library``, the grouped conv1d's
    time (CUDA events around the call) and whether its counts give the
    same output."""
    import torch

    from soap3dp_tpu_torch.kernels import fm_search as fs
    from soap3dp_tpu_torch.pipeline import dp_rescue

    t0 = time.perf_counter()
    args = prescan_args(c, didx, dev)
    n0 = fs.PRESCAN_KERNEL.launches
    got = dp_rescue._prescan_impl(*args)
    torch.cuda.synchronize()
    launched = fs.PRESCAN_KERNEL.launches - n0
    want = dp_rescue._prescan_plain(*args)
    err, ndiff = _fs_diff(got, want)
    ms, call_ms, timer = _timed(lambda: dp_rescue._prescan_impl(*args),
                                reps, "prescan_kernel")
    plain_ms = _events_ms(lambda: dp_rescue._prescan_plain(*args),
                          max(1, reps // 10))
    work = prescan_work(c)
    bms, by = prescan_bound(work, peak_ops)
    M, L = len(c["rlens"]), c["reads"].shape[1]
    row = {"case": name, "kernel": "GP", "shape": f"{M}x{c['O']}x{L}",
           "ms": ms, "call_ms": call_ms, "timer": timer,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_term": by,
           "bound_by": "bytes" if by == "bytes" else "operations",
           "max_abs_err": err, "differing": ndiff, "launches": launched,
           "library_ms": None, **work}
    lib = ""
    if library:
        try:
            conv, conv_out = prescan_conv1d(args)
            row["library_ms"] = _events_ms(conv, 2)
            row["library_equal"] = bool(torch.equal(conv_out, want))
            lib = (f" conv1d_ms={row['library_ms']:.3f} (its counts give "
                   f"the same output: {row['library_equal']})")
            del conv, conv_out
        except RuntimeError as e:  # out of memory, or no algorithm
            lib = f" conv1d: {str(e)[:120]}"
        torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t0
    phase("kernel prescan GP",
          f"{name}: shape={row['shape']} equal={err == 0 and ndiff == 0} "
          f"max_abs_err={err} differing={ndiff} launches={launched} "
          f"ms={ms:.4f} ({timer}) call_ms={call_ms:.4f} "
          f"bound_ms={bms:.4f} ({by}) share={bms / ms:.1%} "
          f"plain_ms={plain_ms:.3f}{lib} valid_offsets="
          f"{work['valid_offsets']} words={work['words']} "
          f"zero_mm={int((want[:, 0] == 0).sum())} "
          f"wall_s={row['wall_s']:.2f}")
    if err or ndiff:
        fail(f"GP disagrees with its plain version ({name})")
    if launched != 1:
        fail(f"GP launched {launched} times for one call ({name})")
    return row


def phase_prescan(dev, peak_ops: float, didx, codes: np.ndarray
                  ) -> list[dict]:
    """GP against its plain version on the card: the largest calls of
    phases 4 and 5 and the plain version's full chunk (PRESCAN_PATH) on
    phase 4's index ``didx`` (genome ``codes``), each with the grouped
    conv1d beside it, and the edges (PRESCAN_EDGES) on prescan_genome's
    index."""
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index

    rng = np.random.default_rng(20261022)
    rows = [run_prescan_case(name, prescan_path_case(rng, codes, M, win),
                             didx, dev, peak_ops, library=True)
            for name, (M, win) in PRESCAN_PATH.items()]
    genome = prescan_genome()
    edx = device_index(build_index(genome, sa_rate=8), dev)
    rows += [run_prescan_case(f"edge_{name}",
                              prescan_edge_case(name, genome.codes), edx,
                              dev, peak_ops, reps=5)
             for name in PRESCAN_EDGES]
    return rows


def gp_kernel_row(rows: list[dict]) -> dict:
    """The JSON line's row of GP: its time at phase 5's largest call,
    with the largest difference over every GP case."""
    main = next(r for r in rows if r["case"] == "path_phase5")
    p4 = next(r for r in rows if r["case"] == "path_phase4")
    row = {"name": "gapless_prescan", "route": "cuda",
           "source": "soap3dp_tpu_torch/csrc/fm_search.cu",
           "replaces": "soap3dp_tpu/pipeline/dp_rescue.py:276",
           "launches": 0, "max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": main["ms"], "timer": main["timer"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "bound_term": main["bound_term"],
           "peak": "int32", "library_ms": main["library_ms"],
           "library": "torch.nn.functional.conv1d(groups=M)",
           "shape": main["shape"], "case": main["case"],
           "phase4_ms": p4["ms"], "phase4_bound_ms": p4["bound_ms"],
           "phase4_plain_ms": p4["plain_ms"],
           "phase4_library_ms": p4["library_ms"]}
    phase("kernel prescan GP summary",
          f"{main['case']} ({main['shape']}): {row['ms']:.4f} ms; bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_term']}) "
          f"{row['bound_ms'] / row['ms']:.1%}; plain {row['plain_ms']:.3f} "
          f"ms; conv1d " + (f"{row['library_ms']:.3f} ms"
                            if row["library_ms"] else "not timed")
          + f"; phase 4's ({p4['shape']}): {p4['ms']:.4f} ms, bound "
          f"{p4['bound_ms']:.4f} ms, plain {p4['plain_ms']:.3f} ms; "
          f"{len(rows)} cases in {sum(r['wall_s'] for r in rows):.2f} s")
    return row


# ------------------------------------------------------------------
# PK: the DP rescue's problem pack against its plain version
# ------------------------------------------------------------------

# the pack calls of phases 4 and 5 on phase 4's index, (problems, the
# distinct read rows they name, max_win), in 120-wide rows of 100-base
# reads: the largest of each phase and phase 4's most frequent
# (compare_prescan.py on the parent, PERF.md section 5)
PACK_PATH = {"path_phase4": (16384, 8532, 256),
             "frequent_phase4": (8192, 4134, 256),
             "path_phase5": (16384, 8655, 4224)}
PACK_EDGES = ("uniform", "ragged", "text_end", "shift_0", "win_1", "win_16",
              "win_17", "win_4224", "code_4", "pad_problems")


def pack_edge_case(name: str, n_text: int, n_pac: int, seed: int = 11
                   ) -> dict:
    """The inputs of dp_rescue._pack_problems (reads (B, L) uint8, lens,
    cread, strand, win_start, un, max_win) and n_pac at the edge ``name``
    of PACK_EDGES, on a text of n_text bases in n_pac pac words, both
    strands in every case: every read of 100 bases (the plain version's
    uniform branch); lengths of 0-120 (the reverse complements of other
    lengths, bytes past a length not zero); windows that end at the
    text's last base, run past it, or start past pac's last word (its
    words clamped); window starts on a word (a shift of 0); max_win of 1,
    16, 17 and 4,224; reads holding code 4; pad problems (cread 0,
    strand 0, win_start 0, as run_banded_dp pads them)."""
    rng = np.random.default_rng(seed)
    B, L, P = 40, 120, 96
    max_win = int(name[4:]) if name.startswith("win_") else 300
    if name == "uniform":
        lens = np.full(B, 100, np.int64)
    else:
        lens = rng.integers(0, L + 1, B)
        lens[:8] = (0, 1, 15, 16, 17, 100, 119, 120)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    if name == "code_4":
        reads[rng.random((B, L)) < 0.05] = 4
    cread = rng.integers(0, B, P)
    strand = np.arange(P) % 2 == 1
    win_start = rng.integers(0, n_text - max_win, P)
    if name == "shift_0":
        win_start &= ~15
    if name == "text_end":
        k = P // 3
        win_start[:k] = n_text - max_win
        win_start[k:2 * k] = n_text - rng.integers(1, max_win, k)
        win_start[2 * k:] = 16 * n_pac + rng.integers(-64, 40, P - 2 * k)
    if name == "pad_problems":
        pad = 32
        cread = np.concatenate([cread, np.zeros(pad, np.int64)])
        strand = np.concatenate([strand, np.zeros(pad, bool)])
        win_start = np.concatenate([win_start, np.zeros(pad, np.int64)])
    return {"reads": reads, "lens": np.asarray(lens, np.int64),
            "cread": np.asarray(cread, np.int64), "strand": strand,
            "win_start": np.asarray(win_start, np.int64),
            "un": 100 if name == "uniform" else 0, "max_win": max_win,
            "n_pac": n_pac}


def pack_path_case(rng, n_text: int, n_pac: int, P: int, rows: int,
                   max_win: int, L: int = 120, read_len: int = 100,
                   win_lo: int = 0) -> dict:
    """A run_banded_dp slice as the rescue makes it: ``rows`` reads of
    ``read_len`` bases in rows of L (every one named, the rest of the P
    problems naming them at random, half on the reverse strand), windows
    of max_win bases at random starts from ``win_lo`` in a text of
    n_text bases."""
    reads = np.zeros((rows, L), np.uint8)
    reads[:, :read_len] = rng.integers(0, 4, (rows, read_len))
    cread = rng.integers(0, rows, P)
    cread[:rows] = np.arange(rows)
    return {"reads": reads, "lens": np.full(rows, read_len, np.int64),
            "cread": cread.astype(np.int64),
            "strand": rng.random(P) < 0.5,
            "win_start": rng.integers(win_lo, n_text - max_win,
                                      P).astype(np.int64),
            "un": read_len, "max_win": max_win, "n_pac": n_pac}


def pack_synthetic_case(rng, didx, P: int = 16384, rows: int = 8655,
                        max_win: int = 4224) -> dict:
    """Phase 5's largest pack call on a synthetic_index: windows past
    2^31, a quarter of them ending at the text's last base and an eighth
    running past it."""
    n = didx.n
    c = pack_path_case(rng, n, didx.pac.shape[0], P, rows, max_win,
                       win_lo=min(1 << 31, n // 2))
    ws = c["win_start"]
    ws[: P // 4] = n - max_win
    ws[P // 4: P // 4 + P // 8] = n - rng.integers(1, max_win, P // 8)
    return c


def pack_args(c: dict, didx, dev) -> tuple:
    """The arguments of dp_rescue._pack_problems of case ``c`` on
    ``dev``."""
    import torch

    def t(k):
        return torch.from_numpy(np.ascontiguousarray(c[k])).to(dev)

    return (didx, t("reads"), t("lens"), t("cread"), t("strand"),
            t("win_start"), int(c["un"]), int(c["max_win"]))


def run_pack_case(name: str, c: dict, didx, dev, reps: int = 20) -> dict:
    """One PK case on the card: dp_rescue._pack_problems (PK) against
    _pack_problems_plain on the same tensors, every byte of both
    outputs; PK's device time (torch.profiler, _timed), the plain
    version's (CUDA events) and the bound (pack_work, pack_bound)."""
    import torch

    from soap3dp_tpu_torch.kernels import fm_search as fs
    from soap3dp_tpu_torch.pipeline import dp_rescue

    t0 = time.perf_counter()
    args = pack_args(c, didx, dev)
    n0 = fs.PACK_KERNEL.launches
    got = dp_rescue._pack_problems(*args)
    torch.cuda.synchronize()
    launched = fs.PACK_KERNEL.launches - n0
    want = dp_rescue._pack_problems_plain(*args)
    err, ndiff = _fs_diff(got, want)
    ms, call_ms, timer = _timed(lambda: dp_rescue._pack_problems(*args),
                                reps, "pack_kernel")
    plain_ms = _events_ms(lambda: dp_rescue._pack_problems_plain(*args),
                          max(1, reps // 4))
    work = pack_work(c)
    bms, by = pack_bound(work)
    P, L = len(c["cread"]), c["reads"].shape[1]
    row = {"case": name, "kernel": "PK", "shape": f"{P}x{L}x{c['max_win']}",
           "ms": ms, "call_ms": call_ms, "timer": timer,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "max_abs_err": err, "differing": ndiff, "launches": launched,
           "library_ms": None, **work, "wall_s": time.perf_counter() - t0}
    phase("kernel pack PK",
          f"{name}: shape={row['shape']} equal={err == 0 and ndiff == 0} "
          f"max_abs_err={err} differing={ndiff} launches={launched} "
          f"ms={ms:.4f} ({timer}) call_ms={call_ms:.4f} "
          f"bound_ms={bms:.4f} ({by}) share={bms / ms:.1%} "
          f"plain_ms={plain_ms:.3f} bytes={work['bytes']} "
          f"wall_s={row['wall_s']:.2f}")
    if err or ndiff:
        fail(f"PK disagrees with its plain version ({name})")
    if launched != 1:
        fail(f"PK launched {launched} times for one call ({name})")
    return row


def phase_pack(dev, didx, codes: np.ndarray) -> list[dict]:
    """PK against its plain version on the card: phase 4's and phase 5's
    pack calls (PACK_PATH) on phase 4's index ``didx`` (genome
    ``codes``), and the edges (PACK_EDGES) on prescan_genome's index."""
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index

    rng = np.random.default_rng(20261023)
    rows = [run_pack_case(name, pack_path_case(
        rng, len(codes), didx.pac.shape[0], P, R, W), didx, dev)
        for name, (P, R, W) in PACK_PATH.items()]
    genome = prescan_genome()
    edx = device_index(build_index(genome, sa_rate=8), dev)
    rows += [run_pack_case(f"edge_{name}", pack_edge_case(
        name, len(genome.codes), edx.pac.shape[0]), edx, dev, reps=5)
        for name in PACK_EDGES]
    return rows


def pk_kernel_row(rows: list[dict]) -> dict:
    """The JSON line's row of PK: its time at phase 5's largest call,
    with the largest difference over every PK case."""
    main = next(r for r in rows if r["case"] == "path_phase5")
    p4 = next(r for r in rows if r["case"] == "path_phase4")
    row = {"name": "problem_pack", "route": "cuda",
           "source": "soap3dp_tpu_torch/csrc/fm_search.cu",
           "replaces": "soap3dp_tpu/pipeline/dp_rescue.py:357",
           "launches": 0, "max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": main["ms"], "timer": main["timer"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": None,
           "shape": main["shape"], "case": main["case"],
           "phase4_ms": p4["ms"], "phase4_bound_ms": p4["bound_ms"],
           "phase4_plain_ms": p4["plain_ms"], "phase4_shape": p4["shape"]}
    phase("kernel pack PK summary",
          f"{main['case']} ({main['shape']}): {row['ms']:.4f} ms; bound "
          f"{row['bound_ms']:.4f} ms (bytes) "
          f"{row['bound_ms'] / row['ms']:.1%}; plain {row['plain_ms']:.3f} "
          f"ms; no one PyTorch call computes both outputs; phase 4's "
          f"({p4['shape']}): {p4['ms']:.4f} ms, bound {p4['bound_ms']:.4f} "
          f"ms, plain {p4['plain_ms']:.3f} ms; {len(rows)} cases in "
          f"{sum(r['wall_s'] for r in rows):.2f} s")
    return row


def phase_golden(dev) -> None:
    """The seven golden SAM cases (five paired-end, two single-end)
    through the port on ``dev``."""
    import io

    from soap3dp_tpu_torch.io.sam import SamWriter
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.pipeline.pair import align_pair_batch
    from soap3dp_tpu_torch.pipeline.single import align_single_batch

    cases = [(n, c, True) for n, c in workloads.GOLDEN_PAIR_CASES] + \
        [(n, c, False) for n, c in workloads.GOLDEN_SINGLE_CASES]
    for name, case, paired in cases:
        t0 = time.perf_counter()
        buf = io.BytesIO()
        opts = workloads.golden_options(case)
        if paired:
            index, b1, b2 = workloads.golden_pair_workload(
                case.get("plant4", False))
            align_pair_batch(index, device_index(index, dev), b1, b2, opts,
                             SamWriter(buf, index))
        else:
            index, b1 = workloads.golden_single_workload()
            align_single_batch(index, device_index(index, dev), b1, opts,
                               SamWriter(buf, index))
        got = [l for l in buf.getvalue().decode().splitlines()
               if not l.startswith("@PG")]
        path = os.path.join(ROOT, "tests", "golden", f"{name}.sam")
        with open(path) as fh:
            want = fh.read().splitlines()
        bad = [i for i, (g, x) in enumerate(zip(got, want))
               if g.split("\t") != x.split("\t")]
        phase("golden", f"{name}: {len(got)} lines vs {len(want)}, "
                        f"{len(bad)} differ ({time.perf_counter() - t0:.2f}s)")
        if len(got) != len(want) or bad:
            i = bad[0] if bad else min(len(got), len(want))
            fail(f"golden {name} line {i}:\n got: "
                 f"{got[i] if i < len(got) else None}\nwant: "
                 f"{want[i] if i < len(want) else None}")


class _Tee:
    """stderr that also keeps a copy (the CLI reports on stderr)."""

    def __init__(self, stream):
        self.stream = stream
        self.parts: list[str] = []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _device_spans(prof) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of every device event of a profile."""
    out = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            out.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(out)


def _profiled_pass(cli_main, argv, wall_plain: float, out_dir: str) -> dict:
    """Run the CLI once more with torch.profiler recording device
    activity only; returns the device busy time (union of kernel and
    copy intervals) and writes the top device events to out_dir."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    sink = io.StringIO()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            contextlib.redirect_stderr(sink):
        rc = cli_main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"the profiled pair CLI exited {rc}")
    spans = _device_spans(prof)
    busy = 0.0
    cur = None
    for a, b, _ in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    copies = sum(b - a for a, b, n in spans if n.startswith("Mem"))
    by_name: dict[str, list] = {}
    for a, b, n in spans:
        by_name.setdefault(n, [0.0, 0])
        by_name[n][0] += b - a
        by_name[n][1] += 1
    with open(os.path.join(out_dir, "e2e_profile.txt"), "w") as fh:
        fh.write(f"profiled wall {wall:.3f}s (unprofiled {wall_plain:.3f}s); "
                 f"device busy {busy / 1e6:.3f}s, of which copies "
                 f"{copies / 1e6:.3f}s\n")
        for n, (us, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:30]:
            fh.write(f"{us / 1e3:10.2f} ms x{k:<7d} {n[:150]}\n")
        fh.write(sink.getvalue())
    res = {"profiled_wall_s": wall, "device_busy_s": busy / 1e6,
           "device_copy_s": copies / 1e6}
    if not spans:
        phase("e2e profile", "the profiler recorded no device events: "
                             "device busy share not measured")
        return res
    phase("e2e profile", f"profiled pass {wall:.2f}s; device busy "
                         f"{busy / 1e6:.3f}s ({copies / 1e6:.3f}s of it "
                         f"copies, mostly the index upload) = "
                         f"{busy / 1e6 / wall:.1%} of the profiled wall, "
                         f"{busy / 1e6 / wall_plain:.1%} of the unprofiled "
                         f"wall; top device events in e2e_profile.txt")
    return res


def search_device_items(dev, reads: dict, out_dir: str,
                        pairs: int = 65536) -> dict:
    """Phase 4's first batch of ``pairs`` pairs searched alone on its
    index, as dispatch_pair_search searches it (both ends, segments
    {0, 1}, rounds included), under torch.profiler: the search's device
    items by name (ms, launches), written to search_profile.txt, and
    their total beside the parent's (SEARCH_DEVICE_BEFORE_MS). A profile
    has lost the device events of its first milliseconds, so the search
    runs twice in it, each time followed by a marker kernel
    (torch.cuda._sleep's spin_kernel), and the items are the events
    between the last two markers (the whole profile's where the first
    marker too was lost). Fails if a scan with indices (torch.cummax's
    kernel) or a scatter-reduce with ReduceMinimum (the plain dedupe's
    scatter-min) runs in either search; reports the scatter-reduce
    kernels by their reduction."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soap3dp_tpu_torch.fm import search as fsearch
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import load_index
    from soap3dp_tpu_torch.io.fastq import read_pairs
    from soap3dp_tpu_torch.utils import shapes

    didx = device_index(load_index(reads["index"]), dev)
    b1, b2 = next(read_pairs(reads["r1"], reads["r2"], batch_size=pairs))
    L = max(b1.codes.shape[1], b2.codes.shape[1])
    codes = np.concatenate([shapes.pad_cols(b1.codes, L),
                            shapes.pad_cols(b2.codes, L)])
    lens = np.concatenate([b1.lens, b2.lens]).astype(np.int32)
    cfg = fsearch.config_for(didx, 2)

    def run():
        fsearch.PendingSearch(didx, codes, lens, cfg,
                              seed_range=(0, 2)).result()
        torch.cuda.synchronize(dev)

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(dev)
    spans = _device_spans(prof)
    marks = [a for a, _, name in spans if "spin_kernel" in name]
    window = (spans if len(marks) < 2 else
              [s for s in spans if marks[-2] < s[0] < marks[-1]])
    items: dict[str, list] = {}
    for a, b, name in window:
        items.setdefault(name, [0.0, 0])
        items[name][0] += (b - a) / 1e3
        items[name][1] += 1
    top = sorted(items.items(), key=lambda kv: -kv[1][0])
    with open(os.path.join(out_dir, "search_profile.txt"), "w") as fh:
        for name, (ms, k) in top:
            fh.write(f"{ms:10.4f} ms x{k:<5d} {name[:200]}\n")
    total = sum(ms for ms, _ in items.values())
    scans = {n for _, _, n in spans if "with_indices" in n}
    reduce = {tag: sum(tag in n for _, _, n in spans)
              for tag in ("ReduceMaximum", "ReduceMinimum")}
    marked = len(marks) >= 2
    short = [f"{name[:60]} {ms:.3f} ms x{k}" for name, (ms, k) in top[:8]]
    phase("e2e search profile",
          f"{2 * len(b1)} reads of phase 4's first batch: {len(items)} "
          f"device items, {total:.3f} ms ("
          + ("the second search, between its markers" if marked else
             "both searches, the markers lost")
          + f"; FS1 among them: "
          f"{any(FS_SYMBOLS['FS1'] in n for n in items)}; PR 7, before FS4: "
          f"{SEARCH_DEVICE_BEFORE_MS:.3f} ms, PERF.md); scans with indices "
          f"(cummax) {len(scans)}, scatter-reduce kernels {reduce}; top: "
          f"{short}; all in search_profile.txt")
    if scans:
        fail(f"the search ran a scan with indices: {list(scans)}")
    if reduce["ReduceMinimum"]:
        fail("the search ran a scatter-reduce with ReduceMinimum (the "
             "plain dedupe's scatter-min)")
    return {"device_ms": total, "items": dict(top), "marked": marked,
            "scans_with_indices": len(scans), "scatter_reduce": reduce}


# the mate-pair library of phases 5 and 6: -/+ (StrandArrangement of the
# ini), inserts ~N(4000, 400) in [2100, 5900], aligned with -v 2000
# -u 6000 over the whole insert window (SOAP3DP_HALF_NARROW_PAD=0)
# phases 4 and 5: the seeded genome and the read pairs of the real size
E2E_GENOME_BP = 250_000_000
E2E_PAIRS = 100_000
MATE_PAIR_LIBRARY = dict(orientation="-/+", insert=4000, insert_sd=400,
                         insert_range=(2100, 5900))
MATE_PAIR_ARGS = ["-v", "2000", "-u", "6000"]
MATE_PAIR_ENV = {"SOAP3DP_HALF_NARROW_PAD": "0"}


def _mate_pair_ini(work: str) -> str:
    path = os.path.join(work, "mate_pair.ini")
    with open(path, "w") as fh:
        fh.write("[PairEnd]\nStrandArrangement=-/+\n")
    return path


def _genome_index(genome_bp: int, work: str, sa_rate: int = 2):
    """(rng after the genome, genome, index path, how, build s, lut_k):
    the seeded genome and its index, built once and cached in ``work``."""
    from soap3dp_tpu_torch.index.builder import build_index, load_index, save_index
    from soap3dp_tpu_torch import workloads

    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(20261016)
    genome = workloads.random_genome(rng, genome_bp, name="chr1")
    idx_path = os.path.join(work, f"genome_{genome_bp}.t3i")
    t0 = time.perf_counter()
    if os.path.exists(os.path.join(idx_path, "meta.json")):
        lut_k = load_index(idx_path).lut_k
        how = "cached"
    else:
        index = build_index(genome, sa_rate=sa_rate,
                            lut_k=13 if genome_bp >= 1_000_000 else None)
        lut_k = index.lut_k
        save_index(index, idx_path)
        del index
        how = "built"
    return rng, genome, idx_path, how, time.perf_counter() - t0, lut_k


def _kernels() -> dict:
    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.kernels import fm_search as fs

    return {"K1": bd.DP_KERNEL, "K2": bd.FORWARD_KERNEL,
            "TB": bd.TRACEBACK_KERNEL, "FS1": fs.SEARCH_KERNEL,
            "FS2": fs.DECODE_KERNEL, "FS2x": fs.EXPAND_KERNEL,
            "FS3": fs.VERIFY_KERNEL, "FS4": fs.DEDUPE_KERNEL,
            "FS2s": fs.SEED_EXPAND_KERNEL, "GP": fs.PRESCAN_KERNEL,
            "PK": fs.PACK_KERNEL}


def _launches() -> dict:
    return {name: k.launches for name, k in _kernels().items()}


def _launch_shapes() -> dict:
    """{kernel: {"shape": launches}} since the counts were last set to 0
    (the shapes the path itself gave each kernel: P x Lr x Lw for the
    DP kernels; lanes x L x max_steps for FS1, rows x sa_rate for FS2,
    slots x lanes x sa_rate for FS2x and FS2s, placements x words for
    FS3, K x K2 x hb for FS4, M x O x Lr for GP, P x Lr x max_win for
    PK)."""
    return {name: {"x".join(map(str, shape)): n for shape, n in
                   sorted(k.shapes.items())}
            for name, k in _kernels().items() if k.shapes}


def _launches_per_device() -> dict:
    """{card: {kernel: launches}} since the counts were last set to 0."""
    out = {}
    for name, k in _kernels().items():
        for d, c in sorted(k.per_device.items()):
            out.setdefault(f"cuda:{d}", dict.fromkeys(_kernels(), 0))[name] = c
    return out


def _counted(fn, dev, env=None) -> tuple[object, float, str, dict]:
    """Run ``fn()`` under ``env`` with every launch count set to 0 just
    before; returns (its result, wall s, stderr, launch counts just
    after). Fails if a plain search primitive ran on a card's index or
    the plain prescan or the plain pack on CUDA tensors in the run (a
    CUDA tensor must take the kernel)."""
    import contextlib

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    tee = _Tee(sys.stderr)
    for k in _kernels().values():
        k.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(tee), _Recorder(record=False) as rec:
            out = fn()
        if dev.type == "cuda":
            import torch
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rec.plain_on_card:
        fail(f"{rec.plain_on_card} plain search primitive calls ran on a "
             "card's index")
    if rec.prescan_plain_on_card:
        fail(f"{rec.prescan_plain_on_card} plain prescan calls ran on CUDA "
             "tensors")
    if rec.pack_plain_on_card:
        fail(f"{rec.pack_plain_on_card} plain pack calls ran on CUDA "
             "tensors")
    return out, time.perf_counter() - t0, tee.text(), _launches()


# the seed search's kernels of the main path: FS1, FS2's two expansions
# (the search's, the DP seeding's), FS3 and FS4; FS2's sa_decode of
# ready rows is on no path since FS2s took the DP seeding
FS_PATH = ("FS1", "FS2x", "FS2s", "FS3", "FS4")


def _fs_launched(where: str, launches: dict) -> None:
    """Fails unless each kernel of FS_PATH launched in the run."""
    missing = [k for k in FS_PATH if launches.get(k, 0) <= 0]
    if missing:
        fail(f"{where} never launched {missing}")


def _run_cli(argv, dev, env=None) -> tuple[float, str, dict]:
    """Run the port's CLI with every launch count set to 0 just before;
    returns (wall s, stderr, launch counts just after)."""
    from soap3dp_tpu_torch.cli.main import main as cli_main

    rc, wall, log, launches = _counted(lambda: cli_main(argv), dev, env)
    if rc != 0:
        fail(f"the {argv[0]} CLI exited {rc}")
    return wall, log, launches


def _sam_recall(path: str, planted: list, rand: np.ndarray) -> float:
    """Fails unless every read has a record; returns the planted-locus
    recall (primary record within 20 bp) of the non-random reads.
    ``planted`` holds each end's 1-based positions (one end: single)."""
    n = len(planted[0])
    seen = np.zeros((len(planted), n), bool)
    hit = np.zeros((len(planted), n), bool)
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.split("\t", 4)
            flag = int(f[1])
            end = 0 if flag & 0x40 or len(planted) == 1 else 1
            r = int(f[0][1:])
            seen[end, r] = True
            if flag & 0x904:  # unmapped, secondary or supplementary
                continue
            hit[end, r] |= abs(int(f[3]) - int(planted[end][r])) <= 20
    if not seen.all():
        fail(f"{int((~seen).sum())} reads have no SAM record")
    return float(hit[~np.reshape(rand, hit.shape)].mean())


def _summary(log: str, cls: str) -> dict:
    import re

    m = re.search(rf"done: {cls}\(([^)]*)\)", log)
    if m is None:
        fail("no run summary on stderr")
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m.group(1))}


def _rates(reads: int, wall: float, log: str) -> dict:
    import re

    up = re.search(r"uploaded to \S+ in ([0-9.]+)s", log)
    load = re.search(r"index loaded in ([0-9.]+)s", log)
    setup_s = float(load.group(1)) + float(up.group(1))
    return {"reads": reads, "wall_s": wall, "reads_per_s": reads / wall,
            "reads_per_s_after_load": reads / max(wall - setup_s, 1e-9),
            "index_load_s": float(load.group(1)),
            "index_upload_s": float(up.group(1))}


def phase_e2e(dev, genome_bp: int, n_pairs: int, card: str, work: str,
              out_dir: str, profile: bool = True, mate_pair: bool = False
              ) -> tuple[dict, dict]:
    """The port's `pair` CLI on ``dev`` over a seeded genome of
    ``genome_bp`` and ``n_pairs`` read pairs: default options
    (-u 500 -v 300) on a +/- library, or with ``mate_pair`` the mate-pair
    library over the whole insert window. Checks records, planted-locus
    recall, rescue counts and kernel launches. Returns (result, the run's
    inputs and outputs: FASTQ paths, end-1 planted positions and random
    mask, index, options, SAM path, summary)."""
    import re

    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.utils import timers

    rng, genome, idx_path, how, build_s, lut_k = _genome_index(genome_bp,
                                                                work)
    tag = "mp_" if mate_pair else ""
    r1 = os.path.join(work, f"{tag}r1.fq")
    r2 = os.path.join(work, f"{tag}r2.fq")
    p1, p2, rand = workloads.make_pe_fastq(
        rng, genome.codes, n_pairs, r1, r2,
        **(MATE_PAIR_LIBRARY if mate_pair else {}))
    del genome
    name = "mate-pair e2e" if mate_pair else "e2e"
    phase(f"{name} setup", f"{genome_bp} bp genome, index {how} in "
                           f"{build_s:.1f}s (sa_rate=2, lut_k={lut_k}), "
                           f"{n_pairs} pairs of 100 bp written")

    out = os.path.join(work, f"{tag}out")
    opts = (MATE_PAIR_ARGS + ["--ini", _mate_pair_ini(work)] if mate_pair
            else ["-u", "500", "-v", "300"])
    argv = ["pair", idx_path, r1, r2] + opts + ["-o", out, "--device",
                                               str(dev)]
    env = MATE_PAIR_ENV if mate_pair else None
    # the stage timers (SOAP3DP_TIMERS=1) on in the measured run: a clock
    # read at each end of a few dozen stages, no device sync
    saved, timers.ENABLED = timers.ENABLED, True
    try:
        wall, log, launches = _run_cli(argv, dev, env)
    finally:
        timers.ENABLED = saved
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[timers\] (\S+)\s+([0-9.]+)s", log)}
    shapes = _launch_shapes()
    with open(os.path.join(out_dir, f"{tag}e2e_stderr.log"), "w") as fh:
        fh.write(log)
    recall = _sam_recall(out + ".sam", [p1, p2], rand)
    summ = _summary(log, "PairSummary")
    batches = [float(x) for x in re.findall(r"BWT-paired \(([0-9.]+)s\)", log)]
    res = dict(_rates(2 * n_pairs, wall, log), index_build_s=build_s,
               batch_s=batches, recall=recall, launches=launches,
               launch_shapes=shapes, summary=summ, card=card)
    phase(f"{name} launch shapes", json.dumps(shapes))
    phase(name, f"{2 * n_pairs} reads in {wall:.2f}s = "
                f"{2 * n_pairs / wall:.0f} reads/s "
                f"({res['reads_per_s_after_load']:.0f} after index load "
                f"{res['index_load_s']:.2f}s + upload "
                f"{res['index_upload_s']:.2f}s); batches {batches} s; "
                f"recall {recall:.4f}; launches {launches}; {summ}; "
                f"card: {card}")
    if recall < 0.95:
        fail(f"planted-locus recall {recall:.4f} < 0.95")
    if summ.get("paired_dp", 0) <= 0:
        fail("the rescue phases produced no DP-paired reads")
    if not mate_pair and summ.get("single_rescued", 0) <= 0:
        fail("the salvage phase produced no singly aligned reads")
    if dev.type == "cuda":
        _fs_launched(name, launches)
        if launches["K1"] <= 0:
            fail("the run never launched the fused DP kernel (K1)")
        if launches["GP"] <= 0:
            fail("the run never launched the gapless prescan kernel (GP)")
        if launches["PK"] <= 0:
            fail("the run never launched the problem pack kernel (PK)")
        if mate_pair and min(launches["K2"], launches["TB"]) <= 0:
            fail("the full-window mate rescue never launched K2 and TB")
        if not mate_pair and launches["K2"] + launches["TB"]:
            fail("the default run launched K2 / TB: its windows are narrow")
    inputs = {"r1": r1, "r2": r2, "planted": p1, "random": rand[0],
              "index": idx_path, "opts": opts, "sam": out + ".sam",
              "summary": summ}
    res["stage_s"] = stages
    phase(f"{name} stage timers",
          f"BC.prescan {stages.get('BC.prescan')} s, BC.half_rescue "
          f"{stages.get('BC.half_rescue')} s, dp.pack "
          f"{stages.get('dp.pack')} s, dp.align {stages.get('dp.align')} s "
          f"(SOAP3DP_TIMERS=1 in the run); GP launches in the run "
          f"{launches['GP']}, PK {launches['PK']}, none of the plain "
          "prescan or pack on CUDA tensors (_counted checks)")
    if profile:
        from soap3dp_tpu_torch.cli.main import main as cli_main
        res["profile"] = _profiled_pass(
            cli_main, argv[:-3] + [out + "_prof"] + argv[-2:], wall, out_dir)
        if dev.type == "cuda":
            res["search_profile"] = search_device_items(dev, inputs, out_dir)
    return res, inputs


def phase_mate_pair_devices(dev, work: str, n_pairs: int = 200) -> dict:
    """The mate-pair library at a small size (200 kbp, ``n_pairs`` pairs
    of inserts in [2500, 5500]) through `pair` on ``dev`` and on the CPU:
    the SAM records must be equal (the CPU side is held to the JAX
    package by the CPU tests)."""
    import torch

    from soap3dp_tpu_torch import workloads

    rng, genome, idx_path, _, _, _ = _genome_index(200_000, work)
    r1, r2 = os.path.join(work, "r1.fq"), os.path.join(work, "r2.fq")
    workloads.make_pe_fastq(rng, genome.codes, n_pairs, r1, r2,
                            **dict(MATE_PAIR_LIBRARY, insert_sd=750,
                                   insert_range=(2500, 5500)))
    ini = _mate_pair_ini(work)
    recs, info = {}, {}
    for d in (str(dev), "cpu"):
        out = os.path.join(work, f"out_{d}")
        wall, _, launches = _run_cli(
            ["pair", idx_path, r1, r2] + MATE_PAIR_ARGS
            + ["--ini", ini, "-o", out, "--device", d],
            torch.device(d), MATE_PAIR_ENV)
        with open(out + ".sam") as fh:
            recs[d] = sorted(l for l in fh if not l.startswith("@PG"))
        info[d] = {"wall_s": wall, "launches": launches}
    same = recs[str(dev)] == recs["cpu"]
    n = len([l for l in recs["cpu"] if not l.startswith("@")])
    phase("mate-pair card vs cpu",
          f"{n} records; {str(dev)} == cpu: {same}; "
          f"{str(dev)} {info[str(dev)]['wall_s']:.2f}s launches "
          f"{info[str(dev)]['launches']}, cpu {info['cpu']['wall_s']:.2f}s")
    if not same or n != 2 * n_pairs:
        fail("the mate-pair SAM on the card differs from the CPU's")
    if dev.type == "cuda" and info[str(dev)]["launches"]["K2"] <= 0:
        fail("the small mate-pair run never launched K2")
    return info


def phase_single_e2e(dev, reads: dict, card: str, work: str,
                     out_dir: str) -> dict:
    """The port's `single` CLI over phase 4's end-1 reads on the same
    index: a record per read, planted-locus recall, K1 launches."""
    import re

    out = os.path.join(work, "se_out")
    wall, log, launches = _run_cli(
        ["single", reads["index"], reads["r1"], "-o", out, "--device",
         str(dev)], dev)
    shapes = _launch_shapes()
    phase("single-end e2e launch shapes", json.dumps(shapes))
    with open(os.path.join(out_dir, "se_e2e_stderr.log"), "w") as fh:
        fh.write(log)
    n = len(reads["planted"])
    recall = _sam_recall(out + ".sam", [reads["planted"]], reads["random"])
    summ = _summary(log, "BatchSummary")
    batches = [float(x) for x in re.findall(r"BWT-aligned \(([0-9.]+)s\)",
                                            log)]
    res = dict(_rates(n, wall, log), batch_s=batches, recall=recall,
               launches=launches, launch_shapes=shapes, summary=summ,
               card=card)
    phase("single-end e2e", f"{n} reads in {wall:.2f}s = {n / wall:.0f} "
                            f"reads/s ({res['reads_per_s_after_load']:.0f} "
                            f"after index load + upload); batches {batches} "
                            f"s; recall {recall:.4f}; launches {launches}; "
                            f"{summ}; card: {card}")
    if recall < 0.95:
        fail(f"single-end planted-locus recall {recall:.4f} < 0.95")
    if summ.get("num_records", 0) != n:
        fail("the single-end run did not write one record per read")
    if dev.type == "cuda" and min(launches["K1"], launches["PK"]) <= 0:
        fail("the single-end salvage never launched K1 and PK")
    if dev.type == "cuda":
        _fs_launched("the single-end run", launches)
    return res


def _records(path: str) -> list[str]:
    """The alignment records of a SAM file, sorted (deferred rescue
    records interleave on a worker thread)."""
    with open(path) as fh:
        return sorted(l for l in fh if not l.startswith("@"))


def _mesh_devices(dev) -> list:
    """max(2, cards) mesh positions on cards 0, 1, ... (two replicas on
    one card); on the CPU two replicas."""
    import torch

    if dev.type != "cuda":
        return [dev, dev]
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(max(2, count))]


def phase_mesh(dev, reads: dict, work: str, out_dir: str,
               dp_case=(2048, 120, 4224, 100)) -> dict:
    """7a: phase 4's pairs through the runner's pair loop on an
    in-process mesh of _mesh_devices: every record and the summary equal
    phase 4's, K1 launched. Then dp_align(mesh=) on ``dp_case`` (P, Lr,
    Lw, read length; the mate-pair window) equal to the unsharded call,
    K2 and TB launched."""
    import torch

    from soap3dp_tpu_torch.cli.main import parse_args
    from soap3dp_tpu_torch.cli.runner import run_pair
    from soap3dp_tpu_torch.distributed import mesh as dmesh
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    devices = _mesh_devices(dev)
    out = os.path.join(work, "mesh_out")
    _, args = parse_args(["pair", reads["index"], reads["r1"], reads["r2"]]
                         + reads["opts"] + ["-o", out, "--device", str(dev)])
    rc, wall, log, launches = _counted(
        lambda: run_pair(args, devices=devices), dev)
    per_dev = _launches_per_device()
    with open(os.path.join(out_dir, "mesh_e2e_stderr.log"), "w") as fh:
        fh.write(log)
    n = 2 * len(reads["planted"])
    same = _records(out + ".sam") == _records(reads["sam"])
    summ = _summary(log, "PairSummary")
    res = dict(_rates(n, wall, log), devices=[str(d) for d in devices],
               launches=launches, launches_per_device=per_dev,
               records_equal=same, summary_equal=summ == reads["summary"])
    phase("multi-device mesh",
          f"{len(devices)} replicas on {sorted(set(map(str, devices)))}: "
          f"{n} reads in {wall:.2f}s = {n / wall:.0f} reads/s "
          f"({res['reads_per_s_after_load']:.0f} after index load + upload "
          f"{res['index_upload_s']:.2f}s); records equal to phase 4: {same}; "
          f"summary equal: {res['summary_equal']}; launches {launches}, "
          f"per card {per_dev}")
    if rc != 0 or not same or not res["summary_equal"]:
        fail("the mesh run's records or summary differ from phase 4's")
    if dev.type == "cuda" and launches["K1"] <= 0:
        fail("the mesh run never launched K1")
    if dev.type == "cuda":
        for card in sorted({str(d) for d in devices}):
            _fs_launched(f"the mesh run on {card}", per_dev.get(card, {}))
        # the prescan runs on the card of the index replica it is given
        if per_dev.get(str(devices[0]), {}).get("GP", 0) <= 0:
            fail(f"the mesh run never launched GP on {devices[0]}")
        # each replica packs its slice of the DP problems on its card
        for card in sorted({str(d) for d in devices}):
            if per_dev.get(card, {}).get("PK", 0) <= 0:
                fail(f"the mesh run never launched PK on {card}")

    P, Lr, Lw, rl = dp_case
    prob = main_path_problems(np.random.default_rng(20261018), P, Lr, Lw,
                              read_len=rl)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in prob]
    mesh = dmesh.make_mesh(devices)
    want, one_s, _, _ = _counted(lambda: bd.dp_align(*args), dev)
    got, mesh_s, _, dp_launches = _counted(
        lambda: bd.dp_align(*args, mesh=mesh), dev)
    dp_per_dev = _launches_per_device()
    ok, err = _dp_equal(got, want)
    ok = ok and all(np.shape(a) == np.shape(b) for a, b in zip(got, want))
    res["dp_align"] = {"P": P, "Lr": Lr, "Lw": Lw, "equal": ok,
                       "max_abs_err": err, "launches": dp_launches,
                       "launches_per_device": dp_per_dev,
                       "mesh_ms": mesh_s * 1e3, "one_device_ms": one_s * 1e3}
    phase("multi-device dp_align",
          f"mesh of {len(devices)}: P={P} Lr={Lr} Lw={Lw} equal to one "
          f"device: {ok} max_abs_err={err} launches {dp_launches} "
          f"per card {dp_per_dev} "
          f"mesh_ms={mesh_s * 1e3:.3f} one_device_ms={one_s * 1e3:.3f}")
    if not ok:
        fail("dp_align(mesh=) differs from the unsharded call")
    if dev.type == "cuda" and min(dp_launches["K2"], dp_launches["TB"]) <= 0:
        fail("dp_align(mesh=) at the mate-pair window never launched K2 + TB")
    return res


# the port's CLI main, then this process's kernel launches as JSON
_HOST_MAIN = (
    "import json, sys\n"
    "from soap3dp_tpu_torch.cli.main import main\n"
    "from soap3dp_tpu_torch.kernels import banded_dp as bd\n"
    "from soap3dp_tpu_torch.kernels import fm_search as fs\n"
    "rc = main(sys.argv[1:])\n"
    "print('[chip_smoke] launches', json.dumps({'K1': bd.DP_KERNEL.launches,"
    " 'K2': bd.FORWARD_KERNEL.launches, 'TB': bd.TRACEBACK_KERNEL.launches,"
    " 'FS1': fs.SEARCH_KERNEL.launches, 'FS2': fs.DECODE_KERNEL.launches,"
    " 'FS2x': fs.EXPAND_KERNEL.launches,"
    " 'FS3': fs.VERIFY_KERNEL.launches, 'FS4': fs.DEDUPE_KERNEL.launches,"
    " 'FS2s': fs.SEED_EXPAND_KERNEL.launches,"
    " 'GP': fs.PRESCAN_KERNEL.launches,"
    " 'PK': fs.PACK_KERNEL.launches}), flush=True)\n"
    "sys.exit(rc)\n")


def phase_hosts(dev, reads: dict, work: str, out_dir: str,
                timeout: float = 600.0) -> dict:
    """7b: two processes of `soap3dp-torch pair --hosts 2` on phase 4's
    inputs, process i on card i % cards: the merged records and the
    global summary equal phase 4's. Each process is waited for with a
    deadline and killed past it, and reports its kernel launches."""
    import re
    import socket

    import torch

    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(work, "hosts_out")
    env = dict(os.environ, PYTHONPATH=ROOT)
    devs = [f"cuda:{i % count}" if dev.type == "cuda" else str(dev)
            for i in range(2)]
    procs, logs, ends = [], [], [None, None]
    t0 = time.perf_counter()
    try:
        for i, d in enumerate(devs):
            logs.append(open(os.path.join(out_dir, f"hosts_{i}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _HOST_MAIN, "pair",
                 reads["index"], reads["r1"], reads["r2"]] + reads["opts"]
                + ["-o", out, "--device", d, "--hosts", "2", "--host-id",
                   str(i), "--coordinator", f"127.0.0.1:{port}"],
                stdout=logs[i], stderr=subprocess.STDOUT, env=env, cwd=work))
        while None in ends and time.perf_counter() - t0 < timeout:
            for i, p in enumerate(procs):
                if ends[i] is None and p.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        text = []
        for log in logs:
            log.seek(0)
            text.append(log.read())
            log.close()
    if None in ends or any(p.returncode for p in procs):
        fail(f"a --hosts 2 process failed or passed {timeout:.0f}s: "
             f"{[p.returncode for p in procs]}\n{text[0][-2000:]}"
             f"\n{text[1][-2000:]}")
    n = 2 * len(reads["planted"])
    merged = sorted(_records(f"{out}.0.sam") + _records(f"{out}.1.sam"))
    same = merged == _records(reads["sam"])
    m = re.search(r"global \(all 2 hosts\): PairSummary\(([^)]*)\)", text[0])
    glob = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m.group(1))} \
        if m else None
    cli_walls = [float(re.search(r"total wall time: ([0-9.]+)s", t).group(1))
                 for t in text]
    pairs = [_summary(t, "PairSummary")["num_pairs"] for t in text]
    res = {"devices": devs, "process_wall_s": ends, "cli_wall_s": cli_walls,
           "reads": n, "combined_reads_per_s": n / max(ends),
           "per_process_pairs": pairs,
           "per_process_reads_per_s": [2 * p / w
                                       for p, w in zip(pairs, cli_walls)],
           "index_upload_s": [float(re.search(
               r"uploaded to \S+ in ([0-9.]+)s", t).group(1)) for t in text],
           "launches": [json.loads(re.search(r"\[chip_smoke\] launches (.*)",
                                             t).group(1)) for t in text],
           "records_equal": same, "summary_equal": glob == reads["summary"]}
    phase("multi-host",
          f"2 processes on {devs}: walls {ends[0]:.2f}s / "
          f"{ends[1]:.2f}s from launch (CLI {cli_walls[0]:.2f}s / "
          f"{cli_walls[1]:.2f}s), pairs {pairs}, reads/s in the CLI "
          f"{[round(r) for r in res['per_process_reads_per_s']]}, index "
          f"uploads {res['index_upload_s']} s, launches {res['launches']}; "
          f"combined {res['combined_reads_per_s']:.0f} reads/s from launch; "
          f"merged records equal to phase 4: {same}; global summary equal: "
          f"{res['summary_equal']}")
    if not same or not res["summary_equal"]:
        fail("the two-process run's records or global summary differ from "
             "phase 4's")
    if dev.type == "cuda" and min(l["K1"] for l in res["launches"]) <= 0:
        fail("a --hosts 2 process never launched K1")
    if dev.type == "cuda":
        for i, l in enumerate(res["launches"]):
            _fs_launched(f"--hosts 2 process {i}", l)
            if l["PK"] <= 0:
                fail(f"--hosts 2 process {i} never launched PK")
    return res


def check_last_card() -> bool:
    """A seed search and both DP routes on the last card while card 0 is
    current give the results of card 0 (needs two cards)."""
    import torch

    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.fm.search import search_reads
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rng = np.random.default_rng(11)
    genome = workloads.random_genome(rng, 50_000)
    index = build_index(genome, sa_rate=4)
    pos = rng.integers(0, 50_000 - 100, 256)
    reads = np.stack([genome.codes[p:p + 100] for p in pos]).astype(np.uint8)
    lens = np.full(256, 100, np.int32)
    cases = [main_path_problems(rng, 64, 100, 256),
             main_path_problems(rng, 64, 120, 4224, read_len=100)]
    last = torch.cuda.device_count() - 1
    torch.cuda.set_device(0)
    out = {}
    for d in (0, last):
        dev = torch.device("cuda", d)
        row, tp, nm, va, fl = search_reads(device_index(index, dev), reads,
                                           lens).to_host()
        out[d] = [(row[va], tp[va], nm[va], fl)] + [
            bd.dp_align(*[torch.from_numpy(x).to(dev) for x in prob])
            for prob in cases]
        if torch.cuda.current_device() != 0:
            return False
    return all(np.array_equal(x, y)
               for a, b in zip(out[0], out[last]) for x, y in zip(a, b))


def phase_all_cards(dev, reads: dict, work: str) -> dict:
    """7c, with two cards or more: the CLI with --devices 0 (every card)
    on phase 4's inputs, records equal; and check_last_card."""
    import torch

    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if count < 2:
        phase("multi-device all cards", f"not run: {count} card")
        return {"not_run": f"{count} card"}
    out = os.path.join(work, "all_out")
    wall, _, launches = _run_cli(
        ["pair", reads["index"], reads["r1"], reads["r2"]] + reads["opts"]
        + ["-o", out, "--device", str(dev), "--devices", "0"], dev)
    same = _records(out + ".sam") == _records(reads["sam"])
    last_ok = check_last_card()
    phase("multi-device all cards",
          f"--devices 0 on {count} cards: {wall:.2f}s, records equal to "
          f"phase 4: {same}, launches {launches}; last card while card 0 "
          f"is current equals card 0: {last_ok}")
    if not same or not last_ok:
        fail("the all-card run or the last-card check differs")
    return {"cards": count, "wall_s": wall, "launches": launches,
            "records_equal": same, "last_card_equal": last_ok}


def _build_all() -> None:
    """Build every kernel library, one nvcc per source, started together;
    print each build's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.kernels import fm_search as fs

    libs = [bd.BANDED_DP_LIB, bd.DP_FORWARD_LIB, fs.FM_SEARCH_LIB]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.load(), libs))
    for lib in libs:
        name = os.path.basename(lib.src)
        phase("build", f"{name} built and loaded (nvcc "
                       f"{lib.build_seconds:.2f}s; all builds "
                       f"{time.perf_counter() - t0:.2f}s)")
        with open(os.path.join(OUT_DIR, f"nvcc_{name}.log"), "w") as fh:
            fh.write(lib.build_log)
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                phase(f"ptxas {name}", line.strip())


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "one CUDA card")
    try:
        import soap3dp_tpu_torch.kernels.banded_dp  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the root "
             "of a checkout")
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)
    walls, start = {}, time.perf_counter()

    def lap(name: str) -> None:  # wall seconds of each part of the run
        walls[name] = time.perf_counter() - start - sum(walls.values())

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind} | torch {torch.__version__} cuda "
                    f"{torch.version.cuda} | nvidia-smi: {card}")
    _build_all()
    lap("build")

    peak_ops = int32_peak_ops()
    phase("device", f"int32 peak {peak_ops / 1e12:.2f} TOP/s (132 SMs x 64 "
                    f"lanes x {sm_max_clock_mhz():.0f} MHz), int16x2 peak "
                    f"{2 * peak_ops / 1e12:.2f} TOP/s (the 16-bit forward), "
                    f"memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    kernels = phase_kernels(dev, peak_ops)
    lap("K1 cases")
    kernels += phase_wide_kernels(dev, peak_ops)
    lap("K2 and TB cases")
    k1_err, k2_err = phase_range_cases(dev)
    lap("range cases")
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], k1_err)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], k2_err)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    fs_rows, fs_cases, repeat = phase_fm_kernels(dev, peak_ops, work)
    kernels += fs_rows
    lap("FS cases (index build and repeat genome included)")
    phase_golden(dev)
    lap("golden")
    e2e, reads = phase_e2e(dev, E2E_GENOME_BP, E2E_PAIRS, card, work, OUT_DIR)
    lap("PE default")
    small = phase_mate_pair_devices(
        dev, os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "mp_small"))
    mate, _ = phase_e2e(dev, E2E_GENOME_BP, E2E_PAIRS, card, work, OUT_DIR,
                        profile=False, mate_pair=True)
    lap("mate-pair, small and full")
    single = phase_single_e2e(dev, reads, card, work, OUT_DIR)
    lap("single-end")
    multi = {"card": card, "mesh": phase_mesh(dev, reads, work, OUT_DIR),
             "hosts": phase_hosts(dev, reads, work, OUT_DIR),
             "all_cards": phase_all_cards(dev, reads, work)}
    lap("several devices")
    phase("wall", ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; all {sum(walls.values()):.1f} s")
    # launches on each kernel's main path: K1 on the default pair run,
    # K2 and TB on the mate-pair run
    kernels[0]["launches"] = e2e["launches"]["K1"]
    kernels[1]["launches"] = mate["launches"]["K2"]
    kernels[2]["launches"] = mate["launches"]["TB"]
    kernels[2]["fetch_share"] = kernels[2]["fetch_ms"] / kernels[2]["ms"]
    for row, label in zip(kernels[3:], FS_ROWS):
        row["launches"] = e2e["launches"][label]
        row["main_path"] = label in FS_PATH
        row["sector_share"] = row["sector_bound_ms"] / row["ms"]
        row["block_sector_share"] = row["block_sector_bound_ms"] / row["ms"]
    gp = next(r for r in kernels if r["name"] == "gapless_prescan")
    gp["launches"] = e2e["launches"]["GP"]
    gp["launches_mate_pair"] = mate["launches"]["GP"]
    pk = next(r for r in kernels if r["name"] == "problem_pack")
    pk["launches"] = e2e["launches"]["PK"]
    pk["launches_mate_pair"] = mate["launches"]["PK"]
    pk["launches_single"] = single["launches"]["PK"]
    for row in kernels:
        row["share"] = row["bound_ms"] / row["ms"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": kernels, "fm_cases": fs_cases,
                   "repeat_search": repeat, "e2e": e2e,
                   "mate_pair_small": small, "mate_pair": mate,
                   "single": single, "multi_device": multi,
                   "wall_s": walls}, fh, indent=1)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "cases"} for r in kernels]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
