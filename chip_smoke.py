"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card; no options

Phases, each printing one line, any failure exits non-zero:

1. device and build: the card's name and power limit, and the build of
   every kernel from csrc/ (one nvcc per source, started together);
2. each kernel against its plain-torch version on the card, outputs
   exactly equal, both times printed with each kernel's bound and
   share: K1 (the fused DP) at the main path's shapes, then at the edges
   of the forward (reads of 31, 32, 33, 127, 128 and 2047 bases, ties
   on the best score across diagonals, anchors, a run-budget overflow
   that re-launches K1); K2 (forward only) at K1's main shape (the
   difference is K1's traceback and scratch share) and, with TB (its
   traceback), at the mate-pair rescue window, an edge shape and a case
   that re-launches TB, where dp_align's wide route is also held
   against K1 at the same shape; then K1 and K2 (every dirs byte) at
   the edges of the forward's two forms: reads of 255 bases at scores
   of magnitude 15 (the 16-bit form's limits: every base mismatched,
   the top score, long gaps), the same with one score at 16, and scores
   past 15 at the main path's shape, with anchors and at a K2 window
   (the 32-bit form);
3. golden SAM: the five paired-end and two single-end golden cases of
   tests/golden rendered through the port on cuda, every record equal
   (@PG excepted);
4. end to end at a real size: a 250 Mbp genome, 100,000 read pairs,
   the port's `pair` CLI with default options (-u 500 -v 300); checks
   records, planted-locus recall, rescue counts and kernel launches (K1,
   and no K2: its windows are narrow) with a histogram of the launch
   shapes (P, Lr, Lw) (phases 5 and 6 likewise), then runs it once more under
   torch.profiler (device busy share, top device events in the output
   directory's e2e_profile.txt);
5. mate-pair: a -/+ library of 2-6 kbp inserts aligned with
   -v 2000 -u 6000 and SOAP3DP_HALF_NARROW_PAD=0 (the half rescue over
   the whole insert window, where dp_align takes K2 + TB). First 200
   pairs on a 200 kbp genome, on cuda and on cpu, SAM records equal;
   then 100,000 pairs on phase 4's 250 Mbp index, checking records,
   recall and the launches of K1, K2 and TB;
6. single-end: the port's `single` CLI over phase 4's end-1 reads on the
   same index, checking records, recall and K1 launches (salvage);
7. several devices and processes, on phase 4's inputs: (a) the runner's
   pair loop on an in-process mesh of max(2, cards) index replicas (two
   on one card), records and summary equal to phase 4's, K1 launched,
   and dp_align(mesh=) at the mate-pair window equal to one device's,
   K2 and TB launched; (b) two `pair --hosts 2` processes (process i on
   card i % cards), merged records and global summary equal to phase
   4's; (c) with two cards or more, `--devices 0` and a search and both
   DP routes on the last card while card 0 is current; on one card it
   prints "not run: 1 card".

Then one JSON line with the kernels (each with its time, its bound on
this card, the share of the bound it reaches and the operations peak
the bound used: int16x2, twice the int32 peak, where the 16-bit forward
runs), and the last line
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


def tb_bound(moves: int, P: int, mr: int, peak_ops: float
             ) -> tuple[float, str]:
    """TB: the direction byte of each cell on this run's paths (the
    walks' moves), its (P, 4) parameters and active mask read once, runs
    and counts (P, MR) and (P, 4) meta written once; a few operations
    per move."""
    nbytes = moves + P * (16 + 1 + 8 * mr + 16)
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


def _kernel_only_ms(bd, args, reps: int = 10, sc=None) -> float:
    """Mean time of one banded_dp launch (no host copies), CUDA events."""
    reads, rlens, wins, wlens, cl, cr, al, ar, cut = args
    params = bd._params(rlens, wlens, cl, cr, al, ar, cut)
    mr = max(bd.MAX_RUNS, bd._max_runs_bound(reads.shape[1]))
    sc = sc or bd.DPScores()
    return _events_ms(lambda: bd._launch_dp(reads, wins, params, mr, sc),
                      reps)


def phase_kernels(dev, peak_ops: float) -> list[dict]:
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rng = np.random.default_rng(20261016)
    cases = [
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
    rows = []
    max_err = 0
    for name, prob in cases:
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
        kms = _kernel_only_ms(bd, args)
        mr = max(bd.MAX_RUNS, bd._max_runs_bound(Lr))
        peak, pname = forward_peak(Lr, bd.DPScores(), peak_ops)
        bms, by = k1_bound(prob, mr, peak)
        phase("kernel banded_dp",
              f"{name}: P={P} Lr={Lr} Lw={Lw} equal={ok} max_abs_err={err} "
              f"passing_lanes={npass} launches={n_launch} "
              f"first_ms={first_ms:.3f} ms={ms:.3f} "
              f"kernel_only_ms={kms:.3f} "
              f"GCUPS={dp_cells(prob) / (kms * 1e6):.1f} "
              f"bound_ms={bms:.4f} ({by}, {pname} peak) "
              f"share={bms / kms:.1%} plain_ms={plain_ms:.3f}")
        if not ok:
            fail(f"banded_dp kernel disagrees with its plain version ({name})")
        if name.startswith("overflow") and n_launch != 2:
            fail("overflow case did not re-launch the DP kernel")
        max_err = max(max_err, err)
        rows.append({"case": name, "P": P, "Lr": Lr, "Lw": Lw,
                     "ms": ms, "kernel_only_ms": kms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "peak": pname})
        if name == "Lr100_Lw768":
            # K2 on the same problems: what K1 adds is its traceback and
            # its direction scratch
            params = bd._params(args[1], args[3], *args[4:8])
            dirs = torch.empty((Lr + Lw, P, Lr + 1), dtype=torch.uint8,
                               device=dev)
            k2_ms = _events_ms(lambda: bd._launch_forward(
                args[0], args[2], params, dirs, bd.DPScores()), 10)
            del dirs
            phase("kernel banded_dp",
                  f"K2 at K1's main shape (P={P} Lr={Lr} Lw={Lw}): "
                  f"kernel_only_ms={k2_ms:.3f} against K1's {kms:.3f}: "
                  f"K1 - K2 = {kms - k2_ms:.3f} ms (K1's traceback and "
                  f"scratch, less K2's writes of its direction tensor)")
            rows[-1]["k2_same_problems_ms"] = k2_ms
    # the main path's most frequent K1 launch (phase 4's histogram)
    main = [r for r in rows if r["case"] == "path_P8192"][0]
    return [{"name": "banded_dp", "route": "cuda",
             "source": "soap3dp_tpu_torch/csrc/banded_dp.cu",
             "replaces": "soap3dp_tpu/kernels/banded_dp.py:606",
             "launches": 0, "max_abs_err": max_err,
             "ms": main["kernel_only_ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "peak": main["peak"], "library_ms": None, "call_ms": main["ms"],
             "cases": rows}]


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


def phase_wide_kernels(dev, peak_ops: float) -> list[dict]:
    """K2 and TB against their plain versions, and dp_align's wide route
    against the plain dp_align and K1 at the same shape."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rng = np.random.default_rng(20261017)
    P2, Lr2, Lw2 = 256, 127, 8192
    edge = make_problems(rng, P2, Lr2, Lw2)
    cases = [
        ("mate_window", main_path_problems(rng, 2048, 120, 4224, read_len=100),
         bd.DPScores()),
        ("edge", edge + ((edge[1] * 0.3).astype(np.int32),), bd.DPScores()),
        ("tb_relaunch", relaunch_problems(rng, 64, 127, 4096),
         bd.DPScores(1, -2, -1, -1)),
    ]
    rows = []
    max_err = 0
    for name, prob, sc in cases:
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
        act = (fwd[0] >= args[8]).cpu().numpy()
        tb_args = (args[1], fwd[1], fwd[2], args[4], act)
        tb = bd.dp_traceback(fwd[4], args[0], args[1], args[2], *tb_args[1:4],
                             act)
        tbp, plain_tb_ms = _host_ms(
            lambda: bd._dp_traceback_plain(fwd[4], *tb_args))
        tb_err = max(int(np.abs(np.asarray(x, np.int64)
                                - np.asarray(y, np.int64)).max(initial=0))
                     if np.shape(x) == np.shape(y) else 1
                     for x, y in zip(tb, tbp))
        # kernel-only times on the whole problem set, CUDA events
        params = bd._params(args[1], args[3], *args[4:8])
        fwd_ms = _events_ms(lambda: bd._launch_forward(
            args[0], args[2], params, fwd[4], sc), 3)
        tbq = torch.stack([args[1], fwd[1], fwd[2], args[4]], 1).to(
            torch.int32).contiguous()
        actd = torch.from_numpy(act.astype(np.uint8)).to(dev)
        mr = max(bd.MAX_RUNS, bd._max_runs_bound(Lr))
        tb_ms = _events_ms(lambda: bd._launch_traceback(
            fwd[4], tbq, actd, None, P, mr), 10)
        del fwd
        # dp_align's wide route against the plain dp_align and K1
        n_f, n_t = bd.FORWARD_KERNEL.launches, bd.TRACEBACK_KERNEL.launches
        got = bd.dp_align(*args, sc=sc)
        n_f = bd.FORWARD_KERNEL.launches - n_f
        n_t = bd.TRACEBACK_KERNEL.launches - n_t
        _, call_ms = _host_ms(lambda: bd.dp_align(*args, sc=sc), 3)
        want, plain_ms = _host_ms(lambda: bd.dp_align_plain(*args, sc=sc))
        k1, k1_ms = _host_ms(lambda: bd.dp_align_cuda(*args, sc=sc), 3)
        k1_kernel_ms = _kernel_only_ms(bd, args, 3, sc)
        ok_plain, e1 = _dp_equal(got, want)
        ok_k1, e2 = _dp_equal(got, k1)
        npass = int((np.asarray(want[6]) > 0).sum())
        f_peak, f_pname = forward_peak(Lr, sc, peak_ops)
        f_bms, f_by = k2_bound(prob, f_peak)
        ops_t, cnt_t = np.asarray(tb[0]), np.asarray(tb[1])
        moves = int(cnt_t[(ops_t >= 1) & (ops_t <= 4)].sum())
        t_bms, t_by = tb_bound(moves, P, mr, peak_ops)
        phase("kernel dp_forward+dp_traceback",
              f"{name}: P={P} Lr={Lr} Lw={Lw} fwd stats max_abs_err={err} "
              f"dirs bytes differing={ndiff} tb max_abs_err={tb_err} "
              f"dp_align==plain {ok_plain} dp_align==K1 {ok_k1} "
              f"passing_lanes={npass} launches fwd={n_f} tb={n_t} "
              f"call_ms={call_ms:.3f} kernel_ms fwd={fwd_ms:.3f} "
              f"tb={tb_ms:.3f} GCUPS={dp_cells(prob) / (fwd_ms * 1e6):.1f} "
              f"bound_ms fwd={f_bms:.4f} ({f_by}, {f_pname} peak, share "
              f"{f_bms / fwd_ms:.1%}) "
              f"tb={t_bms:.4f} ({t_by}, int32 peak, share "
              f"{t_bms / tb_ms:.1%}) "
              f"plain_ms={plain_ms:.3f} (fwd {plain_fwd_ms:.3f}, "
              f"tb {plain_tb_ms:.3f}) K1 call_ms={k1_ms:.3f} "
              f"K1 kernel_ms={k1_kernel_ms:.3f}")
        if err or ndiff or tb_err or not ok_plain or not ok_k1:
            fail(f"K2 / TB disagree with their plain versions ({name})")
        if name == "tb_relaunch" and n_t <= n_f:
            fail("the low-cutoff case did not re-launch the traceback kernel")
        if name != "tb_relaunch" and n_t != n_f:
            fail(f"the traceback kernel re-launched in {name}")
        max_err = max(max_err, err, tb_err, e1, e2)
        rows.append({"case": name, "P": P, "Lr": Lr, "Lw": Lw,
                     "call_ms": call_ms, "fwd_ms": fwd_ms, "tb_ms": tb_ms,
                     "plain_ms": plain_ms, "plain_fwd_ms": plain_fwd_ms,
                     "plain_tb_ms": plain_tb_ms, "k1_call_ms": k1_ms,
                     "k1_kernel_ms": k1_kernel_ms, "fwd_bound_ms": f_bms,
                     "fwd_bound_by": f_by, "fwd_peak": f_pname,
                     "tb_bound_ms": t_bms, "tb_bound_by": t_by,
                     "tb_moves": moves})
    main = rows[0]
    common = {"route": "cuda", "source": "soap3dp_tpu_torch/csrc/dp_forward.cu",
              "launches": 0, "max_abs_err": max_err, "library_ms": None}
    return [dict(common, name="dp_forward",
                 replaces="soap3dp_tpu/kernels/banded_dp.py:238",
                 ms=main["fwd_ms"], plain_ms=main["plain_fwd_ms"],
                 bound_ms=main["fwd_bound_ms"], bound_by=main["fwd_bound_by"],
                 peak=main["fwd_peak"], cases=rows),
            dict(common, name="dp_traceback",
                 replaces="soap3dp_tpu/kernels/banded_dp.py:409",
                 ms=main["tb_ms"], plain_ms=main["plain_tb_ms"],
                 bound_ms=main["tb_bound_ms"], bound_by=main["tb_bound_by"],
                 peak="int32")]


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


# the mate-pair library of phases 5 and 6: -/+ (StrandArrangement of the
# ini), inserts ~N(4000, 400) in [2100, 5900], aligned with -v 2000
# -u 6000 over the whole insert window (SOAP3DP_HALF_NARROW_PAD=0)
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

    return {"K1": bd.DP_KERNEL, "K2": bd.FORWARD_KERNEL,
            "TB": bd.TRACEBACK_KERNEL}


def _launches() -> dict:
    return {name: k.launches for name, k in _kernels().items()}


def _launch_shapes() -> dict:
    """{kernel: {"P x Lr x Lw": launches}} since the counts were last
    set to 0 (the shapes the path itself gave each kernel)."""
    return {name: {f"{p}x{lr}x{lw}": n for (p, lr, lw), n in
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
    after)."""
    import contextlib

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    tee = _Tee(sys.stderr)
    for k in _kernels().values():
        k.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(tee):
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
    return out, time.perf_counter() - t0, tee.text(), _launches()


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
    wall, log, launches = _run_cli(argv, dev, env)
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
        if launches["K1"] <= 0:
            fail("the run never launched the fused DP kernel (K1)")
        if mate_pair and min(launches["K2"], launches["TB"]) <= 0:
            fail("the full-window mate rescue never launched K2 and TB")
        if not mate_pair and launches["K2"] + launches["TB"]:
            fail("the default run launched K2 / TB: its windows are narrow")
    if profile:
        from soap3dp_tpu_torch.cli.main import main as cli_main
        res["profile"] = _profiled_pass(
            cli_main, argv[:-3] + [out + "_prof"] + argv[-2:], wall, out_dir)
    return res, {"r1": r1, "r2": r2, "planted": p1, "random": rand[0],
                 "index": idx_path, "opts": opts, "sam": out + ".sam",
                 "summary": summ}


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
    if dev.type == "cuda" and launches["K1"] <= 0:
        fail("the single-end salvage never launched K1")
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
    "rc = main(sys.argv[1:])\n"
    "print('[chip_smoke] launches', json.dumps({'K1': bd.DP_KERNEL.launches,"
    " 'K2': bd.FORWARD_KERNEL.launches, 'TB': bd.TRACEBACK_KERNEL.launches})"
    ", flush=True)\n"
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

    libs = [bd.BANDED_DP_LIB, bd.DP_FORWARD_LIB]
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
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind} | torch {torch.__version__} cuda "
                    f"{torch.version.cuda} | nvidia-smi: {card}")
    _build_all()

    peak_ops = int32_peak_ops()
    phase("device", f"int32 peak {peak_ops / 1e12:.2f} TOP/s (132 SMs x 64 "
                    f"lanes x {sm_max_clock_mhz():.0f} MHz), int16x2 peak "
                    f"{2 * peak_ops / 1e12:.2f} TOP/s (the 16-bit forward), "
                    f"memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    kernels = phase_kernels(dev, peak_ops) + phase_wide_kernels(dev, peak_ops)
    k1_err, k2_err = phase_range_cases(dev)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], k1_err)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], k2_err)
    phase_golden(dev)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    e2e, reads = phase_e2e(dev, 250_000_000, 100_000, card, work, OUT_DIR)
    small = phase_mate_pair_devices(
        dev, os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "mp_small"))
    mate, _ = phase_e2e(dev, 250_000_000, 100_000, card, work, OUT_DIR,
                        profile=False, mate_pair=True)
    single = phase_single_e2e(dev, reads, card, work, OUT_DIR)
    multi = {"card": card, "mesh": phase_mesh(dev, reads, work, OUT_DIR),
             "hosts": phase_hosts(dev, reads, work, OUT_DIR),
             "all_cards": phase_all_cards(dev, reads, work)}
    # launches on each kernel's main path: K1 on the default pair run,
    # K2 and TB on the mate-pair run
    kernels[0]["launches"] = e2e["launches"]["K1"]
    kernels[1]["launches"] = mate["launches"]["K2"]
    kernels[2]["launches"] = mate["launches"]["TB"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": kernels, "e2e": e2e,
                   "mate_pair_small": small, "mate_pair": mate,
                   "single": single, "multi_device": multi}, fh, indent=1)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "cases"} for r in kernels]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
