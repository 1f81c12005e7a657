"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card; no options

Phases, each printing one line, any failure exits non-zero:

1. device and build: the card's name and power limit, and the build of
   every kernel from csrc/ (one nvcc per source, started together:
   banded_dp.cu, dp_forward.cu, dp_wire.cu, fm_search.cu) with its
   registers and spills;
2. each kernel against its plain-torch version on the card, outputs
   exactly equal, both times printed with each kernel's bound and
   share (a kernel's time is its device time, torch.profiler's device
   events, with the CUDA-event time of a call in a loop of calls
   beside it): K1 (the fused DP) at the main path's shapes, then at the edges
   of the forward (reads of 31, 32, 33, 127, 128 and 2047 bases, ties
   on the best score across diagonals, anchors, alignments of more than
   128 runs); K2 (forward only) at K1's main shape (the
   difference is K1's traceback and scratch share) and, with TB (its
   traceback), at the mate-pair rescue window, an edge shape and a case
   of more than 128 runs, where dp_align's wide route is also held
   against K1 at the same shape and TB's window rule is replayed on K2's
   directions (every cell a walk visits inside the bytes its warp
   fetched; the windows and 32-byte sectors counted for TB's bound), no
   host sync counted inside the wide route's chunk loop (torch.cuda's
   sync debug mode over it, a sync made under it counted first); DW
   (the DP's result wire) against its plain version, every word of the
   wire, on K1's outputs at phase 4's largest call and on K2's and TB's
   at phase 5's, and at its edges (no lane passing, every lane passing,
   counts of 4,095, overflowed lanes, lanes one past a block's tile and
   an odd count of 16-bit words, one lane, 32-bit words), in 20 calls
   in a row on one stream whose shapes grow and shrink (DW_SEQUENCE)
   and from two host threads on two streams at once; beside phase 4's
   and 5's calls torch.masked_select of their runs (its library_ms) and
   an empty launch's device time;
   then K1 and K2 (every dirs byte) at
   the edges of the forward's two forms: reads of 255 bases at scores
   of magnitude 15 (the 16-bit form's limits: every base mismatched,
   the top score, long gaps), the same with one score at 16, and scores
   past 15 at the main path's shape, with anchors and at a K2 window
   (the 32-bit form). Then the seed search's kernels, FS1 (backward
   search), FS2 (SA decode: of ready rows; with the search's lane
   expansion, expand_decode, "FS2x"; with the DP seeding's,
   seed_expand_decode, "FS2s", its candidates as the u32 words of one
   packed transfer), FS3 (packed verify), FS4 (the hash dedupe), FS5
   (the lanes' counts, their scan and the result wire's flagged words;
   beside it torch.cumsum of the counts, its library_ms) and FS6 (the
   search's hit test and result wire), every output
   element equal to the plain version's, with each kernel's device time,
   its bound and share (bytes and 32-byte sectors of the reference's
   separate occ and BWT tables, and the sectors of the occ blocks the
   kernels read), its time when it read the separate tables (quoted
   from PERF.md) and the plain version's: the
   calls of the main path on phase 4's index (a 65,536-pair batch's
   search, the index built and cached here, and a deep-DP seeding of
   as many reads as phase 4's largest, 107,648 lanes), each FS1 branch
   at its edges, FS2
   at sa_rate 1, 2 and 8 and with the SA split over a two-replica mesh,
   the expansion's edges at the search's K (a total of 0, past K and
   equal to K, one lane holding every slot), the seeding expansion's
   (interval widths of 0, 1, 63, 64, 65 and 200, seeds at read offset 0
   and at the read's end, totals past K, equal to K and 0), the occ
   blocks' edges (every SA row of small indexes whose last block holds
   4, 2 or 3 words; seeds that decode below their start), FS3 at its
   edges, FS4 at its edges (uniq above and equal to K2, no pos_ok, K at
   the 1,024-slot table with collisions forced so that same-key losers
   survive, whose count must be above 0, K of 2^22 and of 3,363, every
   key in one slot, one key everywhere, and five calls in a row on the
   table it keeps), FS2s where its warps search
   for lanes (98% of the lanes empty, fewer lanes than a warp), FS5 at
   its edges (lanes not a multiple of the tile, an overflow on one
   strand only, cap 4,096, one read, the seeding's mode, a total of 0)
   and FS6 at its (reads not a multiple of 32, mismatches past k and
   127, K2 of 0), FS1-FS3, FS2s, FS5 and FS6 on a
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
   and the path's FS kernels: FS1, FS2x, FS2s, FS3, FS4, FS5 and FS6,
   GP and PK,
   and no K2: its windows are narrow; no plain search primitive, no
   plain prescan and no plain pack on the card) with a histogram of the
   launch shapes (phases 5, 6 and 7a likewise), the run's stage timers
   (SOAP3DP_TIMERS=1: BC.prescan beside BC.half_rescue, dp.pack beside
   dp.align; phase 5 likewise), then
   runs it once more under torch.profiler (device busy share, top device
   events in the output directory's e2e_profile.txt), and searches its
   first batch alone under torch.profiler (the search's device items
   beside PR 7's total, search_profile.txt; no cummax scan and no
   scatter-min; the result wires' bytes, the copy's time and the library
   launches beside the parent's; up to five profiles until one holds
   FS1's kernel); the measured run keeps the first call of each launch
   shape of FS1 to FS6, and after the phase each is held to its plain
   version, every element, with its device time and bound, failing on a
   launch shape no kept call ran at (the kernels line's FS2s is phase
   4's largest seeding); every dp_align call of the run (K1 and DW) is
   kept the same way and held to the plain dp_align, the whole tuple;
5. mate-pair: a -/+ library of 2-6 kbp inserts aligned with
   -v 2000 -u 6000 and SOAP3DP_HALF_NARROW_PAD=0 (the half rescue over
   the whole insert window, where dp_align takes K2 + TB). First 200
   pairs on a 200 kbp genome, on cuda and on cpu, SAM records equal;
   then 100,000 pairs on phase 4's 250 Mbp index, checking records,
   recall and the launches of K1, K2, TB, GP and PK; each launch shape
   of its dp_align calls (K1's and the wide route's, DW) held to the
   plain dp_align, the whole tuple, no host sync counted inside the wide
   route's chunk loop;
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
   prints "not run: 1 card";
8. accuracy, through the port's copy of the repo's accuracy harness
   (soap3dp_tpu_torch/tools/evaluate_accuracy.py run_eval: the whole
   pair path, seed search to MAPQ, on simulated mutated pairs): (a) the
   three gates of tests/test_accuracy.py at its genomes, seeds and
   sizes (easy and stressed on a 1 Mbp uniform genome, the repeat gate
   on tools/repeat_genome.py's 4 Mbp genome at lut_k 11), each on cuda
   and on the CPU route, the result dicts equal key for key, every
   record equal (CIGAR, mate fields and tags included) and the gate
   held; (b) repeat text at a real size: the repeat genome at 250 Mbp
   (seed 5, 24 chromosomes with N runs), its index built here (sa_rate
   2, lut_k 13) and cached, 50,000 pairs (1% substitutions, 0.1%
   indels, insert 300, k = 3, inserts kept off N runs) held to the
   repeat gate, with the MAPQ buckets, the PairSummary, wall and
   reads/s, the stage timers (SOAP3DP_TIMERS=1), the launches and
   launch shapes (K1, FS1, FS3, FS4, GP and PK must launch; no plain
   search primitive, prescan or pack on the card); the first call of
   each launch shape of every kernel, kept in the run, is then held to
   its plain version, every element, and no launch shape may go
   unheld; (c) 1,000 pairs on the same index on cuda and on the CPU
   route, the dicts and the records equal;
9. the A/B tools behind three of the port's defaults, through the
   port's copies of the repo's tools (soap3dp_tpu_torch/tools/), each
   run keeping the first call of each launch shape of every kernel's
   entry, held to its plain version after it (no launch shape may go
   unheld), with its launches and launch shapes, then a small run on
   cuda and on the CPU route over the same index, equal: (a) the storm
   gate (host_realign_budget) against complete host re-alignment
   (SOAP3DP_HOST_REALIGN_FULL=1), measure_storm_divergence.run on phase
   8's 250 Mbp repeat genome and cached index, 1,000 pairs a pool
   (uniform and repeat-enriched; the tool's 50,000 cut), each pool's
   diff dict, both arms' walls, PairSummary and storm-gate skips (the
   repeat pool's default arm must skip at least once); 100 pairs a pool
   cuda = cpu; (b) the
   phased search on and off, run_ab and divergence over phase 4's
   index, 100,000 of the JAX tool's pairs (insert 400, 0.5%
   substitutions, numpy seed 17); 1,000 pairs cuda = cpu, every record;
   (c) the DP seeding's exact against halved seeds,
   seed_sensitivity.measure over the JAX tool's 40 Mbp genome (numpy
   seed 7), its index built here at sa_rate 1 and lut_k 14 (a 2 GiB
   LUT) and cached, 20,000 reads at 4%: both arms' recall, candidates
   and seeding ms; 2,000 reads cuda = cpu, every candidate.

Then a `wall:` line (each part's seconds), one JSON line with the
kernels (K1, K2, TB, FS1, FS2, FS2x, FS3, FS4, FS2s, FS5, FS6, GP, PK,
DW, each with
its device time, its bound on this card, the share of the bound it
reaches and the operations peak the bound used: int16x2, twice the
int32 peak, where the 16-bit forward runs; its launches on the main
path, on phase 8's repeat text and, by A/B, on phase 9's), and the
last line
{"ok": true, "device": {...}}. Uses only soap3dp_tpu_torch (its own
index builder, readers and writers); imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
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
    any score: each alignment has ~Lr runs, past 128, the first run
    budget before the run budget."""
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
    1-base deletion, ~2 Lr runs, past 128 (the traceback's first run
    budget before the run budget, which re-launched it); the cutoff is
    far below any score."""
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
    diagonals, anchors, and alignments of more than 128 runs (K1's first
    run budget before the run budget, which re-launched it)."""
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


def k1_bound(prob, runs: int, peak_ops: float) -> tuple[float, str]:
    """K1: the recurrence's operations; inputs (reads, windows, the
    (P, 8) parameters) read once and outputs (stats (P, 8) and this
    run's ``runs`` run words, 2 or 4 bytes each) written once. Its
    direction scratch is internal."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    P, Lr = prob[0].shape
    Lw = prob[2].shape[1]
    nbytes = P * (Lr + Lw + 32 + 32) + runs * bd.word_bits(Lr, Lw) // 8
    return bound_ms(dp_cells(prob) * OPS_PER_CELL, nbytes, peak_ops)


def k2_bound(prob, peak_ops: float) -> tuple[float, str]:
    """K2: the same operations; inputs read once, its 4 stats words
    (P, 4) and the whole direction tensor (Lr+Lw, P, Lr+1), its output,
    written once."""
    P, Lr = prob[0].shape
    Lw = prob[2].shape[1]
    nbytes = P * (Lr + Lw + 32 + 16) + (Lr + Lw) * P * (Lr + 1)
    return bound_ms(dp_cells(prob) * OPS_PER_CELL, nbytes, peak_ops)


def tb_bound(moves: int, P: int, runs: int, peak_ops: float,
             path_bytes: int | None = None) -> tuple[float, str]:
    """TB: the direction byte of each cell on this run's paths (the
    walks' moves), each problem's rlen, clip_l and cutoff and its score
    and best cell read once, its 4 stats words and this run's ``runs``
    run words (4 bytes each) written once; a few operations per move.
    With ``path_bytes`` (the sectors its windows fetch) in place of the
    moves, the time of this design's own fetch volume, which is not a
    bound on the function."""
    nbytes = (moves if path_bytes is None else path_bytes) \
        + P * (12 + 12 + 16) + 4 * runs
    return bound_ms(moves * OPS_PER_CELL, nbytes, peak_ops)


def dw_bound(n: int, words: int, bits: int) -> tuple[float, str]:
    """DW: each lane's score, nrun, overflow flag and cutoff read once,
    the passing lanes' run words read and written once, the header
    written: bytes (its operations, a compare and an add a lane, are
    nothing beside them)."""
    return bound_ms(0, 16 * n + 2 * words * bits // 8 + 16, 1.0)


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
    """(device ms, call ms, timer) of one K1 launch into a result wire
    (no DW, no host copies), _timed."""
    reads, wins, params, _ = bd._packed(*args)
    P, Lr = reads.shape
    Lw = wins.shape[1]
    MR = bd.run_budget(Lr, Lw)
    wire, runs = bd._wire_buffers(P, MR, bd.word_bits(Lr, Lw), reads.device)
    stats = bd._wire_stats(wire, P)
    sc = sc or bd.DPScores()
    return _timed(lambda: bd._launch_dp(reads, wins, params, MR, stats, runs,
                                        sc), reps, "dp_align_kernel")


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


# the DP kernels of dp_align's two routes (kernels/banded_dp.py)
DP_LABELS = ("K1", "K2", "TB", "DW")


def run_k1_case(name: str, args: list, peak_ops: float, sc=None) -> dict:
    """One dp_align case on the card: dp_align on ``args`` (its nine
    inputs, on the card) against dp_align_plain on the same tensors,
    every element, under scores ``sc`` (default DPScores); the launches
    of K1, K2, TB and DW in the call and their shapes (``held_shapes``),
    the plain version's time, and where dp_align takes K1, K1's time and
    bound (the wide route's K2 and TB are timed in phase_wide_kernels).
    A wide-route case is labelled K2."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    sc = sc or bd.DPScores()
    kern = _kernels()
    before = {k: (kern[k].launches, dict(kern[k].shapes)) for k in DP_LABELS}
    got, first_ms = _host_ms(lambda: bd.dp_align(*args, sc=sc))
    launched = {k: kern[k].launches - before[k][0] for k in DP_LABELS}
    held = {k: ["x".join(map(str, shape))
                for shape, c in kern[k].shapes.items()
                if c > before[k][1].get(shape, 0)] for k in DP_LABELS}
    _, ms = _host_ms(lambda: bd.dp_align(*args, sc=sc), 3)
    want, plain_ms = _host_ms(lambda: bd.dp_align_plain(*args, sc))
    ok, err = _dp_equal(got, want)
    nrun = np.asarray(want[6])
    npass, runs = int((nrun > 0).sum()), int(nrun.sum())
    prob = [a.cpu().numpy() for a in args]
    P, Lr, Lw = prob[0].shape[0], prob[0].shape[1], prob[2].shape[1]
    row = {"case": name, "kernel": "K1", "shape": f"{P}x{Lr}x{Lw}",
           "held_shapes": held, "P": P, "Lr": Lr, "Lw": Lw,
           "launches": launched["K1"], "launched": launched,
           "max_nrun": int(nrun.max(initial=0)), "runs": runs,
           "max_abs_err": err, "dp_align_ms": ms, "first_ms": first_ms,
           "plain_ms": plain_ms}
    if bd.takes_wide_route(Lr, Lw):
        row["kernel"] = "K2"
        phase("kernel banded_dp",
              f"{name}: P={P} Lr={Lr} Lw={Lw} (the wide route) equal={ok} "
              f"max_abs_err={err} passing_lanes={npass} launches "
              f"{launched} first_ms={first_ms:.3f} dp_align_ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f}")
    else:
        kms, kcall, ktimer = _k1_ms(bd, args, sc=sc)
        peak, pname = forward_peak(Lr, sc, peak_ops)
        bms, by = k1_bound(prob, runs, peak)
        row.update(kernel_ms=kms, call_ms=kcall, timer=ktimer, bound_ms=bms,
                   bound_by=by, peak=pname)
        phase("kernel banded_dp",
              f"{name}: P={P} Lr={Lr} Lw={Lw} equal={ok} max_abs_err={err} "
              f"passing_lanes={npass} launches={launched} "
              f"first_ms={first_ms:.3f} dp_align_ms={ms:.3f} "
              f"kernel_ms={kms:.4f} ({ktimer}) call_ms={kcall:.4f} "
              f"GCUPS={dp_cells(prob) / (kms * 1e6):.1f} "
              f"bound_ms={bms:.4f} ({by}, {pname} peak) "
              f"share={bms / kms:.1%} plain_ms={plain_ms:.3f}")
    if not ok:
        fail(f"dp_align disagrees with its plain version ({name})")
    if launched["DW"] != 1:
        fail(f"dp_align launched DW {launched['DW']} times ({name})")
    return row


def phase_kernels(dev, peak_ops: float) -> list[dict]:
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rows = []
    max_err = 0
    for name, prob in k1_cases(np.random.default_rng(K1_SEED)):
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in prob]
        row = run_k1_case(name, args, peak_ops)
        if row["launches"] != 1:
            fail(f"{name} launched K1 {row['launches']} times")
        if name.startswith("overflow") and row["max_nrun"] <= 128:
            fail("the overflow case's runs do not pass 128, the first run "
                 "budget before the run budget")
        max_err = max(max_err, row["max_abs_err"])
        rows.append(row)
        if name == "Lr100_Lw768":
            # K2 on the same problems: what K1 adds is its traceback and
            # its direction scratch
            P, Lr, Lw, kms = row["P"], row["Lr"], row["Lw"], row["kernel_ms"]
            params = bd._packed(*args)[2]
            dirs = torch.empty((Lr + Lw, P, Lr + 1), dtype=torch.uint8,
                               device=dev)
            st = torch.empty((P, 8), dtype=torch.int32, device=dev)
            k2_ms, _, _ = _timed(lambda: bd._launch_forward(
                args[0], args[2], params, dirs, st, bd.DPScores()), 10,
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


def plain_align_from(fwd, args: list) -> tuple:
    """dp_align_plain's tuple on dp_align's nine inputs ``args``, its
    forward given (``fwd``: banded_dp._dp_forward_scan's outputs on the
    same inputs), so a case that holds K2 to the plain forward runs it
    once."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    params = bd.pack_params(args[1], *args[3:9])
    return bd._plain_tuple(fwd, torch.from_numpy(params), params[:, 6],
                           args[0].shape[1], args[2].shape[1])


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
        got = bd.dp_align_cuda(*args, sc=sc)
        n_k1 = bd.DP_KERNEL.launches - n0
        fwd = bd.dp_forward(*args[:8], sc=sc)
        plain = bd._dp_forward_scan(*args[:8], sc=sc)
        e2 = max(int((a.long() - b.long()).abs().max())
                 for a, b in zip(fwd[:4], plain[:4]))
        ndiff = int((fwd[4] != plain[4]).sum())
        del fwd
        # the plain dp_align from the same plain forward
        ok, e1 = _dp_equal(got, plain_align_from(plain, args))
        del plain
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
    edge shape (256 x 127 x 8192) and a case whose runs pass 128, TB's
    first budget before the run budget (banded_dp.run_budget); with
    ``small`` the same problems at a few problems and windows of a few
    hundred bases, for the CPU."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    P1, Lw1, P2, Lw2, P3, Lw3 = ((16, 600, 16, 500, 4, 400) if small else
                                 (2048, 4224, 256, 8192, 64, 4096))
    edge = make_problems(rng, P2, 127, Lw2)
    return [
        ("mate_window", main_path_problems(rng, P1, 120, Lw1, read_len=100),
         bd.DPScores()),
        ("edge", edge + ((edge[1] * 0.3).astype(np.int32),), bd.DPScores()),
        ("tb_long_runs", relaunch_problems(rng, P3, 127, Lw3),
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
        # the plain dp_align from the same plain forward (its traceback,
        # the plain wire and the parse)
        want, plain_wire_ms = _host_ms(lambda: plain_align_from(plain, args))
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
        # kernel times on the whole problem set: K2 into stats rows, TB
        # from them (each rewrites what it wrote)
        params = bd._packed(*args)[2]
        st = torch.empty((P, 8), dtype=torch.int32, device=dev)
        fwd_ms, fwd_call, fwd_timer = _timed(lambda: bd._launch_forward(
            args[0], args[2], params, fwd[4], st, sc), 3, "dp_forward_kernel")
        mr = bd.run_budget(Lr, Lw)
        runs_d = torch.empty((P, mr), dtype=torch.int32, device=dev)
        tb_ms, tb_call, tb_timer = _timed(lambda: bd._launch_traceback(
            fwd[4], params, st, runs_d, mr), 10, "dp_traceback_kernel")
        del fwd, runs_d
        # dp_align's wide route against the plain dp_align and K1, the
        # host syncs inside its chunk loop counted (bd.LOOP_SYNCS)
        n_f, n_t = bd.FORWARD_KERNEL.launches, bd.TRACEBACK_KERNEL.launches
        got = bd.dp_align(*args, sc=sc)
        n_f = bd.FORWARD_KERNEL.launches - n_f
        n_t = bd.TRACEBACK_KERNEL.launches - n_t
        _, call_ms = _host_ms(lambda: bd.dp_align(*args, sc=sc), 3)
        plain_ms = plain_fwd_ms + plain_wire_ms
        k1, k1_ms = _host_ms(lambda: bd.dp_align_cuda(*args, sc=sc), 3)
        k1_kernel_ms, _, _ = _k1_ms(bd, args, 3, sc)
        ok_plain, e1 = _dp_equal(got, want)
        ok_k1, e2 = _dp_equal(got, k1)
        npass = int((np.asarray(want[6]) > 0).sum())
        f_peak, f_pname = forward_peak(Lr, sc, peak_ops)
        f_bms, f_by = k2_bound(prob, f_peak)
        ops_t, cnt_t = np.asarray(tb[0]), np.asarray(tb[1])
        moves = int(cnt_t[(ops_t >= 1) & (ops_t <= 4)].sum())
        runs = int(np.asarray(tb[2]).sum())
        t_bms, t_by = tb_bound(moves, P, runs, peak_ops)
        t_fetch = tb_bound(moves, P, runs, peak_ops, SECTOR * sectors)[0]
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
        if n_t != n_f:
            fail(f"the traceback kernel launched {n_t} times for {n_f} "
                 f"forward launches in {name}")
        if name == "tb_long_runs" and np.asarray(tb[2]).max() <= 128:
            fail("the long-runs case's runs do not pass 128, TB's first "
                 "run budget before the run budget")
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


class watch_loop_syncs:
    """The host syncs inside the wide route's chunk loop counted
    (banded_dp.WATCH_LOOP_SYNCS, LOOP_SYNCS) while the block runs, on one
    thread; first a sync made inside the loop's watch must be counted,
    and on exit any counted sync fails the run."""

    def __init__(self, dev, where: str):
        self.dev, self.where = dev, where

    def __enter__(self):
        import torch

        from soap3dp_tpu_torch.kernels import banded_dp as bd

        if self.dev.type != "cuda":
            return self
        bd.WATCH_LOOP_SYNCS, bd.LOOP_SYNCS = True, 0
        with bd._chunk_loop():
            torch.zeros(1, device=self.dev).item()
        if bd.LOOP_SYNCS < 1:
            bd.WATCH_LOOP_SYNCS = False
            fail("the chunk loop's sync counter missed a sync (.item())")
        bd.LOOP_SYNCS = 0
        return self

    def __exit__(self, *exc):
        from soap3dp_tpu_torch.kernels import banded_dp as bd

        if self.dev.type != "cuda":
            return False
        bd.WATCH_LOOP_SYNCS = False
        if exc[0] is None:
            phase("dp wide chunk loop",
                  f"{self.where}: host syncs inside the wide route's chunk "
                  f"loop {bd.LOOP_SYNCS} (torch.cuda's sync debug mode over "
                  "the loop; a sync made under it counted first)")
            if bd.LOOP_SYNCS:
                fail(f"{bd.LOOP_SYNCS} host syncs inside the wide route's "
                     f"chunk loop ({self.where})")
        return False


# DW's edges (wire_edge_case): (lanes, run budget, word bits)
WIRE_EDGES = {"none_passing": (3000, 128, 16), "all_passing": (3000, 128, 16),
              "count_4095": (2048, 246, 16), "overflow_lanes": (5000, 246, 16),
              "ragged_2049": (2049, 7, 16), "ragged_4097_odd": (4097, 9, 16),
              "one_lane": (1, 5, 16), "words32": (2050, 246, 32)}


def wire_edge_case(name: str, seed: int = 13, shape=None) -> tuple:
    """DW's inputs at one of its edges, numpy: (params (n, 8) int32, the
    cutoff in word 6; stats (n, 8) int32; runs (n, MR) words, int16 for
    16 bits, int32 for 32, with garbage past each row's nrun as the
    kernels leave it): no lane passing (every cutoff above its score),
    every lane passing, counts of 4,095 (the 16-bit word's largest),
    overflowed lanes (excluded and counted), lanes one past a block's
    tile and 4,097 lanes with an odd word count (the last word's zero
    half), one lane, and 32-bit words with counts past 4,095. With
    ``shape`` (lanes, run budget, word bits) and a name of no edge, a
    random mix of passing, failing and empty lanes of that shape."""
    import soap3dp_tpu_torch.kernels.banded_dp as bd

    n, MR, bits = shape or WIRE_EDGES[name]
    rng = np.random.default_rng(seed)
    score = rng.integers(-50, 100, n)
    cutoff = rng.integers(0, 60, n)
    if name == "none_passing":
        cutoff = score + 1
    elif name == "all_passing":
        cutoff = score - rng.integers(0, 5, n)
    traced = score >= cutoff
    nrun = np.where(traced, rng.integers(1 if name == "all_passing" else 0,
                                         MR + 1, n), 0)
    of = np.zeros(n, np.int64)
    if name in ("overflow_lanes", "random"):
        over = traced & (rng.random(n) < 0.1)
        of[over], nrun[over] = 1, MR
    top = bd.CLIP16 if bits == 16 else (1 << 28) - 1
    cnt = rng.integers(1, top + 1, (n, MR))
    if name == "count_4095":
        cnt[rng.random((n, MR)) < 0.3] = bd.CLIP16
    words = (rng.integers(1, 6, (n, MR)) << (12 if bits == 16 else 28)) | cnt
    if name == "ragged_4097_odd" and int(nrun[traced].sum()) % 2 == 0:
        lane = int(np.flatnonzero(traced & (nrun < MR))[0])
        nrun[lane] += 1
    stats = np.stack([score, rng.integers(0, 120, n), rng.integers(0, 256, n),
                      rng.integers(1, 4, n), rng.integers(0, 200, n), nrun,
                      of, np.zeros(n, np.int64)], axis=1).astype(np.int32)
    params = np.zeros((n, 8), np.int32)
    params[:, 6] = cutoff
    return params, stats, words.astype(np.int16 if bits == 16 else np.int32)


def dw_library_call(params, stats, runs):
    """A callable of DW's one PyTorch call (LIBRARY_CALLS["DW"]) on the
    card, its mask made beforehand from the same inputs."""
    import torch

    n, MR = runs.shape
    nrun = stats[:, 5]
    passing = ((stats[:, 0] >= params[:, 6]) & (nrun > 0)
               & (stats[:, 6] == 0))
    keep = passing[:, None] & (torch.arange(MR, device=runs.device)[None, :]
                               < nrun[:, None])
    return lambda: torch.masked_select(runs, keep)


def run_wire_case(name: str, params, stats, runs, reps: int = 20,
                  library: bool = False) -> dict:
    """DW (banded_dp.dp_wire) against dp_wire_plain on the same inputs
    (on the card), every word of the wire; DW's device time (one kernel
    a call), its bound (dw_bound) and the plain version's time; with
    ``library``, the time of its one PyTorch call (dw_library_call)
    between marker kernels."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    n, MR = runs.shape
    bits = 16 if runs.dtype == torch.int16 else 32
    wire = bd.dp_wire(params, stats, runs)
    want, plain_ms = _host_ms(lambda: bd.dp_wire_plain(params, stats, runs))
    got = wire[:len(want)].cpu()
    err = int((got.long() - want.long()).abs().max())
    ok = bool(torch.equal(got, want))
    ms, call_ms, timer = _timed(lambda: bd._launch_wire(params, runs, wire),
                                reps, "dp_wire_")
    library_ms = (_library_ms(dw_library_call(params, stats, runs), reps)
                  if library else None)
    head = want[:bd.WIRE_HEADER].tolist()
    bms, by = dw_bound(n, head[2], bits)
    phase("kernel dp_wire",
          f"{name}: lanes={n} MR={MR} bits={bits} tiles={bd.wire_tiles(n)} "
          f"wire words={len(want)} header={head} equal={ok} "
          f"max_abs_err={err} kernel_ms={ms:.4f} ({timer}) "
          f"call_ms={call_ms:.4f} "
          f"bound_ms={bms:.6f} ({by}) share={bms / ms:.1%} "
          f"plain_ms={plain_ms:.3f}"
          + ("" if library_ms is None else
             f" library_ms={library_ms:.4f} ({LIBRARY_CALLS['DW']})"))
    if not ok:
        fail(f"DW disagrees with its plain version ({name})")
    return {"case": name, "kernel": "DW", "shape": f"{n}x{MR}x{bits}",
            "lanes": n, "MR": MR, "bits": bits, "header": head,
            "max_abs_err": err, "kernel_ms": ms, "call_ms": call_ms,
            "timer": timer, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms}


# DW calls in a row on one stream (dw_repeat_check): (lanes, run budget,
# word bits), growing and shrinking across its tile (64 lanes) and the
# path's shapes, both word widths
DW_SEQUENCE = [(1, 5, 16), (64, 246, 16), (65, 246, 16), (3000, 128, 16),
               (16384, 246, 16), (200, 9, 16), (4097, 9, 16),
               (2049, 7, 16), (1, 246, 32), (9000, 246, 32), (63, 12, 16),
               (16384, 246, 32), (128, 246, 16), (129, 3, 32),
               (20000, 31, 16), (7, 246, 16), (4096, 246, 16),
               (640, 246, 32), (1, 1, 16), (12345, 100, 16)]


def dw_repeat_check(dev, shapes=DW_SEQUENCE) -> dict:
    """DW's calls in a row on one stream, its inputs' shapes growing and
    shrinking (``shapes``, made by wire_edge_case), each wire word for
    word against dp_wire_plain, after every call was queued (so each
    call's statuses and tickets lie where the call before left its own);
    the scan state's generations and tickets they took (None where a
    call made the state anew, larger). Returns {"calls", "equal",
    "generations", "tickets", "tiles"}."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.kernels import fm_search as fs

    cases = [[torch.from_numpy(x).to(dev) for x in wire_edge_case(
        "random", 100 + k, shape)] for k, shape in enumerate(shapes)]
    torch.cuda.synchronize(dev)
    key = ("scan", dev.index, torch.cuda.current_stream(dev).cuda_stream)
    # the state as large as the sequence needs, so no call makes it anew
    tiles = [bd.wire_tiles(n) for n, _, _ in shapes]
    with fs._STATE_LOCK:
        before = fs.gen_state("scan", dev, key[2], 2 * max(tiles) + 1)
    wires = [bd.dp_wire(*c) for c in cases]
    equal = []
    for c, wire in zip(cases, wires):
        want = bd.dp_wire_plain(*c)
        equal.append(bool(torch.equal(wire[:len(want)].cpu(), want)))
    scan, gen, base = fs._STATES[key]
    same = scan is before[0]
    return {"calls": len(shapes), "equal": equal,
            "generations": gen - before[1] if same else None,
            "tickets": base - before[2] if same else None,
            "tiles": sum(tiles)}


def dw_thread_check(dev, calls: int = 10) -> dict:
    """DW from two host threads at once, each on a stream of its own
    (as a mesh's threads or the rescue flush's worker run their DP
    calls), ``calls`` calls each on inputs of its own, started together;
    every wire word for word against dp_wire_plain. Returns {"equal",
    "states"}: the scan states the two streams hold."""
    import threading

    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.kernels import fm_search as fs

    shapes = [DW_SEQUENCE[k % len(DW_SEQUENCE)] for k in range(2 * calls)]
    cases = [[torch.from_numpy(x).to(dev) for x in wire_edge_case(
        "random", 200 + k, shape)] for k, shape in enumerate(shapes)]
    torch.cuda.synchronize(dev)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    start = threading.Barrier(2)
    got: list = [None] * len(cases)
    errors = []

    def run(j):
        try:
            with torch.cuda.device(dev), torch.cuda.stream(streams[j]):
                start.wait()
                mine = range(j, len(cases), 2)
                wires = [bd.dp_wire(*cases[k]) for k in mine]
                for k, wire in zip(mine, wires):
                    got[k] = wire.cpu()
        except Exception as e:  # reported below, in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(j,)) for j in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    equal = []
    for c, wire in zip(cases, got):
        want = bd.dp_wire_plain(*c)
        equal.append(bool(torch.equal(wire[:len(want)], want)))
    states = sum(("scan", dev.index, s.cuda_stream) in fs._STATES
                 for s in streams)
    return {"equal": equal, "states": states}


def phase_wire(dev) -> list[dict]:
    """DW against its plain version, every word of the wire: on K1's
    outputs at phase 4's largest call (16,384 x 120 x 256) and on K2's
    and TB's at phase 5's (16,384 x 120 x 4,224), then at its edges
    (WIRE_EDGES). Returns the kernels line's DW row (phase 4's case)."""
    import torch

    from soap3dp_tpu_torch.kernels import banded_dp as bd

    rows = []
    for name, seed, Lw, outputs in (
            ("path4_K1", K1_SEED, 256, bd._k1_outputs),
            ("path5_wide", WIDE_SEED, 4224, bd._wide_outputs)):
        prob = main_path_problems(np.random.default_rng(seed), 16384, 120,
                                  Lw, read_len=100)
        reads, wins, params, _ = bd._packed(
            *[torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in prob])
        wire, runs = outputs(reads, wins, params, bd.DPScores())
        stats = bd._wire_stats(wire, 16384).clone()
        del wire, reads, wins
        rows.append(run_wire_case(name, params, stats, runs,
                                  library=True))
        del stats, runs
    for name in WIRE_EDGES:
        rows.append(run_wire_case(name, *[
            torch.from_numpy(x).to(dev) for x in wire_edge_case(name)]))
    repeat = dw_repeat_check(dev)
    threads = dw_thread_check(dev)
    floor = _kernel_device_ms(lambda: torch.cuda._sleep(0), 50,
                              "spin_kernel")
    phase("kernel dp_wire checks",
          f"{repeat['calls']} calls in a row on one stream "
          f"(DW_SEQUENCE): equal {sum(repeat['equal'])}/{repeat['calls']}, "
          f"generations {repeat['generations']}, tickets "
          f"{repeat['tickets']} of {repeat['tiles']} tiles; two threads on "
          f"two streams: equal {sum(threads['equal'])}/"
          f"{len(threads['equal'])}, scan states {threads['states']}; "
          f"path4_K1 {rows[0]['kernel_ms']:.4f} ms, path5_wide "
          f"{rows[1]['kernel_ms']:.4f} ms beside an empty launch "
          f"{floor:.4f} ms of device time (torch.cuda._sleep(0)), one "
          "launch's floor")
    if not all(repeat["equal"]) or not all(threads["equal"]):
        fail("DW disagrees with its plain version in calls in a row or "
             "from two threads")
    if repeat["generations"] not in (None, repeat["calls"]) \
            or repeat["tickets"] not in (None, repeat["tiles"]):
        fail(f"DW's calls in a row took {repeat['generations']} "
             f"generations and {repeat['tickets']} tickets, not "
             f"{repeat['calls']} and {repeat['tiles']}")
    if threads["states"] != 2:
        fail("DW's two streams did not each keep a scan state")
    torch.cuda.empty_cache()
    main = rows[0]
    return [{"name": "dp_wire", "route": "cuda",
             "source": "soap3dp_tpu_torch/csrc/dp_wire.cu",
             "replaces": "soap3dp_tpu/kernels/banded_dp.py:932",
             "launches": 0,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": main["kernel_ms"], "timer": main["timer"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"],
             "library_ms": main["library_ms"],
             "library_call": LIBRARY_CALLS["DW"],
             "call_ms": main["call_ms"],
             "wide_ms": rows[1]["kernel_ms"],
             "wide_library_ms": rows[1]["library_ms"],
             "empty_launch_ms": floor,
             "repeat": {**repeat, "equal": sum(repeat["equal"])},
             "threads": {**threads, "equal": sum(threads["equal"])},
             "cases": rows}]


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
# dedupe, FS5 the lanes' counts and their scan (the search's and the
# seeding's), FS6 the search's result wire.
FS_FUNCTIONS = {"seed_intervals": "FS1", "backward_search": "FS1",
                "backward_search_packed": "FS1", "sa_decode": "FS2",
                "expand_decode": "FS2x", "seed_expand_decode": "FS2s",
                "count_mismatches_rows": "FS3",
                "count_mismatches_packed": "FS3", "dedupe": "FS4",
                "lane_counts": "FS5", "search_wire": "FS6"}
# an entry's plain version, where it is not the entry's name + "_plain"
FS_PLAIN = {"seed_expand_decode": "seed_expand_plain"}
# the argument an entry writes in place (FS5: the wire's flagged words;
# FS6: the wire): a case gives the kernel and the plain version each
# its own copy (fresh_args)
FS_WRITES = {"lane_counts": 4, "search_wire": 0}


def plain_of(fn: str) -> str:
    """The name in fmindex of the plain version of entry ``fn``."""
    return FS_PLAIN.get(fn, fn + "_plain")


def fresh_args(fn: str, args: tuple) -> tuple:
    """``args`` with a copy of the tensor entry ``fn`` writes in place
    (FS_WRITES), so two calls do not share it."""
    i = FS_WRITES.get(fn)
    if i is None or len(args) <= i or not hasattr(args[i], "clone"):
        return args
    return args[:i] + (args[i].clone(),) + args[i + 1:]
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
# a lane of FS5: the width, its test against cap, the select, a scan
# step; a slot of FS6: the hit test, two clips, two shifts and three ors
OPS_COUNT_LANE = 4
OPS_WIRE_SLOT = 10
SECTOR = 32  # bytes the card moves for one scattered load
# the kernels' times at round 1 before their redesign, quoted from
# PERF.md section 6 in the summary lines only: FS1 and FS2 when they read
# the separate occ and BWT tables (FS2 then decoded ready rows after a
# plain-torch compaction of about 0.66 ms a launch, which FS2x now
# does), FS3 when it read a reverse complement base by base
BEFORE_REDESIGN_MS = {"FS1": 0.127, "FS2": 0.035, "FS3": 0.055}
# the search's scatter-min before FS4 (PR 7's run, PERF.md section 5)
SCATTER_MIN_BEFORE_MS = 0.219
# FS4, FS2s and FS2x at phase 4's largest call before PR 12 (five FS4
# kernels; a binary search a slot for its lane), the parent's replayed
# calls in compare_prescan.py on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md section 6), quoted in the summary lines only
SEARCH_REDESIGN_BEFORE_MS = {
    "FS4": "0.0176-0.0177 ms of events, a 0.0236-0.0278 ms span at "
           "524288x262144x20",
    "FS2s": "0.0342 ms at 524288x107648x2",
    "FS2x": "0.0423-0.0427 ms at 524288x524288x2",
    "FS5": "0.0094 ms, L2 evicted 0.0111, at round 1's 524,288 lanes; "
           "0.0042, evicted 0.0053, at the seeding's 107,648 (tiles of "
           "1,024 lanes, the flags by blocks that read l and r again)"}
# the search's device items of phase 4's first batch before FS4 (PR 7)
SEARCH_DEVICE_BEFORE_MS = 0.681
# the same batch's download and library launches before FS5 and FS6
# (compare_search.py, the parent tree, PERF.md section 6)
SEARCH_BEFORE_WIRE = ("9,437,200 bytes in one int64 vector, its copy "
                      "0.1727 ms; 35 library launches of 43; 0.606 ms of "
                      "device items")


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
                          (didx, ori, S,
                           fmindex.SeedLanes.given(t(start), t(length)),
                           steps, mode)))
    # a uniform-length batch of 90 bases in 100-wide rows: the reverse
    # complements of revcomp_reads_uniform
    uni, _ = sample_reads(rng, codes, B, L, np.full(B, 90))
    ori_u = fmindex.OrientedReads.of(
        t(pack_read_matrix(uni).view(np.int32)), t(np.full(B, 90, np.int32)),
        L, uniform_len=90)
    start = rng.integers(0, 60, N)
    length = rng.integers(0, k + 17, N)
    cases.append(("packed_uniform", "seed_intervals",
                  (didx, ori_u, S,
                   fmindex.SeedLanes.given(t(start), t(length)), 16,
                   "packed")))
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

    from soap3dp_tpu_torch.fm import fmindex

    n = didx.n
    seeds = fmindex.SeedLanes.given(t(rng.integers(0, 80, RS)),
                                    lens=t(rng.integers(20, 121, RS // S)))
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
                      (didx, t(l), t(np.cumsum(cnt)), seeds, S, K)))
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

    from soap3dp_tpu_torch.fm import fmindex

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
                      (didx, t(l), t(np.cumsum(cnt)),
                       fmindex.SeedLanes.given(t(sp)), S, K)))
    return cases


# FS5's edges: widths about a cap, the search's S lanes a strand and
# the seeding's; lanes not a multiple of the 1,024-lane tile
COUNT_EDGES = ("search_ragged", "search_one_strand", "search_cap4096",
               "search_one_read", "seed_ragged", "seed_total_0")


def lane_count_inputs(rng, B: int, S: int, cap: int, lo: int = 0,
                      hi: int = 1 << 32):
    """(l, r) numpy int64 of 2 B S lanes (rows b and B + b a read's two
    strands, S lanes a row): widths of 0, 1, cap - 1, cap, cap + 1 and
    5,000, l in [lo, hi - 6,000); read 0 overflows on its forward strand
    only, read 1 on its reverse strand only (B >= 2)."""
    RS = 2 * B * S
    width = rng.choice([0, 1, max(cap - 1, 0), cap, cap + 1, 5000],
                       RS).reshape(2 * B, S)
    if B >= 2:
        width[[0, 1, B, B + 1]] = 0
        width[0, S - 1] = width[B + 1, 0] = cap + 1
    l = rng.integers(lo, hi - 6000, RS)
    return l, l + width.reshape(-1)


def count_cases(rng, dev, B: int, S: int, seed_lanes: int, seed_S: int,
                name: str = "counts", edges=COUNT_EDGES, lo: int = 0,
                hi: int = 1 << 32) -> list[tuple[str, str, tuple]]:
    """FS5 at its edges: the search's mode at B reads of S lanes a strand
    (2 B S lanes; B is the path's plus 45, so the lanes are not a
    multiple of the tile), with an overflow on one strand only, at the
    round-3 cap of 4,096 and for one read; the seeding's mode at
    ``seed_lanes`` lanes of ``seed_S`` a row (the largest seeding call's
    107,648: 105 tiles and an eighth) and with every width 0."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def flags(b):
        return torch.empty(-(-b // 32), dtype=torch.int32, device=dev)

    cases = []
    for edge in edges:
        if edge.startswith("search"):
            b, cap = {"search_ragged": (B + 45, 16),
                      "search_one_strand": (45, 16),
                      "search_cap4096": (8192 + 45, 4096),
                      "search_one_read": (1, 256)}[edge]
            l, r = lane_count_inputs(rng, b, S, cap, lo, hi)
            cases.append((f"{name}_{edge}", "lane_counts",
                          (t(l), t(r), cap, S, flags(b))))
        else:
            rows = seed_lanes // seed_S
            l, r = lane_count_inputs(rng, rows // 2, seed_S, 64, lo, hi)
            if edge == "seed_total_0":
                r = l.copy()
            cases.append((f"{name}_{edge}", "lane_counts",
                          (t(l), t(r), 64, seed_S)))
    return cases


def count_edge_cases(rng, dev, name: str = "counts_edge"
                     ) -> list[tuple[str, str, tuple]]:
    """FS5 at the edges of its tile (fm_search.COUNT_TILE lanes): one
    lane; the seeding's mode (S = 1) at one below,
    at and one above one and two tiles; the search's (S = 1, lanes in
    pairs of strands) at two below, at and two above a tile, and 45 reads
    of S = 3 (an overflow on one strand only, lane_count_inputs);
    intervals past 2^31 in both modes; and lanes x cap just under 2^31
    (524,288 lanes of width cap = 4,095) in both modes."""
    import torch

    from soap3dp_tpu_torch.kernels import fm_search as fs

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def flags(b):
        return torch.empty(-(-b // 32), dtype=torch.int32, device=dev)

    def seeding(RS, lo=0, hi=1 << 32):
        l = rng.integers(lo, hi - 300, RS)
        return t(l), t(l + rng.choice([0, 1, 63, 64, 65, 200], RS))

    tile = fs.COUNT_TILE
    cases = [(f"{name}_one_lane", "lane_counts", seeding(1) + (64, 1))]
    for RS in (tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile + 1):
        cases.append((f"{name}_seed_{RS}", "lane_counts",
                      seeding(RS) + (64, 1)))
    for RS in (tile - 2, tile, tile + 2):
        l, r = lane_count_inputs(rng, RS // 2, 1, 16)
        cases.append((f"{name}_search_{RS}", "lane_counts",
                      (t(l), t(r), 16, 1, flags(RS // 2))))
    l, r = lane_count_inputs(rng, 45, 3, 16, lo=(1 << 31) + 7, hi=1 << 34)
    cases.append((f"{name}_search_past_2^31", "lane_counts",
                  (t(l), t(r), 16, 3, flags(45))))
    cases.append((f"{name}_seed_past_2^31", "lane_counts",
                  seeding(3 * tile + 5, (1 << 31) + 7, 1 << 34) + (64, 1)))
    RS = 524288
    cap = ((1 << 31) - 1) // RS
    l = rng.integers(0, 1 << 32, RS)
    for mode in ("seed", "search"):
        w = np.full(RS, cap)
        if mode == "search":    # all but one lane at cap: none passes it
            w[RS // 3] = cap + 1
        cases.append((f"{name}_{mode}_total_near_2^31", "lane_counts",
                      (t(l), t(l + w), cap, 2)
                      + ((flags(RS // 4),) if mode == "search" else ())))
    return cases


def seed_bound_cases(rng, didx, codes: np.ndarray, dev, B: int = 2048,
                     L: int = 120) -> list[tuple[str, str, tuple]]:
    """FS1 with its seeds made from the reads' lengths (SeedLanes), at
    the edges of the search's pigeonhole segments, in phase 4's
    120-wide packed rows: reads of length 0, reads shorter than S,
    seed_q truncating the segments, a seed range of (1, 3) of S = 3,
    lengths from 1 to 120, a batch padded to a mesh multiple with copies
    of read 0, a uniform batch; and the DP seeding's staged seeds
    (deep_dp_seed_matrix) with reads shorter than their seed, seeds past
    the read's end and reads of length 0."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.fm.search import pack_read_matrix
    from soap3dp_tpu_torch.pipeline import dp_rescue

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k = didx.lut_k
    cases = []
    for edge in ("len0", "shorter_than_S", "seed_q", "seed_range", "uneven",
                 "mesh_pad", "uniform"):
        lens = rng.integers(90, 101, B)
        seed_q, lo, hi, S_all, uniform = k + 3, 0, 3, 3, 0
        if edge == "len0":
            lens[::4] = 0
        elif edge == "shorter_than_S":
            lens[::3] = rng.integers(1, 3, len(lens[::3]))
        elif edge == "seed_q":
            seed_q = k
        elif edge == "seed_range":
            lo = 1
        elif edge == "uneven":
            lens = rng.integers(1, L + 1, B)
        elif edge == "uniform":
            lens[:] = 100
            uniform = 100
        reads, lens = sample_reads(rng, codes, B, L, lens)
        if edge == "mesh_pad":
            reads[-5:], lens[-5:] = reads[0], lens[0]
        ori = fmindex.OrientedReads.of(
            t(pack_read_matrix(reads).view(np.int32)), t(lens), L, uniform)
        seeds = fmindex.SeedLanes.pigeonhole(t(lens), S_all, lo, seed_q)
        mode = "packed" if seed_q > k else "general"
        cases.append((f"seeds_{edge}", "seed_intervals",
                      (didx, ori, hi - lo, seeds, seed_q - k + 2, mode)))
    for edge in ("short_reads", "pos_past_end", "len0"):
        lens = rng.integers(60, 101, B)
        if edge == "short_reads":
            lens[::3] = rng.integers(1, 30, len(lens[::3]))
        elif edge == "len0":
            lens[::5] = 0
        reads, lens = sample_reads(rng, codes, B, L, lens)
        sp, sl = dp_rescue.deep_dp_seed_matrix(lens, L)
        if edge == "pos_past_end":
            sp[::2, -1] = rng.integers(100, 200, len(sp[::2]))
        seeds = fmindex.SeedLanes.staged(t(sp), t(sl), t(lens))
        cases.append((f"seeds_staged_{edge}", "seed_intervals",
                      (didx, fmindex.OrientedReads.of(t(reads), t(lens)),
                       sp.shape[1], seeds, 40, "general")))
    return cases


def placement_cases(rng, didx, codes: np.ndarray, dev, B: int = 4096,
                    L: int = 120, M: int = 65536
                    ) -> list[tuple[str, str, tuple]]:
    """FS3 with its placements as the search's dedupe hands them over
    (count_mismatches_rows with ``valid``): rows clamped (the slots past
    the firsts hold ROW_SENTINEL), positions taken as 0 where a slot is
    not valid (they hold any value), each row's read length from the B
    lengths; packed rows of variable length and a uniform batch."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.fm.search import pack_read_matrix

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for edge, uniform in (("ragged", 0), ("uniform", 100)):
        lens = (np.full(B, uniform) if uniform
                else rng.integers(1, L + 1, B))
        reads, lens = sample_reads(rng, codes, B, L, lens)
        ori = fmindex.OrientedReads.of(
            t(pack_read_matrix(reads).view(np.int32)), t(lens), L, uniform)
        valid = rng.random(M) < 0.7
        urow = rng.integers(0, 2 * B, M)
        urow[~valid] = 0x7FFFFFFF
        utp = rng.integers(0, didx.n, M)
        utp[~valid] = rng.integers(0, 1 << 32, int((~valid).sum()))
        cases.append((f"verify_placements_{edge}", "count_mismatches_rows",
                      (didx, t(utp), ori, t(urow), t(lens), t(valid))))
    return cases


def wire_cases(rng, dev, B: int, K2: int, name: str = "wire",
               tp_lo: int = 0) -> list[tuple[str, str, tuple]]:
    """FS6 at its edges: B reads (plus 13, not a multiple of 32) and K2
    slots: 80% unique placements, their mismatches 0-3 (k = 2) or 200
    (past 127), the rest past uniq (ROW_SENTINEL, not valid); text
    positions in [tp_lo, 2^32); and K2 of 0 (the totals alone)."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    B += 13
    cases = []
    for tag, k2 in ((f"K2_{K2}", K2), ("K2_0", 0)):
        uniq = int(0.8 * k2)
        urow = np.full(k2, 0x7FFFFFFF, np.int64)
        urow[:uniq] = rng.integers(0, 2 * B, uniq)
        wire = torch.full((2 + -(-B // 32) + 2 * k2,), -7, dtype=torch.int32,
                          device=dev)
        cases.append((f"{name}_{tag}", "search_wire",
                      (wire, B, torch.tensor(3 * k2 // 2 + 5, device=dev),
                       torch.tensor(uniq, device=dev), t(urow),
                       t(rng.integers(tp_lo, 1 << 32, k2)),
                       t(np.arange(k2) < uniq),
                       t(rng.choice([0, 1, 2, 3, 200], k2)), 2)))
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


def same_slot_keys(rng, K: int, ok_share: float = 0.9):
    """K distinct keys whose hashes are one value, so that every key
    falls in one table slot whatever the table's size: distinct rows,
    each tp solved from its row (the tp product's factor is odd, so
    invertible mod 2^32); pos_ok for ``ok_share`` of them."""
    m = np.uint64(0xFFFFFFFF)
    h = np.uint64(rng.integers(0, 1 << 32))
    rows = rng.choice(1 << 20, K, replace=False).astype(np.uint64)
    inv = np.uint64(pow(0x85EBCA77, -1, 1 << 32))
    tps = (((rows * np.uint64(0x9E3779B1)) & m) ^ h) * inv & m
    return (rows.astype(np.int64), tps.astype(np.int64),
            rng.random(K) < ok_share)


def dedupe_more_cases(rng, dev, ragged: int = 3363
                      ) -> list[tuple[str, str, tuple]]:
    """FS4 at the edges of its two launches (phase 4's own shapes are
    path_cases'): K of ``ragged``, a multiple neither of a tile (1,024
    slots) nor of a block, with uniq > K2; every key distinct and in
    one table slot (same_slot_keys: each atomic on one slot, every
    pos_ok slot but the winner's a first); one key in every slot."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = [(f"dedupe_K_{ragged}", "dedupe",
              tuple(map(t, dedupe_keys(rng, ragged, ragged // 2)))
              + (ragged // 4,))]
    cases.append(("dedupe_one_slot", "dedupe",
                  tuple(map(t, same_slot_keys(rng, 4096))) + (4096,)))
    one = t(np.full(2000, 7, np.int64))
    cases.append(("dedupe_one_key", "dedupe",
                  (one, one * 1000, t(np.ones(2000, bool)), 64)))
    return cases


def dedupe_repeat_check(rng, dev) -> int:
    """FS4's table and the scan state it shares with FS5 are kept across
    calls on a card and stream: with both dropped first, keys A (a new
    table), A again, B (a table twice as large, so a new one, its
    generation from 1 again), A, B, each call held to the plain version,
    every element; on a card the tables, scan states, generations and
    ticket bases must be those. Fails otherwise. Returns the calls
    made."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.kernels import fm_search as fs

    def keys(K):
        return tuple(torch.from_numpy(a).to(dev)
                     for a in dedupe_keys(rng, K, K // 3, 0.6)) + (K // 2,)

    card = torch.device(dev).type == "cuda"
    where = (torch.device(dev).index, fs._stream(dev)) if card else None
    for kind in ("dedupe", "scan"):
        fs._STATES.pop((kind,) + (where or ()), None)
    a, b = keys(65536), keys(131072)
    calls = (("A", a), ("A", a), ("B", b), ("A", a), ("B", b))
    tables, scans = [], []
    for i, (name, args) in enumerate(calls):
        err, ndiff = _fs_diff(fmindex.dedupe(*args),
                              fmindex.dedupe_plain(*args))
        if err or ndiff:
            fail(f"FS4 call {i} ({name}) of a repeat disagrees with its "
                 f"plain version: {ndiff} elements differ")
        if card:
            table, gen, _ = fs._STATES[("dedupe",) + where]
            tables.append((table.data_ptr(), table.shape[0], gen))
            scan, gen, taken = fs._STATES[("scan",) + where]
            scans.append((scan.shape[0], gen, taken))
    if card and ([t[1:] for t in tables] != [
            (1 << 17, 1), (1 << 17, 2), (1 << 18, 1), (1 << 18, 2),
            (1 << 18, 3)] or tables[1][0] != tables[0][0]
            or tables[4][0] != tables[2][0]):
        fail(f"FS4's table across the repeat (address, slots, generation): "
             f"{tables}")
    if card and scans != [(65, 1, 64), (65, 2, 128), (129, 1, 128),
                          (129, 2, 192), (129, 3, 320)]:
        fail(f"FS4's scan state across the repeat (words, generation, "
             f"tickets): {scans}")
    phase("kernel fm_search FS4 repeat",
          f"{len(calls)} calls in a row (A, A, B, A, B) from no table, a "
          "new table and scan state at A and at B, every output equal to "
          "the plain version's")
    return len(calls)


def scan_share_check(rng, dev) -> int:
    """FS5's calls on the scan state it shares with FS4 (the ticket
    counter and the tagged statuses, kept across calls on a card and
    stream): with the states dropped first, FS5 in the search's mode
    (C), FS4 (A), C again, FS5 in the seeding's mode (D), FS4 on keys
    twice as many (B, a larger scan state), C; each call held to its
    plain version, every element (C's flagged words from a buffer of
    stale bits, which FS5 overwrites); on a card the scan state's size,
    generation and tickets taken after each call must be those. Fails
    otherwise. Returns the calls made."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.kernels import fm_search as fs

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    card = torch.device(dev).type == "cuda"
    where = (torch.device(dev).index, fs._stream(dev)) if card else None
    for kind in ("dedupe", "scan"):
        fs._STATES.pop((kind,) + (where or ()), None)
    Bc, S = 8237, 3
    c = tuple(map(t, lane_count_inputs(rng, Bc, S, 16))) + (16, S)
    l = rng.integers(0, 1 << 32, 70001)
    d = (t(l), t(l + rng.choice([0, 1, 64, 65], l.shape[0])), 64, 1)
    a = tuple(t(x) for x in dedupe_keys(rng, 65536, 65536 // 3, 0.6)) + (
        32768,)
    b = tuple(t(x) for x in dedupe_keys(rng, 131072, 131072 // 3, 0.6)) + (
        65536,)
    nf = fs.flag_words(Bc)

    def stale():
        return torch.full((nf,), -1, dtype=torch.int32, device=dev)

    calls = (("C", "lane_counts", c), ("A", "dedupe", a),
             ("C", "lane_counts", c), ("D", "lane_counts", d),
             ("B", "dedupe", b), ("C", "lane_counts", c))
    scans, tiles = [], {}
    for i, (name, fn, args) in enumerate(calls):
        extra = (stale(),) if name == "C" else ()
        plain = (torch.zeros(nf, dtype=torch.int32, device=dev),) \
            if name == "C" else ()
        err, ndiff = _fs_diff(getattr(fmindex, fn)(*args, *extra),
                              getattr(fmindex, plain_of(fn))(*args, *plain))
        if err or ndiff:
            fail(f"call {i} ({name}, {fn}) on the shared scan state "
                 f"disagrees with its plain version: {ndiff} elements differ")
        RS = args[0].shape[0]
        tiles[name] = (fs.dedupe_tiles(RS, args[3]) if fn == "dedupe" else
                       -(-RS // fs.COUNT_TILE))
        if card:
            scan, gen, taken = fs._STATES[("scan",) + where]
            scans.append((scan.shape[0], gen, taken))
    # gen_state's rule: a new scratch (the larger size, generation and
    # tickets from 0) where a call's tiles do not fit, else the next
    # generation and the tickets counted on
    want, size, gen, taken = [], 0, 0, 0
    for name, _, _ in calls:
        n = tiles[name]
        if size < n + 1:
            size, gen, taken = n + 1, 0, 0
        gen, taken = gen + 1, taken + n
        want.append((size, gen, taken))
    if card and scans != want:
        fail(f"the scan state FS4 and FS5 share, after each call (words, "
             f"generation, tickets): {scans}, not {want}")
    phase("kernel fm_search FS5 scan share",
          f"{len(calls)} calls in a row (FS5 search, FS4, FS5 search, FS5 "
          "seeding, FS4 on a larger scan state, FS5 search) from no scan "
          "state, every output equal to the plain version's"
          + (f"; scan state after each {scans}" if card else ""))
    return len(calls)


def seed_lane_cases(rng, didx, dev, RS: int, S: int
                    ) -> list[tuple[str, str, tuple]]:
    """FS2s where its warps look for their slots' lanes
    (warp_slot_lane): RS lanes, 98% of them empty (a warp's slots past
    its window of 32 lanes, which binary-search beyond it), all slots
    walked and the rest past the total; one row of S lanes (fewer lanes than a
    warp), K below the total and not a multiple of 32; RS lanes of
    SEED_WIDTHS with K odd, half the total."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n = didx.n

    def case(name, width, K):
        sp = rng.integers(0, 75, width.shape[0])
        l = rng.integers(0, n + 1 - width)
        return (name, "seed_expand_decode",
                (didx, t(l), t(np.cumsum(np.minimum(width, 64))),
                 fmindex.SeedLanes.given(t(sp)), S, K))

    sparse = np.where(rng.random(RS) < 0.98, 0, rng.integers(1, 65, RS))
    total = int(sparse.sum())
    few = np.resize(np.array([0, 64, 1, 30]), S)
    wide = rng.choice(SEED_WIDTHS, RS)
    return [case("seed_sparse", sparse, total + total // 4 + 1),
            case("seed_one_row", few, int(np.minimum(few, 64).sum()) - 55),
            case("seed_K_odd", wide,
                 int(np.minimum(wide, 64).sum()) // 2 | 1)]


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
                       fmindex.SeedLanes.given(torch.zeros_like(rows),
                                               lens=ones), 1, n + 1)))
        reads, lens = sample_reads(rng, genome.codes, B, L)
        ori = fmindex.OrientedReads.of(t(reads), t(lens), L)
        start = t(rng.integers(0, L, 2 * B * S))
        length = t(rng.integers(0, 41, 2 * B * S))
        cases.append((f"blocks_nw{r}_search", "seed_intervals",
                      (didx, ori, S, fmindex.SeedLanes.given(start, length),
                       40, "general")))
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
                      (didx, t(tp), ori, t(rows), t(lens))))
    words = fmindex.pack_reads(ori.matrix)[t(rows)]
    # reads of 90 bases in 100-wide rows, their reverse complements of
    # revcomp_reads_uniform
    uni, ulens = sample_reads(rng, codes, B, L, np.full(B, L - 10))
    ori_u = fmindex.OrientedReads.of(t(pack_read_matrix(uni).view(np.int32)),
                                     t(ulens), L, uniform_len=L - 10)
    cases.append(("verify_uniform", "count_mismatches_rows",
                  (didx, t(tp), ori_u, t(rows), t(ulens))))
    # the kernel's other widths, packed: 256-base rows (16 words, the
    # unrolled form's widest) and 300 (the runtime-width form)
    for Lx in (256, 300):
        lx = rng.integers(1, Lx + 1, B)
        lx[:len(edges)] = (Lx,) + RC_EDGES
        rx, lx = sample_reads(rng, codes, B, Lx, lx)
        ori_x = fmindex.OrientedReads.of(
            t(pack_read_matrix(rx).view(np.int32)), t(lx), Lx)
        cases.append((f"verify_L{Lx}", "count_mismatches_rows",
                      (didx, t(tp), ori_x, t(rows), t(lx))))
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
    """FS1-FS3 on a synthetic_index: random packed reads and their
    reverse complements, segments in each FS1 mode (LUT intervals
    anywhere in [0, n]), SA rows and placements over the whole text, a
    quarter of them past 2^31 or in the text's last words; FS2s's
    seeding expansion over the whole SA, FS5's intervals and FS6's text
    positions past 2^31."""
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
                      (didx, ori, S, fmindex.SeedLanes.given(start, length),
                       steps, mode)))
    cases.append(fs_decode_case(rng, "synthetic_decode", didx, dev))
    M = 65536
    tp = rng.integers(0, n, M)
    tp[: M // 4] = rng.integers(min(1 << 31, n // 2), n, M // 4)
    tp[M // 4: M // 4 + 64] = n - rng.integers(1, 200, 64)
    rows = rng.integers(0, 2 * B, M)
    cases.append(("synthetic_verify", "count_mismatches_rows",
                  (didx, t(tp), ori, t(rows), t(lens))))
    # FS2s, FS5 and FS6 with positions and intervals past 2^31 (the
    # packed words' high bit set)
    hi = min(1 << 31, n // 2)
    cases += seed_expand_cases(rng, didx, dev, N, S, "synthetic_seed",
                               ("widths",))
    cases += count_cases(rng, dev, B, S, N, S, "synthetic_counts",
                         ("search_ragged", "seed_ragged"), lo=hi, hi=n)
    cases += wire_cases(rng, dev, B, M, "synthetic_wire", tp_lo=hi)[:1]
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
    tensor never takes a plain version). With ``kept`` (a dict), the
    first call of each launch shape of a ``keep`` entry (of PATH_KEPT,
    or of HELD_ENTRIES) is kept there, {(entry, the arguments' shapes
    and ints, or for the entries in dp_rescue (GP's, PK's, K1's) their
    launch shape): its arguments, each tensor copied}; with
    ``launched_only``, only a call that launched its kernel."""

    def __init__(self, record: bool = True, kept: dict | None = None,
                 keep: tuple | None = None, launched_only: bool = False):
        self.record = record
        self.kept = kept
        self.keep = PATH_KEPT if keep is None else keep
        self.launched_only = launched_only
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
        if self.kept is not None:
            for fn_name in (n for n in RESCUE_KEPT + DP_KEPT
                            if n in self.keep):
                fn = getattr(dp_rescue, fn_name)
                self._saved[fn_name] = fn
                setattr(dp_rescue, fn_name, self._wrap(fn_name, fn))
        for name in FS_FUNCTIONS:
            entry = self.record or (self.kept is not None
                                    and name in self.keep)
            for fn_name in ((name, plain_of(name)) if entry
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
            elif self.record:
                self.calls.append((fn_name, args))
            keep = self.kept is not None and fn_name in self.keep
            if keep:
                counter = _kernels()[KEPT_LABEL.get(fn_name)
                                     or FS_FUNCTIONS[fn_name]]
                n0 = counter.launches
            out = fn(*args, **kw)
            if keep and (counter.launches > n0 or not self.launched_only):
                key = (fn_name,) + (rescue_shape(fn_name, args)
                                    if fn_name in KEPT_LABEL else tuple(
                    tuple(a.shape) if hasattr(a, "clone")
                    else a if isinstance(a, int) else None for a in args))
                if key not in self.kept:
                    if fn_name in DP_KEPT:  # (shards, scores): one shard
                        args = (list(args[0][0]),) + args[1:]
                    self.kept[key] = tuple(
                        [t.clone() if hasattr(t, "clone") else t.copy()
                         for t in a] if isinstance(a, list)
                        else a.clone() if hasattr(a, "clone") else a
                        for a in args)
            return out
        return call

    def __exit__(self, *exc):
        from soap3dp_tpu_torch.fm import fmindex
        from soap3dp_tpu_torch.pipeline import dp_rescue

        dp_rescue._prescan_plain = self._prescan_plain
        dp_rescue._pack_problems_plain = self._pack_plain
        for fn_name, fn in self._saved.items():
            setattr(dp_rescue if fn_name in KEPT_LABEL else fmindex,
                    fn_name, fn)
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


def _rc_bytes(ori) -> int:
    """The bytes of an OrientedReads' reverse-complement lengths."""
    return 0 if ori.rc_len is None else ori.rc_len.numel() * 4


def seed_bytes(seeds) -> int:
    """The bytes of a SeedLanes' tensors: the lanes' given starts and
    lengths, or the reads' lengths (and the staged seeds)."""
    return sum(t.numel() * t.element_size() for t in (
        seeds.start, seeds.length, seeds.lens, seeds.pos, seeds.slen)
        if t is not None)


def _fs1_lanes(fn: str, args: tuple) -> tuple:
    """An FS1 call as (code rows (R, L) int64, each lane's row, start,
    length, max_steps, mode) and the bytes of its inputs and outputs,
    each read or written once (the C array's 40 included): the lanes'
    starts and lengths where given, else the reads' lengths they are
    made from."""
    import torch

    if fn == "seed_intervals":
        ori, S, seeds, steps, mode = args[1:]
        codes = ori.matrix
        start, length = seeds.bounds(S)
        rows = torch.arange(start.shape[0], device=codes.device) // S
        src = (ori.reads.numel() * ori.reads.element_size()
               + _rc_bytes(ori) + seed_bytes(seeds))
        lanes = (codes.long(), rows, start.long(), length.long(), steps,
                 mode)
        return lanes, start.shape[0] * 16 + src + 40
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


def fs2x_replay(idx, l, incl, seeds, S: int, K: int):
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
    out = fmindex._placements(idx, valid, pos, lane, seeds, S)
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
    outputs (17 B each) and count; FS5 each lane's l, r and incl (24 B)
    and its flagged words; FS6 each slot's utp, nmis, uvalid and two
    words (25 B) and a hit's urow (8 B)."""
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
        l, incl, seeds, S, K = args[1:]
        out, probes, lf, gathers, walked, lanes, rows, levels = fs2x_replay(
            idx, l.long(), incl.long(), seeds, S, K)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail(f"FS2's expansion replay disagrees with {fn}_plain")
        RS = l.shape[0]
        # the cumsum once (its last element alone when no slot is
        # walked); l once a walked lane and its given start, or its
        # read's length (4 B a walked row), once (the split entry reads
        # l alone); the three keys (or lane, rank and step) once a slot
        given = seeds.start is not None
        io = ((RS * 8 if walked else 8) + 40
              + (lanes * 8 if idx.sa_parts else
                 lanes * (16 if given else 8) + rows * 4)
              + K * (24 if idx.sa_parts else 17))
        ops = (probes * OPS_SA_PROBE + lf * OPS_SA_LF
               + walked * (4 * levels + OPS_SA_PROBE))
        counts = {"slots": K, "lanes": RS, "walked": walked, "lf_steps": lf}
    elif label == "FS2s":
        from soap3dp_tpu_torch.fm import fmindex

        l, incl, seeds, S, K = args[1:]
        out, probes, lf, gathers, walked, lanes, levels, below = fs2s_replay(
            idx, l.long(), incl.long(), seeds.bounds(S)[0], S, K)
        if not torch.equal(fmindex.seed_words(*out), want):
            fail(f"FS2's seeding replay disagrees with {plain_of(fn)}")
        RS = l.shape[0]
        # the cumsum once (its last element alone when no slot is
        # walked); l and its given seed start once a walked lane, or the
        # staged seed (its position, length and read's length, 12 B) (the
        # split entry reads l alone); the three packed words (or lane,
        # rank and step) once a slot
        seed_b = 8 if seeds.start is not None else 12
        io = ((RS * 8 if walked else 8) + 40
              + lanes * (8 if idx.sa_parts else 8 + seed_b)
              + K * (24 if idx.sa_parts else 12))
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
    elif label == "FS5":
        # each lane's l and r read and its incl written once, the total
        # and the flagged words written once; a count, its scan and, in
        # the search's mode, its overflow test a few operations a lane
        l, flags = args[0], args[4] if len(args) > 4 else None
        RS = l.shape[0]
        nf = 0 if flags is None else flags.shape[0]
        io = 24 * RS + 8 + 4 * nf
        ops = RS * OPS_COUNT_LANE
        counts = {"lanes": RS, "mode": "seed" if flags is None else "search",
                  "total": int(want[1]), "flag_words": nf}
        gathers = {}
    elif label == "FS6":
        # each slot's utp and nmis (8 B), uvalid (1 B) read and its two
        # words written once, its urow (8 B) read where it holds a hit;
        # the totals read and written
        wire, B, _, _, urow, _, uvalid, nmis, k = args
        K2 = urow.shape[0]
        hits = int((uvalid & (nmis <= k)).sum())
        io = 25 * K2 + 8 * hits + 16 + 8
        ops = K2 * OPS_WIRE_SLOT
        counts = {"slots": K2, "reads": B, "hits": hits}
        gathers = {}
    else:
        tp, M = args[1].long(), args[1].shape[0]
        if fn == "count_mismatches_rows":
            # each placement's row, tp and (where given) valid, the
            # reads' lengths, rows and their reverse complements' lengths
            # read once, its count written once; tp 0 where not valid
            ori, rows, rlens = args[2], args[3].long(), args[4]
            valid = args[5] if len(args) > 5 else None
            rows = rows.clamp(0, 2 * ori.B - 1)
            lens = rlens.long()[rows % rlens.shape[0]]
            if valid is not None:
                tp = torch.where(valid, tp, 0)
            W = (ori.L + 15) // 16
            io = (M * (24 + (valid is not None)) + 4 * rlens.numel()
                  + ori.reads.numel() * ori.reads.element_size()
                  + _rc_bytes(ori))
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
# call launches: FS4 is two (dedupe_scatter, dedupe_scan)
FS_SYMBOLS = {"FS1": "fm_search_kernel", "FS2": "sa_decode_kernel",
              "FS2x": "expand_decode_kernel", "FS2s": "seed_expand_kernel",
              "FS3": "verify_kernel", "FS4": "dedupe_",
              "FS5": "lane_counts_kernel", "FS6": "search_wire_kernel"}
FS_KERNELS_PER_CALL = {"FS4": 2}


def _call_span_ms(fn, reps: int, symbol: str) -> tuple[float, float]:
    """(span, events) of a call of ``fn``, medians, ms: the device span
    from the start of its first kernel named ``symbol`` to the end of
    its last (the kernels and the gaps between them), and the sum of
    those kernels' device times; each call between two marker kernels
    (torch.cuda._sleep) of one torch.profiler profile; only calls that
    hold the most such events count (a profile may lose some). NaN if
    no call held one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    spans = _device_spans(prof)
    marks = [(a, b) for a, b, n in spans if "spin_kernel" in n]
    calls = []
    for (_, b0), (a1, _) in zip(marks, marks[1:]):
        ev = [(a, b) for a, b, n in spans if b0 <= a < a1 and symbol in n]
        if ev:
            calls.append((len(ev), max(b for _, b in ev) - ev[0][0],
                          sum(b - a for a, b in ev)))
    if not calls:
        return float("nan"), float("nan")
    most = max(c[0] for c in calls)
    calls = [c for c in calls if c[0] == most]
    return (float(np.median([c[1] for c in calls])) / 1e3,
            float(np.median([c[2] for c in calls])) / 1e3)


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


# FS5 and FS6 stream inputs that fit the 50 MB L2, where the path's
# kernel before them leaves them and where the repeated calls of a case
# find them, so at those sizes a call can beat the bound, which counts
# device-memory bytes; their cases are also timed with the L2 evicted
# before each call (cold_ms), a read of L2_EVICT_BYTES
COLD_TIMED = ("FS5", "FS6")
L2_EVICT_BYTES = 128 << 20


def _cold_device_ms(fn, reps: int, symbol: str, dev) -> float:
    """_kernel_device_ms of ``fn`` with the L2 evicted before each call:
    a sum over L2_EVICT_BYTES, more than the card's 50 MB L2, leaves
    clean lines of another buffer there, so the call reads its inputs
    from device memory and nothing is written back meanwhile."""
    import torch

    junk = torch.ones(L2_EVICT_BYTES // 4, dtype=torch.int32, device=dev)

    def call():
        junk.sum()
        fn()

    return _kernel_device_ms(call, reps, symbol)


# the one PyTorch call that computes (part of) a kernel's function, the
# kernels line's "library_ms": FS5's scan alone, torch.cumsum over the
# lanes' counts (not their counts or the flagged words); DW's
# compaction alone, the runs selected by the passing lanes' nrun
# prefixes (dw_library_call; not the counts, the header or the stats)
LIBRARY_CALLS = {"FS5": "torch.cumsum over the counts, the scan alone",
                 "DW": "torch.masked_select of the runs by the passing "
                       "lanes' arange(MR) < nrun mask, the compaction alone"}


def library_call(fn: str, args: tuple, want):
    """A callable of the one PyTorch call of LIBRARY_CALLS for a case of
    entry ``fn`` (its inputs from the case's, here FS5's counts from
    the plain version's scan ``want``), or None."""
    import torch

    if FS_FUNCTIONS[fn] != "FS5":
        return None
    incl = want[0]
    cnt = torch.diff(incl, prepend=incl.new_zeros(1))
    return lambda: torch.cumsum(cnt, 0)


def _library_ms(fn, reps: int) -> float:
    """Device time of a PyTorch call ``fn()``: the median over calls of
    the sum of its device events, whatever kernels the library launches
    (_call_span_ms, each call between marker kernels), else the
    CUDA-event time of a call."""
    ms = _call_span_ms(fn, reps, "")[1]
    return ms if ms == ms else _events_ms(fn, reps)


def run_fs_case(name: str, fn: str, args: tuple, peak_ops: float,
                reps: int = 20) -> dict:
    """One FS case on the card: the kernel's output against the plain
    version's, every element; the kernel's device time (torch.profiler,
    _timed) and its call's (CUDA events around a loop of wrapper calls, host
    work included), the plain version's, the bound (operations over the
    int32 peak or bytes over the memory rate, the larger), the same
    bound with every scattered gather a 32-byte sector, and with the
    sectors the kernel's walk touches in the occ blocks; FS5's and FS6's
    device time with the L2 evicted before each call too (COLD_TIMED)."""
    import torch

    from soap3dp_tpu_torch.fm import fmindex

    kern, plain = getattr(fmindex, fn), getattr(fmindex, plain_of(fn))
    label = FS_FUNCTIONS[fn]
    counter = _kernels()[label]
    t0 = time.perf_counter()
    n0, shapes0 = counter.launches, dict(counter.shapes)
    got = kern(*fresh_args(fn, args))
    torch.cuda.synchronize()
    launched = counter.launches - n0
    shape = [s for s, c in counter.shapes.items() if c > shapes0.get(s, 0)]
    want = plain(*fresh_args(fn, args))
    err, ndiff = _fs_diff(got, want)
    library = library_call(fn, args, want)
    library_ms = None if library is None else _library_ms(library, reps)
    per_call = FS_KERNELS_PER_CALL.get(label, 1)
    ms, call_ms, timer = _timed(lambda: kern(*args), reps,
                                FS_SYMBOLS[label], per_call)
    # several kernels a call: the call's device span beside their sum
    span_ms = (_call_span_ms(lambda: kern(*args), reps, FS_SYMBOLS[label])[0]
               if per_call > 1 else ms)
    cold_ms = (_cold_device_ms(lambda: kern(*args), reps, FS_SYMBOLS[label],
                               args[0].device)
               if label in COLD_TIMED else None)
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
          f"ms={ms:.4f} ({timer}) span_ms={span_ms:.4f} "
          f"call_ms={call_ms:.4f} bound_ms={bms:.4f} ({by}, int32 peak) "
          f"share={bms / ms:.1%} sector_bound_ms={sms:.4f} "
          f"sector_share={sms / ms:.1%} block_sector_bound_ms={bsms:.4f} "
          f"block_sector_share={bsms / ms:.1%} plain_ms={plain_ms:.3f} "
          + ("" if cold_ms is None else
             f"cold_ms={cold_ms:.4f} (L2 evicted) "
             f"cold_share={bms / cold_ms:.1%} ")
          + ("" if library_ms is None else
             f"library_ms={library_ms:.4f} ({LIBRARY_CALLS[label]}) ")
          + f"work={counts} wall_s={time.perf_counter() - t0:.2f}")
    if err or ndiff:
        fail(f"{label} disagrees with its plain version ({name})")
    if launched != 1:
        fail(f"{label} launched {launched} times for one call ({name})")
    return {"case": name, "kernel": label, "fn": fn, "shape": shape_s,
            "ms": ms, "span_ms": span_ms, "call_ms": call_ms, "timer": timer,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "sector_bound_ms": sms, "library_ms": library_ms,
            "cold_ms": cold_ms,
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
                     ) -> tuple[list[dict], list[dict], list[dict], dict]:
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
    the CPU; GP and PK (phase_prescan, phase_pack). Returns (every FS
    case's row, GP's and PK's rows of the JSON line, every GP and PK
    case's row, the repeat genome's result): main makes the FS rows of
    the JSON line (fs_kernel_rows) once phase 4's path_cases ran."""
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
    q = a[3].seed_q
    cases.append(("path_lut", "seed_intervals",
                  (a[0], a[1], a[2],
                   dataclasses.replace(a[3], seed_q=min(q, lut_k) if q > 0
                                       else lut_k), 0, "lut")))
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
    RS, S, K = a[1].shape[0], a[4], a[5]
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
    cases += dedupe_more_cases(rng, dev)
    cases += seed_lane_cases(rng, didx, dev, RSs, Ss)
    # FS5 at the search's and the seeding's lanes, FS6 at the round-1
    # search's reads and K2
    cases += count_cases(rng, dev, RS // (2 * S), S, RSs, Ss)
    cases += count_edge_cases(rng, dev)
    cases += seed_bound_cases(rng, didx, genome.codes, dev)
    cases += placement_cases(rng, didx, genome.codes, dev)
    a = next(args for fn, args in calls if fn == "search_wire")
    cases += wire_cases(rng, dev, a[1], a[4].shape[0])
    didx1, repeat = phase_repeat_search(dev)
    cases.append(fs_decode_case(rng, "decode_sa1", didx1, dev))
    cases += expansion_cases(rng, didx1, dev, RS, S, K, "expand_sa1",
                             ("zeros",))
    cases += seed_expand_cases(rng, didx1, dev, RSs, Ss, "seed_sa1",
                               ("widths",))
    cases += block_edge_cases(rng, dev)
    rows = [run_fs_case(name, fn, args, peak_ops) for name, fn, args in cases]
    fs5_floor_line(rows)
    collide = next(r for r in rows if r["case"] == "dedupe_collide_1024")
    if collide["surviving_dups"] <= 0:
        fail("the forced collisions left no same-key loser of a slot "
             "another key won")
    dedupe_repeat_check(rng, dev)
    scan_share_check(rng, dev)
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
    return (rows, [gp_kernel_row(gp_rows), pk_kernel_row(pk_rows)],
            gp_rows + pk_rows, repeat)


def fs5_floor_line(rows: list[dict]) -> None:
    """FS5 at the main path's two shapes (phase 2's path calls: the
    round-1 search's lanes and the largest seeding call's), warm and
    with the L2 evicted, beside an empty launch's device time
    (torch.cuda._sleep(0)), the floor of one launch."""
    import torch

    path = [r for r in rows if r["kernel"] == "FS5"
            and r["case"].startswith("path")]
    if not path:
        return
    parts = []
    for mode in ("search", "seed"):
        mine = [r for r in path if r["mode"] == mode]
        if mine:
            r = max(mine, key=lambda r: r["lanes"])
            share = r["bound_ms"] / r["ms"]
            parts.append(f"{mode} {r['lanes']} lanes {r['ms']:.4f} ms "
                         f"(evicted {r['cold_ms']:.4f}, bound "
                         f"{r['bound_ms']:.4f}, {share:.1%})")
    floor = _kernel_device_ms(lambda: torch.cuda._sleep(0), 50,
                              "spin_kernel")
    phase("kernel fm_search FS5 floor",
          "; ".join(parts) + f"; an empty launch {floor:.4f} ms of device "
          "time (torch.cuda._sleep(0)), one launch's floor; "
          f"before the redesign {SEARCH_REDESIGN_BEFORE_MS['FS5']} (PERF.md)")


# the entries phases 4 and 5 keep the first call of each launch shape of
# (_Recorder's ``kept``), held to their plain versions after the run:
# FS1 to FS6 in fmindex (phase 4), GP and PK in dp_rescue
FS_KEPT = ("seed_intervals", "expand_decode", "seed_expand_decode",
           "count_mismatches_rows", "dedupe", "lane_counts", "search_wire")
RESCUE_KEPT = ("_prescan_impl", "_pack_problems")
PATH_KEPT = FS_KEPT + RESCUE_KEPT
# the DP's entry as dp_rescue calls it (K1 or K2 + TB, then DW, which
# every call launches); phase 8 keeps every kernel's entries
DP_KEPT = ("dp_align_shards",)
HELD_ENTRIES = tuple(FS_FUNCTIONS) + RESCUE_KEPT + DP_KEPT
KEPT_LABEL = {"_prescan_impl": "GP", "_pack_problems": "PK",
              "dp_align_shards": "DW"}


def rescue_shape(fn_name: str, args: tuple) -> tuple:
    """The launch shape of a call of dp_rescue's ``fn_name`` (GP: M x O x
    Lr; PK: P x Lr x max_win; the DP, its first shard: P x Lr x Lw)."""
    if fn_name == "_prescan_impl":
        return (args[2].shape[0], args[3], args[1].shape[1])
    if fn_name == "dp_align_shards":
        shard = args[0][0]
        reads, wins = shard[0], shard[1 if len(shard) == 4 else 2]
        return (reads.shape[0], reads.shape[1], wins.shape[1])
    return (args[2].shape[0], args[1].shape[1], args[3])


def path_cases(kept: dict, tag: str = "path4"
               ) -> list[tuple[str, str, tuple]]:
    """FS cases, (name, entry, arguments), of the calls a run kept
    (_Recorder's ``kept``; phase 4: FS2x's, FS2s's and FS4's): each
    launch shape of each FS entry, its real inputs, in FS_FUNCTIONS'
    order, the largest int argument of each entry first; named
    ``tag``_entry_i."""
    entries = list(FS_FUNCTIONS)
    order = sorted((key for key in kept if key[0] in FS_FUNCTIONS),
                   key=lambda key: (entries.index(key[0]), -max(
                       (x for x in key[1:] if isinstance(x, int)),
                       default=0)))
    return [(f"{tag}_{key[0]}_{i}", key[0], kept[key])
            for i, key in enumerate(order)]


def nine_inputs(shard: list) -> list:
    """dp_align's nine inputs of a dp_align_shards shard: as given, or
    from dp_align_packed's four (reads, wins, params, host cutoffs), the
    vectors the columns of params."""
    if len(shard) == 9:
        return shard
    reads, wins, params, _ = shard
    return [reads, params[:, 0], wins] + [params[:, k] for k in range(1, 7)]


def k1_kept_cases(kept: dict, tag: str) -> list[tuple[str, list, object]]:
    """dp_align cases, (name, its nine inputs, scores), of the calls a
    run kept (_Recorder's ``kept``): each launch shape, its real inputs,
    the largest first; named ``tag``_K1_PxLrxLw (K2_ on the wide
    route)."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    keys = sorted((k for k in kept if k[0] in DP_KEPT),
                  key=lambda k: -k[1] * k[2] * k[3])
    return [(f"{tag}_{'K2' if bd.takes_wide_route(*key[2:]) else 'K1'}_"
             + "x".join(map(str, key[1:])), nine_inputs(kept[key][0]),
             kept[key][1]) for key in keys]


def run_held_cases(kept: dict, tag: str, dev, peak_ops: float
                   ) -> list[dict]:
    """Every call a run kept, held to its plain version on the card,
    every element, timed, with its bound: the FS entries' (path_cases,
    run_fs_case), GP's and PK's (run_rescue_cases), K1's (run_k1_case)."""
    return ([run_fs_case(name, fn, args, peak_ops)
             for name, fn, args in path_cases(kept, tag)]
            + run_rescue_cases(kept, tag, dev, peak_ops)
            + [run_k1_case(name, args, peak_ops, sc)
               for name, args, sc in k1_kept_cases(kept, tag)])


def hold_dp_calls(kept: dict, tag: str, launch_shapes: dict, dev,
                  peak_ops: float) -> list[dict]:
    """A phase's kept dp_align calls (k1_kept_cases), each held to the
    plain dp_align, the whole tuple (run_k1_case); fails on a launch
    shape of K1, K2, TB or DW (``launch_shapes``, the run's
    _launch_shapes) that no held call ran at."""
    import torch

    rows = [run_k1_case(name, args, peak_ops, sc)
            for name, args, sc in k1_kept_cases(kept, tag)]
    torch.cuda.empty_cache()
    unheld = unheld_shapes({k: v for k, v in launch_shapes.items()
                            if k in DP_LABELS}, rows)
    phase("kernel banded_dp path calls",
          f"{tag}: {len(rows)} dp_align calls, each launch shape's first, "
          "held to the plain dp_align on the same inputs: every element "
          f"equal; launch shapes not held: {unheld or 'none'}")
    if unheld:
        fail(f"{tag} launched {unheld}, shapes whose calls were not held "
             "to their plain versions")
    return rows


def hold_path_calls(kept: dict, launch_shapes: dict, peak_ops: float
                    ) -> list[dict]:
    """Phase 4's kept FS calls (path_cases), each held to its plain
    version, every element (run_fs_case); fails on a launch shape of an
    FS_PATH kernel (``launch_shapes``, the run's _launch_shapes) that no
    held call ran at."""
    rows = [run_fs_case(name, fn, args, peak_ops)
            for name, fn, args in path_cases(kept)]
    unheld = unheld_shapes({k: v for k, v in launch_shapes.items()
                            if k in FS_PATH}, rows)
    phase("kernel fm_search path calls",
          f"{len(rows)} of phase 4's FS calls, each launch shape's first, "
          "held to their plain versions on the same inputs: every element "
          f"equal; launch shapes not held: {unheld or 'none'}")
    if unheld:
        fail(f"phase 4 launched {unheld}, shapes whose calls were not "
             "held to their plain versions")
    return rows


def unheld_shapes(launch_shapes: dict, rows: list[dict]) -> dict:
    """{kernel: [launch shape]}: each shape of a run's launch-shape
    histogram (_launch_shapes) that no held case (``rows``: run_fs_case,
    run_prescan_case, run_pack_case or run_k1_case rows; a dp_align
    case's with the shapes each DP kernel launched at in it,
    ``held_shapes``) ran at."""
    held = {(r["kernel"], r["shape"]) for r in rows} | {
        (k, s) for r in rows for k, shapes in r.get("held_shapes", {}).items()
        for s in shapes}
    out = {k: [s for s in shapes if (k, s) not in held]
           for k, shapes in launch_shapes.items()}
    return {k: v for k, v in out.items() if v}


def rescue_case(kernel: str, reads, words, n_pac: int, *ints) -> dict:
    """The case (run_prescan_case's or run_pack_case's dict) of a GP or PK
    call's reads and words (host arrays or tensors) and its ints (GP: O,
    W; PK: max_win): the words decoded (dp_rescue.rescue_fields), a
    row's reverse-complement length each of its problems' (rescue_words
    packs them so)."""
    import torch

    from soap3dp_tpu_torch.pipeline import dp_rescue

    reads = reads.cpu().numpy() if torch.is_tensor(reads) else reads
    words = torch.as_tensor(words).cpu()
    read, rev, ws, rc_len, *more = (
        t.numpy() for t in dp_rescue.rescue_fields(words))
    lens = np.zeros(len(reads), np.int64)
    lens[read] = rc_len
    if kernel == "GP":
        c = _prescan_inputs(reads, lens, read, rev.astype(np.int8), ws,
                            more[0], more[1], int(ints[0]))
        c["W"] = int(ints[1])
        return c
    return {"reads": reads, "lens": lens, "cread": read, "strand": rev,
            "win_start": ws, "un": 0, "max_win": int(ints[0]),
            "n_pac": n_pac}


def rescue_cases(kept: dict, tag: str) -> list[tuple[str, str, dict, object]]:
    """GP and PK cases, (name, kernel, case dict as run_prescan_case and
    run_pack_case take it, the call's index), of the calls a run kept
    (_Recorder's ``kept``): each launch shape of GP and PK, its real
    inputs (rescue_case), the largest first; named ``tag``_GP_MxOxLr,
    ``tag``_PK_PxLrxW."""
    out = []
    for key in sorted((k for k in kept if k[0] in RESCUE_KEPT),
                      key=lambda k: (RESCUE_KEPT.index(k[0]),
                                     -k[1] * k[2] * k[3])):
        idx, *a = kept[key]
        kernel = "GP" if key[0] == "_prescan_impl" else "PK"
        shape = "x".join(map(str, key[1:]))
        out.append((f"{tag}_{kernel}_{shape}", kernel,
                    rescue_case(kernel, *a[:2], idx.pac.shape[0], *a[2:]),
                    idx))
    return out


def run_rescue_cases(kept: dict, tag: str, dev, peak_ops: float
                     ) -> list[dict]:
    """Each GP and PK call a run kept (rescue_cases) as a case on the
    card: held to its plain version, every element, timed, with its
    bound."""
    return [run_prescan_case(name, c, idx, dev, peak_ops) if kernel == "GP"
            else run_pack_case(name, c, idx, dev)
            for name, kernel, c, idx in rescue_cases(kept, tag)]


FS_ROWS = {  # label: (name in the JSON line, the TPU-side code it replaces)
    "FS1": ("fm_backward_search", "soap3dp_tpu/fm/fmindex.py:391"),
    "FS2": ("fm_sa_decode", "soap3dp_tpu/fm/fmindex.py:509"),
    "FS2x": ("fm_expand_decode", "soap3dp_tpu/fm/search.py:247"),
    "FS3": ("fm_packed_verify", "soap3dp_tpu/fm/fmindex.py:653"),
    "FS4": ("fm_hash_dedupe", "soap3dp_tpu/fm/search.py:275"),
    "FS2s": ("fm_seed_expand_decode",
             "soap3dp_tpu/pipeline/dp_rescue.py:176"),
    "FS5": ("fm_lane_counts", "soap3dp_tpu/fm/search.py:232"),
    "FS6": ("fm_search_wire", "soap3dp_tpu/fm/search.py:322")}


def fs_kernel_rows(rows: list[dict]) -> list[dict]:
    """The JSON line's rows of FS1, FS2 (sa_decode of ready rows), FS2x
    (FS2's expand_decode), FS3, FS4 (the dedupe) and FS2s (FS2's
    seed_expand_decode): each kernel's largest main-path call (FS1,
    FS2x, FS3 and FS4: the round-1 search of a phase-4 batch; FS2s:
    phase 4's largest deep-DP seeding (path_cases); FS2, on no path
    since FS2s took the seeding: its largest case), with the largest
    difference over every case of that kernel and the bound with the
    sectors of the occ blocks; each printed on one line beside what ran
    before it, quoted from PERF.md (BEFORE_REDESIGN_MS,
    SCATTER_MIN_BEFORE_MS, SEARCH_REDESIGN_BEFORE_MS)."""
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
               "ms": main["ms"], "span_ms": main.get("span_ms", main["ms"]),
               "timer": main["timer"], "plain_ms": main["plain_ms"],
               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "peak": "int32", "sector_bound_ms": main["sector_bound_ms"],
               "block_sector_bound_ms": main.get("block_sector_bound_ms"),
               "library_ms": main.get("library_ms"),
               "cold_ms": main.get("cold_ms"), "shape": main["shape"],
               "case": main["case"]}
        out.append(row)
        block = row["block_sector_bound_ms"]
        before, last = BEFORE_REDESIGN_MS, SEARCH_REDESIGN_BEFORE_MS
        was = {"FS2x": "a binary search a slot before PR 12: "
                       f"{last['FS2x']}; before its redesign FS2 "
                       f"{before['FS2']:.3f} ms after the plain-torch "
                       "compaction, PERF.md",
               "FS4": f"call span {row['span_ms']:.4f} ms; its five "
                      f"kernels before the redesign {last['FS4']}; "
                      "before FS4 plain torch, whose scatter-min alone took "
                      f"{SCATTER_MIN_BEFORE_MS:.3f} ms of PR 7's search, "
                      "PERF.md",
               "FS2s": "a binary search a slot before the redesign: "
                       f"{last['FS2s']}; before FS2s plain torch "
                       "(a slot mask of 64 a lane, its nonzero, FS2), "
                       "PERF.md; its packed words since FS5",
               "FS5": "before its redesign: "
                      f"{last['FS5']}; before FS5 plain torch: the width, "
                      "overflow mask, any, where, clamp and torch.cumsum "
                      "(8 launches in the search, 3 in the seeding); one "
                      "PyTorch call, "
                      f"{LIBRARY_CALLS['FS5']}: "
                      + ("-" if row["library_ms"] is None
                         else f"{row['library_ms']:.4f} ms"),
               "FS6": "before FS6 plain torch: the hit test, where, stack "
                      "and an int64 cat of 32 bytes a slot"}.get(
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
              + ("" if row["cold_ms"] is None else
                 f"; L2 evicted {row['cold_ms']:.4f} ms, bound "
                 f"{row['bound_ms'] / row['cold_ms']:.1%}")
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
# GP's and PK's spans before their redesign (ms), at each launch shape
# of phases 4 and 5 (phase 4's where a shape is in both): the parent's
# replays of the real calls (compare_prescan.py, PERF.md section 6)
RESCUE_BEFORE_MS = {
    "GP": {"4598x384x120": 0.0126, "8532x384x120": 0.0208,
           "4552x4224x120": 0.0726, "8655x4224x120": 0.1264},
    "PK": {"512x120x256": 0.0060, "1024x120x256": 0.0061,
           "4096x120x256": 0.0057, "8192x120x256": 0.0088,
           "16384x120x256": 0.0175, "8192x120x4224": 0.0265,
           "16384x120x4224": 0.0483}}
# the edges' genome: its bases and its run of A (start, length)
PRESCAN_GENOME_N, PRESCAN_POLY_A = 40_000, (12_000, 800)
PRESCAN_MIXED = (1, 15, 16, 17, 31, 32, 33, 100, 120, 250)
# the edges of the aligned loads GP and PK read their rows with
# (csrc/fm_search.cu oriented16): rows of these widths start off 8- and
# 16-byte boundaries; reverse complements of rc_edge_lengths(L) bases;
# the batch's last row ending off a 16-byte boundary; code 4 at the
# first and last bytes of 4- and 16-byte groups (ROW_GROUP_EDGES)
ROW_EDGE_WIDTHS = (100, 101, 127, 128, 250)
ROW_EDGES = tuple(f"width_{L}" for L in ROW_EDGE_WIDTHS) + (
    "last_row", "code_4_groups")
ROW_GROUP_EDGES = (0, 3, 4, 7, 12, 15, 16, 31, 32, 47)
PRESCAN_EDGES = ("mixed_lengths", "rc_length_apart", "no_valid",
                 "full_room", "poly_a", "genome_end", "shared_read", "one",
                 "above_chunk") + ROW_EDGES
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


def rc_edge_lengths(L: int) -> tuple:
    """The reverse complements' lengths an aligned-load edge of rows of
    L bases holds: 1, the 8-byte word's edges, the 16-byte one's, L - 1,
    L, and past the row (the plain version clamps the source index)."""
    return (1, 7, 8, 9, 15, 16, 17, L - 1, L, L + 5)


def row_edge_reads(rng, name: str, codes=None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(reads (B, L) codes, lens (B,) the reverse complements' lengths,
    pos (B,)) of the aligned-load edge ``name`` of ROW_EDGES: B odd, so
    that the batch's last row ends off a 16-byte boundary (not at L =
    128); rows 0-9 of rc_edge_lengths(L), the last row's L + 5 (L - 1 in
    last_row), the rest at random in 0..L. With ``codes``, row b is cut
    from them at pos[b] (odd rows as the reverse complement of their
    lens[b] bases), else random. In code_4_groups, code 4 at
    ROW_GROUP_EDGES of each forward row and of its reverse complement."""
    L = int(name[6:]) if name.startswith("width_") else 120
    B = 33 if name == "last_row" else 41
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, B)
    lens[:10] = rc_edge_lengths(L)
    lens[-1] = L - 1 if name == "last_row" else L + 5
    pos = np.zeros(B, np.int64)
    if codes is not None:
        pos = rng.integers(0, len(codes) - L, B)
        for b in range(B):
            seg = codes[pos[b]:pos[b] + L]
            n = int(min(lens[b], L))
            if b % 2:
                reads[b, :n] = 3 - seg[:n][::-1]
            else:
                reads[b] = seg
    if name == "code_4_groups":
        for b in range(B):
            reads[b, list(ROW_GROUP_EDGES)] = 4
            at = lens[b] - 1 - np.array(ROW_GROUP_EDGES)
            reads[b, at[(at >= 0) & (at < L)]] = 4
    return reads, np.asarray(lens, np.int64), pos


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
    more candidates than the plain version's chunk; and the aligned
    loads' edges (ROW_EDGES, row_edge_reads: every row on both strands,
    on its own window on the strand it was cut for, 16 more candidates
    of the last row)."""
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
    if name in ROW_EDGES:  # every row on both strands (cut on one)
        reads, lens_rows, pos = row_edge_reads(rng, name, codes)
        B, L = reads.shape
        off = rng.integers(0, 50, B)
        rlens = np.clip(lens_rows, 1, L)
        rlens[::7] = L
        extra = 16  # more candidates of the last row
        idx = np.concatenate([np.arange(B), np.arange(B),
                              np.full(extra, B - 1)])
        strand = np.concatenate([np.arange(B) % 2, 1 - np.arange(B) % 2,
                                 np.arange(extra) % 2])
        ws = np.concatenate([np.maximum(pos - off, 0), rng.integers(
            0, N - O - L, B + extra)])
        rl = rlens[idx]
        wlens = rl + rng.integers(50, O + 40, len(idx))
        return _prescan_inputs(reads, lens_rows, idx, strand, ws, rl, wlens,
                               O)
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
    """The arguments of dp_rescue._prescan_impl of case ``c`` on ``dev``:
    the reads and the candidates' words (dp_rescue.rescue_words, a
    reverse complement of its row's lens_rows bases), as gapless_prescan
    makes them."""
    import torch

    from soap3dp_tpu_torch.pipeline import dp_rescue

    idx = c["read_idx"]
    words = dp_rescue.rescue_words(idx, c["strand"] == 1, c["ws"],
                                   c["lens_rows"][idx], c["rlens"],
                                   c["wlens"])
    return (didx, torch.from_numpy(c["reads"]).to(dev),
            torch.from_numpy(words).to(dev), c["O"], c["W"])


def prescan_work(c: dict) -> dict:
    """What GP needs on case ``c``: the valid offsets of each candidate
    (min(O - 1, wlens - rlens) + 1, at least 0) times the words of its
    counted bases (ceil(min(rlen, L) / 16)), OPS_PRESCAN_WORD int32
    operations and a popcount each; bytes: each window's W / 16 genome
    words, each read row referenced and the (M, 3) int32 output once,
    and the candidates' six words."""
    L = c["reads"].shape[1]
    rl = c["rlens"].astype(np.int64)
    valid = np.clip(np.minimum(c["O"] - 1, c["wlens"] - rl) + 1, 0, None)
    words = int((valid * ((np.clip(rl, 0, L) + 15) // 16)).sum())
    M = len(rl)
    rows = len(np.unique(c["read_idx"]))
    nbytes = M * (c["W"] // 16) * 4 + rows * L + M * (12 + 24)
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
    distinct read row named (its L code bytes) read once; and the
    problems' four words (16 B). No arithmetic to speak of: bytes
    only."""
    L = c["reads"].shape[1]
    P, W = len(c["cread"]), int(c["max_win"])
    nw = (W + 15) // 16
    words = _distinct_words(np.asarray(c["win_start"], np.int64) >> 4, nw,
                            int(c["n_pac"])) if P and W else 0
    rows = len(np.unique(c["cread"]))
    nbytes = P * (L + W) + 4 * words + rows * L + P * 16
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

    from soap3dp_tpu_torch.pipeline import dp_rescue

    idx, reads, words, O, W = args
    read, rev, ws, rc_len, rlens, wlens = dp_rescue.rescue_fields(words)
    M, L = read.shape[0], reads.shape[1]
    rows = reads[read]
    ori = torch.where(rev[:, None], fmindex.revcomp_reads(rows, rc_len),
                      rows)
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


def rescue_path_rows(kernels: list[dict], cases: list[dict]) -> None:
    """Add to the JSON line's rows of GP and PK the calls phases 4 and 5
    kept (run_rescue_cases: ``cases``), each launch shape's measured time
    and bound, and count their differences in max_abs_err; print each
    beside its span before the redesign (RESCUE_BEFORE_MS, quoted from
    PERF.md) on the phase line only."""
    for row in kernels:
        label = {"gapless_prescan": "GP", "problem_pack": "PK"}.get(
            row["name"])
        mine = [r for r in cases if r["kernel"] == label]
        if not mine:
            continue
        before = RESCUE_BEFORE_MS[label]
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [r["max_abs_err"] for r in mine])
        row["path_calls"] = [{
            "case": r["case"], "shape": r["shape"], "ms": r["ms"],
            "timer": r["timer"], "bound_ms": r["bound_ms"]} for r in mine]
        phase(f"kernel {label} path calls", "; ".join(
            f"{r['shape']}: {r['ms']:.4f} ms (before the redesign "
            + (f"{before[r['shape']]:.4f}" if r["shape"] in before else "-")
            + f" ms, PERF.md), bound {r['bound_ms']:.4f} ms "
            f"{r['bound_ms'] / r['ms']:.1%}" for r in mine))


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
# (compare_prescan.py on the parent, PERF.md section 5), and phase 4's
# other shapes (its launch-shape histogram; half the problems' rows)
PACK_PATH = {"path_phase4": (16384, 8532, 256),
             "frequent_phase4": (8192, 4134, 256),
             "p4_4096": (4096, 2048, 256), "p4_1024": (1024, 512, 256),
             "p4_512": (512, 256, 256),
             "path_phase5": (16384, 8655, 4224)}
PACK_EDGES = ("uniform", "ragged", "text_end", "shift_0", "win_1", "win_16",
              "win_17", "win_4224", "code_4", "pad_problems") + ROW_EDGES


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
    strand 0, win_start 0, as run_banded_dp pads them); and the aligned
    loads' edges (ROW_EDGES, row_edge_reads: every row on both strands,
    30 more problems of the last row)."""
    rng = np.random.default_rng(seed)
    B, L, P = 40, 120, 96
    max_win = int(name[4:]) if name.startswith("win_") else 300
    if name in ROW_EDGES:  # every row on both strands, more of the last
        reads, lens, _ = row_edge_reads(rng, name)
        B = len(reads)
        extra = 30
        cread = np.concatenate([np.arange(B), np.arange(B),
                                np.full(extra, B - 1)])
        strand = np.concatenate([np.zeros(B, bool), np.ones(B, bool),
                                 np.arange(extra) % 2 == 1])
        return {"reads": reads, "lens": lens,
                "cread": cread.astype(np.int64), "strand": strand,
                "win_start": rng.integers(0, n_text - max_win,
                                          len(cread)).astype(np.int64),
                "un": 0, "max_win": max_win, "n_pac": n_pac}
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
    """The arguments of dp_rescue._pack_problems of case ``c`` on ``dev``:
    the reads and the problems' words (dp_rescue.rescue_words, a reverse
    complement of its row's ``lens`` bases), as run_banded_dp makes
    them."""
    import torch

    from soap3dp_tpu_torch.pipeline import dp_rescue

    words = dp_rescue.rescue_words(c["cread"], c["strand"], c["win_start"],
                                   c["lens"][c["cread"]])
    return (didx, torch.from_numpy(np.ascontiguousarray(c["reads"])).to(dev),
            torch.from_numpy(words).to(dev), int(c["max_win"]))


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
    marker too was lost). Up to PROFILE_TRIES profiles, a pause
    between, until the window holds FS1's kernel; fails if none does, so
    the checks below never pass on an empty window (phase 4 runs it in
    a new process, fresh_search_profile). Fails if a scan with indices (torch.cummax's
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

    copies = []
    host_copy = fsearch._HostCopy

    class Counted(host_copy):
        """_HostCopy counting the bytes each dispatch downloads."""

        def __init__(self, vec):
            copies.append(vec.numel() * vec.element_size())
            super().__init__(vec)

    def run():
        fsearch.PendingSearch(didx, codes, lens, cfg,
                              seed_range=(0, 2)).result()
        torch.cuda.synchronize(dev)

    run()
    fsearch._HostCopy = Counted
    tries = []  # (device events, markers) of each profile
    try:
        for _ in range(PROFILE_TRIES):
            copies.clear()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    run()
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize(dev)
            spans = _device_spans(prof)
            marks = [a for a, _, name in spans if "spin_kernel" in name]
            window = (spans if len(marks) < 2 else
                      [s for s in spans if marks[-2] < s[0] < marks[-1]])
            tries.append((len(spans), len(marks)))
            if any(FS_SYMBOLS["FS1"] in n for _, _, n in window):
                break
            time.sleep(0.5)
    finally:
        fsearch._HostCopy = host_copy
    if not any(FS_SYMBOLS["FS1"] in n for _, _, n in window):
        fail(f"no search profile held FS1's kernel between its markers "
             f"(device events, markers of each: {tries})")
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
    library = library_items(items)
    down = [v for n, v in items.items() if n.startswith("Memcpy DtoH")]
    down_ms, downs = sum(v[0] for v in down), sum(v[1] for v in down)
    wire_bytes = copies[len(copies) // 2:]  # the second search's
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
          + f"; profiles taken (device events, markers): {tries}"
          f"; before FS4: "
          f"{SEARCH_DEVICE_BEFORE_MS:.3f} ms, PERF.md); scans with indices "
          f"(cummax) {len(scans)}, scatter-reduce kernels {reduce}; top: "
          f"{short}; all in search_profile.txt")
    phase("e2e search download",
          f"{len(wire_bytes)} result wires, {sum(wire_bytes)} bytes "
          f"({wire_bytes}); device to host copies {downs} in "
          f"{down_ms:.4f} ms; library launches {sum(library.values())} "
          f"({library}); before the wire ({SEARCH_BEFORE_WIRE}, "
          "PERF.md)")
    if scans:
        fail(f"the search ran a scan with indices: {list(scans)}")
    if reduce["ReduceMinimum"]:
        fail("the search ran a scatter-reduce with ReduceMinimum (the "
             "plain dedupe's scatter-min)")
    return {"device_ms": total, "items": dict(top), "marked": marked,
            "profiles": tries,
            "scans_with_indices": len(scans), "scatter_reduce": reduce,
            "download_bytes": wire_bytes, "download_ms": down_ms,
            "downloads": downs, "library_launches": library}


def library_items(items: dict) -> dict:
    """{name: launches} of a search profile's items (name -> [ms,
    launches]) that are library launches: neither a kernel of
    csrc/fm_search.cu (FS_SYMBOLS), a marker kernel nor a copy."""
    ours = tuple(FS_SYMBOLS.values()) + ("spin_kernel",)
    return {n: v[1] for n, v in items.items()
            if not n.startswith("Mem") and not any(o in n for o in ours)}


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


def _cached_index(genome, path: str, sa_rate: int, lut_k):
    """(index, how, s): ``genome``'s index at ``sa_rate`` and ``lut_k``,
    built and saved at ``path`` once ("built"), then loaded from there
    ("cached")."""
    from soap3dp_tpu_torch.index.builder import build_index, load_index, save_index

    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    if os.path.exists(os.path.join(path, "meta.json")):
        return load_index(path), "cached", time.perf_counter() - t0
    index = build_index(genome, sa_rate=sa_rate, lut_k=lut_k)
    save_index(index, path)
    return index, "built", time.perf_counter() - t0


def _genome_index(genome_bp: int, work: str, sa_rate: int = 2):
    """(rng after the genome, genome, index path, how, build s, lut_k):
    the seeded genome and its index at ``sa_rate``, built once and
    cached in ``work``."""
    from soap3dp_tpu_torch import workloads

    rng = np.random.default_rng(20261016)
    genome = workloads.random_genome(rng, genome_bp, name="chr1")
    tag = "" if sa_rate == 2 else f"_sa{sa_rate}"
    idx_path = os.path.join(work, f"genome_{genome_bp}{tag}.t3i")
    index, how, s = _cached_index(genome, idx_path, sa_rate,
                                  13 if genome_bp >= 1_000_000 else None)
    return rng, genome, idx_path, how, s, index.lut_k


def _kernels() -> dict:
    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.kernels import fm_search as fs

    return {"K1": bd.DP_KERNEL, "K2": bd.FORWARD_KERNEL,
            "TB": bd.TRACEBACK_KERNEL, "FS1": fs.SEARCH_KERNEL,
            "FS2": fs.DECODE_KERNEL, "FS2x": fs.EXPAND_KERNEL,
            "FS3": fs.VERIFY_KERNEL, "FS4": fs.DEDUPE_KERNEL,
            "FS2s": fs.SEED_EXPAND_KERNEL, "FS5": fs.LANE_COUNTS_KERNEL,
            "FS6": fs.SEARCH_WIRE_KERNEL, "GP": fs.PRESCAN_KERNEL,
            "PK": fs.PACK_KERNEL, "DW": bd.WIRE_KERNEL}


def _launches() -> dict:
    return {name: k.launches for name, k in _kernels().items()}


def _launch_shapes() -> dict:
    """{kernel: {"shape": launches}} since the counts were last set to 0
    (the shapes the path itself gave each kernel: P x Lr x Lw for the
    DP kernels; lanes x L x max_steps for FS1, rows x sa_rate for FS2,
    slots x lanes x sa_rate for FS2x and FS2s, placements x words for
    FS3, K x K2 x hb for FS4, M x O x Lr for GP, P x Lr x max_win for
    PK, lanes x run budget x word bits for DW)."""
    return {name: {"x".join(map(str, shape)): n for shape, n in
                   sorted(k.shapes.items())}
            for name, k in _kernels().items() if k.shapes}


def rank_by_loss(launch_shapes: dict, timed: dict) -> list[dict]:
    """The kernels of ``timed`` ({kernel: {"shape": (ms, bound ms)}})
    ranked by the device time they lose on a run whose launch-shape
    histogram is ``launch_shapes`` ({kernel: {"shape": launches}}, as
    _launch_shapes gives it): the sum over its shapes of launches x
    (time - bound), the largest first. A launched shape with no time is
    left out of the sum and listed under "untimed"."""
    out = []
    for kernel, times in timed.items():
        loss, launches, untimed = 0.0, 0, []
        for shape, n in launch_shapes.get(kernel, {}).items():
            if shape in times:
                ms, bound = times[shape]
                loss += n * (ms - bound)
                launches += n
            else:
                untimed.append(shape)
        out.append({"kernel": kernel, "loss_ms": loss, "launches": launches,
                    "untimed": untimed})
    return sorted(out, key=lambda r: -r["loss_ms"])


def _launches_per_device() -> dict:
    """{card: {kernel: launches}} since the counts were last set to 0."""
    out = {}
    for name, k in _kernels().items():
        for d, c in sorted(k.per_device.items()):
            out.setdefault(f"cuda:{d}", dict.fromkeys(_kernels(), 0))[name] = c
    return out


def _counted(fn, dev, env=None, kept=None,
             keep=None) -> tuple[object, float, str, dict]:
    """Run ``fn()`` under ``env`` with every launch count set to 0 just
    before; returns (its result, wall s, stderr, launch counts just
    after). Fails if a plain search primitive ran on a card's index or
    the plain prescan or the plain pack on CUDA tensors in the run (a
    CUDA tensor must take the kernel). ``kept``, ``keep``: as
    _Recorder's; on a card only calls that launched their kernel are
    kept."""
    import contextlib

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    tee = _Tee(sys.stderr)
    for k in _kernels().values():
        k.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(tee), _Recorder(
                record=False, kept=kept, keep=keep,
                launched_only=dev.type == "cuda") as rec:
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
# (the search's, the DP seeding's), FS3, FS4, FS5 and FS6; FS2's
# sa_decode of ready rows is on no path since FS2s took the DP seeding
FS_PATH = ("FS1", "FS2x", "FS2s", "FS3", "FS4", "FS5", "FS6")


def _fs_launched(where: str, launches: dict) -> None:
    """Fails unless each kernel of FS_PATH launched in the run."""
    missing = [k for k in FS_PATH if launches.get(k, 0) <= 0]
    if missing:
        fail(f"{where} never launched {missing}")


def _run_cli(argv, dev, env=None, kept=None,
             keep=None) -> tuple[float, str, dict]:
    """Run the port's CLI with every launch count set to 0 just before;
    returns (wall s, stderr, launch counts just after). ``kept``,
    ``keep``: as _Recorder's."""
    from soap3dp_tpu_torch.cli.main import main as cli_main

    rc, wall, log, launches = _counted(lambda: cli_main(argv), dev, env,
                                       kept, keep)
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

    m = re.search(rf"done: {cls}\(([^)]*)\)", log)
    if m is None:
        fail("no run summary on stderr")
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m.group(1))}


def _rates(reads: int, wall: float, log: str) -> dict:

    up = re.search(r"uploaded to \S+ in ([0-9.]+)s", log)
    load = re.search(r"index loaded in ([0-9.]+)s", log)
    setup_s = float(load.group(1)) + float(up.group(1))
    return {"reads": reads, "wall_s": wall, "reads_per_s": reads / wall,
            "reads_per_s_after_load": reads / max(wall - setup_s, 1e-9),
            "index_load_s": float(load.group(1)),
            "index_upload_s": float(up.group(1))}


def phase_e2e(dev, genome_bp: int, n_pairs: int, card: str, work: str,
              out_dir: str, profile: bool = True, mate_pair: bool = False,
              kept: dict | None = None,
              keep: tuple | None = None) -> tuple[dict, dict]:
    """The port's `pair` CLI on ``dev`` over a seeded genome of
    ``genome_bp`` and ``n_pairs`` read pairs: default options
    (-u 500 -v 300) on a +/- library, or with ``mate_pair`` the mate-pair
    library over the whole insert window. Checks records, planted-locus
    recall, rescue counts and kernel launches. With ``kept`` (a dict),
    the measured run keeps the first call of each launch shape of the
    ``keep`` entries (default PATH_KEPT) there (_Recorder), the copies
    inside its timed wall. Returns (result, the run's
    inputs and outputs: FASTQ paths, end-1 planted positions and random
    mask, index, options, SAM path, summary)."""

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
        wall, log, launches = _run_cli(argv, dev, env, kept, keep)
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
            res["search_profile"] = fresh_search_profile(dev, inputs,
                                                         out_dir)
    return res, inputs


def fresh_search_profile(dev, reads: dict, out_dir: str) -> dict:
    """search_device_items on ``dev`` in a new interpreter, its phase
    lines printed here and its failure failing here. In this process,
    after phase 2's profiles and the e2e profiled pass, the search's
    profiles held only their last events (a download and a marker) or
    none (five in a row, 0.5 s apart), while a new process records them
    all (compare_search.py's runs); the cause inside the profiler is not
    known."""
    paths = {k: reads[k] for k in ("index", "r1", "r2")}
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import json, torch; "
            "import chip_smoke as cs; res = cs.search_device_items("
            f"torch.device({str(dev)!r}), {paths!r}, {out_dir!r}); "
            "print('RESULT ' + json.dumps(res), flush=True)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    res = None
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            res = json.loads(line[len("RESULT "):])
        elif line.startswith("[chip_smoke]"):
            print(line, flush=True)
    if proc.returncode != 0 or res is None:
        fail(f"the search profile's process exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return res


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
    " 'FS5': fs.LANE_COUNTS_KERNEL.launches,"
    " 'FS6': fs.SEARCH_WIRE_KERNEL.launches,"
    " 'GP': fs.PRESCAN_KERNEL.launches,"
    " 'PK': fs.PACK_KERNEL.launches}), flush=True)\n"
    "sys.exit(rc)\n")


def phase_hosts(dev, reads: dict, work: str, out_dir: str,
                timeout: float = 600.0) -> dict:
    """7b: two processes of `soap3dp-torch pair --hosts 2` on phase 4's
    inputs, process i on card i % cards: the merged records and the
    global summary equal phase 4's. Each process is waited for with a
    deadline and killed past it, and reports its kernel launches."""
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


# ------------------------------------------------------------------
# Phase 8: the accuracy gate, through the port's copy of the repo's
# tools/evaluate_accuracy.py (soap3dp_tpu_torch/tools/)

# (name, genome, pairs, substitution rate, indel rate): the gates of
# tests/test_accuracy.py, at its seeds (run_eval's 7, genomes below)
ACCURACY_GATES = (("easy", "random", 1500, 0.01, 0.001),
                  ("stressed", "random", 1500, 0.03, 0.01),
                  ("repeat", "repeat", 800, 0.01, 0.001))
ACCURACY_RANDOM_BP = 1_000_000      # numpy seed 3, sa_rate 2
ACCURACY_REPEAT_BP = 4_000_000      # repeat_genome seed 5, lut_k 11
ACCURACY_REPEAT_LUT_K = 11
# repeat text at a real size: human chr1's, the scale of phases 4-6
REPEAT_TEXT_BP = 250_000_000
REPEAT_TEXT_PAIRS = 50_000          # the pair count of ACCURACY_hg3100.json
REPEAT_TEXT_LUT_K = 13
REPEAT_CROSS_PAIRS = 1_000          # cuda against cpu on the same index
REPEAT_TEXT_KERNELS = ("K1", "FS1", "FS3", "FS4", "GP", "PK")
REPEAT_TEXT_STAGES = ("A.host_realign", "BC.half_rescue", "BC.prescan",
                      "dp.pack", "dp.align")


def gate_failures(name: str, res: dict) -> list[str]:
    """The conditions of the reference's gate ``name``
    (tests/test_accuracy.py, thresholds as there) that run_eval's result
    dict ``res`` fails; empty if it holds."""
    hi = res["mapq_buckets"]["mapq30-255"]
    checks = {
        "easy": (("recall >= 0.999", res["recall"] >= 0.999),
                 ("wrong <= 0.0005", res["wrong"] <= 0.0005)),
        "stressed": (("recall >= 0.995", res["recall"] >= 0.995),
                     ("MAPQ>=30 wrong <= max(1, right // 2000)",
                      hi["wrong"] <= max(1, hi["right"] // 2000))),
        "repeat": (("unaligned <= 0.01", res["unaligned"] <= 0.01),
                   ("recall >= 0.77", res["recall"] >= 0.77),
                   ("mapq30_wrong_rate <= 0.01",
                    res["mapq30_wrong_rate"] <= 0.01),
                   ("still_flagged > 0", res["still_flagged"] > 0)),
    }[name]
    return [cond for cond, ok in checks if not ok]


def _accuracy_line(res: dict) -> str:
    hi = res["mapq_buckets"]["mapq30-255"]
    return (f"recall {res['recall']:.6f}, wrong {res['wrong']:.6f}, "
            f"unaligned {res['unaligned']:.6f}, MAPQ>=30 right {hi['right']} "
            f"wrong {hi['wrong']} (rate {res['mapq30_wrong_rate']:.6f}), "
            f"still_flagged {res['still_flagged']}")


def _no_log(msg: str) -> None:
    pass


def eval_on_both(name: str, dev, codes: np.ndarray, index, didx, cpu_idx,
                 pairs: int, sub: float, indel: float, excluded=None
                 ) -> tuple[dict, float, dict, float, dict]:
    """The port's run_eval of ``pairs`` pairs on ``dev`` (``didx``,
    _counted) and on the CPU route (``cpu_idx``), the same index, every
    record kept (run_eval's ``all_records``): fails unless the two
    result dicts are equal, key for key, and the records, sorted
    (deferred rescue records interleave on a worker thread), equal
    record for record, CIGAR, mate fields and tags included. Returns
    (result, wall s, launches, the CPU route's wall s, {"records": their
    count, "sha256": of the sorted records})."""
    import hashlib

    from soap3dp_tpu_torch.tools import evaluate_accuracy

    got, want = [], []
    res, wall, _, launches = _counted(lambda: evaluate_accuracy.run_eval(
        codes, index, didx, pairs, sub, indel, excluded=excluded,
        all_records=got), dev)
    t0 = time.perf_counter()
    cpu = evaluate_accuracy.run_eval(codes, index, cpu_idx, pairs, sub,
                                     indel, excluded=excluded,
                                     all_records=want)
    cpu_wall = time.perf_counter() - t0
    got.sort()
    want.sort()
    if res != cpu:
        diff = sorted(k for k in res if res[k] != cpu.get(k))
        fail(f"{name}: {dev} and cpu differ in {diff}")
    if got != want:
        bad = [(a, b) for a, b in zip(got, want) if a != b]
        fail(f"{name}: {dev} and cpu write different records ({len(got)} "
             f"and {len(want)}; {len(bad)} of the sorted pairs differ, the "
             f"first {bad[:1]})")
    recs = {"records": len(got), "sha256": hashlib.sha256(
        repr(got).encode()).hexdigest()}
    return res, wall, launches, cpu_wall, recs


def phase_accuracy_gates(dev, gates=ACCURACY_GATES,
                         random_bp: int = ACCURACY_RANDOM_BP,
                         repeat_bp: int = ACCURACY_REPEAT_BP) -> dict:
    """8a: each of ``gates`` through the port's run_eval on ``dev`` and on
    the CPU route, over the uniform genome of tests/test_accuracy.py
    (numpy seed 3) or its repeat genome (repeat_genome seed 5, lut_k
    11), each indexed once at sa_rate 2: the two result dicts and the
    two runs' records must be equal (eval_on_both), and the dict hold
    the gate. Returns {gate: {"result", "wall_s", "cpu_wall_s",
    "launches", "records"}}."""
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.tools import evaluate_accuracy, repeat_genome

    out, built = {}, {}
    for name, kind, pairs, sub, indel in gates:
        if kind not in built:
            if kind == "repeat":
                genome = repeat_genome.generate(repeat_bp, seed=5,
                                                log=_no_log)
                excluded = evaluate_accuracy.excluded_runs(genome)
                lut_k = ACCURACY_REPEAT_LUT_K
            else:
                genome = workloads.random_genome(np.random.default_rng(3),
                                                 random_bp, name="chr1")
                excluded, lut_k = None, None
            index = build_index(genome, sa_rate=2, lut_k=lut_k)
            built[kind] = (genome.codes, index, excluded,
                           device_index(index, dev),
                           device_index(index, "cpu"))
        codes, index, excluded, didx, cpu_idx = built[kind]
        res, wall, launches, cpu_wall, recs = eval_on_both(
            f"accuracy gate {name}", dev, codes, index, didx, cpu_idx, pairs,
            sub, indel, excluded)
        phase(f"accuracy gate {name}",
              f"{pairs} pairs on {dev}: {_accuracy_line(res)}; {wall:.2f}s "
              f"(cpu route {cpu_wall:.2f}s; dict equal, {recs['records']} "
              f"records equal, sha256 {recs['sha256'][:16]}); "
              f"launches {launches}")
        bad = gate_failures(name, res)
        if bad:
            fail(f"accuracy gate {name} fails {bad}: {res}")
        out[name] = {"result": res, "wall_s": wall, "cpu_wall_s": cpu_wall,
                     "launches": launches, "records": recs}
    return out


def hold_kept(name: str, tag: str, kept: dict, launches: dict,
              shapes: dict, kernels: tuple, dev, peak_ops: float | None
              ) -> tuple[list[str], list[dict]]:
    """After a run that kept the first call of each launch shape of every
    kernel's entry (_counted's ``kept``, ``keep=HELD_ENTRIES``) and
    launched ``launches`` at ``shapes`` (_launch_shapes): on a card,
    fails unless each of ``kernels`` launched, holds each kept call to
    its plain version, every element (run_held_cases, timed against
    ``peak_ops``; cases named ``tag``_...), and fails on a launch shape
    no held call ran at. Returns (the kept calls' case names, the held
    cases' rows; none off a card)."""
    kept_names = [c[0] for c in path_cases(kept, tag)
                  + rescue_cases(kept, tag) + k1_kept_cases(kept, tag)]
    if dev.type != "cuda":
        phase(f"{name} kept calls",
              f"{len(kept_names)} (held to their plain versions on a card "
              "only)")
        return kept_names, []
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        fail(f"the {name} run never launched {missing}")
    held = run_held_cases(kept, tag, dev, peak_ops)
    unheld = unheld_shapes(shapes, held)
    phase(f"{name} held calls",
          f"{len(held)} of the run's calls, each launch shape's first, "
          "held to their plain versions on the same inputs: every "
          f"element equal; launch shapes not held: {unheld or 'none'}")
    if unheld:
        fail(f"the {name} run launched {unheld}, shapes whose calls were "
             "not held to their plain versions")
    return kept_names, held


def phase_repeat_text(dev, card: str, work: str, out_dir: str,
                      peak_ops: float | None = None,
                      genome_bp: int = REPEAT_TEXT_BP,
                      n_pairs: int = REPEAT_TEXT_PAIRS,
                      cross_pairs: int = REPEAT_CROSS_PAIRS,
                      lut_k: int = REPEAT_TEXT_LUT_K) -> dict:
    """8b and 8c: run_eval on ``dev`` over ``n_pairs`` pairs of the repeat
    genome at ``genome_bp`` (seed 5; 1% substitutions, 0.1% indels,
    insert 300, k = 3, inserts kept off N runs over 10 bp), held to the
    reference's repeat-genome gate, with the stage timers on, the
    launches and their shapes (no plain search primitive, prescan or
    pack on the card: _counted; its stderr to ``out_dir``'s
    repeat_text_stderr.log). The run keeps the first call of each launch
    shape of every kernel's entry (HELD_ENTRIES; the copies inside its
    wall); on a card each is then held to its plain version, every
    element (run_held_cases, timed against ``peak_ops``), and every
    launch shape of the run must have been held. Then ``cross_pairs``
    pairs on ``dev`` and on the CPU route over the same index, the dicts
    and the records equal (eval_on_both)."""

    import torch

    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.tools import evaluate_accuracy, repeat_genome
    from soap3dp_tpu_torch.utils import timers

    t0 = time.perf_counter()
    genome = repeat_genome.generate(genome_bp, seed=5, log=_no_log)
    gen_s = time.perf_counter() - t0
    excluded = evaluate_accuracy.excluded_runs(genome)
    codes = genome.codes
    index, how, build_s = _cached_index(
        genome, os.path.join(work, f"repeat_{genome_bp}_k{lut_k}.t3i"), 2,
        lut_k)
    del genome
    didx, upload_s = _upload(index, dev)
    phase("repeat text setup",
          f"{genome_bp} bp repeat genome generated in {gen_s:.2f}s "
          f"({len(excluded[0])} N runs over 10 bp), index {how} in "
          f"{build_s:.2f}s (sa_rate=2, lut_k={index.lut_k}), uploaded to "
          f"{dev} in {upload_s:.2f}s")

    def evaluate():
        res = evaluate_accuracy.run_eval(codes, index, didx, n_pairs, 0.01,
                                         0.001, excluded=excluded)
        timers.report()
        return res

    kept = {}
    saved, timers.ENABLED = timers.ENABLED, True
    try:
        res, wall, log, launches = _counted(evaluate, dev, kept=kept,
                                            keep=HELD_ENTRIES)
    finally:
        timers.ENABLED = saved
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[timers\] (\S+)\s+([0-9.]+)s", log)}
    shapes = _launch_shapes()
    with open(os.path.join(out_dir, "repeat_text_stderr.log"), "w") as fh:
        fh.write(log)
    reads = 2 * n_pairs
    phase("repeat text", f"{n_pairs} pairs on {dev}: {_accuracy_line(res)}; "
                         f"{reads} reads in {wall:.2f}s = "
                         f"{reads / wall:.0f} reads/s (the harness's wall: "
                         f"simulation, scoring and the kept calls' copies "
                         f"included); card: {card}")
    phase("repeat text MAPQ buckets", json.dumps(res["mapq_buckets"]))
    phase("repeat text summary", res["summary"])
    phase("repeat text stage timers",
          ", ".join(f"{k} {stages.get(k)} s" for k in REPEAT_TEXT_STAGES)
          + " (SOAP3DP_TIMERS=1 in the run)")
    phase("repeat text launches", json.dumps(launches))
    phase("repeat text launch shapes", json.dumps(shapes))
    bad = gate_failures("repeat", res)
    if bad:
        fail(f"repeat text at {genome_bp} bp fails {bad}: {res}")
    kept_names, held = hold_kept("repeat text", "repeat", kept, launches,
                                 shapes, REPEAT_TEXT_KERNELS, dev, peak_ops)
    del kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    got, dev_wall, _, cpu_wall, recs = eval_on_both(
        "repeat text", dev, codes, index, didx, device_index(index, "cpu"),
        cross_pairs, 0.01, 0.001, excluded)
    phase("repeat text cuda = cpu",
          f"{cross_pairs} pairs on {dev} ({dev_wall:.2f}s) and on the cpu "
          f"route ({cpu_wall:.2f}s): dict equal, {recs['records']} records "
          f"equal (sha256 {recs['sha256'][:16]}); {_accuracy_line(got)}")
    return {"genome_bp": genome_bp, "pairs": n_pairs, "lut_k": index.lut_k,
            "generate_s": gen_s, "index": how, "index_build_s": build_s,
            "index_upload_s": upload_s, "result": res, "wall_s": wall,
            "reads_per_s": reads / wall, "stage_s": stages,
            "launches": launches, "launch_shapes": shapes,
            "kept_calls": kept_names, "held": held,
            "cross_check": {"result": got, "equal": True, "records": recs,
                            "wall_s": dev_wall, "cpu_wall_s": cpu_wall},
            "card": card}


# ------------------------------------------------------------------
# Phase 9: the A/B tools behind three of the port's defaults, through
# the port's copies of the repo's tools/measure_storm_divergence.py
# (host_realign_budget), measure_phased_divergence.py (phased_search)
# and seed_sensitivity.py (dp_seed_1mm) in soap3dp_tpu_torch/tools/

# pairs a pool, cut from the tool's 50,000: the full arm enumerates
# every flagged read on the host, and at 50,000 it did not end in 450 s
STORM_PAIRS = 1_000
STORM_CROSS_PAIRS = 100             # cuda against cpu, pairs a pool
STORM_KERNELS = ("K1", "FS1", "FS3", "FS4", "GP", "PK")
PHASED_PAIRS = 100_000              # the JAX tool's main
PHASED_CROSS_PAIRS = 1_000
# no FS2s: 0.5% substitutions leave no pair to the deep DP
PHASED_KERNELS = ("K1", "FS1", "FS2x", "FS3", "FS4", "GP", "PK")
SEED_GENOME_BP = 40_000_000         # bench.get_index's, as the JAX tool
SEED_LUT_K = 14
SEED_READS = 20_000
SEED_CROSS_READS = 2_000
SEED_SUB_RATE = 0.04
SEED_KERNELS = ("FS1", "FS2s")
AB_PHASES = ("storm", "phased", "seed")
SKIPPED = re.compile(r"host re-align skipped: (\d+) flagged")
REALIGNED = "re-aligned on host"


def _upload(index, dev) -> tuple[object, float]:
    """(``index`` on ``dev``, upload s)."""
    import torch

    from soap3dp_tpu_torch.fm.fmindex import device_index

    t0 = time.perf_counter()
    didx = device_index(index, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return didx, time.perf_counter() - t0


def _timeless(d: dict) -> dict:
    """``d`` without its keys named time_*, at any depth."""
    return {k: _timeless(v) if isinstance(v, dict) else v
            for k, v in d.items() if not k.startswith("time_")}


def storm_arms(log: str) -> dict:
    """{"pool/arm": {"wall_s", "summary", "skips", "skipped_flagged",
    "realigns"}} from the stderr of measure_storm_divergence.run: an
    arm's lines come just before its "[storm-ab] pool/arm:" line; skips
    counts its "host re-align skipped" lines (skipped_flagged, their
    flagged reads), realigns its host re-aligns."""
    out, lines = {}, []
    for line in log.splitlines():
        m = re.match(r"\[storm-ab\] (\w+/\w+): ([0-9.]+)s\s+(.*)", line)
        if m:
            skipped = [int(n) for x in lines for n in SKIPPED.findall(x)]
            out[m.group(1)] = {
                "wall_s": float(m.group(2)), "summary": m.group(3),
                "skips": len(skipped), "skipped_flagged": skipped,
                "realigns": sum(REALIGNED in x for x in lines)}
        lines = [] if line.startswith("[storm-ab]") else lines + [line]
    return out


def storm_failures(res: dict, arms: dict) -> list[str]:
    """What makes a storm A/B measure nothing, or leaves an arm out:
    each pool's dict and both arms' lines present, and the repeat pool's
    default arm skipping host re-align at least once."""
    bad = [f"no {k}" for k in ("uniform", "repeat") if k not in res]
    bad += [f"no {p}/{a} line" for p in ("uniform", "repeat")
            for a in ("default", "full") if f"{p}/{a}" not in arms]
    if not arms.get("repeat/default", {}).get("skips"):
        bad.append("the repeat pool's default arm skipped no host re-align: "
                   "the A/B measured nothing")
    return bad


def phase_storm_ab(dev, card: str, work: str, out_dir: str,
                   peak_ops: float | None = None,
                   genome_bp: int = REPEAT_TEXT_BP,
                   n_per_pool: int = STORM_PAIRS,
                   cross_pairs: int = STORM_CROSS_PAIRS,
                   lut_k: int = REPEAT_TEXT_LUT_K) -> dict:
    """9a: the storm gate's A/B (measure_storm_divergence.run: a uniform
    and a repeat-enriched pool of ``n_per_pool`` pairs, seed 11, k = 3,
    insert 300, each aligned with the storm gate and with
    SOAP3DP_HOST_REALIGN_FULL=1) on phase 8's repeat genome and its
    cached index, on ``dev``, through _counted with every kernel's
    first call of each launch shape kept and held to its plain version
    (hold_kept); each pool's diff dict, both arms' walls, PairSummary
    and storm-gate skips; fails unless the repeat pool's default arm
    skipped (storm_failures). Then ``cross_pairs`` a pool on ``dev`` and
    on the CPU route over the same index: equal dicts, times aside."""
    import torch

    from soap3dp_tpu_torch.tools import measure_storm_divergence as storm
    from soap3dp_tpu_torch.tools import repeat_genome
    from soap3dp_tpu_torch.tools.evaluate_accuracy import excluded_runs

    t0 = time.perf_counter()
    genome = repeat_genome.generate(genome_bp, seed=5, log=_no_log)
    gen_s = time.perf_counter() - t0
    excluded, codes = excluded_runs(genome), genome.codes
    index, how, build_s = _cached_index(
        genome, os.path.join(work, f"repeat_{genome_bp}_k{lut_k}.t3i"), 2,
        lut_k)
    del genome
    didx, upload_s = _upload(index, dev)
    phase("storm A/B setup",
          f"{genome_bp} bp repeat genome generated in {gen_s:.2f}s, index "
          f"{how} in {build_s:.2f}s (sa_rate 2, lut_k {index.lut_k}), "
          f"uploaded to {dev} in {upload_s:.2f}s")
    kept = {}
    res, wall, log, launches = _counted(
        lambda: storm.run(index, codes, excluded, n_per_pool, didx=didx),
        dev, kept=kept, keep=HELD_ENTRIES)
    shapes = _launch_shapes()
    with open(os.path.join(out_dir, "storm_ab_stderr.log"), "w") as fh:
        fh.write(log)
    arms = storm_arms(log)
    for pool in ("uniform", "repeat"):
        phase(f"storm A/B {pool}", json.dumps(res.get(pool)))
    for arm, a in arms.items():
        phase(f"storm A/B {arm}",
              f"{a['wall_s']} s, {a['skips']} storm skips "
              f"(flagged {a['skipped_flagged']}), {a['realigns']} host "
              f"re-aligns; {a['summary']}")
    phase("storm A/B", f"{n_per_pool} pairs a pool on {dev} in {wall:.2f}s "
                       f"(pools drawn, 4 arms; card: {card})")
    phase("storm A/B launches", json.dumps(launches))
    phase("storm A/B launch shapes", json.dumps(shapes))
    bad = storm_failures(res, arms)
    if bad:
        fail(f"storm A/B: {bad}")
    kept_names, held = hold_kept("storm A/B", "storm", kept, launches,
                                 shapes, STORM_KERNELS, dev, peak_ops)
    del kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    got = storm.run(index, codes, excluded, cross_pairs, didx=didx)
    dev_wall = time.perf_counter() - t0
    cpu_idx, cpu_up = _upload(index, torch.device("cpu"))
    t0 = time.perf_counter()
    want = storm.run(index, codes, excluded, cross_pairs, didx=cpu_idx)
    cpu_wall = time.perf_counter() - t0
    if _timeless(got) != _timeless(want):
        fail(f"storm A/B: {dev} and cpu differ: {got} {want}")
    phase("storm A/B cuda = cpu",
          f"{cross_pairs} pairs a pool on {dev} ({dev_wall:.2f}s) and on the "
          f"cpu route ({cpu_wall:.2f}s, its index {cpu_up:.2f}s): dicts "
          "equal, times aside")
    return {"genome_bp": genome_bp, "n_per_pool": n_per_pool,
            "lut_k": index.lut_k, "generate_s": gen_s, "index": how,
            "index_build_s": build_s, "index_upload_s": upload_s,
            "result": res, "arms": arms, "wall_s": wall,
            "launches": launches, "launch_shapes": shapes,
            "kept_calls": kept_names, "held": held,
            "cross_check": {"result": got, "equal": True,
                            "wall_s": dev_wall, "cpu_wall_s": cpu_wall},
            "card": card}


def phase_phased_ab(dev, card: str, work: str, out_dir: str,
                    peak_ops: float | None = None,
                    genome_bp: int = E2E_GENOME_BP,
                    n_pairs: int = PHASED_PAIRS,
                    cross_pairs: int = PHASED_CROSS_PAIRS) -> dict:
    """9b: the phased search's A/B (measure_phased_divergence.run_ab and
    divergence: the same pairs aligned with phased_search on and off,
    records diffed field by field) on phase 4's cached index, over
    ``n_pairs`` of the JAX tool's pairs (make_pairs: insert 400, 0.5%
    substitutions, numpy seed 17), on ``dev``, through _counted with
    every kernel's calls kept and held (hold_kept). Then the first
    ``cross_pairs`` of those pairs on ``dev`` and on the CPU route:
    record maps and divergence dicts equal."""
    import torch

    from soap3dp_tpu_torch.index.builder import load_index
    from soap3dp_tpu_torch.pipeline.pair import _phase1_range
    from soap3dp_tpu_torch.pipeline.options import AlignOptions
    from soap3dp_tpu_torch.tools import measure_phased_divergence as ph

    _, genome, idx_path, how, build_s, _ = _genome_index(genome_bp, work)
    index = load_index(idx_path)
    didx, upload_s = _upload(index, dev)
    opts = dict(min_insert=ph.INSERT // 2, max_insert=ph.INSERT * 2,
                soap3_mismatch_allow=3)
    engaged = _phase1_range(didx, AlignOptions(**opts), 3) is not None
    b1, b2 = ph.make_pairs(genome.codes, n_pairs, np.random.default_rng(17))
    phase("phased A/B setup",
          f"phase 4's index ({genome_bp} bp, sa_rate 2, lut_k "
          f"{index.lut_k}) {how} in {build_s:.2f}s, uploaded to {dev} in "
          f"{upload_s:.2f}s; phased search engages: {engaged}")
    if not engaged:
        fail("phased A/B: the phased search does not engage on this index")
    kept = {}

    def ab():
        a, b = ph.run_ab(index, didx, b1, b2, opts)
        return a, b, ph.divergence(a, b)

    (a, b, res), wall, _, launches = _counted(ab, dev, kept=kept,
                                              keep=HELD_ENTRIES)
    shapes = _launch_shapes()
    phase("phased A/B", f"{n_pairs} pairs on {dev}, phased on and off, in "
                        f"{wall:.2f}s (SAM text included; card: {card}): "
                        + json.dumps(res))
    phase("phased A/B launches", json.dumps(launches))
    phase("phased A/B launch shapes", json.dumps(shapes))
    if res["records"] != 2 * n_pairs:
        fail(f"phased A/B: {res['records']} records for {n_pairs} pairs")
    del a, b
    kept_names, held = hold_kept("phased A/B", "phased", kept, launches,
                                 shapes, PHASED_KERNELS, dev, peak_ops)
    del kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    c1, c2 = (type(x)(x.names[:cross_pairs], x.codes[:cross_pairs],
                      x.lens[:cross_pairs], None) for x in (b1, b2))
    t0 = time.perf_counter()
    got = ph.run_ab(index, didx, c1, c2, opts)
    dev_wall = time.perf_counter() - t0
    cpu_idx, _ = _upload(index, torch.device("cpu"))
    t0 = time.perf_counter()
    want = ph.run_ab(index, cpu_idx, c1, c2, opts)
    cpu_wall = time.perf_counter() - t0
    if got != want:
        fail(f"phased A/B: {dev} and cpu write different records")
    cross = ph.divergence(*got)
    phase("phased A/B cuda = cpu",
          f"{cross_pairs} pairs on {dev} ({dev_wall:.2f}s) and on the cpu "
          f"route ({cpu_wall:.2f}s): both arms' {cross['records']} records "
          "equal, every field; " + json.dumps(cross))
    return {"genome_bp": genome_bp, "pairs": n_pairs, "lut_k": index.lut_k,
            "index": how, "index_upload_s": upload_s, "result": res,
            "wall_s": wall, "launches": launches, "launch_shapes": shapes,
            "kept_calls": kept_names, "held": held,
            "cross_check": {"result": cross, "equal": True,
                            "wall_s": dev_wall, "cpu_wall_s": cpu_wall},
            "card": card}


def phase_seed_sensitivity(dev, card: str, work: str, out_dir: str,
                           peak_ops: float | None = None,
                           genome_bp: int = SEED_GENOME_BP,
                           n_reads: int = SEED_READS,
                           cross_reads: int = SEED_CROSS_READS,
                           lut_k: int = SEED_LUT_K) -> dict:
    """9c: the DP seeding's sensitivity, exact seeds against halved ones
    (seed_sensitivity.measure: ``n_reads`` reads at 4% substitutions,
    those with more than 2 mismatches) over bench_genome's genome,
    indexed here at sa_rate 1 and ``lut_k`` and cached, on ``dev``,
    through _counted with the calls kept and held (hold_kept): both
    arms' recall, candidates and seeding wall, and the JAX tool's
    deltas and ratios. Then ``cross_reads`` on ``dev`` and on the CPU
    route: candidates, recall and counts equal."""
    import torch

    from soap3dp_tpu_torch.tools import seed_sensitivity as sens

    t0 = time.perf_counter()
    genome = sens.bench_genome(genome_bp)
    gen_s = time.perf_counter() - t0
    index, how, build_s = _cached_index(
        genome, os.path.join(work, f"synth_{genome_bp}_sa1_k{lut_k}.t3i"), 1,
        lut_k)
    didx, upload_s = _upload(index, dev)
    phase("seed sensitivity setup",
          f"{genome_bp} bp genome (numpy seed 7) in {gen_s:.2f}s, index "
          f"{how} in {build_s:.2f}s (sa_rate 1, lut_k {index.lut_k}: "
          f"{2 * 4 * 4 ** index.lut_k / 2 ** 30:.2f} GiB of LUT), uploaded "
          f"to {dev} in {upload_s:.2f}s (apart from the seeding times)")
    if index.lut_k != lut_k or index.sa_rate != 1:
        fail(f"seed sensitivity: the index has lut_k {index.lut_k}, sa_rate "
             f"{index.sa_rate}")
    kept = {}
    res, wall, _, launches = _counted(
        lambda: sens.measure(didx, genome.codes, SEED_SUB_RATE, n_reads),
        dev, kept=kept, keep=HELD_ENTRIES)
    shapes = _launch_shapes()
    ratios = sens.ratios(res)
    for arm, r in res.items():
        phase(f"seed sensitivity {arm}",
              f"recall {r['recall']:.6f}, candidates {r['candidates']}, "
              f"seeding {r['seconds'] * 1e3:.2f} ms")
    phase("seed sensitivity",
          f"{n_reads} reads on {dev} in {wall:.2f}s (card: {card}): recall "
          f"delta {ratios['recall_delta']:+.6f}, candidate ratio "
          f"{ratios['candidate_ratio']:.3f}x, time ratio "
          f"{ratios['time_ratio']:.3f}x")
    phase("seed sensitivity launches", json.dumps(launches))
    phase("seed sensitivity launch shapes", json.dumps(shapes))
    kept_names, held = hold_kept("seed sensitivity", "seed", kept, launches,
                                 shapes, SEED_KERNELS, dev, peak_ops)
    del kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    got = sens.measure(didx, genome.codes, SEED_SUB_RATE, cross_reads)
    cpu_idx, _ = _upload(index, torch.device("cpu"))
    want = sens.measure(cpu_idx, genome.codes, SEED_SUB_RATE, cross_reads)
    for arm in got:
        for k in ("recall", "candidates"):
            if got[arm][k] != want[arm][k]:
                fail(f"seed sensitivity {arm}: {k} {got[arm][k]} on {dev}, "
                     f"{want[arm][k]} on cpu")
        for k in ("read", "pos", "strand"):
            if not np.array_equal(got[arm][k], want[arm][k]):
                fail(f"seed sensitivity {arm}: the candidates' {k} differ "
                     f"on {dev} and cpu")
    phase("seed sensitivity cuda = cpu",
          f"{cross_reads} reads on {dev} and on the cpu route: candidates, "
          "recall and counts equal in both arms ("
          + ", ".join(f"{a} {got[a]['candidates']}" for a in got) + ")")
    summary = {a: {k: r[k] for k in ("recall", "candidates", "seconds")}
               for a, r in res.items()}
    return {"genome_bp": genome_bp, "reads": n_reads, "lut_k": index.lut_k,
            "sa_rate": index.sa_rate, "index": how, "index_build_s": build_s,
            "index_upload_s": upload_s, "result": summary, **ratios,
            "wall_s": wall, "launches": launches, "launch_shapes": shapes,
            "kept_calls": kept_names, "held": held,
            "cross_check": {"equal": True, "reads": cross_reads,
                            "result": {a: {k: got[a][k] for k in
                                           ("recall", "candidates")}
                                       for a in got}},
            "card": card}


def _build_all() -> None:
    """Build every kernel library, one nvcc per source, started together;
    print each build's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.kernels import fm_search as fs

    libs = [bd.BANDED_DP_LIB, bd.DP_FORWARD_LIB, bd.DP_WIRE_LIB,
            fs.FM_SEARCH_LIB]
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
    with watch_loop_syncs(dev, "phase 2's wide cases"):
        kernels += phase_wide_kernels(dev, peak_ops)
    lap("K2 and TB cases")
    dw = phase_wire(dev)
    lap("DW cases")
    k1_err, k2_err = phase_range_cases(dev)
    lap("range cases")
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], k1_err)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], k2_err)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    fs_cases, gp_pk, gp_pk_cases, repeat = phase_fm_kernels(dev, peak_ops,
                                                            work)
    lap("FS cases (index build and repeat genome included)")
    phase_golden(dev)
    lap("golden")
    kept = {}
    e2e, reads = phase_e2e(dev, E2E_GENOME_BP, E2E_PAIRS, card, work, OUT_DIR,
                           kept=kept, keep=PATH_KEPT + DP_KEPT)
    lap("PE default")
    # every FS kernel, GP and PK, and every dp_align call (K1, DW) at each
    # of phase 4's launch shapes, its inputs
    fs_cases += hold_path_calls(kept, e2e["launch_shapes"], peak_ops)
    rescue = run_rescue_cases(kept, "path4", dev, peak_ops)
    dp_held = hold_dp_calls(kept, "path4", e2e["launch_shapes"], dev,
                            peak_ops)
    del kept
    torch.cuda.empty_cache()
    kernels += fs_kernel_rows(fs_cases) + gp_pk + dw
    lap("phase 4's FS, GP and PK calls")
    small = phase_mate_pair_devices(
        dev, os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "mp_small"))
    kept = {}
    mate, _ = phase_e2e(dev, E2E_GENOME_BP, E2E_PAIRS, card, work, OUT_DIR,
                        profile=False, mate_pair=True, kept=kept,
                        keep=RESCUE_KEPT + DP_KEPT)
    lap("mate-pair, small and full")
    # GP and PK, and every dp_align call (K1, K2 + TB, DW) at each of
    # phase 5's launch shapes, its inputs
    rescue += run_rescue_cases(kept, "path5", dev, peak_ops)
    with watch_loop_syncs(dev, "phase 5's held calls"):
        dp_held += hold_dp_calls(kept, "path5", mate["launch_shapes"], dev,
                                 peak_ops)
    del kept
    torch.cuda.empty_cache()
    rescue_path_rows(kernels, rescue)
    fs_cases += gp_pk_cases + rescue
    lap("phase 5's GP, PK and DP calls")
    single = phase_single_e2e(dev, reads, card, work, OUT_DIR)
    lap("single-end")
    multi = {"card": card, "mesh": phase_mesh(dev, reads, work, OUT_DIR),
             "hosts": phase_hosts(dev, reads, work, OUT_DIR),
             "all_cards": phase_all_cards(dev, reads, work)}
    lap("several devices")
    accuracy = {"card": card, "gates": phase_accuracy_gates(dev),
                "repeat_text": phase_repeat_text(dev, card, work, OUT_DIR,
                                                 peak_ops)}
    torch.cuda.empty_cache()
    lap("accuracy")
    ab = {"card": card}
    for name, fn in zip(AB_PHASES, (phase_storm_ab, phase_phased_ab,
                                    phase_seed_sensitivity)):
        ab[name] = fn(dev, card, work, OUT_DIR, peak_ops)
        torch.cuda.empty_cache()
        lap(f"A/B {name}")
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
    dw_row = next(r for r in kernels if r["name"] == "dp_wire")
    dw_row["launches"] = e2e["launches"]["DW"]
    dw_row["launches_mate_pair"] = mate["launches"]["DW"]
    dw_row["launches_single"] = single["launches"]["DW"]
    kernels[0]["launches_mate_pair"] = mate["launches"]["K1"]
    kernels[0]["launches_single"] = single["launches"]["K1"]
    kernels[0]["held_path_calls"] = [r["case"] for r in dp_held]
    # launches on phase 8's repeat text, beside the main path's, and the
    # differences of its calls held to their plain versions
    repeat_text = accuracy["repeat_text"]
    # and phase 9's, by A/B
    for row, label in zip(kernels, _kernels(), strict=True):
        row["launches_repeat_text"] = repeat_text["launches"][label]
        row["launches_ab"] = {name: ab[name]["launches"][label]
                              for name in AB_PHASES}
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            r["max_abs_err"] for held in [repeat_text["held"], dp_held] + [
                ab[name]["held"] for name in AB_PHASES]
            for r in held if r["kernel"] == label])
    for row in kernels:
        row["share"] = row["bound_ms"] / row["ms"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": kernels, "fm_cases": fs_cases,
                   "repeat_search": repeat, "e2e": e2e,
                   "mate_pair_small": small, "mate_pair": mate,
                   "single": single, "multi_device": multi,
                   "dp_path_calls": dp_held, "accuracy": accuracy,
                   "ab": ab, "wall_s": walls}, fh,
                  indent=1)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "cases"} for r in kernels]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
