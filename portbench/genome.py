"""The reference genome of a configuration: a frozen copy of the
repeat-structured generator.

Copied from ``soap3dp_tpu_torch/tools/repeat_genome.py`` at commit
ba71ec9 (``generate`` and its helpers, unchanged in what they draw: one
seeded PCG64 stream, so a seed gives the genome that file gives). It
returns a plain ``Genome`` in place of the port's ``PackedGenome``, so
nothing here imports the port. ``cached`` keeps the codes and the
layout under a configuration's cache directory; ``write_fasta`` writes
the FASTA the port's index builder reads (N runs as ``N``).

Family mix (per chromosome): Alu-like SINEs ~12%, LINE-like ~13%,
alpha-satellite ~0.6%, microsatellites ~2%, segmental duplications
~4%, N runs ~2% (telomeres, a centromere gap, scattered gaps); 24
chromosomes in the human ratios.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

# a run of more than this many N is excluded from alignment (the port's
# index/packing.py AMBIGUITY_EXCLUDE_THRESHOLD, README section 2.1)
EXCLUDE_N_RUN = 10
ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class Genome:
    codes: np.ndarray        # (n,) uint8 2-bit codes, N as G (code 2)
    names: list
    offsets: np.ndarray      # (chromosomes + 1,) int64
    amb_starts: np.ndarray   # (runs,) int64 N-run starts
    amb_lengths: np.ndarray  # (runs,) int64

    @property
    def length(self) -> int:
        return len(self.codes)

    def excluded(self) -> tuple[np.ndarray, np.ndarray]:
        """(starts, ends) of the N runs excluded from alignment."""
        keep = self.amb_lengths > EXCLUDE_N_RUN
        s = self.amb_starts[keep]
        return s, s + self.amb_lengths[keep]


_HUMAN_CHROM_MBP = np.array([
    248.9, 242.2, 198.3, 190.2, 181.5, 170.8, 159.3, 145.1, 138.4,
    133.8, 135.1, 133.3, 114.4, 107.0, 102.0, 90.3, 83.3, 80.4,
    58.6, 64.4, 46.7, 50.8, 156.0, 57.2])

_PASTE_CHUNK = 200_000  # copies per vectorized paste chunk


def _rand_codes(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, n, dtype=np.uint8)


def _mutate_tiles(rng, tiles: np.ndarray, rates: np.ndarray) -> np.ndarray:
    """Substitute each base of tiles[i] with prob rates[i] (in place)."""
    m = rng.random(tiles.shape, dtype=np.float32) < rates[:, None]
    cnt = int(m.sum())
    if cnt:
        tiles[m] = (tiles[m] + rng.integers(1, 4, cnt, dtype=np.uint8)) % 4
    return tiles


def _paste_copies(rng, chrom: np.ndarray, consensus: np.ndarray,
                  n_copies: int, lo: int, hi: int) -> int:
    """Paste n_copies of consensus at random positions in chrom[lo:hi],
    each with its own substitution divergence. Returns bases pasted."""
    w = len(consensus)
    if hi - lo <= w or n_copies <= 0:
        return 0
    pasted = 0
    for s in range(0, n_copies, _PASTE_CHUNK):
        m = min(_PASTE_CHUNK, n_copies - s)
        starts = rng.integers(lo, hi - w, m)
        tiles = np.broadcast_to(consensus, (m, w)).copy()
        _mutate_tiles(rng, tiles, rng.uniform(0.02, 0.25, m).astype(np.float32))
        # strand: half the copies are inserted reverse-complemented
        flip = rng.random(m) < 0.5
        tiles[flip] = (3 - tiles[flip, ::-1])
        idx = starts[:, None] + np.arange(w)
        chrom[idx.ravel()] = tiles.ravel()
        pasted += m * w
    return pasted


def _paste_microsats(rng, chrom: np.ndarray, budget: int, lo: int,
                     hi: int) -> int:
    """Scatter short-tandem-repeat runs (1-6 bp motifs) totalling ~budget."""
    pasted = 0
    while pasted < budget:
        motif_len = int(rng.integers(1, 7))
        motif = _rand_codes(rng, motif_len)
        # real STR runs are short (median ~25 bp, tail to a few hundred;
        # 200-2000 bp runs were unrealistic and made reads fully inside
        # a run — no unique flank for any pigeonhole segment — ~2% of
        # the mix, far past what GRCh38 alignment sees)
        run = int(min(20 + rng.geometric(1 / 40.0), 300))
        start = int(rng.integers(lo, hi - run))
        tile = np.tile(motif, run // motif_len + 1)[:run]
        m = rng.random(run, dtype=np.float32) < 0.01
        tile[m] = (tile[m] + rng.integers(1, 4, int(m.sum()),
                                          dtype=np.uint8)) % 4
        chrom[start:start + run] = tile
        pasted += run
    return pasted


def _paste_satellite(rng, chrom: np.ndarray, center: int,
                     budget: int) -> int:
    """Alpha-satellite-like tandem arrays around `center`.

    Higher-order structure: an 8-monomer unit (8 x 171 bp) is itself
    tandemly repeated, monomers diverge ~2% from the family consensus
    and the higher-order unit repeats near-identically — the exact
    pathology that makes centromeres FM-search worst cases."""
    mono = _rand_codes(rng, 171)
    unit = np.broadcast_to(mono, (8, 171)).copy()
    _mutate_tiles(rng, unit, np.full(8, 0.02, np.float32))
    unit = unit.ravel()  # 1368 bp higher-order unit
    pasted = 0
    pos = center
    n = len(chrom)
    if n <= 2 * len(unit):
        return 0
    max_units = (n - 2) // len(unit)
    while pasted < budget:
        arr_units = min(int(rng.integers(20, 200)), max_units)
        arr = np.broadcast_to(unit, (arr_units, len(unit))).copy()
        _mutate_tiles(rng, arr, np.full(arr_units, 0.005, np.float32))
        arr = arr.ravel()
        start = min(max(0, pos), n - len(arr) - 1)
        chrom[start:start + len(arr)] = arr
        pasted += len(arr)
        pos = start + len(arr) + int(rng.integers(1000, 50_000))
        if pos + len(unit) * 200 >= n:
            pos = max(0, center - pasted - int(rng.integers(0, 10_000)))
    return pasted


def _paste_segdups(rng, chrom: np.ndarray, budget: int) -> int:
    """Copy random 20-50 kbp windows elsewhere with ~2% divergence."""
    n = len(chrom)
    pasted = 0
    while pasted < budget:
        w = int(rng.integers(20_000, 50_001))
        if n < 2 * w + 2:
            break
        src = int(rng.integers(0, n - w))
        dst = int(rng.integers(0, n - w))
        seg = chrom[src:src + w].copy()
        m = rng.random(w, dtype=np.float32) < 0.02
        seg[m] = (seg[m] + rng.integers(1, 4, int(m.sum()),
                                        dtype=np.uint8)) % 4
        chrom[dst:dst + w] = seg
        pasted += w
    return pasted


def _n_runs_for(rng, L: int, centro: int) -> list[tuple[int, int]]:
    """(start, length) N runs: telomeres, centromere gap, scattered."""
    runs = [(0, 10_000), (L - 10_000, 10_000)]
    # hg19-style centromere gap (~3 Mbp per chromosome): the deep
    # satellite arrays live inside this N run, not in sequence
    gap = int(rng.integers(2_500_000, 4_000_000)) if L > 20_000_000 \
        else max(100, L // 50)
    runs.append((max(0, centro - gap // 2), min(gap, L - 20_000)))
    for _ in range(int(rng.integers(2, 6))):
        g = int(rng.integers(20_000, 100_000))
        runs.append((int(rng.integers(10_000, max(10_001, L - g - 10_000))), g))
    return runs


def _make_chromosome(rng: np.random.Generator, L: int, name: str,
                     sine: np.ndarray, line: np.ndarray,
                     log=lambda m: None):
    """Returns (codes uint8 (L,), n_runs list, repeat_bases int)."""
    chrom = _rand_codes(rng, L)
    rep = 0
    centro = int(L * float(rng.uniform(0.35, 0.65)))
    # interspersed SINEs (Alu-like): ~12% (real Alu ~11% of GRCh38)
    rep += _paste_copies(rng, chrom, sine, int(L * 0.12) // len(sine), 0, L)
    log(f"{name}: SINEs done")
    # LINE-like: mostly 5'-truncated copies; classes hit ~13% total
    for frac, w in ((0.05, 500), (0.03, 1000), (0.03, 2500), (0.02, 6000)):
        rep += _paste_copies(rng, chrom, line[-w:], int(L * frac) // w, 0, L)
    log(f"{name}: LINEs done")
    # alignable satellite is SMALL: hg19/GRCh38 — the genomes the
    # reference's baseline aligns against — represent the deep
    # centromeric alpha-satellite arrays as assembly gaps (the
    # centromere N run below), with only pericentromeric remnants in
    # sequence. Fully-alignable multi-Mbp arrays would make 5%+ of
    # reads super-repetitive, a load GRCh38 alignment never sees.
    rep += _paste_satellite(rng, chrom, centro, int(L * 0.006))
    rep += _paste_microsats(rng, chrom, int(L * 0.02), 0, L)
    rep += _paste_segdups(rng, chrom, int(L * 0.04))
    log(f"{name}: satellites/microsats/segdups done")
    # N runs last so nothing overwrites them; N encodes as G (code 2)
    n_runs = []
    for start, glen in _n_runs_for(rng, L, centro):
        glen = min(glen, L - start)
        if glen <= 0:
            continue
        chrom[start:start + glen] = 2
        n_runs.append((start, glen))
    n_runs.sort()
    # merge overlapping runs
    merged = []
    for s, g in n_runs:
        if merged and s <= merged[-1][0] + merged[-1][1]:
            ps, pg = merged[-1]
            merged[-1] = (ps, max(pg, s + g - ps))
        else:
            merged.append((s, g))
    return chrom, merged, rep


def generate(total_bp: int, seed: int = 20240817, log=None):
    """Build the repeat-structured genome; returns a Genome."""
    t0 = time.time()
    if log is None:
        def log(m):
            print(f"[repeat-genome +{time.time() - t0:6.0f}s] {m}",
                  file=sys.stderr, flush=True)
    rng = np.random.default_rng(seed)
    lens = np.maximum(
        (_HUMAN_CHROM_MBP / _HUMAN_CHROM_MBP.sum() * total_bp).astype(np.int64),
        50_000)
    lens[0] += total_bp - int(lens.sum())  # exact total
    # one consensus per family, shared genome-wide (like real Alu/L1)
    sine = _rand_codes(rng, 300)
    line = _rand_codes(rng, 6000)
    names = [f"chr{i + 1}" for i in range(22)] + ["chrX", "chrY"]
    names = names[:len(lens)]
    codes = np.empty(total_bp, np.uint8)
    offsets = [0]
    amb_starts: list[int] = []
    amb_lengths: list[int] = []
    rep_total = 0
    for name, L in zip(names, lens):
        base = offsets[-1]
        chrom, n_runs, rep = _make_chromosome(
            rng, int(L), name, sine, line, log)
        codes[base:base + len(chrom)] = chrom
        offsets.append(base + len(chrom))
        for s, g in n_runs:
            amb_starts.append(base + s)
            amb_lengths.append(g)
        rep_total += rep
        log(f"{name}: {L / 1e6:.0f} Mbp done "
            f"(cumulative repeat {rep_total / offsets[-1]:.1%})")
    log(f"total {total_bp / 1e9:.2f} Gbp, repeat fraction "
        f"{rep_total / total_bp:.1%}, {len(amb_starts)} N runs")
    return Genome(codes=codes, names=names,
                  offsets=np.asarray(offsets, np.int64),
                  amb_starts=np.asarray(amb_starts, np.int64),
                  amb_lengths=np.asarray(amb_lengths, np.int64))


def cached(cache_dir: str, total_bp: int, seed: int) -> Genome:
    """The genome of (total_bp, seed), generated once into cache_dir
    (``genome.codes.npy``, ``genome.json``) and loaded from there."""
    codes_path = os.path.join(cache_dir, "genome.codes.npy")
    meta_path = os.path.join(cache_dir, "genome.json")
    want = {"total_bp": int(total_bp), "seed": int(seed)}
    meta = None
    if os.path.exists(meta_path) and os.path.exists(codes_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        if {k: meta.get(k) for k in want} != want:
            meta = None
    if meta is None:
        os.makedirs(cache_dir, exist_ok=True)
        g = generate(total_bp, seed, log=lambda m: None)
        np.save(codes_path + ".tmp.npy", g.codes)
        os.replace(codes_path + ".tmp.npy", codes_path)
        meta = dict(want, names=g.names,
                    offsets=[int(x) for x in g.offsets],
                    amb_starts=[int(x) for x in g.amb_starts],
                    amb_lengths=[int(x) for x in g.amb_lengths])
        with open(meta_path + ".tmp", "w") as fh:
            json.dump(meta, fh)
        os.replace(meta_path + ".tmp", meta_path)
        return g
    return Genome(codes=np.load(codes_path, mmap_mode="r"),
                  names=list(meta["names"]),
                  offsets=np.asarray(meta["offsets"], np.int64),
                  amb_starts=np.asarray(meta["amb_starts"], np.int64),
                  amb_lengths=np.asarray(meta["amb_lengths"], np.int64))


def write_fasta(g: Genome, path: str) -> None:
    """The genome as FASTA, every N run written as N, 80 bases a line."""
    width = 80
    chars = ACGT[np.asarray(g.codes)]
    for s, n in zip(g.amb_starts, g.amb_lengths):
        chars[s:s + n] = ord("N")
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        for i, name in enumerate(g.names):
            seq = chars[g.offsets[i]:g.offsets[i + 1]]
            fh.write(b">%s\n" % name.encode())
            full = len(seq) // width * width
            if full:
                rows = np.empty((full // width, width + 1), np.uint8)
                rows[:, :width] = seq[:full].reshape(-1, width)
                rows[:, width] = ord("\n")
                fh.write(rows.tobytes())
            if full < len(seq):
                fh.write(seq[full:].tobytes() + b"\n")
    os.replace(tmp, path)
