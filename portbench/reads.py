"""The general read generator: one traffic mix's parameters in, a
FASTQ pair and its truth out.

Rewritten from the port's simulators (``soap3dp_tpu_torch/workloads.py``
``make_pe_fastq`` and ``soap3dp_tpu_torch/tools/evaluate_accuracy.py``
``simulate_pairs``, commit ba71ec9) to the mixes of ``traffic/``: every
class of read is an exact count drawn from the seed, so two seeds give
the same amount of every kind of work in another order.

A mix (``traffic/<name>.json``) holds:

- ``source``: the published profile its shares are taken from;
- ``read_len``: bases a read;
- ``orientation``: the library's StrandArrangement, the strands of the
  leftmost and the rightmost leg (``+/-`` paired-end, ``-/+`` mate-pair);
- ``insert``: ``[mean, sd, min, max]`` of the outer distance, drawn
  normal, rounded and clipped;
- ``sub_rate``: the chance that a base of a read is substituted;
- ``indel_reads``: the share of ends with one indel, ``indel_len``
  ``[min, max]`` bases long (insertion or deletion, even odds, at least
  10 bases from either end);
- ``random_end_pairs``: the share of pairs with one end of uniform
  random bases (a contaminant or a chimera);
- ``junction_reads``: the share of ends whose last ``junction_len``
  ``[min, max]`` bases (in sequencing order) are foreign sequence, as a
  mate-pair read that runs through its circularisation junction.

Read 1 is the leftmost leg of its pair or the rightmost, even odds.
Fragments avoid the excluded N runs and never cross a chromosome end.
The truth of an end is its chromosome and the 1-based position of its
leftmost base that comes from the genome.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.genome import ACGT, Genome

MIX_KEYS = {"source", "read_len", "orientation", "insert", "sub_rate", "indel_reads",
            "indel_len", "random_end_pairs", "junction_reads",
            "junction_len"}


@dataclasses.dataclass
class Reads:
    codes: np.ndarray        # (2, n, L) uint8, read 1 then read 2
    chrom: np.ndarray        # (2, n) int64 truth chromosome
    pos: np.ndarray          # (2, n) int64 truth 1-based position
    random: np.ndarray       # (2, n) bool: a random end (no truth)
    indel: np.ndarray        # (2, n) bool
    junction: np.ndarray     # (2, n) bool
    reverse: np.ndarray      # (2, n) bool: the end reads the - strand
    foreign: np.ndarray      # (2, n) int64 junction bases at its end

    @property
    def pairs(self) -> int:
        return self.codes.shape[1]


def check_mix(mix: dict) -> None:
    missing = MIX_KEYS - set(mix)
    if missing:
        raise ValueError(f"mix lacks {sorted(missing)}")
    if mix["orientation"] not in ("+/-", "-/+", "+/+", "-/-"):
        raise ValueError(f"bad orientation {mix['orientation']!r}")
    mean, sd, lo, hi = mix["insert"]
    if not mix["read_len"] <= lo <= mean <= hi:
        raise ValueError("insert must satisfy read_len <= min <= mean <= max")


def _exact(rng, n: int, share: float, eligible: np.ndarray) -> np.ndarray:
    """A mask of round(share * n) entries drawn from the eligible ones."""
    k = int(round(share * n))
    idx = np.flatnonzero(eligible)
    if k > len(idx):
        raise ValueError("a mix asks for more reads of a class than exist")
    out = np.zeros(len(eligible), bool)
    out[rng.choice(idx, k, replace=False)] = True
    return out


def _fragment_starts(rng, g: Genome, ins: np.ndarray, margin: int
                     ) -> np.ndarray:
    """Starts of fragments of length ins (+ margin) inside one
    chromosome and clear of the excluded N runs."""
    starts, ends = g.excluded()
    n = g.length
    s = np.zeros(len(ins), np.int64)
    todo = np.ones(len(ins), bool)
    for _ in range(1000):
        k = int(todo.sum())
        if not k:
            return s
        cand = rng.integers(0, n - int(ins.max()) - margin, k)
        e = cand + ins[todo] + margin
        c0 = np.searchsorted(g.offsets, cand, side="right")
        c1 = np.searchsorted(g.offsets, e - 1, side="right")
        i = np.searchsorted(ends, cand, side="right")
        hit_n = (i < len(starts)) & (starts[np.minimum(i, len(starts) - 1)]
                                     < e) if len(starts) else np.zeros(k, bool)
        ok = (c0 == c1) & ~hit_n
        idx = np.flatnonzero(todo)
        s[idx[ok]] = cand[ok]
        todo[idx[ok]] = False
    raise RuntimeError("no room for the fragments in the genome")


def simulate(g: Genome, mix: dict, n: int, rng: np.random.Generator) -> Reads:
    """n read pairs of ``mix`` from genome ``g``."""
    check_mix(mix)
    L = int(mix["read_len"])
    mean, sd, lo, hi = mix["insert"]
    ins = np.full(n, int(mean), np.int64)
    if sd:
        ins = np.clip(np.rint(rng.normal(mean, sd, n)), lo, hi).astype(np.int64)
    dmax = int(mix["indel_len"][1])
    frag = _fragment_starts(rng, g, ins, dmax)
    codes = np.asarray(g.codes)

    # per leg (0 left, 1 right): class masks over (2, n)
    rand_pair = _exact(rng, n, mix["random_end_pairs"], np.ones(n, bool))
    rand_leg = rng.integers(0, 2, n)
    random = np.zeros((2, n), bool)
    random[rand_leg[rand_pair], np.flatnonzero(rand_pair)] = True
    alive = ~random.ravel()
    indel = _exact(rng, 2 * n, mix["indel_reads"], alive).reshape(2, n)
    junction = _exact(rng, 2 * n, mix["junction_reads"],
                      alive).reshape(2, n)

    j = np.arange(L, dtype=np.int64)[None, :]
    legs = np.empty((2, n, L), np.uint8)
    gpos = np.empty((2, n), np.int64)
    jlen = np.zeros((2, n), np.int64)
    strands = [mix["orientation"][0] == "-", mix["orientation"][2] == "-"]
    for leg in (0, 1):
        m = indel[leg]
        d = np.where(m, rng.integers(int(mix["indel_len"][0]), dmax + 1, n), 0)
        is_del = m & (rng.random(n) < 0.5)
        is_ins = m & ~is_del
        at = rng.integers(10, L - 10 - dmax, n)
        span = L + np.where(is_del, d, 0) - np.where(is_ins, d, 0)
        start = frag if leg == 0 else frag + ins - span
        off = (j + np.where(is_del[:, None] & (j >= at[:, None]), d[:, None], 0)
               - np.where(is_ins[:, None] & (j >= (at + d)[:, None]),
                          d[:, None], 0))
        read = codes[start[:, None] + off]
        inserted = is_ins[:, None] & (j >= at[:, None]) & (j < (at + d)[:, None])
        read[inserted] = rng.integers(0, 4, int(inserted.sum()), dtype=np.uint8)
        if strands[leg]:
            read = (3 - read[:, ::-1])
        jl = np.where(junction[leg],
                      rng.integers(int(mix["junction_len"][0]),
                                   int(mix["junction_len"][1]) + 1, n), 0)
        jlen[leg] = jl
        foreign = j >= (L - jl)[:, None]
        read[foreign] = rng.integers(0, 4, int(foreign.sum()), dtype=np.uint8)
        # a reverse read's last bases lie at the left of its genome span
        gpos[leg] = start + (jl if strands[leg] else 0)
        sub = (rng.random(read.shape, dtype=np.float32) < mix["sub_rate"])
        read[sub] = (read[sub] + rng.integers(1, 4, int(sub.sum()),
                                              dtype=np.uint8)) % 4
        read[random[leg]] = rng.integers(0, 4, (int(random[leg].sum()), L),
                                         dtype=np.uint8)
        legs[leg] = read

    # read 1 is either leg, even odds
    first = rng.integers(0, 2, n).astype(bool)  # True: read 1 is the right leg
    order = np.stack([first.astype(np.int64), (~first).astype(np.int64)])
    cols = np.arange(n)
    pick = lambda a: a[order, cols]  # noqa: E731
    c = np.searchsorted(g.offsets, gpos, side="right") - 1
    chrom = pick(c)
    pos = pick(gpos - g.offsets[c] + 1)
    return Reads(codes=np.stack([legs[order[0], cols], legs[order[1], cols]]),
                 chrom=chrom, pos=pos, random=pick(random),
                 indel=pick(indel), junction=pick(junction),
                 reverse=pick(np.array([[strands[0]] * n, [strands[1]] * n])),
                 foreign=pick(jlen))


def read_name(i) -> bytes:
    return b"r%08d" % i


def write_fastq(reads: Reads, path1: str, path2: str) -> None:
    """Both ends as FASTQ, qualities all ``I``, names ``r%08d``."""
    n, L = reads.codes.shape[1], reads.codes.shape[2]
    names = np.frombuffer(b"".join(read_name(i) for i in range(n)),
                          np.uint8).reshape(n, 9)
    rec = 1 + 9 + 1 + L + 3 + L + 1
    for end, path in ((0, path1), (1, path2)):
        buf = np.empty((n, rec), np.uint8)
        buf[:, 0] = ord("@")
        buf[:, 1:10] = names
        buf[:, 10] = ord("\n")
        buf[:, 11:11 + L] = ACGT[reads.codes[end]]
        buf[:, 11 + L:14 + L] = np.frombuffer(b"\n+\n", np.uint8)
        buf[:, 14 + L:14 + 2 * L] = ord("I")
        buf[:, 14 + 2 * L] = ord("\n")
        with open(path, "wb") as fh:
            fh.write(buf.tobytes())
