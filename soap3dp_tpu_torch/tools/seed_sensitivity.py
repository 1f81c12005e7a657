"""Deep-DP seeding sensitivity, exact seeds vs halved (1-mismatch)
seeds: the port's copy of the repo's tools/seed_sensitivity.py, over
soap3dp_tpu_torch's DP seeding.

The reference seeds deep DP with a 1-mismatch GPU kernel
(single_1_mismatch_alignment2, alignment.cu:1839). The rebuild uses
exact staged seeds; the cheap 1-mismatch equivalent is searching both
exact halves of every seed (pigeonhole; AlignOptions.dp_seed_1mm).
This tool measures, on reads mutated at a given substitution rate (the
reads deep DP actually sees: more than 2 mismatches):

  - per-end candidate recall: planted locus recovered by seeding
  - candidate volume (what the DP stage's cost grows with)
  - wall time of the seeding stage

Usage (on a CUDA card unless ``--device cpu``):

  python -m soap3dp_tpu_torch.tools.seed_sensitivity [sub_rate=0.04] \
      [n_reads=20000] [--device cuda] [--genome-bp 40000000] \
      [--lut-k 14] [--cache DIR]

The genome is bench_genome's (the JAX package's bench.get_index
genome: numpy seed 7, one chromosome), indexed at sa_rate 1 and
``--lut-k`` once and cached in ``--cache`` (default
soap3dp_tpu_torch/_build/seed_sensitivity).

tests/test_torch_seed_sensitivity.py holds measure to the JAX
package's seeding, candidate for candidate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from soap3dp_tpu_torch.index.packing import PackedGenome
from soap3dp_tpu_torch.pipeline import dp_rescue
from soap3dp_tpu_torch.utils import dna

READ_LEN = 100
ARMS = (("exact", False), ("halved-1mm", True))
CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "seed_sensitivity")


def bench_genome(genome_bp: int, seed: int = 7) -> PackedGenome:
    """The uniform random genome of the JAX package's bench.get_index:
    ``genome_bp`` codes from numpy's default_rng(``seed``), one
    chromosome, synth1."""
    codes = np.random.default_rng(seed).integers(0, 4, genome_bp,
                                                 dtype=np.uint8)
    return PackedGenome(
        codes=codes, pac=dna.pack_codes(codes), length=genome_bp,
        names=["synth1"], offsets=np.asarray([0, genome_bp], np.uint64),
        amb_starts=np.zeros(0, np.uint64), amb_lengths=np.zeros(0, np.uint64))


def mutated_reads(codes: np.ndarray, sub_rate: float, n_reads: int,
                  seed: int = 5) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(reads, planted positions, lens): ``n_reads`` forward reads of
    READ_LEN bases substituted at ``sub_rate``, those with more than 2
    mismatches kept (the reads deep DP sees)."""
    L = READ_LEN
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, len(codes) - L, n_reads)
    reads = codes[pos[:, None] + np.arange(L)[None, :]].copy()
    mask = rng.random(reads.shape) < sub_rate
    reads[mask] = (reads[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
    keep = mask.sum(axis=1) > 2
    reads, pos = reads[keep], pos[keep]
    return reads, pos, np.full(len(reads), L, np.int32)


def measure(didx, codes: np.ndarray, sub_rate: float = 0.04,
            n_reads: int = 20_000, seed: int = 5) -> dict:
    """{arm: {"recall", "candidates", "seconds", "read", "pos",
    "strand"}} for the exact and halved-1mm arms on ``didx``: the
    planted-locus recall (forward strand, within dp_margin), the
    candidate count, the seeding wall (after a warm-up call on the first
    1,024 reads) and the candidates."""
    import torch

    codes = np.asarray(codes)
    reads, pos, lens = mutated_reads(codes, sub_rate, n_reads, seed)
    print(f"[sens] {len(reads)} reads with >2 mismatches "
          f"(sub rate {sub_rate})", file=sys.stderr)
    margin = int(dp_rescue.dp_margin(np.asarray([READ_LEN]))[0])
    out = {}
    for name, halved in ARMS:
        sp, sl = dp_rescue.deep_dp_seed_matrix(lens, READ_LEN, halved=halved)
        dp_rescue.seed_candidates(didx, reads[:1024], lens[:1024],
                                  sp[:1024], sl[:1024])
        if didx.pac.is_cuda:
            torch.cuda.synchronize(didx.pac.device)
        t0 = time.time()
        cand = dp_rescue.seed_candidates(didx, reads, lens, sp, sl)
        dt = time.time() - t0
        ok = (cand.strand == 0) & (np.abs(cand.pos - pos[cand.read]) <= margin)
        recall = len(np.unique(cand.read[ok])) / len(reads)
        out[name] = {"recall": recall, "candidates": len(cand.read),
                     "seconds": dt, "read": cand.read, "pos": cand.pos,
                     "strand": cand.strand}
        print(f"[sens] {name:<12s} recall {recall:7.4f}  "
              f"candidates {len(cand.read):8d}  seeding {dt * 1000:7.1f} ms",
              file=sys.stderr)
    return out


def ratios(res: dict) -> dict:
    """The JAX tool's summary of ``measure``'s result: recall delta,
    candidate ratio and time ratio, halved-1mm over exact."""
    ex, hv = res["exact"], res["halved-1mm"]
    return {"recall_delta": hv["recall"] - ex["recall"],
            "candidate_ratio": hv["candidates"] / max(ex["candidates"], 1),
            "time_ratio": hv["seconds"] / max(ex["seconds"], 1e-9)}


def main(argv=None) -> int:
    from soap3dp_tpu_torch.cli.runner import resolve_device
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import (build_index, load_index,
                                                 save_index)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sub_rate", nargs="?", type=float, default=0.04)
    ap.add_argument("n_reads", nargs="?", type=int, default=20_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:K or cpu")
    ap.add_argument("--genome-bp", type=int, default=40_000_000)
    ap.add_argument("--lut-k", type=int, default=14,
                    help="the index's LUT k (14, as the JAX tool builds)")
    ap.add_argument("--cache", default=CACHE,
                    help="where the index is kept between runs")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    genome = bench_genome(a.genome_bp)
    path = os.path.join(a.cache, f"synth{a.genome_bp}.sa1k{a.lut_k}.t3i")
    if os.path.exists(os.path.join(path, "meta.json")):
        index = load_index(path)
    else:
        index = build_index(genome, sa_rate=1, lut_k=a.lut_k)
        os.makedirs(a.cache, exist_ok=True)
        save_index(index, path)
    t0 = time.time()
    didx = device_index(index, dev)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    print(f"[sens] index uploaded to {dev} in {time.time() - t0:.2f}s",
          file=sys.stderr)
    res = measure(didx, genome.codes, a.sub_rate, a.n_reads)
    r = ratios(res)
    print(f"[sens] recall delta {r['recall_delta']:+.4f}, "
          f"candidate ratio {r['candidate_ratio']:.2f}x, "
          f"time ratio {r['time_ratio']:.2f}x", file=sys.stderr)
    print(json.dumps({name: {k: res[name][k] for k in
                             ("recall", "candidates", "seconds")}
                      for name, _ in ARMS} | r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
