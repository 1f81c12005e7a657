"""Random-best (-h 4) on the port, against the JAX package.

The port's counterpart of tests/test_random_best.py: the pick is a pure
function of (seed, read name), so it is invariant under batch splitting
and read order. The port's utils/rhash.py must have the reference's
name-hash properties and an unbiased uniform pick, and give the JAX
package's hashes and picks on the same inputs; the port's single-end
and paired-end pipelines must give the same picks whole, split and
shuffled, and the JAX package's picks at the same seeds.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from soap3dp_tpu.utils import rhash as jax_rhash
from soap3dp_tpu_torch.index.builder import build_index
from soap3dp_tpu_torch.index.packing import PackedGenome
from soap3dp_tpu_torch.io.fastq import ReadBatch
from soap3dp_tpu_torch.io.sam import SamWriter
from soap3dp_tpu_torch.pipeline import options as opt
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.pipeline.pair import align_pair_batch
from soap3dp_tpu_torch.pipeline.single import align_single_batch
from soap3dp_tpu_torch.utils import dna, rhash

from tests.conftest import make_genome
from tests.test_pipeline_e2e import parse_sam
from tests import test_random_best as ref

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


# ------------------------- rhash unit tests -------------------------

def test_name_hash_properties():
    names = np.asarray([b"read%d" % i for i in range(1000)])
    h = rhash.name_hashes(names, seed=3)
    assert h.dtype == np.uint64
    assert len(np.unique(h)) == len(names)          # no collisions here
    assert (rhash.name_hashes(names, seed=3) == h).all()   # deterministic
    assert (rhash.name_hashes(names, seed=4) != h).any()   # seed matters
    # padding-width invariance: same names in a wider S dtype hash equal
    wide = names.astype("S32")
    assert (rhash.name_hashes(wide, seed=3) == h).all()
    for seed in (0, 3, 4):
        np.testing.assert_array_equal(rhash.name_hashes(names, seed=seed),
                                      jax_rhash.name_hashes(names, seed=seed))


def test_unbiased_pick_uniform_and_exact():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**64, size=60_000, dtype=np.uint64)
    for n in (2, 3, 7):
        picks = rhash.unbiased_pick(h, np.full(h.shape, n))
        assert picks.min() >= 0 and picks.max() < n
        counts = np.bincount(picks, minlength=n)
        # 60k samples, expect ~60k/n per bin within 5 sigma
        exp = len(h) / n
        sigma = (exp * (1 - 1 / n)) ** 0.5
        assert (np.abs(counts - exp) < 5 * sigma).all(), counts
        np.testing.assert_array_equal(
            picks, jax_rhash.unbiased_pick(h, np.full(h.shape, n)))
    # n=1 always picks 0
    assert (rhash.unbiased_pick(h[:10], np.ones(10)) == 0).all()
    # mixed counts, as a batch of reads with 1-9 equal-best hits has
    ns = rng.integers(1, 10, h.shape)
    np.testing.assert_array_equal(rhash.unbiased_pick(h, ns),
                                  jax_rhash.unbiased_pick(h, ns))


# --------------------- end-to-end batch invariance ------------------

@pytest.fixture(scope="module")
def repeat_index():
    """tests/test_random_best.py's genome: a 500bp block duplicated 4x
    (exact copies), so reads from the block have 4 equal-best
    placements; indexed by each package."""
    from soap3dp_tpu.index.builder import build_index as jax_build_index

    rng = np.random.default_rng(42)
    genome = make_genome(rng, 24_000)
    block = genome.codes[1000:1500].copy()
    for at in (5_000, 11_000, 17_500):
        genome.codes[at:at + 500] = block
    genome.pac = dna.pack_codes(genome.codes)
    index = build_index(PackedGenome(**dataclasses.asdict(genome)),
                        sa_rate=4)
    return index, jax_build_index(genome, sa_rate=4), genome


def _mk_batch(seqs, names):
    L = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), L), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = s
        lens[i] = len(s)
    return ReadBatch(names=np.asarray(names), codes=codes, lens=lens,
                     quals=None)


def _jax_batch(b):
    from soap3dp_tpu.io.fastq import ReadBatch as JaxReadBatch
    return JaxReadBatch(b.names, b.codes, b.lens, b.quals)


def _align_single(index, didx, batch, n_batches, seed=0):
    opts = AlignOptions(output_mode=opt.OUTPUT_RANDOM_BEST,
                        random_seed=seed)
    buf = io.BytesIO()
    w = SamWriter(buf, index)
    bounds = np.linspace(0, len(batch), n_batches + 1).astype(int)
    for i in range(n_batches):
        sub = batch.take(slice(bounds[i], bounds[i + 1]))
        align_single_batch(index, didx, sub, opts, w)
    return {r["qname"]: (r["rname"], r["pos"], r["flag"] & 16)
            for r in parse_sam(buf.getvalue()) if not r["flag"] & 4}


def _align_pair(index, didx, b1, b2, n_batches, seed=0):
    opts = AlignOptions(output_mode=opt.OUTPUT_RANDOM_BEST,
                        random_seed=seed, min_insert=100, max_insert=600)
    buf = io.BytesIO()
    w = SamWriter(buf, index)
    bounds = np.linspace(0, len(b1), n_batches + 1).astype(int)
    for i in range(n_batches):
        sl = slice(bounds[i], bounds[i + 1])
        align_pair_batch(index, didx, b1.take(sl), b2.take(sl), opts, w)
    return {(r["qname"], r["flag"] & 192): (r["rname"], r["pos"])
            for r in parse_sam(buf.getvalue()) if not r["flag"] & 4}


def test_single_batch_split_invariance(repeat_index):
    from soap3dp_tpu.fm.fmindex import device_index as jax_device_index
    from soap3dp_tpu_torch.fm.fmindex import device_index
    index, jax_index, genome = repeat_index
    didx = device_index(index, "cpu")
    rng = np.random.default_rng(5)
    seqs, names = [], []
    for i in range(48):
        off = int(rng.integers(0, 450))
        seqs.append(genome.codes[1000 + off:1000 + off + 50].copy())
        names.append(b"amb%d" % i)
    batch = _mk_batch(seqs, names)

    whole = _align_single(index, didx, batch, 1)
    split = _align_single(index, didx, batch, 3)
    assert whole == split
    # shuffled read order changes nothing either
    perm = rng.permutation(len(batch))
    shuf = _align_single(index, didx, batch.take(perm), 2)
    assert whole == shuf
    # the copies are exact, so picks must spread over >1 locus
    assert len({v for v in whole.values()}) > 1
    # a different seed moves at least one pick
    other = _align_single(index, didx, batch, 1, seed=99)
    assert other != whole
    # the JAX package picks the same loci at both seeds
    jax_didx = jax_device_index(jax_index)
    for seed, got in ((0, whole), (99, other)):
        assert got == ref._align_single(jax_index, jax_didx,
                                        _jax_batch(batch), 1, seed=seed)


def test_pair_batch_split_invariance(repeat_index):
    from soap3dp_tpu.fm.fmindex import device_index as jax_device_index
    from soap3dp_tpu_torch.fm.fmindex import device_index
    index, jax_index, genome = repeat_index
    didx = device_index(index, "cpu")
    rng = np.random.default_rng(6)
    s1, s2, names = [], [], []
    for i in range(32):
        off = int(rng.integers(0, 100))
        a = genome.codes[1000 + off:1050 + off].copy()
        b = genome.codes[1300 + off:1350 + off].copy()
        s1.append(a)
        s2.append(dna.revcomp_codes(b))
        names.append(b"pr%d" % i)
    b1 = _mk_batch(s1, names)
    b2 = _mk_batch(s2, names)

    whole = _align_pair(index, didx, b1, b2, 1)
    split = _align_pair(index, didx, b1, b2, 4)
    assert whole == split
    perm = rng.permutation(len(b1))
    shuf = _align_pair(index, didx, b1.take(perm), b2.take(perm), 2)
    assert whole == shuf
    assert len({v for v in whole.values()}) > 2  # picks spread over loci
    assert whole == ref._align_pair(jax_index, jax_device_index(jax_index),
                                    _jax_batch(b1), _jax_batch(b2), 1)
