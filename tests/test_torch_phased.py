"""Phased-search divergence bound on the port, against the JAX package.

The port's counterpart of tests/test_phased.py: the same repeat-rich
300 kbp genome (800 bp blocks duplicated with 1-2 substitutions), the
same 3,000 pairs and options, through the port's copy of run_ab and
divergence (soap3dp_tpu_torch/tools/measure_phased_divergence.py) on
the CPU. The phased path must engage in both packages; the bounds are
the reference's, copied verbatim; the port's record maps (phased on and
off) and its divergence dict must equal the JAX run_ab's on the same
batches, tolerance zero. The tool's pairs (make_pairs, bench.py's)
and its main are held to the JAX package's too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from soap3dp_tpu.fm.fmindex import device_index as jax_device_index
from soap3dp_tpu.index.builder import build_index as jax_build_index
from soap3dp_tpu.utils import dna
from soap3dp_tpu_torch.fm.fmindex import device_index
from soap3dp_tpu_torch.index.builder import build_index
from soap3dp_tpu_torch.index.packing import PackedGenome
from soap3dp_tpu_torch.io.fastq import ReadBatch
from soap3dp_tpu_torch.tools.measure_phased_divergence import (divergence,
                                                               run_ab)

from tests.conftest import make_genome
from tests.test_phased import _pairs
from tools import measure_phased_divergence as jax_measure

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

KW = dict(min_insert=150, max_insert=600, soap3_mismatch_allow=3)


@pytest.fixture(scope="module")
def phased_setup():
    """tests/test_phased.py's genome, indexed by each package with a LUT
    short enough that the phased search engages."""
    rng = np.random.default_rng(101)
    genome = make_genome(rng, 300_000)
    for src, dsts in ((10_000, (120_000, 200_000)),
                      (50_000, (160_000, 260_000))):
        block = genome.codes[src:src + 800].copy()
        for d in dsts:
            b = block.copy()
            for off in rng.integers(0, 800, 2):
                b[off] = (b[off] + 1) % 4
            genome.codes[d:d + 800] = b
    genome.pac = dna.pack_codes(genome.codes)
    jax_index = jax_build_index(genome, sa_rate=4, lut_k=8)
    index = build_index(PackedGenome(**dataclasses.asdict(genome)),
                        sa_rate=4, lut_k=8)
    return ((jax_index, jax_device_index(jax_index)),
            (index, device_index(index, "cpu")), genome)


def _port_batch(b):
    return ReadBatch(b.names, b.codes, b.lens, b.quals)


def test_phased_path_engages(phased_setup):
    """The precondition, in both packages: _phase1_range finds a range
    on this index at k = 3."""
    from soap3dp_tpu.pipeline.options import AlignOptions as JaxOptions
    from soap3dp_tpu.pipeline.pair import _phase1_range as jax_phase1_range
    from soap3dp_tpu_torch.pipeline.options import AlignOptions
    from soap3dp_tpu_torch.pipeline.pair import _phase1_range

    (_, jax_didx), (_, didx), _ = phased_setup
    got = _phase1_range(didx, AlignOptions(**KW), 3)
    assert got is not None
    assert got == jax_phase1_range(jax_didx, JaxOptions(**KW), 3)


def test_phased_divergence_bounded(phased_setup):
    (jax_index, jax_didx), (index, didx), genome = phased_setup
    rng = np.random.default_rng(7)
    b1, b2 = _pairs(genome, rng, 3000)

    a, b = run_ab(index, didx, _port_batch(b1), _port_batch(b2), KW)
    d = divergence(a, b)
    assert d["records"] == 6000
    assert d["missing_either"] == 0
    # primary placements and CIGARs must never move: phase-1 resolution
    # requires a complete best-score set
    assert d["pos_rate"] == 0.0, d
    assert d["cigar_rate"] == 0.0, d
    assert d["flag_rate"] == 0.0, d
    # X1/MAPQ may diverge on phase-1-resolved reads whose suboptimal
    # hits live in later segments; bound the rate
    assert d["any_field_rate"] <= 0.05, d

    ja, jb = jax_measure.run_ab(jax_index, jax_didx, b1, b2, KW)
    assert a == ja
    assert b == jb
    assert d == jax_measure.divergence(ja, jb)


@pytest.mark.parametrize("excluded", [False, True])
def test_make_pairs_equals_bench(excluded):
    """The port's make_pairs gives bench.make_pairs' batches (both ends'
    codes, names and lens) for the same codes and rng, with and without
    N runs to keep the inserts off."""
    import bench
    from soap3dp_tpu_torch.tools import measure_phased_divergence as port

    codes = np.random.default_rng(3).integers(0, 4, 200_000).astype(np.uint8)
    ex = None
    if excluded:
        starts = np.arange(10_000, 190_000, 20_000, dtype=np.int64)
        ex = (starts, starts + 3_000)
    assert (port.INSERT, port.READ_LEN) == (bench.INSERT, bench.READ_LEN)
    got = port.make_pairs(codes, 500, np.random.default_rng(17), ex)
    want = bench.make_pairs(codes, 500, np.random.default_rng(17), ex)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.lens, w.lens)
        assert list(g.names) == list(w.names)
        assert g.quals is None and w.quals is None


def test_phased_main_equals_the_jax_main(monkeypatch, capsys):
    """The port's main on a 300 kbp bench_genome (lut_k 8, 200 pairs)
    prints the JSON line the JAX tool's main prints over the same
    genome's index (bench.get_index swapped for it); without
    ``--device cpu`` it needs a card."""
    import json
    import sys

    import bench
    from soap3dp_tpu.index.packing import PackedGenome as JaxPackedGenome
    from soap3dp_tpu.utils import jaxcache
    from soap3dp_tpu_torch.tools import measure_phased_divergence as port
    from soap3dp_tpu_torch.tools.seed_sensitivity import bench_genome

    argv = ["200", "--genome-bp", "300000", "--lut-k", "8"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.main(argv)
    assert port.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    genome = bench_genome(300_000)
    jax_index = jax_build_index(
        JaxPackedGenome(**dataclasses.asdict(genome)), sa_rate=2, lut_k=8)
    monkeypatch.setattr(bench, "get_index",
                        lambda bp, sa_rate, lut_k: (jax_index, genome.codes))
    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["measure_phased_divergence.py", "200"])
    assert jax_measure.main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["n_pairs"] == 200 and got["records"] == 400
