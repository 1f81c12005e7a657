"""The accuracy gate on the port, against the JAX package's.

tests/test_accuracy.py drives the repo's tools/evaluate_accuracy.py
harness through the JAX package's full pair pipeline at fixed seeds and
asserts recall and misplacement bounds. Here the port's copy of that
harness (soap3dp_tpu_torch/tools/evaluate_accuracy.py) drives the
port's pipeline on the CPU over the same genomes, seeds and sizes:

* the reference's three gates hold, thresholds copied verbatim (easy,
  stressed with the MAPQ calibration, and the repeat-structured genome);
* each of the port's result dicts equals the JAX harness's at the same
  seeds, every key (MAPQ buckets and the PairSummary string included),
  tolerance zero: the port is exact;
* the port's repeat-genome generator gives the JAX copy's PackedGenome
  field for field, and its simulate_pairs the JAX copy's arrays.
"""

import numpy as np
import pytest
import torch

from soap3dp_tpu.fm.fmindex import device_index as jax_device_index
from soap3dp_tpu.index.builder import build_index as jax_build_index
from soap3dp_tpu.index.packing import PackedGenome as JaxPackedGenome
from soap3dp_tpu.utils.dna import pack_codes as jax_pack_codes
from soap3dp_tpu_torch.fm.fmindex import device_index
from soap3dp_tpu_torch.index.builder import build_index
from soap3dp_tpu_torch.index.packing import PackedGenome
from soap3dp_tpu_torch.tools import evaluate_accuracy, repeat_genome
from soap3dp_tpu_torch.utils.dna import pack_codes
from tools import evaluate_accuracy as jax_evaluate_accuracy
from tools import repeat_genome as jax_repeat_genome

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

# (n_pairs, sub_rate, indel_rate) of the reference's gates
EASY = (1500, 0.01, 0.001)
STRESSED = (1500, 0.03, 0.01)
REPEAT = (800, 0.01, 0.001)


def _quiet(m):
    pass


@pytest.fixture(scope="module")
def eval_genome():
    """The reference's 1 Mbp uniform genome, indexed by each package."""
    rng = np.random.default_rng(3)
    n = 1_000_000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    meta = dict(length=n, names=["chr1"], offsets=np.array([0, n], np.uint64),
                amb_starts=np.zeros(0, np.uint64),
                amb_lengths=np.zeros(0, np.uint64))
    jax_index = jax_build_index(
        JaxPackedGenome(codes=codes, pac=jax_pack_codes(codes), **meta),
        sa_rate=2)
    index = build_index(PackedGenome(codes=codes, pac=pack_codes(codes),
                                     **meta), sa_rate=2)
    return (codes, (jax_index, jax_device_index(jax_index)),
            (index, device_index(index, "cpu")))


@pytest.fixture(scope="module")
def repeat_setup():
    """The reference's 4 Mbp repeat genome (seed 5), generated and
    indexed (lut_k 11) by each package, and its N runs over 10 bp."""
    jax_genome = jax_repeat_genome.generate(4_000_000, seed=5, log=_quiet)
    genome = repeat_genome.generate(4_000_000, seed=5, log=_quiet)
    jax_index = jax_build_index(jax_genome, sa_rate=2, lut_k=11)
    index = build_index(genome, sa_rate=2, lut_k=11)
    return (genome, (jax_index, jax_device_index(jax_index)),
            (index, device_index(index, "cpu")),
            evaluate_accuracy.excluded_runs(genome))


@pytest.fixture(scope="module")
def jax_dicts(eval_genome, repeat_setup):
    """The JAX harness's result dict of each gate, computed once."""
    codes, (jix, jdidx), _ = eval_genome
    genome, (rjix, rjdidx), _, excluded = repeat_setup
    run = jax_evaluate_accuracy.run_eval
    return {"easy": run(codes, jix, jdidx, *EASY),
            "stressed": run(codes, jix, jdidx, *STRESSED),
            "repeat": run(genome.codes, rjix, rjdidx, *REPEAT,
                          excluded=excluded)}


def test_recall_easy(eval_genome, jax_dicts):
    """1% SNPs + 0.1% indels: everything must align to the locus."""
    codes, _, (index, didx) = eval_genome
    res = evaluate_accuracy.run_eval(codes, index, didx, n_pairs=1500,
                                     sub_rate=0.01, indel_rate=0.001)
    assert res["recall"] >= 0.999, res
    assert res["wrong"] <= 0.0005, res
    assert res == jax_dicts["easy"]


def test_recall_stressed_and_mapq_calibration(eval_genome, jax_dicts):
    """3% SNPs + 1% indels: >=99.5% recall, and the MAPQ>=30 bucket
    must be essentially never wrong (calibration contract)."""
    codes, _, (index, didx) = eval_genome
    res = evaluate_accuracy.run_eval(codes, index, didx, n_pairs=1500,
                                     sub_rate=0.03, indel_rate=0.01)
    assert res["recall"] >= 0.995, res
    hi = res["mapq_buckets"]["mapq30-255"]
    assert hi["wrong"] <= max(1, hi["right"] // 2000), res
    assert res == jax_dicts["stressed"]


def test_repeat_genome_accuracy(repeat_setup, jax_dicts):
    """The repeat-structured genome (4 Mbp, seed 5, lut_k 11, 800 pairs,
    inserts kept off N runs over 10 bp): the reference's contract, and
    the super-repetitive machinery fires (still_flagged > 0)."""
    genome, _, (index, didx), excluded = repeat_setup
    res = evaluate_accuracy.run_eval(genome.codes, index, didx, 800, 0.01,
                                     0.001, excluded=excluded)
    assert res["unaligned"] <= 0.01, res
    assert res["recall"] >= 0.77, res
    assert res["mapq30_wrong_rate"] <= 0.01, res
    assert res["still_flagged"] > 0, res
    assert res == jax_dicts["repeat"]


def test_all_records_leave_the_dict_as_it_is(repeat_setup):
    """``all_records`` collects every record the pipeline writes (each
    read end's, unmapped ones included, tags built) and leaves the
    result dict as it is without them."""
    genome, _, (index, didx), excluded = repeat_setup
    args = (genome.codes, index, didx, 120, 0.01, 0.001)
    recs = []
    res = evaluate_accuracy.run_eval(*args, excluded=excluded,
                                     all_records=recs)
    assert res == evaluate_accuracy.run_eval(*args, excluded=excluded)
    assert {(q, bool(f & 0x40)) for q, f, *_ in recs} == {
        (b"e%07d" % i, first) for i in range(120) for first in (True, False)}
    mapped = [r for r in recs if not r[1] & 0x4]
    assert len(mapped) >= 2 * 120 * (1 - res["unaligned"])
    assert all(r[5] and any(t.startswith("XM:i:") for t in r[9])
               for r in mapped)
    assert any(t.startswith("XA:Z:") for r in mapped for t in r[9])


@pytest.mark.parametrize("total_bp,seed", [(4_000_000, 5), (6_000_000, 11)])
def test_generate_equals_reference(total_bp, seed):
    want = jax_repeat_genome.generate(total_bp, seed=seed, log=_quiet)
    got = repeat_genome.generate(total_bp, seed=seed, log=_quiet)
    assert got.length == want.length == total_bp
    assert got.names == want.names
    for f in ("codes", "pac", "offsets", "amb_starts", "amb_lengths"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got.amb_starts) > 0


@pytest.mark.parametrize("with_excluded", [False, True])
def test_simulate_pairs_equals_reference(repeat_setup, with_excluded):
    genome, _, _, excluded = repeat_setup
    ex = excluded if with_excluded else None
    args = (genome.codes, 2000, 100, 300, 0.03, 0.01)
    got = evaluate_accuracy.simulate_pairs(
        *args, np.random.default_rng(7), excluded=ex)
    want = jax_evaluate_accuracy.simulate_pairs(
        *args, np.random.default_rng(7), excluded=ex)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if with_excluded:   # no insert overlaps an N run over 10 bp
        st, en = excluded
        pos = got[3]
        i = np.searchsorted(en, pos, side="right")
        assert not ((i < len(st))
                    & (st[np.minimum(i, len(st) - 1)] < pos + 300)).any()


def test_main_needs_a_card_unless_asked_for_cpu(monkeypatch):
    """The harness's command line runs on cuda by default, and without
    a card raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_accuracy.main(["10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_accuracy.main(["10", "--hg", "--device", "cuda:0"])


@pytest.mark.parametrize("argv,genome", [
    (["60", "0.01", "0.001", "0.2"], "uniform"),
    (["60", "0.01", "0.001", "4", "11", "--hg"], "repeat"),
])
def test_main_on_cpu(capsys, argv, genome):
    """``--device cpu``: the index built by the port's builder, uploaded
    with device_index(index, "cpu"), one JSON result dict on stdout."""
    import json

    assert evaluate_accuracy.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["n_ends"] == 120
    assert res["recall"] >= (0.99 if genome == "uniform" else 0.6), res
    assert res["summary"].startswith("PairSummary(num_pairs=60,")
