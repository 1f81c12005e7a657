"""Deep-DP seeding sensitivity on the port, against the JAX package.

The repo's tools/seed_sensitivity.py measures, for 100 bp reads
substituted at 4%, the planted-locus recall and the candidate volume of
the deep-DP seeding with exact seeds and with halved (1-mismatch
pigeonhole) seeds, over bench.get_index's 40 Mbp genome at sa_rate 1,
lut_k 14. Here, on a 2 Mbp copy of that genome (sa_rate 1, lut_k 10: a
4 MiB LUT in the 2.1 GiB one's place, small enough for the CPU), the
port's measure (soap3dp_tpu_torch/tools/seed_sensitivity.py) must give
the JAX tool's candidates (read, pos, strand), recall and counts in both
arms, tolerance zero: the JAX side calls dp_rescue.deep_dp_seed_matrix,
seed_candidates and dp_margin as the JAX tool's main does, on the same
reads. bench_genome must give bench.get_index's codes.
"""

import numpy as np
import pytest
import torch

import bench
from soap3dp_tpu.fm.fmindex import device_index as jax_device_index
from soap3dp_tpu.pipeline import dp_rescue as jax_dp_rescue
from soap3dp_tpu_torch.fm.fmindex import device_index
from soap3dp_tpu_torch.index.builder import build_index
from soap3dp_tpu_torch.tools import seed_sensitivity

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

GENOME_BP = 2_000_000
LUT_K = 10
SUB_RATE = 0.04
N_READS = 1500


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """bench.get_index's genome and index at GENOME_BP (its cache in a
    temporary directory), and the port's bench_genome indexed alike."""
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "CACHE", str(tmp_path_factory.mktemp("bench_cache")))
    try:
        jax_index, jax_codes = bench.get_index(GENOME_BP, sa_rate=1,
                                               lut_k=LUT_K)
    finally:
        mp.undo()
    genome = seed_sensitivity.bench_genome(GENOME_BP)
    index = build_index(genome, sa_rate=1, lut_k=LUT_K)
    return (np.asarray(jax_codes), jax_index, genome, index)


def jax_measure(didx, codes, sub_rate, n_reads):
    """The JAX tool's main after its index: {arm: (recall, candidates)}
    and the candidates, as there."""
    L = 100
    rng = np.random.default_rng(5)
    pos = rng.integers(0, len(codes) - L, n_reads)
    reads = codes[pos[:, None] + np.arange(L)[None, :]].copy()
    mask = rng.random(reads.shape) < sub_rate
    reads[mask] = (reads[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
    keep = mask.sum(axis=1) > 2
    reads, pos = reads[keep], pos[keep]
    lens = np.full(len(reads), L, np.int32)
    out = {}
    for name, halved in (("exact", False), ("halved-1mm", True)):
        sp, sl = jax_dp_rescue.deep_dp_seed_matrix(lens, L, halved=halved)
        cand = jax_dp_rescue.seed_candidates(didx, reads, lens, sp, sl)
        margin = int(jax_dp_rescue.dp_margin(np.asarray([L]))[0])
        ok = (cand.strand == 0) & (np.abs(cand.pos - pos[cand.read]) <= margin)
        recall = len(np.unique(cand.read[ok])) / len(reads)
        out[name] = (recall, len(cand.read), cand)
    return out


def test_bench_genome_is_bench_get_index_genome(indexes):
    jax_codes, jax_index, genome, index = indexes
    np.testing.assert_array_equal(genome.codes, jax_codes)
    assert genome.names == ["synth1"]
    assert list(genome.offsets) == [0, GENOME_BP]
    np.testing.assert_array_equal(index.pac, jax_index.pac)
    np.testing.assert_array_equal(index.sa_samples, jax_index.sa_samples)


def test_measure_equals_the_jax_tool(indexes):
    jax_codes, jax_index, genome, index = indexes
    got = seed_sensitivity.measure(device_index(index, "cpu"), genome.codes,
                                   SUB_RATE, N_READS)
    want = jax_measure(jax_device_index(jax_index), jax_codes, SUB_RATE,
                       N_READS)
    assert set(got) == set(want) == {"exact", "halved-1mm"}
    for arm, (recall, count, cand) in want.items():
        g = got[arm]
        assert g["recall"] == recall, arm
        assert g["candidates"] == count, arm
        for f in ("read", "pos", "strand"):
            np.testing.assert_array_equal(g[f], getattr(cand, f),
                                          err_msg=f"{arm} {f}")
        assert g["seconds"] > 0
    # the measurement the default rests on: halved seeds find more
    # planted loci, from more candidates
    assert got["halved-1mm"]["recall"] > got["exact"]["recall"]
    assert got["halved-1mm"]["candidates"] > got["exact"]["candidates"]
    r = seed_sensitivity.ratios(got)
    assert r["recall_delta"] == (got["halved-1mm"]["recall"]
                                 - got["exact"]["recall"])
    assert r["candidate_ratio"] == (got["halved-1mm"]["candidates"]
                                    / got["exact"]["candidates"])


def test_main_defaults_to_the_card_and_runs_on_cpu(tmp_path, capsys):
    import json

    argv = ["0.04", "300", "--genome-bp", "300000", "--lut-k", "8",
            "--cache", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            seed_sensitivity.main(argv)
    assert seed_sensitivity.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"exact", "halved-1mm", "recall_delta",
                        "candidate_ratio", "time_ratio"}
    assert 0 < res["exact"]["recall"] <= res["halved-1mm"]["recall"] <= 1
    # a second run loads the index it cached
    assert (tmp_path / "synth300000.sa1k8.t3i" / "meta.json").exists()
    assert seed_sensitivity.main(argv + ["--device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["exact"]["candidates"] == res["exact"]["candidates"]
