"""The genome and the read generator: deterministic per seed, every
class of read an exact count, and the truth of every end where its
bases say it is."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench import genome, reads

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def g():
    return genome.generate(8_000_000, 20240817, log=lambda m: None)


def mix(name):
    """A mix of traffic/, or ``mate-pairs``: a mate-pair library with
    random ends and junction reads, the generator's other classes."""
    if name == "mate-pairs":
        return dict(mix("wgs"), orientation="-/+",
                    insert=[4000, 400, 2100, 5900], indel_reads=0.05,
                    random_end_pairs=0.01, junction_reads=0.1)
    with open(os.path.join(HERE, "traffic", name + ".json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ["wgs", "clean", "mate-pairs"])
def test_deterministic_per_seed(g, name):
    a = reads.simulate(g, mix(name), 3000, np.random.default_rng(11))
    b = reads.simulate(g, mix(name), 3000, np.random.default_rng(11))
    c = reads.simulate(g, mix(name), 3000, np.random.default_rng(12))
    assert (a.codes == b.codes).all() and (a.pos == b.pos).all()
    assert not (a.codes == c.codes).all()


@pytest.mark.parametrize("name", ["wgs", "clean", "mate-pairs"])
def test_class_counts_and_shares(g, name):
    m = mix(name)
    n = 20000
    r = reads.simulate(g, m, n, np.random.default_rng(5))
    assert int(r.random.sum()) == round(m["random_end_pairs"] * n)
    assert int(r.indel.sum()) == round(m["indel_reads"] * 2 * n)
    assert int(r.junction.sum()) == round(m["junction_reads"] * 2 * n)
    assert not (r.random & (r.indel | r.junction)).any()
    # read 1 is the left leg about half the time
    plain = ~(r.random | r.indel | r.junction)
    assert plain.all(axis=0).sum() > 0.5 * n * (1 - 2 * m["indel_reads"])


@pytest.mark.parametrize("name", ["wgs", "mate-pairs"])
def test_truth_of_every_end(g, name):
    """An end without an indel or random bases is the genome at its
    truth, on its strand, up to its foreign junction bases."""
    m = dict(mix(name), sub_rate=0.0)
    L = m["read_len"]
    r = reads.simulate(g, m, 3000, np.random.default_rng(9))
    lo, hi = m["insert"][2], m["insert"][3]
    checked = 0
    for i in range(3000):
        if r.random[:, i].any() or r.indel[:, i].any():
            continue
        for e in (0, 1):
            seq = r.codes[e, i]
            fwd = 3 - seq[::-1] if r.reverse[e, i] else seq
            J = int(r.foreign[e, i])
            part = fwd[J:] if r.reverse[e, i] else fwd[:L - J]
            start = g.offsets[r.chrom[e, i]] + r.pos[e, i] - 1
            assert (part == np.asarray(g.codes[start:start + L - J])).all()
            checked += 1
        if not r.junction[:, i].any():
            assert lo <= max(r.pos[:, i]) + L - min(r.pos[:, i]) <= hi
            left = int(np.argmin(r.pos[:, i]))
            assert r.reverse[left, i] == (m["orientation"][0] == "-")
    assert checked > 3000


def test_every_mix_names_its_source():
    for name in os.listdir(os.path.join(HERE, "traffic")):
        m = mix(name[:-len(".json")])
        reads.check_mix(m)
        assert m["source"].strip()
    with pytest.raises(ValueError, match="source"):
        reads.check_mix({k: v for k, v in mix("wgs").items()
                         if k != "source"})


def test_fragments_avoid_excluded_runs(g):
    r = reads.simulate(g, mix("wgs"), 5000, np.random.default_rng(2))
    starts, ends = g.excluded()
    p = g.offsets[r.chrom] + r.pos - 1
    i = np.searchsorted(ends, p, side="right")
    inside = (i < len(starts)) & (starts[np.minimum(i, len(starts) - 1)]
                                  < p + 100)
    assert not inside[~r.random].any()


def test_fastq_round_trip(g, tmp_path):
    r = reads.simulate(g, mix("clean"), 50, np.random.default_rng(1))
    p1, p2 = tmp_path / "a.fq", tmp_path / "b.fq"
    reads.write_fastq(r, str(p1), str(p2))
    lines = p2.read_bytes().split(b"\n")
    assert lines[0] == b"@r00000000" and lines[2] == b"+"
    assert lines[1] == genome.ACGT[r.codes[1, 0]].tobytes()
    assert len(lines) == 4 * 50 + 1


def test_genome_cache_round_trip(tmp_path):
    a = genome.cached(str(tmp_path), 4_000_000, 7)
    b = genome.cached(str(tmp_path), 4_000_000, 7)
    assert (np.asarray(a.codes) == np.asarray(b.codes)).all()
    assert a.names == b.names and (a.offsets == b.offsets).all()
    fa = tmp_path / "g.fa"
    genome.write_fasta(b, str(fa))
    text = fa.read_bytes()
    assert text.startswith(b">chr1\n") and b"N" * 60 in text
