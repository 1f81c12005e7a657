"""Host complete re-alignment on the port, against the JAX package.

The port's counterpart of tests/test_host_search.py: its eight tests
(the complete search against the brute-force oracle, host decode rows
against the device's, a super-repetitive read's complete set, the
re-align keeping other reads, the overflow guard, single-end X0, the
occurrence cap, the storm threshold), each on soap3dp_tpu_torch's
fm/host_search.py over an index the port builds, and each output held
to the JAX package's host_search on the same genome and reads,
tolerance zero. The storm threshold is run both ways the storm gate's
A/B (tools/measure_storm_divergence.py) runs it: the default skip, and
SOAP3DP_HOST_REALIGN_FULL=1's complete enumeration past the budget.
"""

import dataclasses

import numpy as np
import pytest
import torch

from soap3dp_tpu.fm import fmindex as jax_fmindex
from soap3dp_tpu.fm import host_search as jax_host_search
from soap3dp_tpu.fm.search import SearchConfig as JaxSearchConfig
from soap3dp_tpu.fm.search import search_reads as jax_search_reads
from soap3dp_tpu.index.builder import build_index as jax_build_index
from soap3dp_tpu.index.packing import PackedGenome as JaxPackedGenome
from soap3dp_tpu.utils import dna as jax_dna
from soap3dp_tpu_torch.fm import fmindex, host_search
from soap3dp_tpu_torch.fm.search import HitArrays, SearchConfig, search_reads
from soap3dp_tpu_torch.index.builder import build_index
from soap3dp_tpu_torch.index.packing import PackedGenome
from soap3dp_tpu_torch.utils import dna
from tests.conftest import make_genome
from tests.test_search import brute_hits

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

FULL_ENV = "SOAP3DP_HOST_REALIGN_FULL"


def _both(genome, **kw):
    """(JAX index, port index) of one genome, each package's builder."""
    return (jax_build_index(genome, **kw),
            build_index(PackedGenome(**dataclasses.asdict(genome)), **kw))


def _same_search(a, b):
    for x, y, name in zip(a, b, ("strand", "tp", "nmis")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)
    assert bool(a[3]) == bool(b[3])


def _same_hits(h, jh):
    for x, y, name in zip(h.to_host(), jh.to_host(),
                          ("row", "tp", "nmis", "valid", "flagged")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def test_complete_search_matches_oracle(rng):
    genome = make_genome(rng, 30_000)
    jax_index, index = _both(genome, sa_rate=4, lut_k=6)
    codes = genome.codes
    for trial in range(6):
        p = int(rng.integers(0, 29_000))
        read = codes[p:p + 60].copy()
        if trial % 2:
            read = dna.revcomp_codes(read)
        if trial >= 2:  # plant mismatches
            for _ in range(trial // 2):
                q = int(rng.integers(0, 60))
                read[q] = (read[q] + 1) % 4
        got = host_search.complete_search(index, read, 60, 2)
        assert not got[3]
        assert {(int(s), int(t)): int(m) for s, t, m in zip(*got[:3])} \
            == brute_hits(codes, read, 2)
        _same_search(got, jax_host_search.complete_search(jax_index, read,
                                                          60, 2))


def test_decode_rows_matches_device(rng):
    genome = make_genome(rng, 8_000)
    jax_index, index = _both(genome, sa_rate=8, lut_k=5)
    didx = fmindex.device_index(index, "cpu")
    rows = rng.integers(0, index.num_rows, 500).astype(np.uint32)
    host = host_search.decode_rows(index, rows)
    dev = fmindex.sa_decode(didx, torch.as_tensor(rows.astype(np.int64)),
                            torch.ones(500, dtype=torch.bool))
    np.testing.assert_array_equal(host, dev.cpu().numpy())
    np.testing.assert_array_equal(
        host, jax_host_search.decode_rows(jax_index, rows))


@pytest.fixture()
def tandem(rng):
    """A genome dominated by a tandem repeat: every pigeonhole segment
    of a read drawn from it occurs ~n_copies times, far past the
    round-3 budget (occ_cap_round3 = 4096)."""
    unit = rng.integers(0, 4, 60).astype(np.uint8)
    codes = np.concatenate(
        [rng.integers(0, 4, 2_000).astype(np.uint8),
         np.tile(unit, 6_000),
         rng.integers(0, 4, 2_000).astype(np.uint8)])
    g = JaxPackedGenome(codes=codes, pac=jax_dna.pack_codes(codes),
                        length=len(codes), names=["rep1"],
                        offsets=np.asarray([0, len(codes)], np.uint64),
                        amb_starts=np.zeros(0, np.uint64),
                        amb_lengths=np.zeros(0, np.uint64))
    return g, unit, _both(g, sa_rate=4, lut_k=6)


def test_super_repetitive_read_gets_complete_set(tandem):
    genome, unit, (jax_index, index) = tandem
    didx = fmindex.device_index(index, "cpu")
    read = np.tile(unit, 2)[:100]          # aligns at every unit start
    lens = np.asarray([100], np.int32)
    hits = search_reads(didx, read[None, :].copy(), lens, SearchConfig(k=2))
    # the device rounds must have given up on this read
    assert np.asarray(hits.flagged).any()
    expect = brute_hits(genome.codes, read, 2)
    assert len(expect) > SearchConfig.occ_cap_round3

    fixed = host_search.realign_flagged(index, hits, read[None, :], lens, 2)
    assert not np.asarray(fixed.flagged).any()
    row, tp, nm, va, _ = fixed.to_host()
    got = {(int(r >= 1), int(t)): int(m)
           for r, t, m, v in zip(row, tp, nm, va) if v}
    assert got == expect

    jhits = jax_search_reads(jax_fmindex.device_index(jax_index),
                             read[None, :].copy(), lens, JaxSearchConfig(k=2))
    _same_hits(hits, jhits)
    _same_hits(fixed, jax_host_search.realign_flagged(
        jax_index, jhits, read[None, :], lens, 2))


def test_realign_preserves_other_reads(tandem):
    """Unflagged reads' hits survive the re-align merge untouched."""
    genome, unit, (jax_index, index) = tandem
    didx = fmindex.device_index(index, "cpu")
    normal = genome.codes[500:600].copy()   # unique flank placement
    batch = np.stack([normal, np.tile(unit, 2)[:100]])
    lens = np.full(2, 100, np.int32)
    hits = search_reads(didx, batch, lens, SearchConfig(k=2))
    fl = np.asarray(hits.flagged)
    assert not fl[0] and fl[1]

    def read0(h):
        row, tp, nm, va, _ = h.to_host()
        return {(int(r), int(t)): int(m) for r, t, m, v in
                zip(row, tp, nm, va) if v and r in (0, 2)}

    fixed = host_search.realign_flagged(index, hits, batch, lens, 2)
    assert read0(fixed) == read0(hits)
    assert not np.asarray(fixed.flagged).any()

    jhits = jax_search_reads(jax_fmindex.device_index(jax_index), batch,
                             lens, JaxSearchConfig(k=2))
    _same_hits(fixed, jax_host_search.realign_flagged(jax_index, jhits,
                                                      batch, lens, 2))


def test_overflow_guard_keeps_flag(tandem):
    _, unit, (jax_index, index) = tandem
    read = np.tile(unit, 2)[:100]
    got = host_search.complete_search(index, read, 100, 2, max_interval=100)
    assert got[3]
    _same_search(got, jax_host_search.complete_search(
        jax_index, read, 100, 2, max_interval=100))


def _single_records(pkg, index, read, opts_kw):
    """(summary, records' (qname, flag, pos, mapq, tags)) of one read
    through package ``pkg``'s single-end pipeline."""
    import importlib

    fm = importlib.import_module(f"{pkg}.fm.fmindex")
    fastq = importlib.import_module(f"{pkg}.io.fastq")
    options = importlib.import_module(f"{pkg}.pipeline.options")
    single = importlib.import_module(f"{pkg}.pipeline.single")
    didx = (fm.device_index(index, "cpu") if pkg == "soap3dp_tpu_torch"
            else fm.device_index(index))
    batch = fastq.ReadBatch([b"rep"], read[None, :].copy(),
                            np.asarray([100], np.int32), None)
    recs = []

    class Cap:
        needs_seq = False
        needs_tags = True

        def write(self, rec):
            recs.append(rec)

    s = single.align_single_batch(index, didx, batch,
                                  options.AlignOptions(**opts_kw), Cap())
    return s, [(bytes(r.qname), int(r.flag), int(r.pos), int(r.mapq),
                tuple(r.tags)) for r in recs]


def test_single_pipeline_x0_reflects_complete_set(tandem):
    """End to end: a super-repetitive read aligned through the single
    pipeline reports the complete best-hit count (X0), and the run no
    longer counts it as still_flagged; the JAX package's records are the
    same."""
    genome, unit, (jax_index, index) = tandem
    read = np.tile(unit, 2)[:100]
    # raise the reference-parity occurrence clamp (MaxOutputPerRead)
    # past the repeat's copy count so enumeration is complete
    kw = dict(max_output_per_read=1_000_000)
    s, recs = _single_records("soap3dp_tpu_torch", index, read, kw)
    assert s.still_flagged == 0
    assert s.aligned_bwt == 1
    expect0 = sum(1 for m in brute_hits(genome.codes, read, 2).values()
                  if m == 0)
    x0 = [t for t in recs[0][4] if t.startswith("X0:i:")]
    assert x0 and int(x0[0][5:]) == expect0
    js, jrecs = _single_records("soap3dp_tpu", jax_index, read, kw)
    assert recs == jrecs
    assert (s.still_flagged, s.aligned_bwt) == (js.still_flagged,
                                                js.aligned_bwt)


def test_occ_cap_truncates_and_keeps_flag(tandem):
    """With the reference-parity occurrence clamp
    (CPUfunctions.cpp:1287-1299) a super-repetitive read's decode is
    truncated, stays flagged, and returns at most the cap per strand."""
    _, unit, (jax_index, index) = tandem
    read = np.tile(unit, 2)[:100]
    got = host_search.complete_search(index, read, 100, 2, max_decode=500)
    assert got[3]
    for s in (0, 1):
        assert (got[0] == s).sum() <= 3 * 500  # k+1 segs, 500/strand cap
    _same_search(got, jax_host_search.complete_search(
        jax_index, read, 100, 2, max_decode=500))


@pytest.mark.parametrize("full", [False, True], ids=["default", "full"])
def test_realign_storm_threshold_skips_batch(tandem, monkeypatch, full):
    """When more flagged reads than ``budget`` arrive (a satellite
    storm), realign_flagged skips the batch whole: reads keep their
    device hit sets and stay flagged; under the threshold every read is
    re-aligned. With SOAP3DP_HOST_REALIGN_FULL=1 (the storm A/B's full
    arm) neither the budget nor the occurrence cap applies: every read
    is enumerated completely."""
    genome, unit, (jax_index, index) = tandem
    B = 4
    codes = np.stack([np.tile(unit, 2)[:100]] * B)
    lens = np.full(B, 100, np.int32)
    if full:
        monkeypatch.setenv(FULL_ENV, "1")
    else:
        monkeypatch.delenv(FULL_ENV, raising=False)

    def fresh(cls):
        return cls(row=np.zeros(0, np.int32), tp=np.zeros(0, np.uint32),
                   nmis=np.zeros(0, np.int32), valid=np.zeros(0, bool),
                   flagged=np.ones(B, bool))

    from soap3dp_tpu.fm.search import HitArrays as JaxHitArrays

    for budget in (2, 8):
        out = host_search.realign_flagged(index, fresh(HitArrays), codes,
                                          lens, k=2, max_decode=200,
                                          budget=budget)
        _same_hits(out, jax_host_search.realign_flagged(
            jax_index, fresh(JaxHitArrays), codes, lens, k=2,
            max_decode=200, budget=budget))
        row = np.asarray(out.row)
        if budget == 2 and not full:
            # storm: 4 flagged > budget 2 -> untouched
            assert np.asarray(out.flagged).all()
            assert len(row) == 0
            continue
        assert set((row % B).tolist()) == {0, 1, 2, 3}
        if full:
            # complete: every placement of every read, none flagged
            assert not np.asarray(out.flagged).any()
            expect = brute_hits(genome.codes, codes[0], 2)
            assert int((row == 0).sum() + (row == B).sum()) == len(expect)
        else:
            # capped at 200 a strand: truncated, so still flagged
            assert np.asarray(out.flagged).all()


@pytest.mark.parametrize("full", [False, True], ids=["capped", "full"])
def test_realign_copies_of_a_read(tandem, rng, monkeypatch, full):
    """A batch that repeats reads (as a phase-2 batch repeats its first
    pair in every pad row): the port enumerates each distinct read once
    and gives every copy its placements; the hit arrays equal the JAX
    package's, which enumerates every copy, lane for lane."""
    from soap3dp_tpu.fm.search import HitArrays as JaxHitArrays

    genome, unit, (jax_index, index) = tandem
    rep = np.tile(unit, 2)[:100]
    other = np.tile(np.roll(unit, 7), 2)[:100]
    flank = genome.codes[300:400].copy()
    mut = rep.copy()
    mut[50] = (mut[50] + 1) % 4
    batch = np.stack([rep, flank, rep, other, mut, rep, other, rep])
    lens = np.full(len(batch), 100, np.int32)
    lens[5] = 90                  # a copy's prefix: another read
    if full:
        monkeypatch.setenv(FULL_ENV, "1")
    else:
        monkeypatch.delenv(FULL_ENV, raising=False)

    def flagged(cls):
        f = np.ones(len(batch), bool)
        f[1] = False
        return cls(row=np.zeros(0, np.int32), tp=np.zeros(0, np.uint32),
                   nmis=np.zeros(0, np.int32), valid=np.zeros(0, bool),
                   flagged=f)

    first, inv = host_search._distinct_reads(batch, lens,
                                             np.flatnonzero(flagged(
                                                 HitArrays).flagged))
    # sel = rows 0, 2-7: rep, rep, other, mut, rep (90 bases), other, rep
    assert first.tolist() == [0, 2, 3, 4] and inv.tolist() == [
        0, 0, 1, 2, 3, 1, 0]
    out = host_search.realign_flagged(index, flagged(HitArrays), batch,
                                      lens, k=2, max_decode=300)
    _same_hits(out, jax_host_search.realign_flagged(
        jax_index, flagged(JaxHitArrays), batch, lens, k=2, max_decode=300))
    row = np.asarray(out.row) % len(batch)
    for a, b in ((0, 2), (0, 7), (3, 6)):
        np.testing.assert_array_equal(np.asarray(out.tp)[row == a],
                                      np.asarray(out.tp)[row == b])
