"""Seed search of the PyTorch port against the JAX package and against
the brute-force oracle of tests/test_search.py.

Parity: the same numpy reads through soap3dp_tpu.fm.search and
soap3dp_tpu_torch.fm.search; the valid (row, tp, nmis) hit lists and
the flagged masks must be equal — exact, as every output is an integer
(the port reproduces the reference's compaction order, so the lists are
equal element for element, not only as sets).
"""

import numpy as np
import pytest
import torch

from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu.fm import search as js
from soap3dp_tpu_torch.fm import fmindex as tf
from soap3dp_tpu_torch.fm import search as ts
from tests.test_search import _genome_from_codes, brute_hits, make_reads
from tests.test_torch_host_copies import port_index

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def indexes(small_index):
    return (jf.device_index(small_index),
            tf.device_index(port_index(small_index), "cpu"))


def _valid(h):
    row, tp, nm, va, fl = h.to_host()
    return row[va], tp[va], nm[va], fl


def _assert_same(hj, ht):
    a, b = _valid(hj), _valid(ht)
    for x, y, name in zip(a, b, ("row", "tp", "nmis", "flagged")):
        np.testing.assert_array_equal(x, y, err_msg=name)


def _hits_dict(h, b, B):
    row, tp, nm, va, _ = h.to_host()
    out = {}
    for strand, r in ((0, b), (1, B + b)):
        m = va & (row == r)
        for t, n in zip(tp[m], nm[m]):
            out[(strand, int(t))] = int(n)
    return out


@pytest.mark.parametrize("k,seed_range", [
    (1, None), (2, None), (2, (0, 2)), (2, (2, 3)), (3, (0, 2)), (4, None)])
def test_pending_search_matches_reference(indexes, small_genome, rng, k,
                                          seed_range):
    jd, td = indexes
    B, L = 48, 60
    reads = make_reads(rng, small_genome.codes, B, L, k)
    lens = np.full(B, L, np.int32)
    lens[::5] = 51                              # a non-uniform batch
    hj = js.PendingSearch(jd, reads, lens, js.SearchConfig(k=k),
                          seed_range=seed_range).result()
    ht = ts.PendingSearch(td, reads, lens, ts.SearchConfig(k=k),
                          seed_range=seed_range).result()
    _assert_same(hj, ht)


def test_search_batch_device_arrays_match(indexes, small_genome, rng):
    """One _search_batch dispatch, before the host: every output array."""
    import jax.numpy as jnp
    import torch

    jd, td = indexes
    B, L = 32, 48
    reads = make_reads(rng, small_genome.codes, B, L, 2)
    lens = np.full(B, L, np.int32)
    cfg_j, cfg_t = js.SearchConfig(k=2), ts.SearchConfig(k=2)
    seed_q = js.default_seed_q(jd, cfg_j)
    assert seed_q == ts.default_seed_q(td, cfg_t)
    steps = js._steps_for(jd, seed_q, L // 3)
    hj, totj = js._search_batch(jd, jnp.asarray(reads), jnp.asarray(lens),
                                cfg_j, 16, steps, seed_q, K=2048, K2=1024)
    ht, tott = ts._search_batch(td, torch.from_numpy(reads),
                                torch.from_numpy(lens), cfg_t, 16, steps,
                                seed_q, K=2048, K2=1024)
    np.testing.assert_array_equal(np.asarray(totj), tott.numpy())
    for name in ("row", "tp", "nmis", "valid", "flagged"):
        a = np.asarray(getattr(hj, name)).astype(np.int64)
        b = getattr(ht, name).numpy().astype(np.int64)
        if name == "row":
            a = np.where(np.asarray(hj.valid), a, -1)
            b = np.where(ht.valid.numpy(), b, -1)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_compaction_budget_regrowth(rng):
    """Reads inside a 12-copy repeat yield ~12 candidates per seed, past
    the first dispatch's budget: the re-dispatch loop must grow K/K2."""
    from soap3dp_tpu.index.builder import build_index

    unit = rng.integers(0, 4, size=40).astype(np.uint8)
    codes = np.concatenate([np.tile(unit, 12),
                            rng.integers(0, 4, size=3000).astype(np.uint8)])
    idx = build_index(_genome_from_codes(codes), sa_rate=4, lut_k=4)
    jd, td = jf.device_index(idx), tf.device_index(port_index(idx), "cpu")
    starts = rng.integers(0, 40 * 10, 48)
    reads = np.stack([codes[s:s + 45] for s in starts]).astype(np.uint8)
    lens = np.full(len(reads), 45, np.int32)
    pt = ts.PendingSearch(td, reads, lens, ts.SearchConfig(k=2))
    t = int(pt._out[0].numpy()[0])
    assert t > min(pt.K, pt.K_max)      # the first budget overflowed
    _assert_same(js.PendingSearch(jd, reads, lens, js.SearchConfig(k=2)).result(),
                 pt.result())


def test_forced_round2_round3_escalation(rng):
    """A repeat-heavy genome and a small round-1 cap flag reads; rounds 2
    and 3 must re-search them identically in both packages."""
    from soap3dp_tpu.index.builder import build_index

    unit = rng.integers(0, 4, size=25).astype(np.uint8)
    codes = np.concatenate([np.tile(unit, 60),
                            rng.integers(0, 4, size=4000).astype(np.uint8)])
    idx = build_index(_genome_from_codes(codes), sa_rate=4, lut_k=4)
    jd, td = jf.device_index(idx), tf.device_index(port_index(idx), "cpu")
    reads = np.stack([codes[s:s + 50] for s in (3, 40, 200, 1600, 2500,
                                                 3000)]).astype(np.uint8)
    lens = np.full(len(reads), 50, np.int32)
    kw = dict(k=1, occ_cap=2, occ_cap_round2=8, occ_cap_round3=128)
    hj = js.PendingSearch(jd, reads, lens, js.SearchConfig(**kw)).result()
    ht = ts.PendingSearch(td, reads, lens, ts.SearchConfig(**kw)).result()
    _assert_same(hj, ht)
    assert not ht.to_host()[4][:3].any()   # the repeat reads resolved
    for b in range(3):
        assert _hits_dict(ht, b, len(reads)) == brute_hits(codes, reads[b], 1)
    # the storm gate: over escalate_budget, round-1 sets are kept flagged
    kw["escalate_budget"] = 0
    hj = js.PendingSearch(jd, reads, lens, js.SearchConfig(**kw)).result()
    ht = ts.PendingSearch(td, reads, lens, ts.SearchConfig(**kw)).result()
    _assert_same(hj, ht)
    assert ht.to_host()[4][:3].all()


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_all_valid_matches_bruteforce(indexes, small_genome, rng, k):
    """The oracle cases of tests/test_search.py, through the port."""
    _, td = indexes
    B, L = 24, 36
    reads = make_reads(rng, small_genome.codes, B, L, k)
    hits = ts.search_reads(td, reads, np.full(B, L), ts.SearchConfig(k=k))
    flagged = hits.to_host()[4]
    for b in range(B):
        if flagged[b]:
            continue
        assert _hits_dict(hits, b, B) == brute_hits(small_genome.codes,
                                                    reads[b], k), b


def test_variable_length_and_full_sa(small_genome, rng):
    from soap3dp_tpu.index.builder import build_index

    codes = small_genome.codes
    td = tf.device_index(port_index(build_index(small_genome, sa_rate=1)),
                        "cpu")
    L = 48
    lens = np.array([48, 37, 25, 41])
    reads = np.zeros((4, L), dtype=np.uint8)
    for i, (p, ln) in enumerate(zip(rng.integers(0, len(codes) - L, 4), lens)):
        reads[i, :ln] = codes[p:p + ln]
    hits = ts.search_reads(td, reads, lens, ts.SearchConfig(k=1))
    for b in range(4):
        assert _hits_dict(hits, b, 4) == brute_hits(codes, reads[b, :lens[b]],
                                                    1), b


def test_lut_only_seed_path(rng):
    """A genome small enough that 4^lut_k >= n: LUT-only seeds."""
    from soap3dp_tpu.index.builder import build_index

    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    idx = build_index(_genome_from_codes(codes), sa_rate=2, lut_k=6)
    jd, td = jf.device_index(idx), tf.device_index(port_index(idx), "cpu")
    assert ts.default_seed_q(td, ts.SearchConfig(k=2)) == idx.lut_k
    reads = make_reads(rng, codes, 32, 40, 2)
    lens = np.full(32, 40, np.int32)
    _assert_same(js.search_reads(jd, reads, lens, js.SearchConfig(k=2)),
                 ts.search_reads(td, reads, lens, ts.SearchConfig(k=2)))


def test_empty_batch(indexes):
    _, td = indexes
    h = ts.PendingSearch(td, np.zeros((0, 30), np.uint8),
                         np.zeros(0, np.int32)).result()
    assert h.to_host()[0].size == 0


@pytest.fixture(scope="module")
def repeat_indexes():
    """(genome codes, JAX device index, the port's CPU device index) of
    a 25-base unit tiled 60 times before 4,000 random bases (sa_rate 4,
    lut_k 4): seeds in the repeat overflow a small cap."""
    from soap3dp_tpu.index.builder import build_index

    rng = np.random.default_rng(77)
    unit = rng.integers(0, 4, size=25).astype(np.uint8)
    codes = np.concatenate([np.tile(unit, 60),
                            rng.integers(0, 4, size=4000).astype(np.uint8)])
    idx = build_index(_genome_from_codes(codes), sa_rate=4, lut_k=4)
    return codes, jf.device_index(idx), tf.device_index(port_index(idx),
                                                        "cpu")


@pytest.mark.parametrize("setting", ["round1", "escalation"])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_search_batch_wire_matches_reference(repeat_indexes, k, setting):
    """One dispatch's result wire, the port's _search_batch_wire against
    the JAX package's on the same reads: 45 reads (not a multiple of
    32), some inside the repeat so their seeds overflow the cap and they
    are flagged, some random, lengths 40-60; round 1 (genome-scaled seed
    prefixes, cap 2, PendingSearch's first budgets K and K2) and an
    escalation round (full segments, cap 256, the lossless K = K2). The
    wires are equal word for word, and _parse_wire's host arrays lane
    for lane, the lanes that hold no hit included. Tolerance: zero."""
    import jax.numpy as jnp

    from soap3dp_tpu.utils import shapes

    codes, jd, td = repeat_indexes
    rng = np.random.default_rng(100 + k)
    B, L = 45, 60
    starts = np.concatenate([rng.integers(0, 1400, 15),
                             rng.integers(1500, len(codes) - L, 30)])
    reads = np.stack([codes[p:p + L] for p in starts]).astype(np.uint8)
    reads[40:] = rng.integers(0, 4, (5, L))            # found nowhere
    lens = rng.integers(40, L + 1, B).astype(np.int32)
    for i, n in enumerate(lens):
        reads[i, n:] = 0
    cfg_j, cfg_t = js.SearchConfig(k=k), ts.SearchConfig(k=k)
    S = k + 1
    if setting == "round1":
        seed_q = js.default_seed_q(jd, cfg_j)
        assert seed_q == ts.default_seed_q(td, cfg_t)
        steps = js._steps_for(jd, seed_q, min(int(lens.min()) // S, seed_q))
        cap = 2
        K = shapes.bucket(B * S * 5 // 4, min_size=1024)
        K2 = shapes.bucket(B * 2, min_size=1024)
    else:
        longest = -(-L // S)
        seed_q, steps = 0, js._steps_for(jd, longest,
                                         min(int(lens.min()) // S, longest))
        cap, K, K2 = 256, 0, 0
    wj = np.asarray(js._search_batch_wire(
        jd, jnp.asarray(reads), jnp.asarray(lens), cfg_j, cap, steps, seed_q,
        K, K2=K2))
    wt = ts._search_batch_wire(td, torch.from_numpy(reads),
                               torch.from_numpy(lens), cfg_t, cap, steps,
                               seed_q, K, K2=K2)
    assert wj.dtype == np.uint32 and wt.dtype == torch.int32
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), wj)
    K2 = K2 or 2 * B * S * cap
    assert wj.shape == (2 + 2 + 2 * K2,)      # ceil(45 / 32) flag words
    tj, uj, hj = js._parse_wire(wj, B, K2)
    tt, ut, ht = ts._parse_wire(wt.numpy(), B, K2)
    assert (tt, ut) == (tj, uj) and uj > 0
    for name in ("row", "tp", "nmis", "valid", "flagged"):
        a, b = getattr(hj, name), getattr(ht, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ht.valid.any() and not ht.valid.all()
    assert (ht.row[~ht.valid] == 0xFFFFFF).all()   # no hit: the clipped
    if setting == "round1":                        # sentinel
        assert ht.flagged.any() and not ht.flagged[40:].any()


SEED_EDGES = ("len0", "shorter_than_S", "seed_q", "lut", "seed_range",
              "uneven", "mesh_pad", "uniform")


@pytest.mark.parametrize("edge", SEED_EDGES)
def test_search_batch_wire_seed_bounds_match_reference(repeat_indexes, edge):
    """The seeds' bounds, which the port's kernels make from each read's
    length (fmindex.SeedLanes), against the reference's _seed_bounds,
    through one dispatch's result wire, word for word, and directly
    (SeedLanes.bounds), at their edges: reads of length 0; reads shorter
    than S (empty segments); seed_q truncating the segments (the packed
    branch) and at lut_k with no FM step (the LUT-only branch); the seed
    range (1, 3) of S = 3; lengths from 1 to L; a batch padded to a mesh
    multiple with copies of read 0; a uniform-length batch. k = 2, so
    S = 3; 45 reads (not a multiple of 32), some in the repeat.
    Tolerance: zero."""
    import jax.numpy as jnp

    codes, jd, td = repeat_indexes
    rng = np.random.default_rng(SEED_EDGES.index(edge) + 300)
    B, L, S = 45, 60, 3
    starts = np.concatenate([rng.integers(0, 1400, 15),
                             rng.integers(1500, len(codes) - L, B - 15)])
    reads = np.stack([codes[p:p + L] for p in starts]).astype(np.uint8)
    lens = rng.integers(40, L + 1, B).astype(np.int32)
    seed_q, lo, hi, uniform = 0, 0, 0, 0
    if edge == "len0":
        lens[::4] = 0
    elif edge == "shorter_than_S":
        lens[::3] = rng.integers(1, S, len(lens[::3]))
    elif edge == "seed_q":
        seed_q = 6
    elif edge == "lut":
        seed_q = jd.lut_k
    elif edge == "seed_range":
        lo, hi = 1, 3
    elif edge == "uneven":
        lens = rng.integers(1, L + 1, B).astype(np.int32)
    elif edge == "mesh_pad":
        pad = 48 - B
        reads = np.concatenate([reads, np.repeat(reads[:1], pad, 0)])
        lens = np.concatenate([lens, np.repeat(lens[:1], pad)])
    elif edge == "uniform":
        lens[:] = 52
        uniform = 52
    for i, n in enumerate(lens):
        reads[i, n:] = 0
    B = reads.shape[0]
    S_eff = (hi or S) - lo
    if seed_q:
        steps = 0 if edge == "lut" else js._steps_for(jd, seed_q, 0)
    else:
        longest = -(-L // S)
        steps = js._steps_for(jd, longest,
                              min(int(lens.min()) // S, longest))
    cfg_j, cfg_t = js.SearchConfig(k=2), ts.SearchConfig(k=2)
    cap = 64 if edge == "lut" else 4      # 4-mer intervals are wide
    kw = dict(K2=0, uniform_len=uniform, seed_lo=lo, seed_hi=hi)
    wj = np.asarray(js._search_batch_wire(
        jd, jnp.asarray(reads), jnp.asarray(lens), cfg_j, cap, steps, seed_q,
        0, **kw))
    wt = ts._search_batch_wire(td, torch.from_numpy(reads),
                               torch.from_numpy(lens), cfg_t, cap, steps,
                               seed_q, 0, **kw)
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), wj)
    tt, ut, _ = ts._parse_wire(wt.numpy(), B, 2 * B * S_eff * cap)
    assert tt > 0 and ut > 0
    # the bounds themselves, lane for lane
    jstart, jlen = js._seed_bounds(jnp.asarray(np.concatenate([lens, lens])),
                                   S, seed_q)
    jstart, jlen = (np.asarray(x)[:, lo:hi or S].reshape(-1)
                    for x in (jstart, jlen))
    start, length = tf.SeedLanes.pigeonhole(
        torch.from_numpy(lens), S, lo, seed_q).bounds(S_eff)
    np.testing.assert_array_equal(start.numpy(), jstart)
    np.testing.assert_array_equal(length.numpy(), jlen)
    if edge in ("len0", "shorter_than_S"):
        assert (length == 0).any() and (length > 0).any()
    if edge in ("seed_q", "lut"):
        assert int(length.max()) == seed_q and (jlen < 60 // S).all()


@pytest.mark.parametrize("case", ["valid_mask", "sentinel_rows", "uniform"])
def test_count_mismatches_rows_placements_match_reference(repeat_indexes,
                                                          case):
    """FS3's argument prep, done in the port's verify as it loads its
    arguments (rows clamped to the 2B oriented rows, positions 0 where
    the slot holds no placement, each row's read length from the B
    lengths), against the reference's lines (soap3dp_tpu/fm/search.py
    :305-310: clamp, where, olens gather, count_mismatches_packed): slots
    past the firsts (ROW_SENTINEL, not valid), invalid slots with any
    position, a uniform-length batch. Tolerance: zero."""
    import jax.numpy as jnp

    codes, jd, td = repeat_indexes
    rng = np.random.default_rng(["valid_mask", "sentinel_rows",
                                 "uniform"].index(case) + 400)
    B, L, M = 45, 60, 3000
    starts = rng.integers(0, len(codes) - L, B)
    reads = np.stack([codes[p:p + L] for p in starts]).astype(np.uint8)
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    uniform = 52 if case == "uniform" else 0
    if uniform:
        lens[:] = uniform
    for i, n in enumerate(lens):
        reads[i, n:] = 0
    urow = rng.integers(0, 2 * B, M).astype(np.int64)
    valid = rng.random(M) < 0.7
    if case == "sentinel_rows":
        urow[~valid] = 0x7FFFFFFF
    utp = rng.integers(0, jd.n, M).astype(np.int64)
    utp[~valid] = rng.integers(0, 1 << 32, int((~valid).sum()))
    # the reference's lines
    rc = (jf.revcomp_reads_uniform(jnp.asarray(reads), uniform) if uniform
          else jf.revcomp_reads(jnp.asarray(reads), jnp.asarray(lens)))
    oriented = jnp.concatenate([jnp.asarray(reads), rc], axis=0)
    olens = jnp.concatenate([jnp.asarray(lens)] * 2)
    urow_c = jnp.clip(jnp.asarray(urow.astype(np.int32)), 0, 2 * B - 1)
    tp = jnp.where(jnp.asarray(valid), jnp.asarray(utp.astype(np.uint32)),
                   jnp.uint32(0))
    want = jf.count_mismatches_packed(jd, tp, jf.pack_reads(oriented)[urow_c],
                                      olens[urow_c])
    ori = tf.OrientedReads.of(torch.from_numpy(reads), torch.from_numpy(lens),
                              uniform_len=uniform)
    got = tf.count_mismatches_rows(td, torch.from_numpy(utp), ori,
                                   torch.from_numpy(urow),
                                   torch.from_numpy(lens),
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[torch.from_numpy(valid)] < 5).any()
