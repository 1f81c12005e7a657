"""FM-index primitives of the PyTorch port against the JAX package.

Same numpy-seeded inputs through soap3dp_tpu.fm.fmindex (JAX, CPU) and
soap3dp_tpu_torch.fm.fmindex (torch, CPU); tolerance: exact (every
output is an integer). Run on the session ``small_index`` (sa_rate=8)
and on an sa_rate=1 index of the same genome (the one-gather decode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu_torch.fm import fmindex as tf

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)



@pytest.fixture(scope="module", params=["sa8", "sa1"])
def pair_index(request, small_genome, small_index):
    """(host index, JAX device index, torch device index of the port's
    Index, loaded from the JAX package's index files)."""
    from soap3dp_tpu.index.builder import build_index
    from tests.test_torch_host_copies import port_index

    idx = small_index if request.param == "sa8" else \
        build_index(small_genome, sa_rate=1)
    return idx, jf.device_index(idx), tf.device_index(port_index(idx), "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t):
    a = np.asarray(j).astype(np.int64)
    b = t.numpy().astype(np.int64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_device_index_tables_equal(pair_index):
    idx, jd, td = pair_index
    for name in ("mark_rank", "mark_words", "sa_samples", "pac", "lut_lo",
                 "lut_hi"):
        want = np.asarray(getattr(idx, name)).astype(np.int64)
        got = tf._u32(getattr(td, name)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    # occ and bwt live on the device as the occ blocks: block j holds the
    # counts before BWT word 4j, then words 4j..4j+3 (zero past the last)
    nw = len(idx.bwt)
    blocks = tf._u32(td.occ_blocks).numpy()
    np.testing.assert_array_equal(
        blocks[:, :4], np.asarray(idx.occ).reshape(nw, 4)[::4])
    words = blocks[:, 4:].reshape(-1)
    np.testing.assert_array_equal(words[:nw], np.asarray(idx.bwt))
    assert not words[nw:].any()
    assert (td.n, td.primary, td.sa_rate, td.lut_k) == (
        idx.n, idx.primary, idx.sa_rate, idx.lut_k)
    assert td.repeat_heavy == jd.repeat_heavy
    assert td.device == torch.device("cpu")


def test_uint32_helpers_match_numpy():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    from soap3dp_tpu.index.builder import _popcount_u32
    want = _popcount_u32(x.astype(np.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tf.popcount32(_t(x.astype(np.int64))).numpy(),
                                  want)
    for c in (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D):
        want = ((x * np.uint64(c)) & np.uint64(0xFFFFFFFF)).astype(np.int64)
        np.testing.assert_array_equal(
            tf.mul32(_t(x.astype(np.int64)), c).numpy(), want)


def test_occ_and_backward_extend(pair_index, rng):
    idx, jd, td = pair_index
    k = rng.integers(0, idx.n + 2, 2048).astype(np.uint32)
    k[:4] = [0, idx.primary, idx.n, idx.n + 1]
    c = rng.integers(0, 4, 2048).astype(np.uint32)
    _eq(jf.occ(jd, jnp.asarray(c), jnp.asarray(k)),
        tf.occ(td, _t(c.astype(np.int64)), _t(k.astype(np.int64))))
    r = np.minimum(k.astype(np.int64) + rng.integers(0, 50, 2048),
                   idx.n + 1).astype(np.uint32)
    jl, jr = jf.backward_extend(jd, jnp.asarray(k), jnp.asarray(r),
                                jnp.asarray(c))
    tl, tr = tf.backward_extend(td, _t(k.astype(np.int64)),
                                _t(r.astype(np.int64)), _t(c.astype(np.int64)))
    _eq(jl, tl)
    _eq(jr, tr)


@pytest.mark.parametrize("seg", ["short", "long"])
def test_backward_search(pair_index, small_genome, rng, seg):
    """Segments shorter than lut_k (no LUT jumpstart) and longer."""
    idx, jd, td = pair_index
    B, L = 256, 48
    pos = rng.integers(0, idx.n - L, B)
    seqs = np.stack([small_genome.codes[p:p + L] for p in pos]).astype(np.uint8)
    seqs[::3] = rng.integers(0, 4, (len(seqs[::3]), L))   # absent seeds
    start = rng.integers(0, 20, B).astype(np.int32)
    length = (rng.integers(0, idx.lut_k, B) if seg == "short"
              else rng.integers(idx.lut_k, 28, B)).astype(np.int32)
    jl, jr = jf.backward_search(jd, jnp.asarray(seqs), jnp.asarray(start),
                                jnp.asarray(length), 28)
    tl, tr = tf.backward_search(td, _t(seqs), _t(start), _t(length), 28)
    _eq(jl, tl)
    _eq(jr, tr)


def test_rolling_kmer_and_packed_search(pair_index, small_genome, rng):
    idx, jd, td = pair_index
    R, L = 128, 40
    pos = rng.integers(0, idx.n - L, R)
    seqs = np.stack([small_genome.codes[p:p + L] for p in pos]).astype(np.uint8)
    for k in (idx.lut_k, 16):
        _eq(jf.rolling_kmer_codes(jnp.asarray(seqs), k),
            tf.rolling_kmer_codes(_t(seqs), k))
    rows = np.repeat(np.arange(R, dtype=np.int32), 2)
    start = rng.integers(0, 20, 2 * R).astype(np.int32)
    length = rng.integers(0, idx.lut_k + 16, 2 * R).astype(np.int32)
    steps = 16
    jl, jr = jf.backward_search_packed(
        jd, jf.rolling_kmer_codes(jnp.asarray(seqs), 16), jnp.asarray(rows),
        jnp.asarray(start), jnp.asarray(length), steps)
    tl, tr = tf.backward_search_packed(
        td, tf.rolling_kmer_codes(_t(seqs), 16), _t(rows), _t(start),
        _t(length), steps)
    _eq(jl, tl)
    _eq(jr, tr)


def test_sa_decode(pair_index, rng):
    idx, jd, td = pair_index
    rows = rng.integers(0, idx.n + 1, 4096).astype(np.uint32)
    rows[:3] = [0, idx.primary, idx.n]
    valid = rng.random(4096) < 0.8
    got = tf.sa_decode(td, _t(rows.astype(np.int64)), _t(valid))
    _eq(jf.sa_decode(jd, jnp.asarray(rows), jnp.asarray(valid)), got)
    # and it is the suffix array: decoding every row is a permutation
    allrows = np.arange(idx.n + 1, dtype=np.int64)
    sa = tf.sa_decode(td, _t(allrows), torch.ones(idx.n + 1, dtype=torch.bool))
    assert sorted(sa.numpy().tolist()) == list(range(idx.n + 1))


def test_genome_windows_and_packed_verify(pair_index, rng):
    idx, jd, td = pair_index
    M, L = 512, 70
    tp = rng.integers(0, idx.n, M).astype(np.uint32)
    tp[:2] = [0, idx.n - 1]
    _eq(jf.extract_genome(jd, jnp.asarray(tp), L),
        tf.extract_genome(td, _t(tp.astype(np.int64)), L))
    W = 5
    _eq(jf.aligned_genome_words(jd, jnp.asarray(tp), W),
        tf.aligned_genome_words(td, _t(tp.astype(np.int64)), W))
    reads = rng.integers(0, 4, (M, L)).astype(np.uint8)
    lens = rng.integers(1, L + 1, M).astype(np.int32)
    _eq(jf.pack_reads(jnp.asarray(reads)), tf.pack_reads(_t(reads)))
    jw = jf.pack_reads(jnp.asarray(reads))
    tw = tf.pack_reads(_t(reads))
    _eq(jf.count_mismatches_packed(jd, jnp.asarray(tp), jw, jnp.asarray(lens)),
        tf.count_mismatches_packed(td, _t(tp.astype(np.int64)), tw, _t(lens)))


def test_revcomp(rng):
    B, L = 64, 50
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    _eq(jf.revcomp_reads(jnp.asarray(reads), jnp.asarray(lens)),
        tf.revcomp_reads(_t(reads), _t(lens)))
    for n in (L, 37):
        _eq(jf.revcomp_reads_uniform(jnp.asarray(reads), n),
            tf.revcomp_reads_uniform(_t(reads), n))


def test_device_index_ladder_degrades_like_reference(small_index):
    """A budget below the index size makes both ladders re-sample the SA
    to the same coarser rate. The port's footprint is the reference's
    with the occ and BWT tables replaced by the occ blocks, 32 bytes per
    64 BWT positions."""
    budget = jf.index_hbm_bytes(small_index) - 1
    tables = np.asarray(small_index.occ).nbytes + np.asarray(
        small_index.bwt).nbytes
    blocks = 32 * -(-len(small_index.bwt) // 4)
    tbudget = budget - tables + blocks
    assert tf.index_hbm_bytes(small_index) == tbudget + 1
    jd, jidx = jf.device_index_ladder(small_index, hbm_budget=budget)
    td, tidx = tf.device_index_ladder(small_index, "cpu", hbm_budget=tbudget)
    assert tidx.sa_rate == jidx.sa_rate > small_index.sa_rate
    rows = np.arange(0, small_index.n + 1, 7, dtype=np.uint32)
    valid = np.ones(len(rows), bool)
    _eq(jf.sa_decode(jd, jnp.asarray(rows), jnp.asarray(valid)),
        tf.sa_decode(td, _t(rows.astype(np.int64)), _t(valid)))


def test_oom_detection():
    assert tf.is_oom_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert tf.is_oom_error(MemoryError())
    assert not tf.is_oom_error(ValueError("bad input"))
