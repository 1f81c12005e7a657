"""The occ blocks of the FM steps and the lane expansion folded into SA
decode (soap3dp_tpu_torch/fm/fmindex.py: occ_block_table, occ,
backward_extend, lf_step, expand_decode; the FS1 and FS2 kernels of
csrc/fm_search.cu read the same blocks).

On the CPU, every result is an integer and held exactly: the block
table's layout; Occ, the backward extension and the LF step on the
blocks against the JAX package's occ/BWT ones for every row of small
indexes (nw % 4 of 0-3, the sentinel's row inside a block, rows at
63/64 block edges); the plain expansion + decode against the
reference's compaction (cumsum, scatter-max, cummax) with the JAX
package's SA decode, on counts with zeros, overflow lanes, totals of 0,
above K and equal to K, one lane holding every slot, and an SA table
split over a two-replica mesh; and _search_batch against the JAX
package's in each seed branch, with a seed range, a small K and the
split table. The kernels against their plain versions are marked
``cuda`` and skip here; chip_smoke.py runs the same cases on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu.fm import search as js
from soap3dp_tpu_torch.distributed import mesh as tmesh
from soap3dp_tpu_torch.fm import fmindex as tf
from soap3dp_tpu_torch.fm import search as ts
from soap3dp_tpu_torch.kernels import fm_search as fs
from tests.conftest import make_genome
from tests.test_search import make_reads
from tests.test_torch_host_copies import port_index

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _indexes(n: int, sa_rate: int = 4, lut_k: int = 6, seed: int = 41):
    """(JAX device index, the port's CPU device index, the host index)
    of an n-base random genome."""
    from soap3dp_tpu.index.builder import build_index

    idx = build_index(make_genome(np.random.default_rng(seed), n),
                      sa_rate=sa_rate, lut_k=lut_k)
    return (jf.device_index(idx), tf.device_index(port_index(idx), "cpu"),
            idx)


# genomes of 16 (4 * 40 + r - 1) + 5 bases: nw = n // 16 + 1 is 4 * 40 + r
@pytest.fixture(scope="module", params=[0, 1, 2, 3], ids=lambda r: f"nw%4={r}")
def by_words(request):
    r = request.param
    jd, td, idx = _indexes(16 * (4 * 40 + r - 1) + 5, seed=50 + r)
    assert len(idx.bwt) % 4 == r
    return jd, td, idx


def test_occ_block_table_and_count(by_words):
    """The table's layout, and Occ(c, k) from the blocks equal to the
    JAX package's occ/BWT Occ for every row k in [0, n + 1] and base c,
    so the sentinel's row and every block edge (kp & 63 of 63 and 0) are
    among them."""
    jd, td, idx = by_words
    nw = len(idx.bwt)
    nb = -(-nw // 4)
    blocks = td.occ_blocks
    assert blocks.shape == (nb, 8) and blocks.dtype == torch.int32
    blocks = blocks.numpy().view(np.uint32)
    assert np.array_equal(blocks[:, :4],
                          np.asarray(idx.occ).reshape(nw, 4)[::4])
    words = blocks[:, 4:].reshape(-1)
    assert np.array_equal(words[:nw], idx.bwt) and not words[nw:].any()
    k = np.repeat(np.arange(td.n + 2, dtype=np.int64), 4)
    c = np.tile(np.arange(4, dtype=np.int64), td.n + 2)
    kp = k - (k > td.primary)
    assert {0, 63} <= set((kp & 63).tolist())
    want = jf.occ(jd, jnp.asarray(c, jnp.uint32), jnp.asarray(k, jnp.uint32))
    got = tf.occ(td, _t(c), _t(k))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())


def test_extend_and_lf_step_on_blocks(by_words):
    """The backward extension on the blocks equals the JAX package's for
    random intervals; the LF step on the blocks equals the occ/BWT one
    (C[c] + Occ(c, k) of the BWT base at row k) for every SA row."""
    jd, td, idx = by_words
    rng = np.random.default_rng(7)
    l = rng.integers(0, td.n + 2, 4000)
    r = np.minimum(l + rng.integers(0, 70, 4000), td.n + 1)
    c = rng.integers(0, 4, 4000)
    jl, jr = jf.backward_extend(jd, jnp.asarray(l, jnp.uint32),
                                jnp.asarray(r, jnp.uint32),
                                jnp.asarray(c, jnp.uint32))
    tl, tr = tf.backward_extend(td, _t(l), _t(r), _t(c))
    np.testing.assert_array_equal(np.asarray(jl).astype(np.int64), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    rows = torch.arange(td.n + 1)
    kp = rows - (rows > td.primary).long()
    word = _t(np.asarray(idx.bwt, np.int64))[kp >> 4]
    base = (word >> (2 * (kp & 15))) & 3
    want = jf.occ(jd, jnp.asarray(base.numpy(), jnp.uint32),
                  jnp.asarray(rows.numpy(), jnp.uint32))
    assert torch.equal(tf.lf_step(td, rows),
                       td.counts[base] + torch.from_numpy(
                           np.asarray(want).astype(np.int64)))


# ------------------------------------------------------------------
# The lane expansion + SA decode
# ------------------------------------------------------------------

R, S, CAP = 60, 3, 16


@pytest.fixture(scope="module")
def decode_pair():
    return _indexes(20_000, sa_rate=4, lut_k=8, seed=43)[:2]


def _lanes(td, case: str, seed: int = 9):
    """(l, width, cap, sstart, olens, K) of R * S lanes: intervals of up
    to 20 rows anywhere in the SA, counts with the case's edges."""
    rng = np.random.default_rng(seed)
    RS = R * S
    cap = CAP
    width = rng.integers(0, 21, RS)
    width[rng.random(RS) < 0.3] = 0
    if case == "overflow":
        width[::7] = cap + rng.integers(1, 50, len(width[::7]))
    if case == "total_0":
        width[:] = 0
    if case == "one_lane":
        width[:] = 0
        width[RS // 2] = 500
        cap = 500
    l = rng.integers(0, td.n + 1 - width.clip(max=td.n))
    olens = rng.integers(20, 101, R)
    sstart = rng.integers(0, 60, RS)
    cnt = np.where(width > cap, 0, np.minimum(width, cap))
    total = int(cnt.sum())
    K = {"zeros": total + 37, "overflow": total + 1, "total_0": 64,
         "total_gt_K": total // 2, "total_eq_K": total, "one_lane": 500,
         "split": total + 5}[case]
    return l, width, cap, sstart, olens, K


def _reference_compaction(jd, l, width, cap, sstart, olens, K):
    """The reference's compaction (soap3dp_tpu/fm/search.py:247-273, the
    port's lines before expand_decode) with the JAX package's SA decode:
    the dedupe keys (krow, ktp, pos_ok) of the K slots."""
    l, width, sstart = _t(l), _t(width), _t(sstart)
    olens = _t(olens)
    RS = l.shape[0]
    overflow = width > cap
    cnt = torch.where(overflow, torch.zeros_like(width), width.clamp(max=cap))
    incl = torch.cumsum(cnt, 0)
    off = incl - cnt
    total = incl[-1]
    scat = torch.where(cnt > 0, off, torch.full_like(off, K)).clamp(max=K)
    tbl = torch.zeros(K + 1, dtype=torch.int64).scatter_reduce_(
        0, scat, torch.arange(1, RS + 1), "amax")
    lane_p1 = torch.cummax(tbl[:K], 0).values
    idxK = torch.arange(K)
    cvalid = (idxK < total) & (lane_p1 > 0)
    lane = (lane_p1 - 1).clamp(min=0)
    cslot = torch.where(cvalid, idxK - off[lane], torch.zeros_like(idxK))
    rows_sa = l[lane] + cslot
    sa_pos = torch.from_numpy(np.asarray(jf.sa_decode(
        jd, jnp.asarray(rows_sa.numpy(), jnp.uint32),
        jnp.asarray(cvalid.numpy()))).astype(np.int64))
    st = sstart[lane]
    tp = sa_pos - st
    orow = torch.arange(R).repeat_interleave(S)[lane]
    pos_ok = cvalid & (sa_pos >= st) & (tp + olens[orow] <= int(jd.n))
    krow = torch.where(pos_ok, orow, torch.full_like(orow, 0xFFFFFFFF))
    ktp = torch.where(pos_ok, tp & 0xFFFFFFFF,
                      torch.full_like(tp, 0xFFFFFFFF))
    return (krow, ktp, pos_ok), incl


@pytest.mark.parametrize("case", ["zeros", "overflow", "total_0",
                                  "total_gt_K", "total_eq_K", "one_lane",
                                  "split"])
def test_expand_decode_plain_matches_reference_compaction(decode_pair, case):
    jd, td = decode_pair
    l, width, cap, sstart, olens, K = _lanes(td, case)
    want, incl = _reference_compaction(jd, l, width, cap, sstart, olens, K)
    total = int(incl[-1])
    assert {"total_0": total == 0, "total_gt_K": total > K,
            "total_eq_K": total == K,
            "one_lane": int((incl.diff() > 0).sum()) <= 1 and total == K
            }.get(case, total < K)
    if case == "split":
        from soap3dp_tpu.index.builder import build_index

        idx = build_index(make_genome(np.random.default_rng(43), 20_000),
                          sa_rate=4, lut_k=8)
        mesh = tmesh.replicate_index(port_index(idx),
                                     tmesh.make_mesh(["cpu"] * 2),
                                     shard_sa=True)
        reps = mesh.replicas
        assert all(rep.sa_parts for rep in reps)
    else:
        reps = [td]
    for rep in reps:
        got = tf.expand_decode_plain(
            rep, _t(l), incl, tf.SeedLanes.given(_t(sstart), lens=_t(olens)),
            S, K)
        for a, b, name in zip(got, want, ("krow", "ktp", "pos_ok")):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert want[2].sum() > 0 or total == 0 or case == "total_0"


def test_expand_decode_on_cpu_takes_the_plain_version(decode_pair):
    """expand_decode on CPU tensors is its plain version and launches
    nothing; the kernel wrappers refuse CPU tensors."""
    _, td = decode_pair
    l, width, cap, sstart, olens, K = _lanes(td, "overflow", seed=3)
    cnt = np.where(width > cap, 0, np.minimum(width, cap))
    args = (td, _t(l), _t(np.cumsum(cnt)),
            tf.SeedLanes.given(_t(sstart), lens=_t(olens)), S, K)
    n0 = fs.EXPAND_KERNEL.launches
    got, want = tf.expand_decode(*args), tf.expand_decode_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fs.EXPAND_KERNEL.launches == n0
    for fn in (fs.expand_decode, fs.expand_ranks):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


# ------------------------------------------------------------------
# _search_batch through the expansion, against the JAX package
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def search_pair(small_index):
    return (small_index, jf.device_index(small_index),
            tf.device_index(port_index(small_index), "cpu"))


@pytest.mark.parametrize("case", ["lut", "packed", "general", "seed_range",
                                  "small_K", "split"])
def test_search_batch_matches_reference(search_pair, small_genome, case):
    """One _search_batch dispatch in each seed branch ("lut": seeds of
    lut_k bases and no FM step; "packed": the extension window in one
    16-base word; "general": full pigeonhole segments), over segments
    {1, 2} of 3, with a K below the candidate total, and on each replica
    of an SA table split over a two-replica mesh: every output array
    equal to the JAX package's."""
    index, jd, td = search_pair
    rng = np.random.default_rng(21)
    B, L = 32, 48
    reads = make_reads(rng, small_genome.codes, B, L, 2)
    lens = np.full(B, L, np.int32)
    lens[::5] = 41
    k = td.lut_k
    seed_q, steps = {"lut": (k, 0), "packed": (k + 5, 5)}.get(
        case, (0, L // 3))
    kw = dict(K=2048, K2=1024)
    if case == "seed_range":
        kw.update(seed_lo=1, seed_hi=3)
    if case == "small_K":
        kw.update(K=48, K2=32)
    reps = [td]
    if case == "split":
        mesh = tmesh.replicate_index(port_index(index),
                                     tmesh.make_mesh(["cpu"] * 2),
                                     shard_sa=True)
        reps = mesh.replicas
    hj, totj = js._search_batch(jd, jnp.asarray(reads), jnp.asarray(lens),
                                js.SearchConfig(k=2), 16, steps, seed_q, **kw)
    assert np.asarray(totj)[0] > (48 if case == "small_K" else 0)
    for rep in reps:
        ht, tott = ts._search_batch(rep, _t(reads), _t(lens),
                                    ts.SearchConfig(k=2), 16, steps, seed_q,
                                    **kw)
        np.testing.assert_array_equal(np.asarray(totj), tott.numpy())
        for name in ("row", "tp", "nmis", "valid", "flagged"):
            a = np.asarray(getattr(hj, name)).astype(np.int64)
            b = getattr(ht, name).numpy().astype(np.int64)
            if name == "row":
                a = np.where(np.asarray(hj.valid), a, -1)
                b = np.where(ht.valid.numpy(), b, -1)
            np.testing.assert_array_equal(a, b, err_msg=f"{case} {name}")


# ------------------------------------------------------------------
# On the card (skip here; chip_smoke.py runs the same cases)
# ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zeros", "overflow", "total_0",
                                  "total_gt_K", "total_eq_K", "one_lane"])
def test_expand_decode_kernel_matches_plain(decode_pair, case):
    dev = _card()
    _, td = decode_pair
    td = tf.DeviceIndex(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                           for k, v in vars(td).items()})
    l, width, cap, sstart, olens, K = _lanes(td, case)
    cnt = np.where(width > cap, 0, np.minimum(width, cap))
    args = (td, _t(l).to(dev), _t(np.cumsum(cnt)).to(dev),
            tf.SeedLanes.given(_t(sstart).to(dev), lens=_t(olens).to(dev)),
            S, K)
    n0 = fs.EXPAND_KERNEL.launches
    got, want = tf.expand_decode(*args), tf.expand_decode_plain(*args)
    assert fs.EXPAND_KERNEL.launches == n0 + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_block_edges_on_the_card(by_words):
    """FS2 over every SA row of the small indexes (every block edge, the
    sentinel's block, the last block's padding) equals its plain
    version."""
    dev = _card()
    _, td, _ = by_words
    td = tf.DeviceIndex(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                           for k, v in vars(td).items()})
    rows = torch.arange(td.n + 1, device=dev)
    valid = torch.ones_like(rows, dtype=torch.bool)
    assert torch.equal(tf.sa_decode(td, rows, valid).cpu(),
                       tf.sa_decode_plain(td, rows, valid).cpu())
