"""DP rescue plumbing of the PyTorch port against the JAX package:
seed_candidates, gapless_prescan and run_banded_dp on the same numpy
inputs (the tiny PE workload's index and reads), and the DP seeding's
lane expansion (_seed_cand_batch through fmindex.seed_expand_decode;
the FS2s kernel on the card) at its edges: interval widths of 0, 1, 63,
64, 65 and 200 (a unit pasted that often), seeds at read offset 0 and at
the read's end (some decoding below their start), totals above, equal
to and below K and 0. Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu.kernels.banded_dp import DPScores as JScores
from soap3dp_tpu.pipeline import dp_rescue as jr
from soap3dp_tpu_torch.fm import fmindex as tf
from soap3dp_tpu_torch.kernels import fm_search as fs
from soap3dp_tpu_torch.kernels.banded_dp import DPScores as TScores
from soap3dp_tpu_torch.pipeline import dp_rescue as tr
from soap3dp_tpu_torch.workloads import make_tiny_pair_workload

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def work():
    """((JAX index, port index), JAX device index, port device index,
    reads, lengths): each package's own tiny PE workload (the recipes
    are equal, tests/test_torch_pipeline.py)."""
    import __graft_entry__ as ge

    jindex, b1, b2, _ = ge.make_tiny_pair_workload(seed=5, n_pairs=60)
    tindex = make_tiny_pair_workload(seed=5, n_pairs=60)[0]
    reads = np.concatenate([b1.codes, b2.codes])
    lens = np.concatenate([b1.lens, b2.lens]).astype(np.int32)
    return ((jindex, tindex), jf.device_index(jindex),
            tf.device_index(tindex, "cpu"), reads, lens)


UNIT = 30
COPIES = (1, 63, 64, 65, 200)  # about the 64 candidate slots of a lane


@pytest.fixture(scope="module")
def edges():
    """(JAX device index, the port's CPU device index, reads, lengths,
    seed positions, seed lengths): a 100 kbp random genome with a
    30-base unit pasted 1, 63, 64, 65 and 200 times (copies on a
    50-base grid, the first two at text positions 10 and 60, below the
    read-end seeds' start); 100-base reads that start at a copy and that
    end at one (their seed at 0, resp. 74, lies in the unit), eight
    random; two 26-base seeds a read, at 0 and at 74."""
    from soap3dp_tpu.index.builder import build_index
    from tests.test_search import _genome_from_codes
    from tests.test_torch_host_copies import port_index

    rng = np.random.default_rng(31)
    n, L = 100_000, 100
    codes = rng.integers(0, 4, n).astype(np.uint8)
    grid = np.concatenate([[0, 1], 2 + rng.permutation(n // 50 - 4)])
    reads, at = [], 0
    for c in COPIES:
        unit = rng.integers(0, 4, UNIT)
        pos = grid[at:at + c] * 50 + 10
        at += c
        for p in pos:
            codes[p:p + UNIT] = unit
        far = pos[(pos >= L) & (pos + L <= n)][:4]
        reads += [codes[p:p + L] for p in far]
        reads += [codes[p + UNIT - L:p + UNIT] for p in far]
    reads = np.concatenate([np.stack(reads),
                            rng.integers(0, 4, (8, L))]).astype(np.uint8)
    jidx = build_index(_genome_from_codes(codes), sa_rate=4)
    lens = np.full(len(reads), L, np.int32)
    sp = np.tile(np.array([0, L - 26], np.int32), (len(reads), 1))
    sl = np.full(len(reads), 26, np.int32)
    return (jf.device_index(jidx), tf.device_index(port_index(jidx), "cpu"),
            reads, lens, sp, sl)


@pytest.mark.parametrize("kind", ["single", "deep", "deep_round2",
                                  "edge_widths", "edge_absent"])
def test_seed_candidates_equal(work, kind, request):
    if kind.startswith("edge"):
        jd, td, reads, lens, sp, sl = request.getfixturevalue("edges")
        if kind == "edge_absent":   # the random reads: a total of 0
            reads, lens, sp, sl = reads[-8:], lens[-8:], sp[-8:], sl[-8:]
        cj = jr.seed_candidates(jd, reads, lens, sp, sl)
        ct = tr.seed_candidates(td, reads, lens, sp, sl)
        assert (cj.read.size == 0) == (kind == "edge_absent")
        for f in ("read", "strand", "pos"):
            np.testing.assert_array_equal(getattr(cj, f), getattr(ct, f),
                                          err_msg=f)
        return
    index, jd, td, reads, lens = work
    L = reads.shape[1]
    if kind == "single":
        sp, sl = jr.single_dp_seed_matrix(lens, L, halved=True)
        sp2, sl2 = tr.single_dp_seed_matrix(lens, L, halved=True)
    else:
        r2 = kind == "deep_round2"
        sp, sl = jr.deep_dp_seed_matrix(lens, L, round2=r2, halved=True)
        sp2, sl2 = tr.deep_dp_seed_matrix(lens, L, round2=r2, halved=True)
    np.testing.assert_array_equal(sp, sp2)
    np.testing.assert_array_equal(sl, sl2)
    cj = jr.seed_candidates(jd, reads, lens, sp, sl)
    ct = tr.seed_candidates(td, reads, lens, sp, sl)
    assert cj.read.size > len(reads) // 2
    for f in ("read", "strand", "pos"):
        np.testing.assert_array_equal(getattr(cj, f), getattr(ct, f), err_msg=f)


def _windows(work, seed):
    """Candidates around seeded loci, half-rescue style windows."""
    index, jd, td, reads, lens = work
    sp, sl = jr.single_dp_seed_matrix(lens, reads.shape[1], halved=True)
    cand = jr.seed_candidates(jd, reads, lens, sp, sl)
    rng = np.random.default_rng(seed)
    margin = rng.integers(10, 90, cand.read.size)
    ws = np.maximum(cand.pos - margin, 0)
    wl = np.minimum(lens[cand.read] + 2 * margin + rng.integers(0, 40, ws.size),
                    int(index[0].n) - ws).astype(np.int32)
    return cand, ws, wl


def test_gapless_prescan_equal(work):
    index, jd, td, reads, lens = work
    cand, ws, wl = _windows(work, 1)
    mlens = lens[cand.read]
    a = jr.gapless_prescan(jd, reads, mlens, cand, ws, wl, int(wl.max()))
    b = tr.gapless_prescan(td, reads, mlens,
                           tr.Candidates(cand.read, cand.strand, cand.pos),
                           ws, wl, int(wl.max()))
    assert (np.asarray(a[0]) == 0).any()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("with_host", [True, False])
def test_run_banded_dp_equal(work, with_host):
    index, jd, td, reads, lens = work
    cand, ws, wl = _windows(work, 2)
    M = cand.read.size
    clip_l = np.where(cand.strand == 1, 49, 20)
    clip_r = np.where(cand.strand == 1, 20, 49)
    al = np.full(M, int(wl.max()) + 1, np.int32)
    ar = np.zeros(M, np.int32)
    cutoff = (lens[cand.read] * 0.3).astype(int)
    jhost, thost = index if with_host else (None, None)
    a = jr.run_banded_dp(jd, reads, lens, cand, ws, wl, int(wl.max()),
                         clip_l, clip_r, al, ar, cutoff, JScores(),
                         index_host=jhost)
    b = tr.run_banded_dp(td, reads, lens,
                         tr.Candidates(cand.read, cand.strand, cand.pos),
                         ws, wl, int(wl.max()), clip_l, clip_r, al, ar,
                         cutoff, TScores(), index_host=thost)
    assert a.read.size > M // 4
    for f in ("read", "strand", "pos", "score", "nrun", "win_start",
              "n_best_cells", "problem"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for i in range(a.read.size):
        n = int(a.nrun[i])
        np.testing.assert_array_equal(a.ops[i, :n], b.ops[i, :n])
        np.testing.assert_array_equal(a.cnts[i, :n], b.cnts[i, :n])


def test_run_banded_dp_uploads_the_rows_it_names(work, monkeypatch):
    """The problems name a few rows of a large batch of mixed lengths:
    run_banded_dp equals the JAX package's, and the pack is given only
    the rows named, with their lengths."""
    index, jd, td, reads, lens = work
    cand, ws, wl = _windows(work, 3)
    keep = np.flatnonzero(cand.read % 7 == 0)
    cand = jr.Candidates(cand.read[keep], cand.strand[keep], cand.pos[keep])
    ws, wl = ws[keep], wl[keep]
    rng = np.random.default_rng(4)
    B = 2000
    big = rng.integers(0, 4, (B, reads.shape[1])).astype(np.uint8)
    big_lens = rng.integers(20, reads.shape[1] + 1, B).astype(np.int32)
    at = rng.choice(B, len(reads), replace=False)
    big[at], big_lens[at] = reads, lens
    big_lens[at[::3]] -= 3  # the named rows of mixed lengths too
    cand = jr.Candidates(at[cand.read].astype(np.int32), cand.strand,
                         cand.pos)
    M = cand.read.size
    clip_l = np.where(cand.strand == 1, 49, 20)
    clip_r = np.where(cand.strand == 1, 20, 49)
    al = np.full(M, int(wl.max()) + 1, np.int32)
    ar = np.zeros(M, np.int32)
    cutoff = (big_lens[cand.read] * 0.3).astype(int)
    a = jr.run_banded_dp(jd, big, big_lens, cand, ws, wl, int(wl.max()),
                         clip_l, clip_r, al, ar, cutoff, JScores())
    packed = []
    pack = tr._pack_problems

    def spy(idx, reads_d, lens_d, *rest):
        packed.append((reads_d.numpy(), lens_d.numpy()))
        return pack(idx, reads_d, lens_d, *rest)

    monkeypatch.setattr(tr, "_pack_problems", spy)
    b = tr.run_banded_dp(td, big, big_lens,
                         tr.Candidates(cand.read, cand.strand, cand.pos),
                         ws, wl, int(wl.max()), clip_l, clip_r, al, ar,
                         cutoff, TScores())
    from soap3dp_tpu_torch.utils import shapes

    # the problems' rows, and row 0 of the pad problems
    pad = shapes.bucket(M, min_size=128) > M
    rows = np.unique(np.concatenate([cand.read, [0] * pad]))
    assert len(packed) == 1 and len(rows) < B // 20
    assert len(set(big_lens[rows])) > 1
    np.testing.assert_array_equal(packed[0][0], big[rows])
    np.testing.assert_array_equal(packed[0][1], big_lens[rows])
    assert a.read.size > M // 4
    for f in ("read", "strand", "pos", "score", "nrun", "win_start",
              "n_best_cells", "problem"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for i in range(a.read.size):
        n = int(a.nrun[i])
        np.testing.assert_array_equal(a.ops[i, :n], b.ops[i, :n])
        np.testing.assert_array_equal(a.cnts[i, :n], b.cnts[i, :n])


def test_concat_and_empty_results():
    e = tr.empty_dpresult()
    assert tr.concat_dpresults([e, None]).read.size == 0
    r = tr.DPResult(read=np.array([1], np.int32), strand=np.array([0], np.int8),
                    pos=np.array([5]), score=np.array([9], np.int32),
                    ops=np.ones((1, 2), np.int32), cnts=np.ones((1, 2), np.int32),
                    nrun=np.array([2], np.int32), win_start=np.array([0]),
                    n_best_cells=np.array([1], np.int32), problem=np.array([0]))
    r2 = tr.DPResult(**{**r.__dict__, "ops": np.ones((1, 4), np.int32),
                        "cnts": np.ones((1, 4), np.int32)})
    c = tr.concat_dpresults([r, r2])
    assert c.ops.shape == (2, 4) and c.ops[0, 2:].sum() == 0
    np.testing.assert_array_equal(tr.dp_margin(np.array([100, 101, 400])),
                                  jr.dp_margin(np.array([100, 101, 400])))


def _seed_batches(edges, K_of):
    """Both packages' _seed_cand_batch over the edge reads at the K that
    K_of(total) gives: (the port's row, pos, valid, total; the JAX
    package's packed [row | pos | valid] split, and total)."""
    jd, td, reads, lens, sp, sl = edges
    steps = max(26 - td.lut_k, min(td.lut_k, 26))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (reads, lens, sp, sl)]
    total = int(tr._seed_cand_batch(td, *t, 64, steps, 1024)[3])
    K = K_of(total)
    got = tr._seed_cand_batch(td, *t, 64, steps, K)
    packed, jtotal = jr._seed_cand_batch(
        jd, jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(sp),
        jnp.asarray(sl), occ_cap=64, max_steps=steps, K=K)
    packed = np.asarray(packed).astype(np.int64)
    return got, [packed[:K], packed[K:2 * K], packed[2 * K:]], int(jtotal)


@pytest.mark.parametrize("case", ["K_eq_total", "K_below_total",
                                  "K_past_total", "total_0"])
def test_seed_cand_batch_matches_reference(edges, case):
    """The port's _seed_cand_batch (the lane expansion, then SA decode)
    against the JAX package's (its (lanes, 64) slot mask and nonzero):
    row, pos and valid equal element for element at the same K, and the
    total; the widths reach 0, 1, 63, 64 and past 64, and seeds at the
    read's end decode below their start."""
    if case == "total_0":
        edges = tuple(a[-8:] if isinstance(a, np.ndarray) else a
                      for a in edges)
    K_of = {"K_eq_total": lambda t: t, "K_below_total": lambda t: t // 2,
            "K_past_total": lambda t: t + 100,
            "total_0": lambda t: 1024}[case]
    (row, pos, valid, total), want, jtotal = _seed_batches(edges, K_of)
    assert int(total) == jtotal
    assert (jtotal == 0) == (case == "total_0")
    for a, b, name in zip((row, pos, valid), want, ("row", "pos", "valid")):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), b,
                                      err_msg=f"{case} {name}")
    if case == "K_past_total":
        assert not valid[jtotal:].any() and not row[jtotal:].any()
        # the mask of 64 slots a lane: widths 0, 1 and 63, and 64 slots
        # for 64, 65 and 200
        td, (reads, lens, sp, sl) = edges[1], edges[2:]
        ori = tf.OrientedReads.of(torch.from_numpy(reads),
                                  torch.from_numpy(lens))
        sp2 = torch.from_numpy(np.concatenate([sp, sp])).long().reshape(-1)
        l, r = tf.seed_intervals(td, ori, 2, sp2, torch.full_like(sp2, 26),
                                 26, "general")
        assert set((r - l).tolist()) >= {0, 1} | set(COPIES)
        live = torch.arange(valid.shape[0]) < jtotal
        assert (live & ~valid).any()       # decoded below the seed start


def test_seed_expand_on_cpu_takes_the_plain_version(edges):
    """seed_expand_decode on CPU tensors is its plain version and
    launches nothing; the kernel wrappers refuse CPU tensors."""
    td = edges[1]
    rng = np.random.default_rng(4)
    cnt = np.minimum(rng.choice([0, 1, 63, 64, 65, 200], 600), 64)
    args = (td, torch.from_numpy(rng.integers(0, td.n - 200, 600)),
            torch.from_numpy(np.cumsum(cnt)),
            torch.from_numpy(rng.integers(0, 75, 600)), 3, 20000)
    n0 = fs.SEED_EXPAND_KERNEL.launches
    got, want = tf.seed_expand_decode(*args), tf.seed_expand_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fs.SEED_EXPAND_KERNEL.launches == n0
    for fn in (fs.seed_expand_decode, fs.seed_expand_ranks):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


@pytest.mark.cuda
def test_seed_expand_kernel_matches_plain(edges):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    td = tf.DeviceIndex(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                           for k, v in vars(edges[1]).items()})
    rng = np.random.default_rng(4)
    cnt = np.minimum(rng.choice([0, 1, 63, 64, 65, 200], 600), 64)
    for K in (int(cnt.sum()), int(cnt.sum()) // 2, 1024):
        args = (td, torch.from_numpy(rng.integers(0, td.n - 200, 600)).to(dev),
                torch.from_numpy(np.cumsum(cnt)).to(dev),
                torch.from_numpy(rng.integers(0, 75, 600)).to(dev), 3, K)
        n0 = fs.SEED_EXPAND_KERNEL.launches
        got, want = tf.seed_expand_decode(*args), tf.seed_expand_plain(*args)
        assert fs.SEED_EXPAND_KERNEL.launches == n0 + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
