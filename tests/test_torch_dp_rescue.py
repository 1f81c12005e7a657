"""DP rescue plumbing of the PyTorch port against the JAX package:
seed_candidates, gapless_prescan and run_banded_dp on the same numpy
inputs (the tiny PE workload's index and reads), and the DP seeding's
lane expansion (_seed_cand_batch through fmindex.seed_expand_decode;
the FS2s kernel on the card) at its edges: interval widths of 0, 1, 63,
64, 65 and 200 (a unit pasted that often), seeds at read offset 0 and at
the read's end (some decoding below their start), totals above, equal
to and below K and 0, and lanes mostly empty (runs longer than a warp's
32 lanes without a slot, past the window the kernel's warps read).
Tolerance: exact.
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
    the rows named, each problem's words naming its row with its
    length."""
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

    def spy(idx, reads_d, words_d, *rest):
        packed.append((reads_d.numpy(), tr.rescue_fields(words_d)))
        return pack(idx, reads_d, words_d, *rest)

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
    read, _, _, rc_len = (t.numpy() for t in packed[0][1])
    named = np.concatenate([cand.read, np.zeros(len(read) - M, np.int32)])
    np.testing.assert_array_equal(rows[read], named)
    np.testing.assert_array_equal(rc_len, big_lens[named])
    assert a.read.size > M // 4
    for f in ("read", "strand", "pos", "score", "nrun", "win_start",
              "n_best_cells", "problem"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for i in range(a.read.size):
        n = int(a.nrun[i])
        np.testing.assert_array_equal(a.ops[i, :n], b.ops[i, :n])
        np.testing.assert_array_equal(a.cnts[i, :n], b.cnts[i, :n])


@pytest.mark.parametrize("replicas", [1, 2])
def test_run_banded_dp_uploads_and_words(work, monkeypatch, replicas):
    """A shard of run_banded_dp makes one upload (stage_to_device) of its
    named read rows, its (P, 8) problem rows and PK's words (the named
    row, the strand, the window start and the read's length, params
    column 0), on one device and on a mesh of two; the results equal the
    JAX package's."""
    from soap3dp_tpu_torch.distributed import mesh as tmesh

    index, jd, td, reads, lens = work
    cand, ws, wl = _windows(work, 2)
    M = cand.read.size
    clip_l = np.where(cand.strand == 1, 49, 20)
    clip_r = np.where(cand.strand == 1, 20, 49)
    al = np.full(M, int(wl.max()) + 1, np.int32)
    ar = np.zeros(M, np.int32)
    cutoff = (lens[cand.read] * 0.3).astype(int)
    didx = td if replicas == 1 else tmesh.replicate_index(
        index[1], tmesh.make_mesh(["cpu"] * replicas))
    ups, shards = [], []
    up, align = tr.stage_to_device, tr.dp_align_shards

    def spy(arrays, device):
        ups.append([np.asarray(a) for a in arrays])
        return up(arrays, device)

    def held(parts, sc):
        shards.extend(parts)
        return align(parts, sc)

    monkeypatch.setattr(tr, "stage_to_device", spy)
    monkeypatch.setattr(tr, "dp_align_shards", held)
    b = tr.run_banded_dp(didx, reads, lens,
                         tr.Candidates(cand.read, cand.strand, cand.pos),
                         ws, wl, int(wl.max()), clip_l, clip_r, al, ar,
                         cutoff, TScores())
    monkeypatch.undo()
    a = jr.run_banded_dp(jd, reads, lens, cand, ws, wl, int(wl.max()),
                         clip_l, clip_r, al, ar, cutoff, JScores())
    assert len(shards) == replicas and len(ups) == replicas
    P = shards[0][2].shape[0]
    ws_pad = np.concatenate([ws, np.zeros(P * replicas - M, ws.dtype)])
    for j, (oriented, wins, params, cut) in enumerate(shards):
        rows_up, params_up, words = ups[j]
        assert params_up.dtype == np.int32 and params_up.shape == (P, 8)
        np.testing.assert_array_equal(params.numpy(), params_up)
        assert words.dtype == np.int32 and words.shape == (P, fs.PK_WORDS)
        read, rev, wstart, rc_len = (
            t.numpy() for t in tr.rescue_fields(torch.from_numpy(words)))
        np.testing.assert_array_equal(rc_len, params[:, 0].numpy())
        assert rows_up.shape[0] == len(np.unique(read))
        np.testing.assert_array_equal(oriented.numpy()[~rev],
                                      rows_up[read[~rev]])
        np.testing.assert_array_equal(wstart, ws_pad[j * P:(j + 1) * P])
        assert params.is_contiguous() and cut.shape == (P,)
    for f in ("read", "strand", "pos", "score", "nrun", "win_start",
              "n_best_cells", "problem"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("sizes", [(1, 7, 0), (16, 24, 3), (33, 0, 1000)])
def test_stage_to_device_views(sizes):
    """stage_to_device: several host arrays through one buffer, each a
    contiguous view from a 16-byte boundary with its own dtype, shape
    and values (uint8 rows, int32 words with the sign bit set, bool, an
    empty array)."""
    rng = np.random.default_rng(sum(sizes))
    n8, n32, nb = sizes
    arrays = [rng.integers(0, 256, (n8, 5)).astype(np.uint8),
              rng.integers(-(1 << 31), 1 << 31, (n32, 6)).astype(np.int32),
              rng.random(nb) < 0.5, np.zeros((0, 4), np.int32)]
    got = tf.stage_to_device(arrays, "cpu")
    base = got[0].untyped_storage().data_ptr()
    for g, a in zip(got, arrays):
        assert g.is_contiguous() and tuple(g.shape) == a.shape
        assert g.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(g.numpy(), a)
        assert g.untyped_storage().data_ptr() == base
        assert (g.data_ptr() - base) % 16 == 0


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
    K_of(total) gives: (the port's packed words as u32, split into row,
    pos and valid, and total; the JAX package's packed [row | pos |
    valid], and total)."""
    jd, td, reads, lens, sp, sl = edges
    steps = max(26 - td.lut_k, min(td.lut_k, 26))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (reads, lens, sp, sl)]
    total = int(tr._seed_cand_batch(td, *t, 64, steps, 1024)[1])
    K = K_of(total)
    packed, total = tr._seed_cand_batch(td, *t, 64, steps, K)
    jpacked, jtotal = jr._seed_cand_batch(
        jd, jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(sp),
        jnp.asarray(sl), occ_cap=64, max_steps=steps, K=K)
    assert packed.dtype == torch.int32 and packed.shape == (3 * K,)
    words = packed.numpy().view(np.uint32)
    jwords = np.asarray(jpacked)
    assert jwords.dtype == np.uint32
    # word for word, tolerance zero
    np.testing.assert_array_equal(words, jwords)
    return (words[:K], words[K:2 * K], words[2 * K:] != 0, total), \
        jwords, int(jtotal)


@pytest.mark.parametrize("case", ["K_eq_total", "K_below_total",
                                  "K_past_total", "total_0"])
def test_seed_cand_batch_matches_reference(edges, case):
    """The port's _seed_cand_batch (the lanes' counts and scan, the lane
    expansion, then SA decode) against the JAX package's (its (lanes, 64)
    slot mask and nonzero): the packed [row | pos | valid] words equal
    word for word at the same K, and the total; the widths reach 0, 1,
    63, 64 and past 64, and seeds at the read's end decode below their
    start."""
    if case == "total_0":
        edges = tuple(a[-8:] if isinstance(a, np.ndarray) else a
                      for a in edges)
    K_of = {"K_eq_total": lambda t: t, "K_below_total": lambda t: t // 2,
            "K_past_total": lambda t: t + 100,
            "total_0": lambda t: 1024}[case]
    (row, pos, valid, total), _, jtotal = _seed_batches(edges, K_of)
    assert int(total) == jtotal
    assert (jtotal == 0) == (case == "total_0")
    if case == "K_past_total":
        assert not valid[jtotal:].any() and not row[jtotal:].any()
        # the mask of 64 slots a lane: widths 0, 1 and 63, and 64 slots
        # for 64, 65 and 200
        td, (reads, lens, sp, sl) = edges[1], edges[2:]
        ori = tf.OrientedReads.of(torch.from_numpy(reads),
                                  torch.from_numpy(lens))
        sp2 = torch.from_numpy(np.concatenate([sp, sp])).long().reshape(-1)
        l, r = tf.seed_intervals(
            td, ori, 2, tf.SeedLanes.given(sp2, torch.full_like(sp2, 26)),
            26, "general")
        assert set((r - l).tolist()) >= {0, 1} | set(COPIES)
        live = np.arange(valid.shape[0]) < jtotal
        assert (live & ~valid).any()       # decoded below the seed start


@pytest.mark.parametrize("case", ["K_eq_total", "K_below_total"])
def test_seed_cand_batch_on_sparse_lanes_matches_reference(edges, case):
    """_seed_cand_batch against the JAX package's where most lanes hold
    no slot: a fifth of the edge reads between 150 and 70 random reads
    (no 26-base seed of a random read lies in the 100 kbp text), so
    runs of hundreds of empty lanes; row, pos, valid and the total
    equal at K equal to the total and at half of it plus 1."""
    jd, td, reads, lens, sp, sl = edges
    rng = np.random.default_rng(9)
    pad = rng.integers(0, 4, (150, reads.shape[1])).astype(np.uint8)
    mixed = np.concatenate([pad, reads[::5], pad[:70]])
    n = len(mixed)
    sparse = (jd, td, mixed, np.full(n, reads.shape[1], np.int32),
              np.tile(sp[0], (n, 1)), np.full(n, 26, np.int32))
    K_of = {"K_eq_total": lambda t: t,
            "K_below_total": lambda t: t // 2 + 1}[case]
    (row, pos, valid, total), _, jtotal = _seed_batches(sparse, K_of)
    assert int(total) == jtotal > 0
    r = row[:jtotal] % n          # rows n.. are the reverse complements
    assert int(r.min()) >= 150 and int(r.max()) < n - 70   # no random read


@pytest.mark.parametrize("case", ["short_reads", "pos_past_end",
                                  "len0", "mesh_pad"])
def test_seed_cand_batch_staged_seeds_match_reference(edges, case):
    """The staged seeds' clamps into each read, which the port's FS1 and
    FS2s make from the B reads' seed_pos, seed_len and lens as they load
    them (fmindex.SeedLanes.staged), against the reference's concatenates,
    minimums and clamps (soap3dp_tpu/pipeline/dp_rescue.py:155-164):
    reads shorter than their seed, seeds past the read's end, reads of
    length 0, and a batch padded to a mesh multiple with copies of read
    0; the packed words equal word for word, and the total. Tolerance:
    zero."""
    jd, td, reads, lens, sp, sl = edges
    rng = np.random.default_rng(["short_reads", "pos_past_end", "len0",
                                 "mesh_pad"].index(case) + 50)
    reads, lens, sp, sl = (a.copy() for a in (reads, lens, sp, sl))
    if case == "short_reads":
        lens[::3] = rng.integers(1, 26, len(lens[::3]))
    elif case == "pos_past_end":
        sp[::2, 1] = rng.integers(80, 150, len(sp[::2]))
    elif case == "len0":
        lens[::5] = 0
    else:
        pad = -len(lens) % 8 or 8
        reads, lens, sp, sl = (np.concatenate([a, np.repeat(a[:1], pad, 0)])
                               for a in (reads, lens, sp, sl))
    for i, n in enumerate(lens):
        reads[i, n:] = 0
    (row, pos, valid, total), _, jtotal = _seed_batches(
        (jd, td, reads, lens, sp, sl), lambda t: t + 100)
    assert int(total) == jtotal > 0
    start, length = tf.SeedLanes.staged(
        torch.from_numpy(sp), torch.from_numpy(sl),
        torch.from_numpy(lens)).bounds(sp.shape[1])
    ln2 = np.concatenate([lens, lens]).astype(np.int64)
    sl2 = np.concatenate([sl, sl]).astype(np.int64)
    want = np.minimum(np.concatenate([sp, sp]),
                      np.maximum(ln2 - sl2, 0)[:, None]).reshape(-1)
    np.testing.assert_array_equal(start.numpy(), want)
    np.testing.assert_array_equal(
        length.numpy(), np.repeat(np.minimum(sl2, ln2), sp.shape[1]))
    if case in ("short_reads", "len0"):
        assert (length.numpy() < 26).any()


def test_seed_expand_on_cpu_takes_the_plain_version(edges):
    """seed_expand_decode on CPU tensors is its plain version and
    launches nothing; the kernel wrappers refuse CPU tensors."""
    td = edges[1]
    rng = np.random.default_rng(4)
    cnt = np.minimum(rng.choice([0, 1, 63, 64, 65, 200], 600), 64)
    args = (td, torch.from_numpy(rng.integers(0, td.n - 200, 600)),
            torch.from_numpy(np.cumsum(cnt)),
            tf.SeedLanes.given(torch.from_numpy(rng.integers(0, 75, 600))),
            3, 20000)
    n0 = fs.SEED_EXPAND_KERNEL.launches
    got, want = tf.seed_expand_decode(*args), tf.seed_expand_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
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
                tf.SeedLanes.given(
                    torch.from_numpy(rng.integers(0, 75, 600)).to(dev)), 3, K)
        n0 = fs.SEED_EXPAND_KERNEL.launches
        got, want = tf.seed_expand_decode(*args), tf.seed_expand_plain(*args)
        assert fs.SEED_EXPAND_KERNEL.launches == n0 + 1
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_seed_expand_kernel_on_sparse_and_few_lanes(edges):
    """FS2s where its warps search for their slots' lanes
    (chip_smoke.seed_lane_cases: 98% of the lanes empty, one row of
    fewer lanes than a warp, K odd): equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    dev = torch.device("cuda", 0)
    td = tf.DeviceIndex(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                           for k, v in vars(edges[1]).items()})
    for name, fn, args in chip_smoke.seed_lane_cases(
            np.random.default_rng(6), td, dev, 4000, 4):
        got, want = tf.seed_expand_decode(*args), tf.seed_expand_plain(*args)
        assert got.dtype == want.dtype and torch.equal(got.cpu(),
                                                       want.cpu()), name


@pytest.mark.parametrize("mode", ["search", "seed"])
def test_lane_counts_plain_matches_reference(mode):
    """lane_counts_plain (FS5's plain version) against the reference's
    lines in jnp: the search's overflow mask, per-read any over both
    strands, where / minimum and cumsum (soap3dp_tpu/fm/search.py:232-252)
    and its wire's flagged words (:336-340), or the seeding's minimum of
    the widths and occ_cap (dp_rescue.py:176-179); 45 reads (not a
    multiple of 32) of 3 lanes a strand, overflows on one strand only.
    Tolerance: zero."""
    import chip_smoke
    from soap3dp_tpu.utils import scans

    B, S, cap = 45, 3, 16
    l, r = chip_smoke.lane_count_inputs(np.random.default_rng(21), B, S, cap)
    width = jnp.asarray(r.astype(np.uint32)) - jnp.asarray(
        l.astype(np.uint32))
    if mode == "search":
        overflow = width > jnp.uint32(cap)
        fl = overflow.reshape(2 * B, S).any(axis=1)
        fl = (fl[:B] | fl[B:]).astype(jnp.uint32)
        fl = jnp.zeros(64, jnp.uint32).at[:B].set(fl)
        want_flags = (fl.reshape(-1, 32) << jnp.arange(32, dtype=jnp.uint32)
                      ).sum(axis=1, dtype=jnp.uint32)
        cnt = jnp.where(overflow, jnp.uint32(0),
                        jnp.minimum(width, jnp.uint32(cap))).astype(jnp.int32)
        flags = torch.full((2,), 7, dtype=torch.int32)
        incl, total, out = tf.lane_counts(torch.from_numpy(l),
                                          torch.from_numpy(r), cap, S, flags)
        assert out is flags
        np.testing.assert_array_equal(flags.numpy().view(np.uint32),
                                      np.asarray(want_flags))
        got = flags.numpy().view(np.uint32)
        assert got[0] & 0b11 == 0b11     # one strand's overflow alone
    else:
        cnt = jnp.minimum(width, jnp.uint32(cap)).astype(jnp.int32)
        incl, total = tf.lane_counts(torch.from_numpy(l), torch.from_numpy(r),
                                     cap, S)
    want = np.asarray(scans.cumsum_1d(cnt))
    assert incl.dtype == torch.int64
    np.testing.assert_array_equal(incl.numpy(), want)
    assert int(total) == int(want[-1]) > 0
    n0 = fs.LANE_COUNTS_KERNEL.launches
    plain = tf.lane_counts_plain(torch.from_numpy(l), torch.from_numpy(r),
                                 cap, S, *([torch.zeros(2, dtype=torch.int32)]
                                           if mode == "search" else []))
    assert torch.equal(plain[0], incl) and fs.LANE_COUNTS_KERNEL.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        fs.lane_counts(torch.from_numpy(l), torch.from_numpy(r), cap, S)


def test_search_wire_refuses_cpu_tensors():
    """The FS5 and FS6 wrappers refuse CPU tensors (the entry points take
    them to the plain versions): no fallback."""
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        fs.search_wire(torch.zeros(2 + 1 + 8, dtype=torch.int32), 3,
                       z[0], z[0], z, z, z.to(torch.bool), z, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fs.lane_counts(z, z, 4, 1, torch.zeros(1, dtype=torch.int32))


def _cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [45, 11667, 131072])
def test_lane_counts_kernel_matches_plain(B):
    """FS5 against lane_counts_plain on the card in both modes, every
    output element (incl, total, the flagged words); 2 B S lanes, S = 3:
    270 and 70,002 lanes (not multiples of the 1,024-lane tile) and
    phase 4's 786,432."""
    import chip_smoke

    dev = _cuda_dev()
    l, r = (torch.from_numpy(a).to(dev) for a in chip_smoke.lane_count_inputs(
        np.random.default_rng(B), B, 3, 16))
    nf = -(-B // 32)
    for flags in (None, torch.empty(nf, dtype=torch.int32, device=dev)):
        extra = [] if flags is None else [flags]
        n0 = fs.LANE_COUNTS_KERNEL.launches
        got = tf.lane_counts(l, r, 16, 3, *extra)
        assert fs.LANE_COUNTS_KERNEL.launches == n0 + 1
        want = tf.lane_counts_plain(
            l, r, 16, 3, *[torch.empty_like(f) for f in extra])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_search_wire_kernel_matches_plain():
    """FS6 against search_wire_plain on the card, every word of the wire:
    K2 slots of random hits, misses past uniq, mismatches past k and
    past 127, text positions past 2^31."""
    dev = _cuda_dev()
    rng = np.random.default_rng(5)
    B, K2 = 45, 3000

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    urow = np.where(rng.random(K2) < 0.8, rng.integers(0, 2 * B, K2),
                    0x7FFFFFFF)
    args = (B, torch.tensor(901, device=dev),
            torch.tensor(2400, device=dev), t(urow),
            t(rng.integers(0, 1 << 32, K2)), t(urow < 2 * B),
            t(rng.choice([0, 1, 2, 3, 200], K2)), 2)
    wire = torch.full((2 + 2 + 2 * K2,), 9, dtype=torch.int32, device=dev)
    want = tf.search_wire_plain(wire.clone(), *args)
    n0 = fs.SEARCH_WIRE_KERNEL.launches
    got = tf.search_wire(wire.clone(), *args)
    assert fs.SEARCH_WIRE_KERNEL.launches == n0 + 1
    assert torch.equal(got.cpu(), want.cpu())


def test_copy_prefix_refuses_cpu_tensors():
    """The seeding's prefix copy (fm_search.copy_prefix) takes a CUDA
    tensor only; _prefix_to_host gives the CPU's prefix from its slices,
    each third's first words as u32."""
    packed = torch.arange(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fs.copy_prefix(packed, 3, 2)
    np.testing.assert_array_equal(tr._prefix_to_host(packed, 4, 2),
                                  np.array([[0, 1], [4, 5], [8, 9]],
                                           np.uint32))
