"""Banded DP of the PyTorch port: its plain-torch dp_align against the
JAX package's dp_align (the scan path on the CPU), against the fused
Pallas kernel in interpret mode, and against tests/dp_oracle.py.
Tolerance: exact (scores, cells, counts and runs are integers).

The CUDA kernel itself runs only on the card; test_kernel_matches_plain
is marked ``cuda`` and skips here (chip_smoke.py runs the same check on
the card at the main path's shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap3dp_tpu.kernels import banded_dp as jb
from soap3dp_tpu_torch.kernels import banded_dp as tb
from tests import dp_oracle
from tests.test_dp import make_problems, runs_from_oracle

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


SC = tb.DPScores()
SCORES = (SC.match, SC.mismatch, SC.gap_open, SC.gap_ext)
OPCH = {tb.OP_MATCH: "M", tb.OP_MISMATCH: "m", tb.OP_INS: "I",
        tb.OP_DEL: "D", tb.OP_CLIP: "S"}


def _torch(prob, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in prob]


def _runs(ops, cnts, nrun, p):
    return [(int(ops[p, r]), int(cnts[p, r])) for r in range(int(nrun[p]))
            if int(cnts[p, r]) > 0]


def assert_dp_equal(a, b, check_width=False):
    """Two dp_align results equal: per-lane stats exactly, runs over each
    lane's nrun prefix (ops widths may differ between implementations)."""
    for k in (0, 1, 2, 3, 6, 7, 8):
        np.testing.assert_array_equal(np.asarray(a[k]).astype(np.int64),
                                      np.asarray(b[k]).astype(np.int64),
                                      err_msg=f"field {k}")
    if check_width:
        assert a[4].shape == b[4].shape
    for p in range(len(a[0])):
        assert _runs(a[4], a[5], a[6], p) == _runs(b[4], b[5], b[6], p), p


def overflow_problems(P, Lr, Lw, seed=3):
    """Every other base mismatched, no free clips, a cutoff far below any
    score: ~Lr runs per alignment (past the kernel's first run budget)."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 4, size=(P, Lw)).astype(np.uint8)
    reads = wins[:, 20:20 + Lr].copy()
    reads[:, 1::2] = (reads[:, 1::2] + 1 + (np.arange(Lr)[1::2] % 3)) % 4
    z = np.zeros(P, np.int32)
    return (reads, np.full(P, Lr, np.int32), wins, np.full(P, Lw, np.int32),
            z, z.copy(), np.full(P, Lw + 1, np.int32), z.copy(),
            np.full(P, -100000, np.int32))


@pytest.mark.parametrize("with_anchor", [False, True])
def test_plain_matches_reference_scan_path(with_anchor):
    rng = np.random.default_rng(9)
    P, Lr, Lw = 64, 40, 70
    prob = make_problems(rng, P, Lr, Lw, with_anchor) + (
        np.full(P, 10, np.int32),)
    want = jb.dp_align(*[jnp.asarray(x) for x in prob[:8]], prob[8], sc=jb.DPScores())
    got = tb.dp_align(*_torch(prob), sc=SC)
    assert_dp_equal(want, got, check_width=True)
    assert (np.asarray(got[6]) > 0).sum() > P // 2


@pytest.mark.parametrize("with_anchor", [False, True])
def test_plain_matches_fused_pallas_interpret(with_anchor):
    """Held against the TPU kernel itself, run in interpret mode."""
    rng = np.random.default_rng(19)
    P, Lr, Lw = 64, 40, 70
    prob = make_problems(rng, P, Lr, Lw, with_anchor)
    cutoff = np.full(P, 10, np.int32)
    mr = max(jb.MAX_RUNS, jb._max_runs_bound(Lr))
    stats, runs = jb._dp_align_pallas_call(
        *[jnp.asarray(x) for x in prob], jnp.asarray(cutoff), jb.DPScores(),
        pt=jb.PALLAS_P_TILE, mr=mr, interpret=True)
    stats, runs = np.asarray(stats), np.asarray(runs)
    got = tb.dp_align(*_torch(prob + (cutoff,)), sc=SC)
    for k, col in ((0, 0), (1, 1), (2, 2), (3, 3), (7, 4), (6, 5)):
        np.testing.assert_array_equal(np.asarray(got[k]), stats[:, col])
    assert not stats[:, 6].any()
    for p in range(P):
        want = [(int(r) >> 12, int(r) & 0xFFF) for r in runs[p, :stats[p, 5]]
                if int(r) & 0xFFF]
        assert _runs(got[4], got[5], got[6], p) == want, p


@pytest.mark.parametrize("with_anchor", [False, True])
def test_plain_matches_oracle(rng, with_anchor):
    P, Lr, Lw = 32, 24, 48
    prob = make_problems(rng, P, Lr, Lw, with_anchor)
    reads, rlens, wins, wlens, cl, cr, al, ar = prob
    got = tb.dp_align(*_torch(prob + (np.ones(P, np.int32),)), sc=SC)
    score, hi, hj, cnt, ops, cnts, nrun, startj, _ = got
    checked = 0
    for p in range(P):
        H, Dt, best, c = dp_oracle.oracle_forward(
            reads[p, :rlens[p]], wins[p], cl[p], cr[p], al[p], ar[p], SCORES)
        assert (score[p], hj[p], hi[p], cnt[p]) == (best[0], best[1],
                                                    best[2], c), p
        if score[p] < 1:
            continue
        pat, sj = dp_oracle.oracle_traceback(
            reads[p, :rlens[p]], wins[p], H, Dt, best, cl[p], al[p], SCORES)
        want = runs_from_oracle(pat)
        assert [(OPCH[o], n) for o, n in _runs(ops, cnts, nrun, p)] == want, p
        assert startj[p] == sj, p
        checked += 1
    assert checked > P // 2


@pytest.mark.parametrize("shape", [(32, 300, 420), (16, 100, 768)])
def test_long_read_and_main_window(shape):
    """A 300 bp read case and the main path's 100 bp x 768 window."""
    P, Lr, Lw = shape
    rng = np.random.default_rng(Lr)
    wins = rng.integers(0, 4, (P, Lw)).astype(np.uint8)
    reads = np.zeros((P, Lr), np.uint8)
    rlens = rng.integers(Lr * 3 // 4, Lr + 1, P).astype(np.int32)
    for p in range(P):
        reads[p, :rlens[p]] = wins[p, 20:20 + rlens[p]]
    reads[0, 60] = (reads[0, 60] + 1) % 4
    reads[1, 30:Lr - 20] = np.roll(reads[1, 30:Lr - 20], 2)
    reads[2] = rng.integers(0, 4, Lr)
    prob = (reads, rlens, wins, np.full(P, Lw, np.int32),
            rng.integers(0, 20, P).astype(np.int32),
            rng.integers(0, 20, P).astype(np.int32),
            np.full(P, Lw + 1, np.int32), np.zeros(P, np.int32),
            (rlens * 0.3).astype(np.int32))
    want = jb.dp_align(*[jnp.asarray(x) for x in prob[:8]], prob[8])
    got = tb.dp_align(*_torch(prob), sc=SC)
    assert_dp_equal(want, got, check_width=True)


def test_many_runs_overflow_shape():
    """Alignments with ~Lr runs (the shape that overflows the kernel's
    first run budget on the card) agree in full with the reference."""
    prob = overflow_problems(16, 260, 360)
    want = jb.dp_align(*[jnp.asarray(x) for x in prob[:8]], prob[8])
    got = tb.dp_align(*_torch(prob), sc=SC)
    assert_dp_equal(want, got, check_width=True)
    # past 128 runs, the first run budget before it became run_budget
    assert (np.asarray(got[6]) > 128).sum() >= 8
    assert np.asarray(got[6]).max() <= tb.run_budget(260, 360)


def test_wrapper_routes_by_device():
    prob = overflow_problems(2, 20, 40)
    out = tb.dp_align(*_torch(prob), sc=SC)
    assert len(out) == 9 and not out[8].any()
    meta = [torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                        device="meta") for x in prob]
    with pytest.raises(ValueError):
        tb.dp_align(*meta, sc=SC)
    with pytest.raises(ValueError):
        tb.dp_forward(*meta[:8], sc=SC)
    dirs = torch.empty((60, 2, 21), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tb.dp_traceback(dirs, *meta[:3], meta[1], meta[1], meta[4],
                        np.ones(2, bool))


def _wide_problems(seed, P=64, Lr=100, Lw=256):
    """Rescue-shaped problems at Lr <= 127 (the shapes K2 serves)."""
    rng = np.random.default_rng(seed)
    prob = make_problems(rng, P, Lr, Lw, with_anchor=seed % 2 == 1)
    cl, cr = prob[4] * 8, prob[5] * 8   # wider free clips: SM/fresh exits
    return prob[:4] + (cl, cr) + prob[6:]


@pytest.mark.parametrize("seed", [31, 32])
def test_forward_matches_reference(seed):
    """dp_forward against the JAX scan and the TPU kernel K2 itself, run
    in interpret mode: stats equal, dirs equal over the Lr+1 real lanes
    (the Pallas kernel pads them to 128)."""
    prob = _wide_problems(seed)
    Lr = prob[0].shape[1]
    jargs = [jnp.asarray(x) for x in prob]
    got = tb.dp_forward(*_torch(prob), sc=SC)
    scan = jb.dp_forward(*jargs, sc=jb.DPScores())
    pallas = jb._dp_forward_pallas_call(*jargs, sc=jb.DPScores(),
                                        interpret=True)
    for want in (scan, pallas):
        for k in range(4):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[4].numpy(),
                                      np.asarray(want[4])[:, :, :Lr + 1])
    assert got[4].shape == (Lr + prob[2].shape[1], len(prob[0]), Lr + 1)


@pytest.mark.parametrize("seed", [41, 42])
def test_traceback_matches_reference(seed):
    """dp_traceback against the JAX dp_traceback on the same dirs."""
    prob = _wide_problems(seed, P=48, Lr=60, Lw=200)
    jargs = [jnp.asarray(x) for x in prob]
    bS, bI, bJ, _, dirs = jb.dp_forward(*jargs, sc=jb.DPScores())
    active = np.asarray(bS) >= 10
    active[::7] = False
    want = jb.dp_traceback(dirs, jargs[0], jargs[1], jargs[2], bI, bJ,
                           jargs[4], jnp.asarray(active))
    t = _torch(prob)
    got = tb.dp_traceback(torch.from_numpy(np.array(dirs)), t[0], t[1],
                          t[2], torch.from_numpy(np.array(bI)),
                          torch.from_numpy(np.array(bJ)), t[4], active)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert (np.asarray(got[2]) > 0).sum() > len(active) // 2


def test_wide_route_matches_reference_gates():
    """dp_align takes K2 + traceback exactly where the reference's
    dp_align leaves its fused kernel for dp_forward and dp_forward takes
    its Pallas kernel (the TPU's problem-tiling conditions aside)."""
    for Lr in (36, 64, 100, 120, 127, 128, 150, 300):
        for Lw in (256, 768, 4095, 4096, 4224, 8192):
            tile = jb._fused_tile(Lr + Lw, -(-(Lr + 1) // 128) * 128)
            ref_fused = tile is not None and Lw < 4096
            ref_k2 = not ref_fused and Lr + 1 <= 128
            assert tb.takes_wide_route(Lr, Lw) == ref_k2, (Lr, Lw)
    assert tb.FUSED_MAX_WINDOW == 4096


def test_cells_per_lane_bounds():
    assert tb._cells_per_lane(100) == 4
    assert tb._cells_per_lane(127) == 4
    assert tb._cells_per_lane(128) == 8
    assert tb._cells_per_lane(1024) == 64


@pytest.mark.cuda
def test_kernel_matches_plain():
    """The Hopper kernel against its plain version (needs a CUDA card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    rng = np.random.default_rng(7)
    prob = make_problems(rng, 256, 100, 256, True) + (
        np.full(256, 10, np.int32),)
    args = _torch(prob, "cuda")
    before = tb.DP_KERNEL.launches
    got = tb.dp_align(*args, sc=SC)
    assert tb.DP_KERNEL.launches == before + 1
    assert_dp_equal(tb.dp_align_plain(*args, sc=SC), got)


@pytest.mark.cuda
def test_wide_kernels_match_plain():
    """K2 and the traceback kernel against their plain versions, and the
    wide route of dp_align against the plain dp_align and K1 (needs a
    CUDA card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    prob = _wide_problems(33, P=128, Lr=100, Lw=4224)
    args = _torch(prob, "cuda")
    got = tb.dp_forward(*args, sc=SC)
    want = tb._dp_forward_scan(*args, sc=SC)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    active = (got[0] >= 10).cpu().numpy()
    t = tb.dp_traceback(got[4], args[0], args[1], args[2], got[1], got[2],
                        args[4], active)
    p = tb.dp_traceback(want[4].cpu(), *[a.cpu() for a in args[:3]],
                        want[1].cpu(), want[2].cpu(), args[4].cpu(), active)
    for g, w in zip(t, p):
        np.testing.assert_array_equal(g, w)
    cut = torch.full((128,), 10, dtype=torch.int32, device="cuda")
    n0 = tb.FORWARD_KERNEL.launches
    wide = tb.dp_align(*args, cut, sc=SC)
    assert tb.FORWARD_KERNEL.launches == n0 + 1
    assert_dp_equal(tb.dp_align_plain(*args, cut, sc=SC), wide)
    assert_dp_equal(tb.dp_align_cuda(*args, cut, sc=SC), wide)


# the edges of the redesigned forward (csrc/dp_wavefront.cuh): cells per
# lane C = 4 up to Lr = 127 and 8 from 128 (word and lane boundaries at
# 31 / 32 / 33 and 127 / 128), equal best scores on several diagonals
EDGE_CPU = [("Lr31", 31), ("Lr32", 32), ("Lr33", 33), ("Lr127", 127),
            ("Lr128", 128), ("ties", 60)]


@pytest.mark.parametrize("name,Lr", EDGE_CPU, ids=[n for n, _ in EDGE_CPU])
def test_edge_shapes_plain_matches_reference(name, Lr):
    """The plain version at the forward's edge shapes against the JAX
    package's dp_align; the ties case holds equal best scores on two
    diagonals, so the tie-breaks and the tie count decide it."""
    import chip_smoke

    rng = np.random.default_rng(Lr)
    if name == "ties":
        prob = chip_smoke.tie_problems(rng, 12, Lr, 260)
    else:
        prob = make_problems(rng, 12, Lr, Lr + 40, with_anchor=Lr % 2 == 1) \
            + (np.full(12, Lr // 4, np.int32),)
    want = jb.dp_align(*[jnp.asarray(x) for x in prob[:8]], prob[8],
                       sc=jb.DPScores())
    got = tb.dp_align(*_torch(prob), sc=SC)
    assert_dp_equal(want, got, check_width=True)
    if name == "ties":
        # both exact copies score Lr; the unmutated pairs tie
        assert (np.asarray(got[0]) == Lr).all()
        assert (np.asarray(got[3])[1::3] >= 2).all()


EDGE_CARD = ["Lr31", "Lr32", "Lr33", "Lr127", "Lr128", "Lr2047", "ties",
             "anchors_Lr33", "overflow_Lr260"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CARD)
def test_kernel_edges_match_plain(name):
    """K1 against its plain version at chip_smoke.py's edge cases (needs
    a CUDA card; phase 2 runs the same cases): exactly equal, one launch
    of K1 and one of DW each, the overflow case's runs past 128 held by
    the run budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    import chip_smoke

    cases = dict(chip_smoke.edge_cases(np.random.default_rng(11)))
    args = _torch(cases[name], "cuda")
    before, wire = tb.DP_KERNEL.launches, tb.WIRE_KERNEL.launches
    got = tb.dp_align(*args, sc=SC)
    assert tb.DP_KERNEL.launches == before + 1
    assert tb.WIRE_KERNEL.launches == wire + 1
    assert_dp_equal(tb.dp_align_plain(*args, sc=SC), got)
    if name.startswith("overflow"):
        assert (np.asarray(got[6]) > 128).any()


@pytest.mark.cuda
@pytest.mark.parametrize("Lr,with_anchor", [(31, True), (33, False),
                                            (127, True)])
def test_forward_edges_match_plain(Lr, with_anchor):
    """K2 at the forward's edge read lengths and a window of 4,096 and
    more: stats and every direction byte equal the plain scan (needs a
    CUDA card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    prob = make_problems(np.random.default_rng(Lr), 32, Lr, 4200,
                         with_anchor)
    args = _torch(prob, "cuda")
    got = tb.dp_forward(*args, sc=SC)
    want = tb._dp_forward_scan(*args, sc=SC)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the limits of the forward's two forms (chip_smoke.range_cases): reads of
# 255 bases at scores of magnitude 15 (the 16-bit form), one score at 16
# and scores past 15 (the 32-bit form)
RANGE_CARD = ["r16_Lr255_ext15", "r16_Lr255_ext1", "r32_Lr255_match16",
              "r32_Lr255_ext16", "r32_main", "r32_anchors", "r32_window4224"]
RANGE_SCORES = [(15, -15, -15, -15), (15, -15, -15, -1),
                (16, -15, -15, -15), (15, -15, -15, -16)]


@pytest.mark.parametrize("scores", RANGE_SCORES,
                         ids=["ext15", "ext1", "match16", "ext16"])
def test_extreme_scores_plain_matches_reference(scores):
    """The plain version against the JAX package's dp_align on reads of
    255 bases at the 16-bit form's score limits and just past them:
    every base mismatched, the top score, long deletions and
    insertions."""
    import chip_smoke

    prob = chip_smoke.extreme_problems(np.random.default_rng(abs(sum(scores))),
                                       8, 255, 700)
    want = jb.dp_align(*[jnp.asarray(x) for x in prob[:8]], prob[8],
                       sc=jb.DPScores(*scores))
    got = tb.dp_align(*_torch(prob), sc=tb.DPScores(*scores))
    assert_dp_equal(want, got, check_width=True)
    # the planted reads reach the top score, 255 x match
    assert (np.asarray(got[0])[1::4] == 255 * scores[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", RANGE_CARD)
def test_kernel_range_matches_plain(name):
    """K1 (dp_align result) and K2 (stats and every direction byte)
    against their plain versions at the edges of the 16-bit and 32-bit
    forward forms (needs a CUDA card; chip_smoke.py phase 2 runs the
    same cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    import chip_smoke

    cases = {n: (p, s) for n, p, s in
             chip_smoke.range_cases(np.random.default_rng(12))}
    prob, scores = cases[name]
    sc = tb.DPScores(*scores)
    args = _torch(prob, "cuda")
    assert_dp_equal(tb.dp_align_plain(*args, sc=sc),
                    tb.dp_align_cuda(*args, sc=sc))
    got = tb.dp_forward(*args[:8], sc=sc)
    want = tb._dp_forward_scan(*args[:8], sc=sc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
