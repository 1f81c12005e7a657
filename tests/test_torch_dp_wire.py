"""The DP rescue's result wire in the PyTorch port: K1's runs as packed
words, DW (the wire: header, stats rows, the passing lanes' runs) and
the host parse, held to the JAX package with tolerance zero (scores,
cells, counts and run words are integers):

* the plain K1 outputs against ``_dp_align_pallas_call`` in interpret
  mode (its stats and its runs, word for word, overflowed lanes too),
  and the plain wire's runs against ``_gather_runs_u16`` over the same
  passing lanes;
* dp_align on CPU tensors, through the wire and its parse, against the
  JAX package's dp_align and the plain forward and traceback's own
  tuple; the wide route's runs against the JAX dp_traceback's; counts of
  exactly 4,095 (16-bit words) and past it (32-bit words);
* no lane passing, every lane passing, pad lanes; alignments past 128
  runs; a mesh of two CPU shards.

The kernels (K1, TB, DW) run only on a card: the tests marked ``cuda``
skip here (chip_smoke.py runs the same checks on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from soap3dp_tpu.kernels import banded_dp as jb
from soap3dp_tpu_torch.distributed import mesh as tmesh
from soap3dp_tpu_torch.kernels import banded_dp as tb
from tests.test_dp import make_problems
from tests.test_torch_dp import assert_dp_equal

torch.set_num_threads(1)

SC = tb.DPScores()


def _torch(prob, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in prob]


def _plain_tuple(args, sc=SC):
    """dp_align's tuple straight from the plain forward and traceback,
    without the wire (what the plain dp_align returned before it)."""
    bS, bI, bJ, bC, dirs = tb._dp_forward_scan(*args[:8], sc=sc)
    active = (bS >= args[8]).numpy()
    ops, cnts, nrun, startj = tb._dp_traceback_plain(dirs, args[1], bI, bJ,
                                                     args[4], active)
    return (bS.numpy(), bI.numpy(), bJ.numpy(), bC.numpy(), ops, cnts,
            nrun, startj.astype(np.int64), np.zeros(len(nrun), bool))


def _jax_align(prob, sc=jb.DPScores()):
    return jb.dp_align(*[jnp.asarray(x) for x in prob[:8]], prob[8], sc=sc)


def _params(prob):
    return torch.from_numpy(tb.pack_params(prob[1], *prob[3:9]))


@pytest.mark.parametrize("with_anchor", [False, True])
@pytest.mark.parametrize("mr", [None, 8])
def test_k1_words_and_wire_match_pallas_interpret(with_anchor, mr):
    """The plain K1 outputs at the TPU kernel's run budget (and at a
    budget of 8, where lanes overflow) equal the kernel's own stats and
    packed runs in interpret mode, word for word; the plain wire's runs
    equal _gather_runs_u16 over the lanes that pass and did not
    overflow, each row cut to its nrun."""
    rng = np.random.default_rng(21 + with_anchor)
    P, Lr, Lw = 64, 40, 70
    prob = make_problems(rng, P, Lr, Lw, with_anchor) + (
        np.full(P, 10, np.int32),)
    mr = mr or jb.MAX_RUNS
    stats, runs = jb._dp_align_pallas_call(
        *[jnp.asarray(x) for x in prob[:8]], jnp.asarray(prob[8]),
        jb.DPScores(), pt=jb.PALLAS_P_TILE, mr=mr, interpret=True)
    stats, runs = np.asarray(stats), np.asarray(runs)
    t = _torch(prob)
    params = _params(prob)
    got_stats, got_runs = tb._k1_plain(t[0], t[2], params, mr, 16, SC)
    np.testing.assert_array_equal(got_stats.numpy(), stats)
    np.testing.assert_array_equal(got_runs.numpy().astype(np.int64), runs)
    assert (stats[:, 6] != 0).any() == (mr == 8)

    wire = tb.dp_wire_plain(params, got_stats, got_runs).numpy()
    npass = (stats[:, 0] >= prob[8]) & (stats[:, 5] > 0) & (stats[:, 6] == 0)
    pass_idx = np.flatnonzero(npass)
    sub = np.asarray(jb._gather_runs_u16(jnp.asarray(runs),
                                         jnp.asarray(pass_idx)))
    want = np.concatenate([sub[k, :stats[p, 5]]
                           for k, p in enumerate(pass_idx)])
    k = tb.WIRE_HEADER + tb.STATS_WORDS * P
    assert wire[:tb.WIRE_HEADER].tolist() == [
        len(pass_idx), int((stats[:, 6] != 0).sum()), len(want), len(wire)]
    np.testing.assert_array_equal(wire[tb.WIRE_HEADER:k].reshape(P, 8),
                                  stats)
    np.testing.assert_array_equal(wire[k:].view(np.uint16)[:len(want)],
                                  want)
    assert len(wire[k:]) == -(-len(want) // 2)


@pytest.mark.parametrize("with_anchor", [False, True])
def test_dp_align_through_the_wire(with_anchor):
    """dp_align on CPU tensors goes through the plain wire and its parse:
    equal to the JAX dp_align (widths included) and to the tuple of the
    plain forward and traceback without the wire."""
    rng = np.random.default_rng(31 + with_anchor)
    P, Lr, Lw = 48, 36, 90
    prob = make_problems(rng, P, Lr, Lw, with_anchor) + (
        np.full(P, 8, np.int32),)
    got = tb.dp_align(*_torch(prob), sc=SC)
    assert_dp_equal(_jax_align(prob), got, check_width=True)
    assert_dp_equal(_plain_tuple(_torch(prob)), got, check_width=True)
    assert 0 < (np.asarray(got[6]) > 0).sum() < P


@pytest.mark.parametrize("case", ["none", "all", "pad"])
def test_none_all_and_pad_lanes(case):
    """No lane passing (an empty runs section, ops one column of zeros),
    every lane passing, and pad lanes at run_banded_dp's unreachable
    cutoff (1 << 20) beside real ones."""
    rng = np.random.default_rng(41)
    P, Lr, Lw = 24, 30, 64
    prob = make_problems(rng, P, Lr, Lw)
    cut = {"none": np.full(P, 1 << 20), "all": np.full(P, -1000),
           "pad": np.where(np.arange(P) < 16, 6, 1 << 20)}[case]
    prob = prob + (cut.astype(np.int32),)
    got = tb.dp_align(*_torch(prob), sc=SC)
    assert_dp_equal(_jax_align(prob), got, check_width=True)
    nrun = np.asarray(got[6])
    if case == "none":
        assert not nrun.any() and got[4].shape == (P, 1)
    elif case == "all":
        assert (nrun > 0).all()
    else:
        assert not nrun[16:].any() and nrun[:16].any()
    stats, runs = tb._k1_plain(*_torch(prob)[0:3:2], _params(prob),
                               tb.run_budget(Lr, Lw), 16, SC)
    wire = tb.dp_wire_plain(_params(prob), stats, runs)
    assert wire[0] == (nrun > 0).sum() and wire[2] == nrun.sum()


def _long_deletion(Lw: int):
    """Two problems in windows of Lw: a 1-base read whose best alignment
    is one deletion of Lw bases (anchored at both window ends, its
    mismatch dearer than the gap's open), and a 4-base exact match."""
    P, Lr = 2, 4
    reads = np.zeros((P, Lr), np.uint8)
    reads[1] = 1
    wins = np.ones((P, Lw), np.uint8)
    return (reads, np.array([1, 4], np.int32), wins,
            np.full(P, Lw, np.int32), np.array([1, 0], np.int32),
            np.zeros(P, np.int32), np.array([0, Lw + 1], np.int32),
            np.array([Lw, 0], np.int32), np.array([-50000, 0], np.int32))


@pytest.mark.parametrize("Lw", [4095, 4097])
def test_counts_at_and_past_4095(Lw):
    """A deletion of 4,095 bases on K1's route (16-bit words: the count
    the word's 12 bits hold exactly) and of 4,097 on the wide route
    (32-bit words), exact through the wire and its parse, equal to the
    JAX dp_align."""
    sc = tb.DPScores(1, -9, -3, -1)
    prob = _long_deletion(Lw)
    assert tb.word_bits(4, Lw) == (16 if Lw < 4096 else 32)
    assert tb.takes_wide_route(4, Lw) == (Lw >= 4096)
    got = tb.dp_align(*_torch(prob), sc=sc)
    assert_dp_equal(_jax_align(prob, jb.DPScores(1, -9, -3, -1)), got,
                    check_width=True)
    assert (got[4][0, :2].tolist(), got[5][0, :2].tolist()) == (
        [tb.OP_DEL, tb.OP_CLIP], [Lw, 1])


def test_parse_keeps_32_bit_counts_and_refuses_bad_wires():
    """A synthetic wire of 32-bit words with counts past 4,095 parses
    exactly; an overflowed lane or a header that disagrees with its
    stats raises."""
    params, stats, runs = chip_smoke.wire_edge_case("words32")
    params, stats, runs = (torch.from_numpy(x) for x in (params, stats, runs))
    stats[:, 6] = 0
    wire = tb.dp_wire_plain(params, stats, runs).numpy()
    n = len(stats)
    k = tb.WIRE_HEADER + tb.STATS_WORDS * n
    out = tb.parse_wire(wire[:k], wire[k:], 32, params[:, 6].numpy())
    passing = (stats[:, 0] >= params[:, 6]) & (stats[:, 5] > 0)
    for p in np.flatnonzero(passing.numpy())[:50]:
        m = int(stats[p, 5])
        w = runs[p, :m].numpy().astype(np.int64)
        assert out[4][p, :m].tolist() == (w >> 28).tolist()
        assert out[5][p, :m].tolist() == (w & ((1 << 28) - 1)).tolist()
    assert out[5].max() > 4095
    bad = wire.copy()
    bad[2] += 1
    with pytest.raises(RuntimeError):
        tb.parse_wire(bad[:k], bad[k:], 32, params[:, 6].numpy())
    stats[int(np.flatnonzero(passing.numpy())[0]), 6] = 1
    wire = tb.dp_wire_plain(params, stats, runs).numpy()
    with pytest.raises(RuntimeError):
        tb.parse_wire(wire[:k], wire[k:], 32, params[:, 6].numpy())


def test_wide_route_runs_match_jax_traceback():
    """The wide route's plain runs (TB's plain version through the wire)
    at a window of 4,100 equal the JAX dp_traceback's on the same
    directions."""
    rng = np.random.default_rng(51)
    P, Lr, Lw = 6, 60, 4100
    prob = make_problems(rng, P, Lr, Lw, with_anchor=True)
    jargs = [jnp.asarray(x) for x in prob]
    bS, bI, bJ, _, dirs = jb.dp_forward(*jargs, sc=jb.DPScores())
    active = np.asarray(bS) >= 0
    want = jb.dp_traceback(dirs, jargs[0], jargs[1], jargs[2], bI, bJ,
                           jargs[4], jnp.asarray(active))
    t = _torch(prob)
    got = tb.dp_traceback(torch.from_numpy(np.array(dirs)), t[0], t[1],
                          t[2], torch.from_numpy(np.array(bI)),
                          torch.from_numpy(np.array(bJ)), t[4], active)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert active.sum() >= 3


def test_runs_past_128_within_the_budget():
    """Alignments of ~2 Lr runs (the traceback's first budget of 128
    before the run budget re-launched them) at a wide window: equal to
    the JAX dp_align, wider than 128 and within run_budget, which they
    nearly reach."""
    sc = tb.DPScores(1, -2, -1, -1)
    prob = chip_smoke.relaunch_problems(np.random.default_rng(61), 3, 127,
                                        4100)
    got = tb.dp_align(*_torch(prob), sc=sc)
    assert_dp_equal(_jax_align(prob, jb.DPScores(1, -2, -1, -1)), got,
                    check_width=True)
    nrun = np.asarray(got[6])
    assert (nrun > 128).all() and (nrun <= tb.run_budget(127, 4100)).all()
    assert nrun.max() >= 2 * 127 - 4
    assert got[4].shape[1] == nrun.max()


def test_run_budget_and_word_bits():
    assert tb.run_budget(120, 256) == 246
    assert tb.run_budget(10, 5) == 19
    assert tb.word_bits(120, 4095) == 16
    assert tb.word_bits(120, 4096) == 32
    assert tb.word_bits(2047, 2100) == 16
    rng = np.random.default_rng(71)
    for Lr, Lw, cut in ((20, 30, -1000), (33, 50, -1000), (12, 14, -100)):
        prob = make_problems(rng, 32, Lr, Lw) + (np.full(32, cut, np.int32),)
        got = tb.dp_align(*_torch(prob), sc=tb.DPScores(1, -1, -1, -1))
        assert np.asarray(got[6]).max() <= tb.run_budget(Lr, Lw)


def test_packed_shards_on_a_mesh_of_two_cpus():
    """dp_align_shards over two CPU shards in the packed form
    run_banded_dp gives (reads, wins, params, host cutoffs), and
    dp_align(mesh=) over two CPU replicas, equal to one dp_align."""
    rng = np.random.default_rng(81)
    P = 21
    prob = make_problems(rng, P, 30, 80) + (np.full(P, 6, np.int32),)
    whole = tb.dp_align(*_torch(prob), sc=SC)
    params = tb.pack_params(prob[1], *prob[3:9])
    t = _torch(prob)
    shards = [(t[0][s], t[2][s], torch.from_numpy(params[s]), params[s, 6])
              for s in (slice(0, 11), slice(11, P))]
    assert_dp_equal(whole, tb.dp_align_shards(shards, SC))
    got = tb.dp_align(*t, sc=SC, mesh=tmesh.make_mesh(["cpu"] * 2))
    assert_dp_equal(whole, got)


def test_wire_edge_cases_plain():
    """DW's edges (chip_smoke.wire_edge_case) through the plain wire: the
    header counts the passing and the overflowed lanes, the runs section
    holds exactly the passing lanes' words, an odd 16-bit count ends in a
    zero half."""
    for name, (n, MR, bits) in chip_smoke.WIRE_EDGES.items():
        params, stats, runs = (torch.from_numpy(x)
                               for x in chip_smoke.wire_edge_case(name))
        assert runs.shape == (n, MR)
        wire = tb.dp_wire_plain(params, stats, runs).numpy()
        score, nrun, of = stats[:, 0], stats[:, 5], stats[:, 6]
        traced = score >= params[:, 6]
        passing = (traced & (nrun > 0) & (of == 0)).numpy()
        words = int(nrun.numpy()[passing].sum())
        head = wire[:4].tolist()
        assert head == [passing.sum(), int((traced & (of != 0)).sum()),
                        words, len(wire)], name
        body = wire[4 + 8 * n:]
        if bits == 16:
            assert len(body) == -(-words // 2)
            if words % 2:
                assert body.view(np.uint16)[-1] == 0
        if name == "none_passing":
            assert head[0] == 0 and len(body) == 0
        if name == "all_passing":
            assert head[0] == n
        if name == "overflow_lanes":
            assert head[1] > 0
        if name == "ragged_4097_odd":
            assert words % 2 == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.WIRE_EDGES))
def test_dw_matches_plain_on_the_card(name):
    """DW against its plain version at its edges, every word of the wire
    (needs a CUDA card; chip_smoke.py phase 2 runs the same cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    params, stats, runs = (torch.from_numpy(x).cuda()
                           for x in chip_smoke.wire_edge_case(name))
    want = tb.dp_wire_plain(params, stats, runs)
    got = tb.dp_wire(params, stats, runs)[:len(want)].cpu()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Lw", [256, 4224])
def test_routes_match_plain_on_the_card(Lw):
    """K1 + DW (Lw 256) and K2 + TB + DW (Lw 4,224) through dp_align
    against the plain dp_align, one DW launch a call (needs a CUDA
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    prob = chip_smoke.main_path_problems(np.random.default_rng(91), 256,
                                         120, Lw, read_len=100)
    args = _torch(prob, "cuda")
    n0 = tb.WIRE_KERNEL.launches
    got = tb.dp_align(*args, sc=SC)
    assert tb.WIRE_KERNEL.launches == n0 + 1
    assert_dp_equal(tb.dp_align_plain(*args, sc=SC), got, check_width=True)


def test_wire_tiles_and_words():
    """DW's tiles: one for no lanes (it writes the header), one up to a
    tile of WIRE_TILE lanes, one more one past it, 16,384 at 2^20 lanes;
    WIRE_TILE is the kernel's TILE; the wire's words, and a wire past
    2^31 words refused."""
    import os
    import re

    src = os.path.join(os.path.dirname(tb.__file__), "..", "csrc",
                       "dp_wire.cu")
    with open(src) as fh:
        tile = int(re.search(r"constexpr int TILE = (\d+);", fh.read())[1])
    assert tb.WIRE_TILE == tile == 64
    assert [tb.wire_tiles(n) for n in (0, 1, 63, 64, 65, 128, 129)] == [
        1, 1, 1, 1, 2, 2, 3]
    assert tb.wire_tiles(16384) == 256
    assert tb.wire_tiles(1 << 20) == 16384
    assert tb.wire_words(0, 5, 16) == tb.WIRE_HEADER
    assert tb.wire_words(3, 5, 16) == 4 + 24 + 8
    assert tb.wire_words(3, 5, 32) == 4 + 24 + 15
    assert tb.wire_words(16384, 246, 16) == 4 + 8 * 16384 + 16384 * 123
    with pytest.raises(ValueError):
        tb.wire_words(1 << 20, 4100, 32)
    wire, runs = tb._wire_buffers(3, 5, 16, torch.device("cpu"))
    assert wire.numel() == tb.wire_words(3, 5, 16)
    assert runs.shape == (3, 5) and runs.dtype == torch.int16


def test_dw_scan_state_on_the_cpu():
    """DW's look-back state (_wire_scan) is the scan state FS4 and FS5
    keep for each card and stream (fm_search.gen_state "scan", 2 words
    a tile after the ticket counter: the tiles' statuses and their lanes
    words): a call of n lanes takes the next generation (its tag, << 2) and
    wire_tiles(n) tickets after the ones earlier calls took on that
    stream, whatever kernel took them; a call larger than the state
    makes it anew, larger, its generations and tickets from 0."""
    from soap3dp_tpu_torch.kernels import fm_search as fs

    cpu = torch.device("cpu")
    stream = 9021
    key = ("scan", None, stream)
    fs._STATES.pop(key, None)
    try:
        fs.gen_state("scan", cpu, stream, 513, 512)  # an FS5 call's
        gen, taken = 1, 512
        for n in (1, 65, 16384, 3):
            scan, tag, base = tb._wire_scan(cpu, stream, n)
            gen += 1
            assert (tag, base) == (gen << 2, taken), n
            assert scan.numel() == 513 and not scan.any()
            taken += tb.wire_tiles(n)
        assert fs._STATES[key][1:] == [gen, taken]
        scan, tag, base = tb._wire_scan(cpu, stream, 1 << 20)
        assert (tag, base, scan.numel()) == (1 << 2, 0, 2 * 16384 + 1)
        assert fs._STATES[key][1:] == [1, 16384]
        assert tb._wire_scan(cpu, stream + 1, 64)[1:] == (1 << 2, 0)
    finally:
        fs._STATES.pop(key, None)
        fs._STATES.pop(("scan", None, stream + 1), None)


def test_dp_wire_refuses_cpu_tensors_and_bad_wires():
    """dp_wire takes CUDA tensors only (dp_wire_plain is the CPU's); DW's
    launcher refuses a wire too short for its runs, or a wire or params
    off a 16-byte boundary, before it builds or launches anything."""
    params, stats, runs = (torch.from_numpy(x)
                           for x in chip_smoke.wire_edge_case("ragged_2049"))
    with pytest.raises(ValueError, match="CUDA"):
        tb.dp_wire(params, stats, runs)
    n, MR = runs.shape
    short = torch.zeros(tb.wire_words(n, MR, 16) - 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needed"):
        tb._launch_wire(params, runs, short)
    wire = torch.zeros(tb.wire_words(n, MR, 16) + 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        tb._launch_wire(params, runs, wire[1:])
    flat = torch.zeros(8 * n + 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        tb._launch_wire(flat[1:1 + 8 * n].view(n, 8), runs, wire[:-4])


def test_dw_sequence_plain():
    """The shapes of DW's calls in a row (chip_smoke.DW_SEQUENCE) through
    the plain wire: each header counts its passing and overflowed lanes
    and its words, grows and shrinks across the kernel's tile, and
    holds every word of both widths."""
    seq = chip_smoke.DW_SEQUENCE
    assert len(seq) == 20 and {b for _, _, b in seq} == {16, 32}
    tiles = [tb.wire_tiles(n) for n, _, _ in seq]
    assert min(tiles) == 1 and max(tiles) > 256
    assert any(a > b for a, b in zip(tiles, tiles[1:]))
    for k, shape in enumerate(seq):
        params, stats, runs = (torch.from_numpy(x) for x in
                               chip_smoke.wire_edge_case("random", 100 + k,
                                                         shape))
        assert tuple(runs.shape) == shape[:2]
        wire = tb.dp_wire_plain(params, stats, runs).numpy()
        traced = stats[:, 0] >= params[:, 6]
        passing = traced & (stats[:, 5] > 0) & (stats[:, 6] == 0)
        assert wire[:3].tolist() == [
            int(passing.sum()), int((traced & (stats[:, 6] != 0)).sum()),
            int(stats[:, 5][passing].sum())], shape
        assert len(wire) == wire[3] == tb.WIRE_HEADER + 8 * shape[0] + -(
            -int(wire[2]) * shape[2] // 32)


@pytest.mark.cuda
def test_dw_calls_in_a_row_on_the_card():
    """DW's 20 calls in a row on one stream, shapes growing and shrinking
    (chip_smoke.dw_repeat_check), each wire word for word against
    dp_wire_plain; the calls took one generation each and their tiles'
    tickets (needs a CUDA card; chip_smoke.py phase 2 runs the same
    check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    res = chip_smoke.dw_repeat_check(torch.device("cuda", 0))
    assert all(res["equal"]) and len(res["equal"]) == 20
    assert (res["generations"], res["tickets"]) == (20, res["tiles"])


@pytest.mark.cuda
def test_dw_two_threads_on_two_streams():
    """DW from two host threads at once, each on a stream of its own
    (chip_smoke.dw_thread_check), every wire word for word against
    dp_wire_plain, each stream with a scan state of its own (needs a
    CUDA card; chip_smoke.py phase 2 runs the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check")
    res = chip_smoke.dw_thread_check(torch.device("cuda", 0))
    assert all(res["equal"]) and len(res["equal"]) == 20
    assert res["states"] == 2
