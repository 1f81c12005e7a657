"""The DP rescue's gapless prescan of the PyTorch port against the JAX
package, on the same numpy inputs: ``_prescan_impl`` (each candidate's
least mismatch count over the valid window offsets, its leftmost offset
and the count of zero-mismatch offsets) and ``gapless_prescan`` around
it, on the CPU, where the port takes ``_prescan_plain`` (its kernel, GP,
runs on the card: the ``cuda``-marked case here and chip_smoke.py's
phase 2 hold it to the plain version). The cases are the prescan's
edges: reads of 1, 15, 16, 17, 31, 32, 33, 100, 120 and 250 bases in one
call, both strands, a reverse complement of another length than the
counted one, no valid offset (wlens < rlens), every offset valid
(wlens - rlens = O - 1 and more), a poly-A read on a poly-A window (the
leftmost of tied offsets), windows that end at the genome's last base or
run past it, one read behind two candidates of different lengths, one
candidate, more candidates than the plain version's chunk, and the
edges of the aligned loads GP reads its rows with (chip_smoke.ROW_EDGES:
rows of 100, 101, 127, 128 and 250 bases, reverse complements of 1, 7-9,
15-17, L - 1, L and L + 5 bases, the batch's last row ending off a
16-byte boundary, code 4 at the first and last bytes of 4- and 16-byte
groups). Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu.pipeline import dp_rescue as jr
from soap3dp_tpu_torch.fm import fmindex as tf
from soap3dp_tpu_torch.kernels import fm_search as fs
from soap3dp_tpu_torch.pipeline import dp_rescue as tr

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

CASES = chip_smoke.PRESCAN_EDGES


@pytest.fixture(scope="module")
def genome():
    """(genome codes, JAX device index, the port's CPU device index) of
    chip_smoke.prescan_genome: 40 kbp holding an 800-base run of A."""
    from soap3dp_tpu.index.builder import build_index
    from tests.test_search import _genome_from_codes
    from tests.test_torch_host_copies import port_index

    codes = chip_smoke.prescan_genome().codes
    jidx = build_index(_genome_from_codes(codes), sa_rate=8)
    return codes, jf.device_index(jidx), tf.device_index(port_index(jidx),
                                                         "cpu")


def jax_prescan(c: dict, jd) -> np.ndarray:
    """The reference's _prescan_impl, with gapless_prescan's types."""
    return np.asarray(jr._prescan_impl(
        jd, jnp.asarray(c["reads"]), jnp.asarray(c["lens_rows"]),
        jnp.asarray(c["read_idx"].astype(np.int32)),
        jnp.asarray(c["strand"]), jnp.asarray(c["ws"].astype(np.uint32)),
        jnp.asarray(c["rlens"]), jnp.asarray(c["wlens"]), O=c["O"],
        W=c["W"])).astype(np.int64)


@pytest.mark.parametrize("name", CASES)
def test_prescan_impl_equal(genome, name):
    codes, jd, td = genome
    c = chip_smoke.prescan_edge_case(name, codes)
    want = jax_prescan(c, jd)
    got = tr._prescan_impl(*chip_smoke.prescan_args(c, td, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    # the case is the edge it names
    mm, best, n0 = want.T
    room = c["wlens"].astype(np.int64) - c["rlens"]
    if name == "no_valid":
        assert (room < 0).all() and (mm == 1 << 20).all()
        assert not best.any() and not n0.any()
    elif name == "full_room":
        assert (room >= c["O"] - 1).all() and (room == c["O"] - 1).any()
    elif name == "poly_a":
        assert not mm.any() and not best.any()
        np.testing.assert_array_equal(n0, np.minimum(room, c["O"] - 1) + 1)
    elif name == "genome_end":
        assert (c["ws"][:-1] + c["wlens"][:-1] == len(codes)).all()
        assert not mm[:-1].any()  # the genome's last bases, found
    elif name in ("mixed_lengths", "rc_length_apart"):
        assert set(c["rlens"]) == set(chip_smoke.PRESCAN_MIXED)
        assert (mm < 1 << 20).all() and (best > 0).any()
        if name == "mixed_lengths":
            assert set(c["strand"]) == {0, 1}
        else:
            assert (c["lens_rows"] != c["rlens"]).any()
    elif name == "shared_read":
        assert len(set(c["rlens"][c["read_idx"] == 0])) > 1
    elif name == "above_chunk":
        assert len(c["ws"]) > tr._PRESCAN_CHUNK
    elif name in chip_smoke.ROW_EDGES:
        B, L = c["reads"].shape
        assert B % 2 and ((B * L) % 16 or L == 128)  # the last row's end
        assert set(chip_smoke.rc_edge_lengths(L)) <= set(c["lens_rows"])
        for s in (0, 1):
            assert set(c["read_idx"][c["strand"] == s]) == set(range(B))
        assert (mm < 1 << 20).all()
        if name == "code_4_groups":  # code 4 at base 0: never a 0
            assert (c["reads"][:, list(chip_smoke.ROW_GROUP_EDGES)]
                    == 4).all() and mm.min() > 0
        else:  # the rows cut from the genome, found
            assert (mm == 0).sum() > B * 3 // 4


@pytest.mark.parametrize("name", ["mixed_lengths", "shared_read", "one",
                                  "above_chunk"])
def test_gapless_prescan_equal_at_edges(genome, name):
    """gapless_prescan around it: the per-read reverse-complement lengths
    it makes, its padding (JAX) and chunks (the port's plain version)."""
    codes, jd, td = genome
    c = chip_smoke.prescan_edge_case(name, codes)
    cand = (c["read_idx"].astype(np.int32), c["strand"], c["ws"])
    args = (c["reads"], c["rlens"])
    a = jr.gapless_prescan(jd, *args, jr.Candidates(*cand), c["ws"],
                           c["wlens"], int(c["wlens"].max()))
    b = tr.gapless_prescan(td, *args, tr.Candidates(*cand), c["ws"],
                           c["wlens"], int(c["wlens"].max()))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_prescan_kernel_refuses_cpu_tensors(genome):
    codes, _, td = genome
    a = chip_smoke.prescan_args(
        chip_smoke.prescan_edge_case("one", codes), td, "cpu")
    src = fs.oriented_rows(a[1], a[1].shape[1], None)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fs.prescan(td, src, a[2], a[3])


def test_prescan_kernel_refuses_packed_rows(genome):
    """GP reads code rows only: packed words are refused before any
    launch, on any device; and rows that carry their own lengths, since
    GP takes each reverse complement's length from its candidate's
    words."""
    codes, _, td = genome
    a = chip_smoke.prescan_args(
        chip_smoke.prescan_edge_case("one", codes), td, "cpu")
    B, L = a[1].shape
    src = fs.oriented_rows(torch.zeros((B, (L + 15) // 16), dtype=torch.int32),
                           L, None)
    with pytest.raises(ValueError, match="code rows, not packed"):
        fs.prescan(td, src, a[2], a[3])
    src = fs.oriented_rows(a[1], L, torch.full((B,), L, dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths from its words"):
        fs.prescan(td, src, a[2], a[3])


# window starts (a candidate's words carry them as two u32 words): on
# either side of 2^31 and 2^32, and near the largest a 63-bit start holds
WORD_STARTS = (0, 15, (1 << 31) - 1, 1 << 31, (1 << 32) - 16, 1 << 32,
               (1 << 32) + 17, 3_100_000_123, (1 << 62) + 5)


@pytest.mark.parametrize("O", [384, 4224, 8320])
def test_prescan_words_round_trip(O):
    """rescue_words packs GP's candidates and rescue_fields, the plain
    version's reading of them, gives every field back: both strands,
    window starts past 2^31 and 2^32, reads of 1-250 bases, reverse
    complements past the row, windows up to O and past it, and a window
    shorter than its read (no valid offset)."""
    rng = np.random.default_rng(O)
    M = 300
    read = rng.integers(0, (1 << 31) - 1, M)
    read[:3] = (0, 1, (1 << 31) - 1)
    rev = np.arange(M) % 2 == 1
    ws = rng.integers(0, 1 << 40, M)
    ws[:len(WORD_STARTS)] = WORD_STARTS
    rlen = rng.integers(1, 251, M)
    rlen[:4] = (1, 16, 17, 250)
    rc_len = rlen + rng.integers(-3, 6, M)
    wlen = rlen + rng.integers(-20, O + 40, M)
    wlen[-1] = O + 250
    words = tr.rescue_words(read, rev, ws, rc_len, rlen, wlen)
    assert words.dtype == np.int32 and words.shape == (M, fs.GP_WORDS)
    got = [t.numpy() for t in tr.rescue_fields(torch.from_numpy(words))]
    for g, w in zip(got, (read, rev, ws, rc_len, rlen, wlen)):
        np.testing.assert_array_equal(g, w)
    # the words as the kernel reads them: bit 31 the strand, then the
    # start's low and high 32 bits
    u = words.view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(u[:, 0] >> 31, rev)
    np.testing.assert_array_equal(u[:, 1] + (u[:, 2] << 32), ws)


@pytest.mark.parametrize("name", ["shared_read", "above_chunk"])
def test_gapless_prescan_uploads_and_result(genome, monkeypatch, name):
    """A gapless_prescan call makes one upload (stage_to_device) of two
    arrays, the reads and one block of the candidates' words (an int32
    row of GP_WORDS each, a reverse complement as long as its read's last
    candidate says), and its result is int32, equal to the JAX package's
    field by field."""
    codes, jd, td = genome
    c = chip_smoke.prescan_edge_case(name, codes)
    cand = (c["read_idx"].astype(np.int32), c["strand"], c["ws"])
    ups = []
    up = tr.stage_to_device

    def spy(arrays, device):
        ups.append([np.asarray(a) for a in arrays])
        return up(arrays, device)

    monkeypatch.setattr(tr, "stage_to_device", spy)
    b = tr.gapless_prescan(td, c["reads"], c["rlens"], tr.Candidates(*cand),
                           c["ws"], c["wlens"], int(c["wlens"].max()))
    monkeypatch.undo()
    a = jr.gapless_prescan(jd, c["reads"], c["rlens"], jr.Candidates(*cand),
                           c["ws"], c["wlens"], int(c["wlens"].max()))
    assert len(ups) == 1 and len(ups[0]) == 2
    reads_up, words_up = ups[0]
    np.testing.assert_array_equal(reads_up, c["reads"])
    M = len(c["ws"])
    assert words_up.dtype == np.int32 and words_up.shape == (M, fs.GP_WORDS)
    read, rev, ws, rc_len, rlen, wlen = (
        t.numpy() for t in tr.rescue_fields(torch.from_numpy(words_up)))
    lens_rows = np.zeros(len(c["reads"]), np.int32)
    lens_rows[c["read_idx"]] = c["rlens"]
    np.testing.assert_array_equal(rc_len, lens_rows[c["read_idx"]])
    for g, w in ((read, c["read_idx"]), (rev, c["strand"] == 1),
                 (ws, c["ws"]), (rlen, c["rlens"]), (wlen, c["wlens"])):
        np.testing.assert_array_equal(g, w)
    for x, y in zip(a, b):
        assert y.dtype == np.int32 and y.shape == (M,)
        np.testing.assert_array_equal(np.asarray(x), y)


def test_prescan_impl_routes_cpu_to_plain(genome, monkeypatch):
    codes, _, td = genome
    args = chip_smoke.prescan_args(
        chip_smoke.prescan_edge_case("shared_read", codes), td, "cpu")
    calls = []
    plain = tr._prescan_plain

    def spy(*a):
        calls.append(a[1].device.type)
        return plain(*a)

    def no_kernel(*a, **kw):
        raise AssertionError("a CPU tensor reached the GP kernel")

    monkeypatch.setattr(tr, "_prescan_plain", spy)
    monkeypatch.setattr(fs, "prescan", no_kernel)
    got = tr._prescan_impl(*args)
    assert calls == ["cpu"]
    assert torch.equal(got, plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_prescan_kernel_on_card(genome, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codes, _, td = genome
    dev = torch.device("cuda", 0)
    card = tf.DeviceIndex(**{k: v.to(dev) if isinstance(v, torch.Tensor)
                             else v for k, v in vars(td).items()})
    args = chip_smoke.prescan_args(chip_smoke.prescan_edge_case(name, codes),
                                 card, dev)
    n0 = fs.PRESCAN_KERNEL.launches
    got = tr._prescan_impl(*args)
    assert fs.PRESCAN_KERNEL.launches == n0 + 1
    assert torch.equal(got.cpu(), tr._prescan_plain(*args).cpu())
