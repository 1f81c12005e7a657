"""The DP rescue's problem pack of the PyTorch port against the JAX
package, on the same numpy inputs: ``_pack_problems`` (each problem's
read oriented by its strand, and its genome window as 2-bit codes), on
the CPU, where the port takes ``_pack_problems_plain`` (its kernel, PK,
runs on the card: the ``cuda``-marked case here and chip_smoke.py's
phase 2 hold it to the plain version). The cases are the pack's edges
(chip_smoke.pack_edge_case), both strands in each: every read of one
length (the uniform branch) and lengths of 0-120 (the ragged one, bytes
past a length not zero), windows that end at the text's last base, run
past it or start past pac's last word, window starts on a word (a shift
of 0), max_win of 1, 16, 17 and 4,224, reads holding code 4, pad
problems, and the edges of the aligned loads PK reads its rows with
(chip_smoke.ROW_EDGES: rows of 100, 101, 127, 128 and 250 bases,
reverse complements of 1, 7-9, 15-17, L - 1, L and L + 5 bases, the
batch's last row ending off a 16-byte boundary, code 4 at the first and
last bytes of 4- and 16-byte groups). Tolerance: none, the outputs are
codes.
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

CASES = chip_smoke.PACK_EDGES


@pytest.fixture(scope="module")
def genome():
    """(genome codes, JAX device index, the port's CPU device index) of
    chip_smoke.prescan_genome (40 kbp)."""
    from soap3dp_tpu.index.builder import build_index
    from tests.test_search import _genome_from_codes
    from tests.test_torch_host_copies import port_index

    codes = chip_smoke.prescan_genome().codes
    jidx = build_index(_genome_from_codes(codes), sa_rate=8)
    return codes, jf.device_index(jidx), tf.device_index(port_index(jidx),
                                                         "cpu")


def jax_pack(c: dict, jd) -> tuple[np.ndarray, np.ndarray]:
    """The reference's _pack_problems, with run_banded_dp's types."""
    oriented, wins = jr._pack_problems(
        jd, jnp.asarray(c["reads"]), jnp.asarray(c["lens"], np.int32),
        jnp.asarray(c["cread"].astype(np.int32)), jnp.asarray(c["strand"]),
        jnp.asarray(c["win_start"].astype(np.uint32)), un=c["un"],
        max_win=c["max_win"])
    return np.asarray(oriented), np.asarray(wins)


def _case(genome, name):
    codes, _, td = genome
    return chip_smoke.pack_edge_case(name, len(codes), td.pac.shape[0])


@pytest.mark.parametrize("name", CASES)
def test_pack_problems_equal(genome, name):
    codes, jd, td = genome
    c = _case(genome, name)
    want = jax_pack(c, jd)
    got = tr._pack_problems(*chip_smoke.pack_args(c, td, "cpu"))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    # the case is the edge it names
    ws, W = c["win_start"], c["max_win"]
    assert set(c["strand"]) == {False, True}
    assert want[1].shape == (len(ws), W)
    if name == "uniform":
        assert c["un"] and (c["lens"] == c["un"]).all()
    else:
        assert not c["un"] and len(set(c["lens"])) > 10
    if name == "ragged":
        # bytes past a length: as stored forward, 0 in the reverse
        short = c["cread"] < 8
        assert short.any() and c["reads"][:8, 100:].any()
    if name == "text_end":
        n_text, n_pac = len(codes), td.pac.shape[0]
        assert (ws + W == n_text).any() and (ws + W > n_text).any()
        assert (ws >> 4 >= n_pac).any()
        # past pac: the last word's bases again
        w = int(td.pac[-1]) & 0xFFFFFFFF
        word = np.array([(w >> (2 * k)) & 3 for k in range(16)], np.uint8)
        past = want[1][ws >> 4 >= n_pac]
        assert (past == np.tile(word, W // 16 + 1)[:W]).all()
    if name == "shift_0":
        assert not (ws & 15).any()
    if name.startswith("win_"):
        assert W == int(name[4:])
    if name == "code_4":
        assert (c["reads"] == 4).any() and (want[0] == 255).any()
    if name in chip_smoke.ROW_EDGES:
        B, L = c["reads"].shape
        assert B % 2 and ((B * L) % 16 or L == 128)  # the last row's end
        assert set(chip_smoke.rc_edge_lengths(L)) <= set(c["lens"])
        for s in (False, True):
            assert set(c["cread"][c["strand"] == s]) == set(range(B))
        if name.startswith("width_"):
            assert L == int(name[6:])
        if name == "code_4_groups":
            edges = list(chip_smoke.ROW_GROUP_EDGES)
            assert (c["reads"][:, edges] == 4).all()
            assert (want[0][c["strand"]][:, edges] == 255).any()
    if name == "pad_problems":
        assert not c["cread"][-32:].any() and not c["strand"][-32:].any()
        assert not ws[-32:].any()


def test_pack_kernel_refuses_cpu_tensors(genome):
    a = chip_smoke.pack_args(_case(genome, "ragged"), genome[2], "cpu")
    src = fs.oriented_rows(a[1], a[1].shape[1], None)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fs.pack_problems(a[0], src, a[2], a[3])


def test_pack_kernel_refuses_packed_rows(genome):
    """PK reads code rows only: packed words are refused before any
    launch, on any device; and rows that carry their own lengths, since
    PK takes each reverse complement's length from its problem's
    words."""
    a = chip_smoke.pack_args(_case(genome, "ragged"), genome[2], "cpu")
    B, L = a[1].shape
    src = fs.oriented_rows(torch.zeros((B, (L + 15) // 16), dtype=torch.int32),
                           L, None)
    with pytest.raises(ValueError, match="code rows, not packed"):
        fs.pack_problems(a[0], src, a[2], a[3])
    src = fs.oriented_rows(a[1], L, torch.full((B,), L, dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths from its words"):
        fs.pack_problems(a[0], src, a[2], a[3])


@pytest.mark.parametrize("name", ["ragged", "text_end", "width_250"])
def test_pack_words_round_trip(genome, name):
    """pack_args' words (rescue_words, as run_banded_dp packs them) give
    back each problem's row, strand, window start and its row's length;
    and at window starts past 2^31 and 2^32 (a 3.1 Gbp text's), both
    strands."""
    c = _case(genome, name)
    words = chip_smoke.pack_args(c, genome[2], "cpu")[2]
    assert words.dtype == torch.int32 and words.shape == (
        len(c["cread"]), fs.PK_WORDS)
    read, rev, ws, rc_len = (t.numpy() for t in tr.rescue_fields(words))
    np.testing.assert_array_equal(read, c["cread"])
    np.testing.assert_array_equal(rev, c["strand"])
    np.testing.assert_array_equal(ws, c["win_start"])
    np.testing.assert_array_equal(rc_len, c["lens"][c["cread"]])
    far = c["win_start"] + np.where(c["strand"], 1 << 32, 3_100_000_000)
    words = torch.from_numpy(tr.rescue_words(c["cread"], c["strand"], far,
                                             c["lens"][c["cread"]]))
    np.testing.assert_array_equal(tr.rescue_fields(words)[2].numpy(), far)


def test_pack_units_range():
    """PK's unit index is 32-bit: P times the units a problem below 2^31,
    checked by the wrapper alone, which raises."""
    assert fs.pack_units(16384, 120, 4224) == 264 + 8
    assert fs.pack_units(3, 120, 0) == 8 and fs.pack_units(3, 0, 17) == 2
    units = fs.pack_units(1, 120, (1 << 30) - 1)
    assert fs.pack_units((1 << 31) // units - 1, 120, (1 << 30) - 1)
    with pytest.raises(ValueError, match="pass 2"):
        fs.pack_units(-(-(1 << 31) // units), 120, (1 << 30) - 1)
    with pytest.raises(ValueError, match="max_win"):
        fs.pack_units(1, 120, 1 << 30)
    with pytest.raises(ValueError, match="max_win"):
        fs.pack_units(1, 120, -1)


def test_pack_problems_routes_cpu_to_plain(genome, monkeypatch):
    args = chip_smoke.pack_args(_case(genome, "uniform"), genome[2], "cpu")
    calls = []
    plain = tr._pack_problems_plain

    def spy(*a):
        calls.append(a[1].device.type)
        return plain(*a)

    def no_kernel(*a, **kw):
        raise AssertionError("a CPU tensor reached the PK kernel")

    monkeypatch.setattr(tr, "_pack_problems_plain", spy)
    monkeypatch.setattr(fs, "pack_problems", no_kernel)
    got = tr._pack_problems(*args)
    assert calls == ["cpu"]
    for g, w in zip(got, plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_pack_kernel_on_card(genome, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, td = genome
    dev = torch.device("cuda", 0)
    card = tf.DeviceIndex(**{k: v.to(dev) if isinstance(v, torch.Tensor)
                             else v for k, v in vars(td).items()})
    args = chip_smoke.pack_args(_case(genome, name), card, dev)
    n0 = fs.PACK_KERNEL.launches
    got = tr._pack_problems(*args)
    assert fs.PACK_KERNEL.launches == n0 + 1
    for g, w in zip(got, tr._pack_problems_plain(*args)):
        assert torch.equal(g.cpu(), w.cpu())
