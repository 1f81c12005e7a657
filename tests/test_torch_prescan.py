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
candidate, and more candidates than the plain version's chunk.
Tolerance: exact.
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
    src = fs.oriented_rows(a[1], a[1].shape[1], a[2].to(torch.int64))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fs.prescan(td, src, a[3], a[5], a[6].long(), a[7].long(), a[8])


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
