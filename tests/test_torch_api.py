"""Embeddable API of the PyTorch port against the JAX package's: the
tests/test_api.py cases through both on the CPU, records equal field by
field; ``load`` puts the index on the device it is given and, like the
CLI, refuses ``cuda`` without a card."""

import dataclasses

import numpy as np
import pytest
import torch

from soap3dp_tpu import api as japi
from soap3dp_tpu.utils import dna
from soap3dp_tpu_torch import api as tapi

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def loaded(small_index, small_device_index):
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from tests.test_torch_host_copies import port_index

    index = port_index(small_index)
    return (japi.LoadedIndex(index=small_index, didx=small_device_index),
            tapi.LoadedIndex(index=index, didx=device_index(index, "cpu")))


def _same(a, b):
    assert [dataclasses.asdict(x) for x in a] == \
        [dataclasses.asdict(x) for x in b]


def test_align_single_r(loaded, small_index, small_genome):
    codes = small_genome.codes
    p = 1234
    rng = np.random.default_rng(5)
    mut = codes[p + 300:p + 380].copy()
    mut[[10, 50]] = (mut[[10, 50]] + 1) % 4
    reads = [dna.decode(codes[p:p + 60]).decode(), "A" * 40,
             dna.decode(dna.revcomp_codes(mut)).decode(),
             dna.decode(rng.integers(0, 4, 70).astype(np.uint8)).decode()]
    want = japi.align_single_r(loaded[0], reads)
    got = tapi.align_single_r(loaded[1], reads)
    _same(got, want)
    r0 = [a for a in got if a.read_id == 0]
    assert r0 and r0[0].mapped
    assert r0[0].pos == p and r0[0].chrom == small_index.names[0]
    assert r0[0].cigar == "60M"


def test_align_pair_r(loaded, small_genome):
    codes = small_genome.codes
    p, ins, L = 4000, 200, 50
    s1 = dna.decode(codes[p:p + L]).decode()
    s2 = dna.decode(dna.revcomp_codes(codes[p + ins - L:p + ins])).decode()
    want = japi.align_pair_r(loaded[0], [s1], [s2], min_insert=100,
                             max_insert=300)
    got = tapi.align_pair_r(loaded[1], [s1], [s2], min_insert=100,
                            max_insert=300)
    _same(got, want)
    assert len(got) == 2
    first = next(a for a in got if a.flag & 0x40)
    second = next(a for a in got if a.flag & 0x80)
    assert first.mapped and second.mapped
    assert first.pos == p
    assert second.pos == p + ins - L
    assert first.tlen == ins and second.tlen == -ins


def test_load_places_index_on_device(tmp_path, small_index):
    from soap3dp_tpu.index.builder import save_index

    path = str(tmp_path / "g.index")
    save_index(small_index, path + ".t3i")
    got = tapi.load(path, device="cpu")
    assert got.didx.device.type == "cpu" and got.index.n == small_index.n
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.load(path)
