"""The search's hash dedupe (soap3dp_tpu_torch/fm/fmindex.py: dedupe,
dedupe_plain; the FS4 kernel of csrc/fm_search.cu) against the JAX
package.

On the CPU every output is an integer and held exactly: the port's
_search_batch against the JAX package's on a K small enough for the
1,024-slot table to collide, with K2 below, equal to and above the
count of first occurrences (uniq); and dedupe_plain against a copy of
the reference's dedupe lines (soap3dp_tpu/fm/search.py:287-301, inline
in its _search_batch) run in jnp on keys with forced collisions, no
pos_ok, one key everywhere, K2 past K, every key in one table slot
and a K that is a multiple of neither a tile (1,024) nor a block. The
kernel against its plain version (and two calls in a row on its table,
which the wrapper keeps across calls) is marked ``cuda`` and skips here;
chip_smoke.py runs the same cases on the card. The wrapper's host
arithmetic (the second launch's grid, the table and its generation) is
tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu.fm import search as js
from soap3dp_tpu.utils import scans
from soap3dp_tpu_torch.fm import fmindex as tf
from soap3dp_tpu_torch.fm import search as ts
from soap3dp_tpu_torch.kernels import fm_search as fs
from tests.test_search import make_reads
from tests.test_torch_host_copies import port_index

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reference_dedupe(krow, ktp, pos_ok, K2):
    """The reference's dedupe (soap3dp_tpu/fm/search.py:287-301) on
    uint32 keys, in jnp: (urow, utp, uvalid, uniq), urow of the slot's
    key row where the reference gathers orow (equal where pos_ok)."""
    U32 = jnp.uint32
    krow = jnp.asarray(krow.astype(np.uint32))
    ktp = jnp.asarray(ktp.astype(np.uint32))
    pos_ok = jnp.asarray(pos_ok)
    K = krow.shape[0]
    idxs = jnp.arange(K, dtype=jnp.int32)
    hb = max((K - 1).bit_length() + 1, 10)          # table = 2x candidates
    h = (krow * U32(0x9E3779B1)) ^ (ktp * U32(0x85EBCA77))
    hslot = ((h * U32(0xC2B2AE3D)) >> U32(32 - hb)).astype(jnp.int32)
    table = jnp.full((1 << hb,), K, jnp.int32).at[hslot].min(
        jnp.where(pos_ok, idxs, K))
    widx = jnp.minimum(table[hslot], K - 1)
    dup = pos_ok & (widx != idxs) & (krow[widx] == krow) & (ktp[widx] == ktp)
    first = pos_ok & ~dup
    uniq = first.sum(dtype=jnp.int32)
    idx2 = scans.nonzero_prefix(first, K2)
    uvalid = idx2 >= 0
    idx2s = jnp.where(uvalid, idx2, 0)
    urow = jnp.where(uvalid, krow[idx2s].astype(jnp.int32), js.ROW_SENTINEL)
    utp = ktp[idx2s]
    return [np.asarray(x) for x in (urow, utp, uvalid, uniq)]


def _keys(case: str):
    """(krow, ktp, pos_ok, K2) numpy keys of one dedupe case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "collide_1024":
        return chip_smoke.collision_keys(rng) + (256,)
    if case == "no_pos_ok":
        none = np.full(700, 0xFFFFFFFF, np.int64)
        return none, none, np.zeros(700, bool), 512
    if case == "one_key":
        return (np.full(600, 7, np.int64), np.full(600, 123456, np.int64),
                np.ones(600, bool), 64)
    if case == "one_slot":
        return chip_smoke.same_slot_keys(rng, 2048) + (2048,)
    if case == "K_not_tile":
        return chip_smoke.dedupe_keys(rng, 3363, 1500) + (700,)
    krow, ktp, ok = chip_smoke.dedupe_keys(rng, 3000, 900)
    return krow, ktp, ok, {"uniq_gt_K2": 300, "K2_past_K": 4096}[case]


CASES = ["collide_1024", "no_pos_ok", "one_key", "uniq_gt_K2", "K2_past_K",
         "one_slot", "K_not_tile"]


@pytest.mark.parametrize("case", CASES)
def test_dedupe_plain_matches_reference_lines(case):
    """dedupe_plain equals the reference's dedupe lines on the same keys,
    every output element (urow, utp, uvalid and uniq); the forced
    collisions leave same-key losers of a slot that another key won."""
    krow, ktp, ok, K2 = _keys(case)
    got = tf.dedupe_plain(_t(krow), _t(ktp), _t(ok), K2)
    want = _reference_dedupe(krow, ktp, ok, K2)
    for a, b, name in zip(got, want, ("urow", "utp", "uvalid", "uniq")):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      b.astype(np.int64), err_msg=name)
    work = chip_smoke.dedupe_work(_t(krow), _t(ktp), _t(ok), K2, got)
    uniq = int(want[3])
    if case == "collide_1024":
        assert work["hb"] == 10 and work["surviving_dups"] > 0
    if case == "no_pos_ok":
        assert uniq == 0 and not got[2].any()
    if case == "one_key":
        assert uniq == 1 and int(got[2].sum()) == 1
    if case == "uniq_gt_K2":
        assert uniq > K2 and bool(got[2].all())
    if case == "K2_past_K":
        assert K2 > len(krow) and int(got[2].sum()) == uniq
    if case == "one_slot":   # distinct keys, one slot: all but one collide
        assert len(np.unique(chip_smoke._slot_of(krow, ktp, work["hb"]))) == 1
        assert uniq == int(ok.sum()) == work["collided"] + 1
    if case == "K_not_tile":
        assert len(krow) % fs.DEDUPE_TILE and len(krow) % 256 and uniq > K2


def _search(reads, lens, jd, td, monkeypatch, K2):
    """Both packages' _search_batch over the reads (k = 2, cap 16, full
    pigeonhole segments, K 512: a 1,024-slot table); the port's dedupe
    keys are captured on the way."""
    L = reads.shape[1]
    kw = dict(K=512, K2=K2)
    hj, totj = js._search_batch(jd, jnp.asarray(reads), jnp.asarray(lens),
                                js.SearchConfig(k=2), 16, L // 3, 0, **kw)
    seen = []
    plain = tf.dedupe

    def capture(*args):
        seen.append(args)
        return plain(*args)

    monkeypatch.setattr(tf, "dedupe", capture)
    ht, tott = ts._search_batch(td, _t(reads), _t(lens), ts.SearchConfig(k=2),
                                16, L // 3, 0, **kw)
    monkeypatch.setattr(tf, "dedupe", plain)
    return hj, np.asarray(totj), ht, tott.numpy(), seen[0]


@pytest.mark.parametrize("case", ["uniq_gt_K2", "uniq_eq_K2", "K2_default"])
def test_search_batch_on_a_colliding_table(small_index, small_genome,
                                           monkeypatch, case):
    """The port's _search_batch against the JAX package's, the K of 512
    giving the dedupe its 1,024-slot floor, where distinct keys collide;
    K2 half the first occurrences (uniq > K2, the regrowth case of
    PendingSearch), equal to them, and K: every returned array equal."""
    jd = jf.device_index(small_index)
    td = tf.device_index(port_index(small_index), "cpu")
    rng = np.random.default_rng(61)
    B, L = 96, 48
    reads = make_reads(rng, small_genome.codes, B, L, 2)
    lens = np.full(B, L, np.int32)
    lens[::7] = 44
    uniq = int(_search(reads, lens, jd, td, monkeypatch, 0)[1][1])
    K2 = {"uniq_gt_K2": uniq // 2, "uniq_eq_K2": uniq, "K2_default": 0}[case]
    hj, totj, ht, tott, keys = _search(reads, lens, jd, td, monkeypatch,
                                       K2)
    np.testing.assert_array_equal(totj, tott)
    assert totj[0] <= 512 and totj[1] == uniq
    assert {"uniq_gt_K2": uniq > K2, "uniq_eq_K2": uniq == K2,
            "K2_default": K2 == 0}[case]
    for name in ("row", "tp", "nmis", "valid", "flagged"):
        a = np.asarray(getattr(hj, name)).astype(np.int64)
        b = getattr(ht, name).numpy().astype(np.int64)
        np.testing.assert_array_equal(a, b, err_msg=f"{case} {name}")
    work = chip_smoke.dedupe_work(*keys, tf.dedupe_plain(*keys))
    assert work["hb"] == 10 and work["collided"] > 0


def test_dedupe_on_cpu_takes_the_plain_version():
    """dedupe on CPU tensors is its plain version and launches nothing;
    the kernel wrapper refuses CPU tensors."""
    krow, ktp, ok, K2 = (_t(a) if isinstance(a, np.ndarray) else a
                         for a in _keys("collide_1024"))
    n0 = fs.DEDUPE_KERNEL.launches
    got, want = tf.dedupe(krow, ktp, ok, K2), tf.dedupe_plain(krow, ktp, ok,
                                                             K2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fs.DEDUPE_KERNEL.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        fs.dedupe(krow, ktp, ok, K2)


# ------------------------------------------------------------------
# On the card (skips here; chip_smoke.py runs the same cases)
# ------------------------------------------------------------------

def test_dedupe_grid_and_range():
    """FS4's second launch's grid: a tile of 1,024 slots each; K outside
    [1, 2^31) or K2 outside [0, 2^31) raises (the kernel keeps K - k and
    the counts of firsts in 32 bits)."""
    assert fs.dedupe_tiles(1, 0) == 1
    assert fs.dedupe_tiles(1024, 2048) == 1
    assert fs.dedupe_tiles(1025, 256) == 2
    assert fs.dedupe_tiles(524288, 262144) == 512
    assert fs.dedupe_tiles((1 << 31) - 1, (1 << 31) - 1) == 1 << 21
    for K, K2 in ((0, 1), (1 << 31, 1), (5, -1), (5, 1 << 31)):
        with pytest.raises(ValueError, match="out of range"):
            fs.dedupe_tiles(K, K2)


def test_dedupe_table_generations(monkeypatch):
    """The table a card and stream keep (gen_state "dedupe"): made
    zeroed at first use, kept (the generation one higher each call)
    while it is large enough, made anew (the larger size kept) when a
    call needs more slots or the generations are spent; another stream
    has its own."""
    monkeypatch.setattr(fs, "_STATES", {})
    cpu = torch.device("cpu")
    t1, g1, _ = fs.gen_state("dedupe", cpu, 7, 1024)
    assert t1.shape == (1024,) and not t1.any() and g1 == 1
    t2, g2, _ = fs.gen_state("dedupe", cpu, 7, 512)
    assert t2 is t1 and g2 == 2
    t3, g3, _ = fs.gen_state("dedupe", cpu, 7, 4096)
    assert t3 is not t1 and t3.shape == (4096,) and g3 == 1
    assert fs.gen_state("dedupe", cpu, 7, 1024)[0] is t3
    fs._STATES[("dedupe", None, 7)][1] = fs._GEN_MAX
    t4, g4, _ = fs.gen_state("dedupe", cpu, 7, 16)
    assert t4 is not t3 and t4.shape == (4096,) and g4 == 1
    t5, g5, _ = fs.gen_state("dedupe", cpu, 8, 16)
    assert t5 is not t4 and g5 == 1
    assert (fs._GEN_MAX << 2 | 3) < 1 << 32  # a status's tag and state


def test_scan_state_tickets(monkeypatch):
    """The scan state FS4 and FS5 share (gen_state "scan"): each call's
    ticket base is the tickets the calls before it took there, kept
    apart from FS4's table; a new scratch (tickets from 0) when a call
    needs more tiles or the 32-bit tickets would run out."""
    monkeypatch.setattr(fs, "_STATES", {})
    cpu = torch.device("cpu")
    s1, g1, b1 = fs.gen_state("scan", cpu, 7, 65, 64)
    assert s1.shape == (65,) and (g1, b1) == (1, 0)
    table, _, _ = fs.gen_state("dedupe", cpu, 7, 1 << 10)
    assert table is not s1
    s2, g2, b2 = fs.gen_state("scan", cpu, 7, 9, 8)
    assert s2 is s1 and (g2, b2) == (2, 64)
    s3, g3, b3 = fs.gen_state("scan", cpu, 7, 129, 128)
    assert s3 is not s1 and s3.shape == (129,) and (g3, b3) == (1, 0)
    fs._STATES[("scan", None, 7)][2] = (1 << 32) - 100
    s4, g4, b4 = fs.gen_state("scan", cpu, 7, 129, 128)
    assert s4 is not s3 and (g4, b4) == (1, 0)
    assert fs.gen_state("scan", cpu, 7, 2, 1)[1:] == (2, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_dedupe_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    krow, ktp, ok, K2 = _keys(case)
    args = (_t(krow).to(dev), _t(ktp).to(dev), _t(ok).to(dev), K2)
    n0 = fs.DEDUPE_KERNEL.launches
    got, want = tf.dedupe(*args), tf.dedupe_plain(*args)
    assert fs.DEDUPE_KERNEL.launches == n0 + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_dedupe_kernel_twice_in_a_row():
    """Two calls in a row on the card's table give equal outputs, and so
    do calls after a larger table replaced it (chip_smoke's
    dedupe_repeat_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    assert chip_smoke.dedupe_repeat_check(np.random.default_rng(3), dev) == 5
    krow, ktp, ok, K2 = _keys("uniq_gt_K2")
    args = (_t(krow).to(dev), _t(ktp).to(dev), _t(ok).to(dev), K2)
    first, second = tf.dedupe(*args), tf.dedupe(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
