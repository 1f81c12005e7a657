"""Multi-device data parallelism of the port (mirrors
tests/test_distributed.py): the port's mesh of CPU replicas against the
port on one device and against the JAX package on its 8-device virtual
CPU mesh. A port mesh may name one device several times, so 4 (or 3)
CPU replicas stand in for 4 cards. Every output is an integer: equality
is exact.

The two-card check of the device-context repairs (a search and both DP
routes on the last card while card 0 is current) is marked ``cuda`` and
skips without two cards."""

import jax
import numpy as np
import pytest
import torch

from soap3dp_tpu.distributed import mesh as jmesh
from soap3dp_tpu.fm import search as js
from soap3dp_tpu_torch import workloads
from soap3dp_tpu_torch.distributed import mesh as tmesh
from soap3dp_tpu_torch.fm import fmindex as tf
from soap3dp_tpu_torch.fm import search as ts
from soap3dp_tpu_torch.kernels import banded_dp as tb
from tests.test_dp import make_problems
from tests.test_torch_host_copies import port_index

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

CPU4 = tmesh.make_mesh(["cpu"] * 4)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(jax.devices()[:8])


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    """With no devices named and no card, make_mesh raises instead of
    making a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmesh.make_mesh()


def test_make_mesh_of_named_cpu_devices():
    mesh = tmesh.make_mesh(["cpu"] * 2)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert (mesh.size, mesh.axis) == (2, "reads")


def _reads(codes, B, L, seed):
    pos = np.random.default_rng(seed).integers(0, len(codes) - L, B)
    return (np.stack([codes[p:p + L] for p in pos]).astype(np.uint8),
            np.full(B, L, np.int32))


def _per_read(h, B, Bp=None):
    """{(read, strand): {(tp, nmis)}} of the valid hits of reads 0..B-1;
    reverse-complement rows start at Bp (the padded batch, default B)."""
    row, tp, nm, va, _ = h.to_host()
    Bp = Bp or B
    out = {}
    for r in range(B):
        for strand, orow in ((0, r), (1, Bp + r)):
            m = va & (row == orow)
            out[(r, strand)] = set(zip(tp[m].tolist(), nm[m].tolist()))
    return out


def _valid(h):
    row, tp, nm, va, fl = h.to_host()
    return row[va], tp[va], nm[va], fl


@pytest.mark.parametrize("B", [64, 62])
def test_sharded_search_matches_single_device(mesh8, small_index,
                                              small_genome, B):
    """64 reads (and 62: not a mesh multiple, so the padding is
    stripped), k = 1, occ_cap = 8: alignment_step and the pipeline's
    PendingSearch on the 4-replica mesh, against one device and the JAX
    package's 8-device mesh."""
    L = 40
    reads, lens = _reads(small_genome.codes, B, L, seed=B)
    cfg_t, cfg_j = ts.SearchConfig(k=1, occ_cap=8), js.SearchConfig(k=1,
                                                                    occ_cap=8)
    tidx = port_index(small_index)
    single = ts.search_reads(tf.device_index(tidx, "cpu"), reads, lens, cfg_t)
    want = _per_read(single, B)

    didx = tmesh.replicate_index(tidx, CPU4)
    assert tmesh.mesh_of(didx) is CPU4 and len(tmesh.replicas_of(didx)) == 4
    sreads, slens, B0 = tmesh.shard_batch(CPU4, reads, lens)
    Bp = sum(r.shape[0] for r in sreads)
    assert B0 == B and Bp == 64 and len(sreads) == 4
    hits, n = tmesh.alignment_step(CPU4, didx, sreads, slens, cfg_t,
                                   max_steps=L // 2)
    assert n == B          # every read was sampled from the genome
    assert _per_read(hits, B, Bp) == want
    for x, y in zip(_valid(tmesh.sharded_search(didx, sreads, slens, cfg_t,
                                                L // 2)), _valid(hits)):
        np.testing.assert_array_equal(x, y)

    jd = jmesh.replicate_index(small_index, mesh8)
    jr, jl, _ = jmesh.shard_batch(mesh8, reads, lens)
    jh, jn = jmesh.alignment_step(mesh8, jd, jr, jl, cfg_j, max_steps=L // 2)
    assert jn == B
    assert _per_read(jh, B, jr.shape[0]) == want

    # the pipeline's search: padded with copies of read 0 and stripped.
    # Per-read sets: each shard's hash dedupe keeps its own rare
    # duplicate placement (the host tables drop them, pipeline/hits.py)
    got = ts.search_reads(didx, reads, lens, cfg_t)
    jgot = js.search_reads(jd, reads, lens, cfg_j)
    assert _per_read(got, B) == want == _per_read(jgot, B)
    np.testing.assert_array_equal(got.to_host()[4], single.to_host()[4])


def test_escalation_rounds_on_the_mesh():
    """A repeat-heavy genome and a small round-1 cap: the flagged reads
    re-run over the mesh (padded to it) give the single device's hits."""
    from soap3dp_tpu.index.builder import build_index
    from tests.test_search import _genome_from_codes

    rng = np.random.default_rng(25)
    unit = rng.integers(0, 4, size=25).astype(np.uint8)
    codes = np.concatenate([np.tile(unit, 60),
                            rng.integers(0, 4, size=4000).astype(np.uint8)])
    idx = port_index(build_index(_genome_from_codes(codes), sa_rate=4,
                                 lut_k=4))
    reads = np.stack([codes[s:s + 50] for s in (3, 40, 200, 1600, 2500)]
                     ).astype(np.uint8)
    lens = np.full(len(reads), 50, np.int32)
    cfg = ts.SearchConfig(k=1, occ_cap=2, occ_cap_round2=8,
                          occ_cap_round3=128)
    want = ts.search_reads(tf.device_index(idx, "cpu"), reads, lens, cfg)
    got = ts.search_reads(tmesh.replicate_index(idx, CPU4), reads, lens, cfg)
    assert not want.to_host()[4][:3].any()   # the repeat reads resolved
    assert _per_read(got, len(reads)) == _per_read(want, len(reads))
    np.testing.assert_array_equal(got.to_host()[4], want.to_host()[4])


def _record_tuples(writer):
    return [(r.qname, r.flag, r.chrom, r.pos, r.mapq, r.cigar, r.mate_chrom,
             r.mate_pos, r.tlen, tuple(r.tags)) for r in writer.records]


def test_pair_pipeline_mesh_matches_single_device(mesh8):
    """The whole pair pipeline (align_pair_batch phases A-E) on the
    4-replica mesh with the SA table sharded: the summary and every
    record equal the port's single-device run and the JAX package's run
    on its 8-device mesh."""
    import __graft_entry__ as g
    from soap3dp_tpu.pipeline.pair import align_pair_batch as jax_align
    from soap3dp_tpu_torch.pipeline.pair import align_pair_batch

    # each package runs on its own objects (the recipes are equal,
    # tests/test_torch_pipeline.py)
    tw = workloads.make_tiny_pair_workload(n_pairs=36, seed=5)
    jw = g.make_tiny_pair_workload(n_pairs=36, seed=5)
    runs = []
    for align, didx, (index, b1, b2, opts) in (
            (align_pair_batch, tf.device_index(tw[0], "cpu"), tw),
            (align_pair_batch, tmesh.replicate_index(tw[0], CPU4,
                                                     shard_sa=True), tw),
            (jax_align, jmesh.replicate_index(jw[0], mesh8, shard_sa=True),
             jw)):
        w = g._CollectWriter()
        s = align(index, didx, b1, b2, opts, w)
        runs.append(((s.paired_bwt, s.paired_dp, s.single_rescued,
                      s.unaligned, s.num_records), _record_tuples(w)))
    assert runs[1] == runs[0]
    assert runs[2] == runs[0]
    paired_bwt, paired_dp = runs[0][0][:2]
    assert paired_bwt > 0 and paired_dp > 0


@pytest.mark.parametrize("sa_rate", [8, 1])
def test_sharded_sa_matches_replicated(small_genome, sa_rate):
    """SA table split over the mesh: 1/n of it per replica, the same hits
    (both SA decode paths: the LF walk, and one gather at sa_rate 1)."""
    from soap3dp_tpu.index.builder import build_index

    index = port_index(build_index(small_genome, sa_rate=sa_rate))
    B, L = 32, 40
    reads, lens = _reads(small_genome.codes, B, L, seed=sa_rate)
    cfg = ts.SearchConfig(k=1, occ_cap=8)
    d_rep = tmesh.replicate_index(index, CPU4)
    d_sh = tmesh.replicate_index(index, CPU4, shard_sa=True)
    sizes = [r.sa_samples.nbytes for r in d_sh.replicas]
    assert max(sizes) <= d_rep.sa_samples.nbytes // 4 + 8
    assert len({r.sa_samples.data_ptr() for r in d_sh.replicas}) == 4
    sr, sl, _ = tmesh.shard_batch(CPU4, reads, lens)
    h_rep, n_rep = tmesh.alignment_step(CPU4, d_rep, sr, sl, cfg, L // 2)
    h_sh, n_sh = tmesh.alignment_step(CPU4, d_sh, sr, sl, cfg, L // 2)
    assert n_rep == n_sh == B
    for x, y in zip(_valid(h_rep), _valid(h_sh)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(_valid(ts.search_reads(d_sh, reads, lens, cfg)),
                    _valid(ts.search_reads(d_rep, reads, lens, cfg))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sa_rate", [8, 1])
def test_sharded_sa_seeding_matches_one_device(small_genome, sa_rate):
    """The DP seeding (seed_candidates) on a mesh whose SA table is split
    over the replicas gives one device's candidates."""
    from soap3dp_tpu.index.builder import build_index
    from soap3dp_tpu_torch.pipeline import dp_rescue as tr

    index = port_index(build_index(small_genome, sa_rate=sa_rate))
    reads, lens = _reads(small_genome.codes, 40, 100, seed=7 + sa_rate)
    sp, sl = tr.deep_dp_seed_matrix(lens, 100)
    want = tr.seed_candidates(tf.device_index(index, "cpu"), reads, lens,
                              sp, sl)
    got = tr.seed_candidates(
        tmesh.replicate_index(index, CPU4, shard_sa=True), reads, lens, sp,
        sl)
    assert want.read.size >= len(reads)
    for f in ("read", "strand", "pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_seed_ranks_route_matches_one_device(small_genome):
    """The card's route for a split SA table: FS2s's ranks form (at
    sa_rate 1 each slot's rank is its SA row, no LF step) and the owner
    routing (fmindex._seed_from_ranks) on each replica of a two-replica
    split give one device's seed_expand_plain."""
    from soap3dp_tpu.index.builder import build_index

    index = port_index(build_index(small_genome, sa_rate=1))
    one = tf.device_index(index, "cpu")
    reps = tmesh.replicate_index(index, tmesh.make_mesh(["cpu"] * 2),
                                 shard_sa=True).replicas
    rng = np.random.default_rng(9)
    RS, S = 900, 3
    cnt = torch.from_numpy(np.minimum(rng.choice([0, 1, 63, 64, 65, 200], RS),
                                      64))
    incl = torch.cumsum(cnt, 0)
    l = torch.from_numpy(rng.integers(0, one.n - 200, RS))
    sp = torch.from_numpy(rng.integers(0, 75, RS))
    for K in (int(incl[-1]) + 50, int(incl[-1]) // 2):
        want = tf.seed_expand_plain(one, l, incl, tf.SeedLanes.given(sp), S,
                                    K)
        k = torch.arange(K)
        live = k < incl[-1]
        lane = torch.where(live, torch.searchsorted(incl, k, right=True), 0)
        off = torch.where(lane > 0, incl[(lane - 1).clamp(min=0)], 0)
        rank = torch.where(live, l[lane] + k - off, 0)
        for rep in reps:
            assert rep.sa_parts
            got = tf._seed_from_ranks(rep, lane, rank, torch.zeros_like(rank),
                                      incl, sp, S)
            assert got.dtype == want.dtype and torch.equal(got, want)
        valid = want[2 * K:] != 0       # the packed words' third part
        assert valid.any() and (live & ~valid).any()


def _torch(prob, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in prob]


@pytest.mark.parametrize("Lr,Lw", [(40, 70), (30, 4096)],
                         ids=["K1_shape", "K2_TB_shape"])
def test_dp_align_mesh_matches_unsharded(Lr, Lw):
    """dp_align(mesh=) on 5 problems over 2 replicas (not a multiple):
    every output array, shapes included, equals the unsharded call, at
    a shape of each CUDA route (K1; K2 + TB from Lw = 4096)."""
    P = 5
    prob = make_problems(np.random.default_rng(Lw), P, Lr, Lw) + (
        np.full(P, 10, np.int32),)
    assert tb.takes_wide_route(Lr, Lw) == (Lw >= tb.FUSED_MAX_WINDOW)
    args = _torch(prob)
    want = tb.dp_align(*args)
    got = tb.dp_align(*args, mesh=tmesh.make_mesh(["cpu"] * 2))
    assert (np.asarray(want[6]) > 0).sum() > P // 2
    for k, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=f"field {k}")


@pytest.mark.cuda
def test_last_card_while_card0_is_current():
    """A search and both DP routes on cuda:{count-1} while cuda:0 is
    current give the results of cuda:0 (the host copy's event and the
    kernel launches follow the tensors' device). Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards; chip_smoke.py phase 7c runs this "
                    "check where the card count allows")
    import chip_smoke

    assert chip_smoke.check_last_card()
