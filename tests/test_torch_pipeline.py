"""Paired-end pipeline of the PyTorch port against the JAX package.

* the five paired-end golden SAM cases render byte-equal through the
  port (tests/golden is the reference's frozen output);
* the port's workload recipes equal the reference's;
* a double-buffered multi-batch run (async dispatch of batch i+1,
  Phase2Queue, RescueQueue flushed on an AsyncFlusher worker) gives the
  same SAM records as the JAX package, at the default narrow half-rescue
  window and with it off (half_narrow_pad=0). Records are compared as
  sorted lists: the flush worker interleaves records nondeterministically
  in both packages;
* the two single-end golden SAM cases, and a double-buffered single-end
  run (SinglePhase2Queue, SalvageQueue on each package's AsyncFlusher),
  likewise.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from soap3dp_tpu.io.aio import AsyncWriter
from soap3dp_tpu.io.sam import SamWriter
from soap3dp_tpu.pipeline.overlap import AsyncFlusher
from soap3dp_tpu_torch import workloads
from soap3dp_tpu_torch.io.aio import AsyncWriter as TAsyncWriter
from soap3dp_tpu_torch.io.sam import SamWriter as TSamWriter
from soap3dp_tpu_torch.pipeline.overlap import AsyncFlusher as TFlusher

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.mark.parametrize("name,case", workloads.GOLDEN_PAIR_CASES,
                         ids=[c[0] for c in workloads.GOLDEN_PAIR_CASES])
def test_golden_sam_through_port(name, case):
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.pipeline.pair import align_pair_batch

    index, b1, b2 = workloads.golden_pair_workload(case.get("plant4", False))
    buf = io.BytesIO()
    align_pair_batch(index, device_index(index, "cpu"), b1, b2,
                     workloads.golden_options(case), TSamWriter(buf, index))
    got = [l for l in buf.getvalue().decode().splitlines()
           if not l.startswith("@PG")]
    with open(os.path.join(GOLDEN_DIR, f"{name}.sam")) as fh:
        want = fh.read().splitlines()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.split("\t") == w.split("\t"), f"{name} line {i}"


@pytest.mark.parametrize("name,case", workloads.GOLDEN_SINGLE_CASES,
                         ids=[c[0] for c in workloads.GOLDEN_SINGLE_CASES])
def test_golden_single_sam_through_port(name, case):
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.pipeline.single import align_single_batch

    index, b1 = workloads.golden_single_workload()
    buf = io.BytesIO()
    align_single_batch(index, device_index(index, "cpu"), b1,
                       workloads.golden_options(case), TSamWriter(buf, index))
    got = [l for l in buf.getvalue().decode().splitlines()
           if not l.startswith("@PG")]
    with open(os.path.join(GOLDEN_DIR, f"{name}.sam")) as fh:
        want = fh.read().splitlines()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.split("\t") == w.split("\t"), f"{name} line {i}"


@pytest.mark.parametrize("plant4", [False, True])
def test_workload_recipes_match_reference(plant4):
    import __graft_entry__ as ge
    from tests.test_golden_sam import _workload

    ia, a1, a2 = _workload(plant4)
    ib, c1, c2 = workloads.golden_pair_workload(plant4)
    for x, y in ((a1, c1), (a2, c2)):
        np.testing.assert_array_equal(x.codes, y.codes)
        np.testing.assert_array_equal(x.quals, y.quals)
        assert list(x.names) == list(y.names)
    np.testing.assert_array_equal(ia.sa_samples, ib.sa_samples)
    ra = ge.make_tiny_pair_workload(seed=4)
    rb = workloads.make_tiny_pair_workload(seed=4)
    np.testing.assert_array_equal(ra[1].codes, rb[1].codes)
    np.testing.assert_array_equal(ra[2].codes, rb[2].codes)
    assert dataclasses.asdict(ra[3]) == dataclasses.asdict(rb[3])


# each package's (AsyncWriter, SamWriter, AsyncFlusher)
JAX_IO = (AsyncWriter, SamWriter, AsyncFlusher)
PORT_IO = (TAsyncWriter, TSamWriter, TFlusher)


def _double_buffered(pair_mod, io_cls, didx, index, b1, b2, opts, batch):
    """The runner's batch loop over ``batch``-pair slices."""
    async_writer, sam_writer, flusher_cls = io_cls
    buf = io.BytesIO()
    total = pair_mod.PairSummary()
    with async_writer(sam_writer(buf, index)) as w:
        rq = pair_mod.RescueQueue(index, didx, opts, flush_pairs=24)
        p2q = pair_mod.Phase2Queue(index, didx, opts)
        flusher = flusher_cls(rq, w, eager_min=8)
        n = len(b1)
        parts = [(b1.take(slice(s, s + batch)), b2.take(slice(s, s + batch)))
                 for s in range(0, n, batch)]
        pending = pair_mod.dispatch_pair_search(didx, *parts[0], opts)
        for i, (x1, x2) in enumerate(parts):
            nxt = parts[i + 1] if i + 1 < len(parts) else None
            nxt_pending = pair_mod.dispatch_pair_search(didx, *nxt, opts) \
                if nxt else None
            total.add(pair_mod.align_pair_batch(
                index, didx, x1, x2, opts, w, pending_search=pending,
                rescue_queue=rq, phase2_queue=p2q))
            flusher.maybe_submit()
            pending = nxt_pending
        flusher.submit()
        total.add(p2q.process(w, rq))
        flusher.submit()
        flusher.join(total.add)
    recs = sorted(l for l in buf.getvalue().decode().splitlines()
                  if not l.startswith("@"))
    return recs, total


@pytest.fixture(scope="module")
def tiny():
    """Each package's own tiny PE workload, (index, b1, b2, options):
    the recipes are equal (test_workload_recipes_match_reference)."""
    import __graft_entry__ as ge

    return (ge.make_tiny_pair_workload(n_pairs=96, seed=21),
            workloads.make_tiny_pair_workload(n_pairs=96, seed=21))


@pytest.mark.parametrize("half_narrow_pad", [32, 0])
def test_double_buffered_run_matches_reference(tiny, half_narrow_pad):
    from soap3dp_tpu.fm.fmindex import device_index as jdev
    from soap3dp_tpu.pipeline import pair as jpair
    from soap3dp_tpu_torch.fm.fmindex import device_index as tdev
    from soap3dp_tpu_torch.pipeline import pair as tpair

    (ji, j1, j2, jo), (index, b1, b2, opts) = tiny
    jo = dataclasses.replace(jo, half_narrow_pad=half_narrow_pad)
    opts = dataclasses.replace(opts, half_narrow_pad=half_narrow_pad)
    want, ws = _double_buffered(jpair, JAX_IO, jdev(ji), ji, j1, j2, jo, 32)
    got, gs = _double_buffered(tpair, PORT_IO, tdev(index, "cpu"), index, b1,
                               b2, opts, 32)
    assert len(got) == 2 * len(b1)
    assert got == want
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    # every phase fired: BWT pairs, DP pairs, salvaged ends, unmapped
    assert gs.paired_bwt and gs.paired_dp and gs.single_rescued \
        and gs.unaligned


def _double_buffered_single(single_mod, io_cls, didx, index, batch, opts,
                            size):
    """The runner's single-end batch loop over ``size``-read slices."""
    async_writer, sam_writer, flusher_cls = io_cls
    buf = io.BytesIO()
    total = single_mod.BatchSummary()
    with async_writer(sam_writer(buf, index)) as w:
        sq = single_mod.SalvageQueue(index, didx, opts, flush_reads=24)
        spq = single_mod.SinglePhase2Queue(index, didx, opts)
        flusher = flusher_cls(sq, w, eager_min=8)
        parts = [batch.take(slice(s, s + size))
                 for s in range(0, len(batch), size)]
        pending = single_mod.dispatch_single_search(didx, parts[0], opts)
        for i, b in enumerate(parts):
            nxt = parts[i + 1] if i + 1 < len(parts) else None
            nxt_pending = single_mod.dispatch_single_search(didx, nxt, opts) \
                if nxt is not None else None
            total.add(single_mod.align_single_batch(
                index, didx, b, opts, w, salvage_queue=sq,
                pending_search=pending, phase2_queue=spq))
            flusher.maybe_submit()
            pending = nxt_pending
        flusher.submit()
        total.add(spq.process(w, sq))
        flusher.submit()
        flusher.join(total.add)
    recs = sorted(l for l in buf.getvalue().decode().splitlines()
                  if not l.startswith("@"))
    return recs, total


def test_double_buffered_single_run_matches_reference(tiny):
    """Both ends of the tiny workload as one single-end stream, through
    the double-buffered loop with SalvageQueue, SinglePhase2Queue and
    AsyncFlusher, in both packages."""
    from soap3dp_tpu.fm.fmindex import device_index as jdev
    from soap3dp_tpu.pipeline import pair as jpair
    from soap3dp_tpu.pipeline import single as jsingle
    from soap3dp_tpu_torch.fm.fmindex import device_index as tdev
    from soap3dp_tpu_torch.pipeline import pair as tpair
    from soap3dp_tpu_torch.pipeline import single as tsingle

    def one_stream(pair_mod, b1, b2):
        reads = pair_mod._concat_batches([b1, b2])
        reads.names = np.asarray([b"%s/%d" % (n, e) for e in (1, 2)
                                  for n in b1.names])
        return reads

    (ji, j1, j2, jo), (index, b1, b2, opts) = tiny
    reads = one_stream(tpair, b1, b2)
    want, ws = _double_buffered_single(jsingle, JAX_IO, jdev(ji), ji,
                                       one_stream(jpair, j1, j2), jo, 40)
    got, gs = _double_buffered_single(tsingle, PORT_IO, tdev(index, "cpu"),
                                      index, reads, opts, 40)
    assert len(got) == len(reads)
    assert got == want
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    # every phase fired: BWT hits, DP salvage, unmapped reads
    assert gs.aligned_bwt and gs.aligned_dp and gs.unaligned
