"""DP rescue plumbing of the PyTorch port against the JAX package:
seed_candidates, gapless_prescan and run_banded_dp on the same numpy
inputs (the tiny PE workload's index and reads). Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu.kernels.banded_dp import DPScores as JScores
from soap3dp_tpu.pipeline import dp_rescue as jr
from soap3dp_tpu_torch.fm import fmindex as tf
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


@pytest.mark.parametrize("kind", ["single", "deep", "deep_round2"])
def test_seed_candidates_equal(work, kind):
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
