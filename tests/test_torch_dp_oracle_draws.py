"""The draws of tests/test_dp.py's ``make_problems(rng, 32, 24, 48,
False)`` on which the count of best cells differs between the JAX
package's dp_forward and tests/dp_oracle.py: ``np.random.default_rng``
seeds 7, 44, 230, 297 and 388, one problem each. On every problem of
these draws the port's plain forward and ``dp_align_plain`` equal the
JAX dp_forward on every field (score, hit_i, hit_j, count), and the
score and best cell equal the oracle's; only the count differs from the
oracle, where it does.

Which side matches the docstring of the JAX dp_forward
(soap3dp_tpu/kernels/banded_dp.py:85, "count = number of eligible cells
achieving the best score"): the oracle. It counts every eligible cell
at the best score. The JAX package (and the port, which holds to it, K1
and K2 included) folds the diagonals in order and resets the count where
a later anti-diagonal reaches the best score at a smaller j (the cell
the tie-break keeps), so it drops the cells at that score on the
diagonals before: each cell the oracle counts and JAX does not
(MISSED) lies on an earlier anti-diagonal (i + j) than the best cell,
at a larger j. So tests/test_dp.py::test_forward_matches_oracle[False]
and tests/test_torch_dp.py::test_plain_matches_oracle[False] fail
whenever their session-scoped ``rng`` reaches such a draw.

Tolerance: exact (scores, cells and counts are integers). The kernels
run only on a card: the test marked ``cuda`` skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap3dp_tpu.kernels import banded_dp as jb
from soap3dp_tpu_torch.kernels import banded_dp as tb
from tests import dp_oracle
from tests.test_dp import make_problems

torch.set_num_threads(1)

SC = tb.DPScores()
SCORES = (SC.match, SC.mismatch, SC.gap_open, SC.gap_ext)
P, LR, LW = 32, 24, 48
# seed -> {problem: the cells (i, j), 1-based, the oracle counts at the
# best score and the JAX package does not}
MISSED = {7: {5: [(14, 26)]}, 44: {30: [(10, 19)]}, 230: {13: [(16, 30)]},
          297: {23: [(8, 22)]}, 388: {14: [(20, 32)]}}


def _draw(seed: int) -> tuple:
    return make_problems(np.random.default_rng(seed), P, LR, LW, False)


def _torch(prob, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in prob]


def _oracle(prob, p: int):
    """(best score, hit_i, hit_j, count, the cells (i, j) at the best
    score that are eligible) of problem p by the oracle."""
    reads, rlens, wins, _, cl, cr, al, ar = prob
    H, _, best, cnt = dp_oracle.oracle_forward(
        reads[p, :rlens[p]], wins[p], cl[p], cr[p], al[p], ar[p], SCORES)
    Lr = int(rlens[p])
    cells = [(i, j) for j in range(1, LW + 1) for i in range(1, Lr + 1)
             if i >= Lr - cr[p] and j >= ar[p] and H[j, i] == best[0]]
    return int(best[0]), int(best[2]), int(best[1]), int(cnt), cells


@pytest.mark.parametrize("seed", sorted(MISSED))
def test_port_equals_jax_on_every_field(seed):
    """The port's plain forward and dp_align_plain against the JAX
    dp_forward on all 32 problems: score, hit_i, hit_j and count; score
    and best cell against the oracle."""
    prob = _draw(seed)
    want = [np.asarray(x) for x in
            jb.dp_forward(*[jnp.asarray(x) for x in prob],
                          sc=jb.DPScores())[:4]]
    t = _torch(prob)
    fwd = [x.numpy() for x in tb.dp_forward(*t, sc=SC)[:4]]
    cutoff = torch.ones(P, dtype=torch.int32)
    align = tb.dp_align_plain(*t, cutoff, sc=SC)[:4]
    for k, name in enumerate(("score", "hit_i", "hit_j", "count")):
        np.testing.assert_array_equal(fwd[k], want[k], err_msg=name)
        np.testing.assert_array_equal(np.asarray(align[k]), want[k],
                                      err_msg=name)
    for p in range(P):
        score, i, j, _, _ = _oracle(prob, p)
        assert (want[0][p], want[1][p], want[2][p]) == (score, i, j), p


@pytest.mark.parametrize("seed", sorted(MISSED))
def test_oracle_counts_cells_jax_drops(seed):
    """Where the counts differ: the oracle's count is every eligible cell
    at the best score (the docstring's), the JAX package's those on the
    best cell's anti-diagonal and after it; the cells between are
    MISSED, each on an earlier anti-diagonal at a larger j."""
    prob = _draw(seed)
    got = jb.dp_forward(*[jnp.asarray(x) for x in prob], sc=jb.DPScores())
    count = np.asarray(got[3])
    missed = {}
    for p in range(P):
        _, i, j, cnt, cells = _oracle(prob, p)
        assert cnt == len(cells), p
        later = [c for c in cells if sum(c) >= i + j]
        assert count[p] == len(later), p
        if cnt != count[p]:
            missed[p] = [c for c in cells if c not in later]
            assert all(a + b < i + j and b > j for a, b in missed[p]), p
    assert missed == MISSED[seed]


@pytest.mark.cuda
def test_kernels_match_plain_on_seed_7():
    """K1 (dp_align_cuda, through DW) and K2 (dp_forward on the card, its
    direction bytes too; and dp_align_wide, K2 + TB + DW) on seed 7's 32
    problems against the plain version (needs a CUDA card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tests.test_torch_dp import assert_dp_equal

    prob = _draw(7)
    cutoff = np.ones(P, np.int32)
    cpu = _torch(prob + (cutoff,))
    dev = _torch(prob + (cutoff,), "cuda")
    want = tb.dp_align_plain(*cpu, sc=SC)
    assert_dp_equal(want, tb.dp_align_cuda(*dev, sc=SC), check_width=True)
    assert_dp_equal(want, tb.dp_align_wide(*dev, sc=SC), check_width=True)
    plain = tb.dp_forward(*cpu[:8], sc=SC)
    k2 = tb.dp_forward(*dev[:8], sc=SC)
    for a, b in zip(plain, k2):
        assert torch.equal(a.to(torch.int64), b.cpu().to(torch.int64))
    assert int(want[3][5]) == 3  # the JAX package's count, not the oracle's
