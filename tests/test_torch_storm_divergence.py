"""The storm gate's A/B on the port, against the JAX package.

The repo's tools/measure_storm_divergence.py aligns two pools of pairs
(uniform, and the least diverse quartile of a larger sample) twice: with
the storm gate (host re-align skipped for a batch with more flagged
reads than AlignOptions.host_realign_budget) and with
SOAP3DP_HOST_REALIGN_FULL=1 (every flagged read enumerated completely),
and diffs the primary records. Here, on the 4 Mbp repeat genome (seed 5)
that tests/test_torch_accuracy.py uses, each package indexed at lut_k
11, the port's copy (soap3dp_tpu_torch/tools/measure_storm_divergence.py)
must give the JAX tool's pools, batches, result dicts (times aside) and
record maps (Collect.primary, .counts) of every arm, tolerance zero; at
the default budget of 256 and at a budget of 1 (AlignOptions swapped
for a partial in both packages, test-side), under which the default arm
skips re-aligns the full arm makes.
"""

import functools
import json
import os
import re

import numpy as np
import pytest
import torch

from soap3dp_tpu.index.builder import build_index as jax_build_index
from soap3dp_tpu_torch.fm.fmindex import device_index
from soap3dp_tpu_torch.index.builder import build_index
from soap3dp_tpu_torch.tools import measure_storm_divergence as storm
from soap3dp_tpu_torch.tools import repeat_genome
from soap3dp_tpu_torch.tools.evaluate_accuracy import excluded_runs
from tools import measure_storm_divergence as jax_storm
from tools import repeat_genome as jax_repeat_genome

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

SKIPPED = "host re-align skipped"


def _quiet(m):
    pass


@pytest.fixture(scope="module")
def storm_setup():
    jax_genome = jax_repeat_genome.generate(4_000_000, seed=5, log=_quiet)
    genome = repeat_genome.generate(4_000_000, seed=5, log=_quiet)
    index = build_index(genome, sa_rate=2, lut_k=11)
    return (genome, excluded_runs(genome),
            jax_build_index(jax_genome, sa_rate=2, lut_k=11),
            (index, device_index(index, "cpu")))


def _timeless(d):
    return {k: ({f: x for f, x in v.items() if not f.startswith("time_")}
                if isinstance(v, dict) else v) for k, v in d.items()}


def test_pools_and_batches_equal(storm_setup):
    genome, ex, _, _ = storm_setup
    codes = genome.codes
    pos = np.random.default_rng(4).integers(0, len(codes) - 400, 300)
    np.testing.assert_array_equal(storm._distinct_kmer_frac(codes, pos),
                                  jax_storm._distinct_kmer_frac(codes, pos))
    got = storm.sample_pools(codes, 200, np.random.default_rng(11), ex)
    want = jax_storm.sample_pools(codes, 200, np.random.default_rng(11), ex)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    # every insert off the N runs over 10 bp
    starts, ends = ex
    for p in np.concatenate(got[:2]):
        i = np.searchsorted(ends, p, side="right")
        assert i == len(starts) or starts[i] >= p + storm.INSERT
    rng, jrng = np.random.default_rng(12), np.random.default_rng(12)
    for g, w in zip(storm.make_batches(codes, got[1], rng),
                    jax_storm.make_batches(codes, want[1], jrng)):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.lens, w.lens)
        np.testing.assert_array_equal(g.names, w.names)


def _collecting(monkeypatch, module):
    """Wrap ``module``'s align_once to keep each arm's Collect."""
    kept = []
    real = module.align_once

    def align_once(*args):
        out = real(*args)
        kept.append(out[0])
        return out

    monkeypatch.setattr(module, "align_once", align_once)
    return kept


@pytest.mark.parametrize("budget,n_per_pool", [(None, 300), (1, 150)])
def test_run_equals_the_jax_tool(storm_setup, monkeypatch, capsys, budget,
                                 n_per_pool):
    from soap3dp_tpu.pipeline import options as jax_options
    from soap3dp_tpu_torch.pipeline import options

    genome, ex, jax_index, (index, didx) = storm_setup
    if budget is not None:
        for mod in (options, jax_options):
            monkeypatch.setattr(mod, "AlignOptions", functools.partial(
                mod.AlignOptions, host_realign_budget=budget))
    got_cols = _collecting(monkeypatch, storm)
    want_cols = _collecting(monkeypatch, jax_storm)

    got = storm.run(index, genome.codes, ex, n_per_pool, didx=didx)
    log = capsys.readouterr().err
    assert storm.FULL_ENV not in os.environ
    want = jax_storm.run(jax_index, genome.codes, ex, n_per_pool)
    assert _timeless(got) == _timeless(want)
    assert set(got["uniform"]) == set(want["uniform"])
    # pools x arms: uniform/default, uniform/full, repeat/default, ...
    assert len(got_cols) == len(want_cols) == 4
    for g, w in zip(got_cols, want_cols):
        assert g.primary == w.primary
        assert g.counts == w.counts
        assert len(g.primary) == 2 * n_per_pool
    # the gate fires in the default arms only; the full arms re-align
    arms = log.split("[storm-ab] ")
    default_log = "".join(a for a, b in zip(arms, arms[1:])
                          if b.startswith(("uniform/default",
                                           "repeat/default")))
    full_log = "".join(a for a, b in zip(arms, arms[1:])
                       if b.startswith(("uniform/full", "repeat/full")))
    assert SKIPPED not in full_log
    assert "re-aligned on host" in full_log
    # each skip's flagged reads exceed the budget; at a budget of 1 some
    # batch the default budget re-aligns is skipped
    skips = [int(n) for n in re.findall(r"skipped: (\d+) flagged",
                                        default_log)]
    assert skips and min(skips) > (budget or 256)
    assert (min(skips) <= 256) == (budget == 1)


def test_main_defaults_to_the_card_and_runs_on_cpu(capsys):
    argv = ["60", "4", "--lut-k", "11"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            storm.main(argv)
    assert storm.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["n_per_pool"] == 60
    assert {"uniform", "repeat"} <= set(res)
    assert res["repeat"]["n_ends"] == 120
    assert storm.FULL_ENV not in os.environ
