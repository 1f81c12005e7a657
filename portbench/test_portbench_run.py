"""A whole run but the look for a card, on the CPU at a size a test run
holds: the port through its ``--device cpu`` route over an 8 Mbp genome,
the judge after it. A sound run is correct; a run with the timed path
broken underneath is not, once for each fault a cell can have: half of
each batch left out, an answer altered where it is produced, and the
rescue's windows shifted. And the check that the harness, the readers
and the reference load no JAX module and the reference none of the
port."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import run as R
from portbench.cell import Cell

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A repo root whose configurations are the cells' own at 8 Mbp and
    a few hundred pairs a job."""
    root = tmp_path_factory.mktemp("tiny")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    (root / "portbench" / "configs").mkdir(parents=True)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            conf = json.load(fh)
        conf.update(genome={"total_bp": 8_000_000, "seed": 20240817},
                    job_pairs=240, warmup_pairs=16, sample_pairs=240)
        (root / c["file"]).write_text(json.dumps(conf))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def run_tiny(tiny, cell: str, seed: int = 4242424242) -> dict:
    c = Cell(cell, str(tiny))
    return R.run_cell(c, seed, 0.01, False, device="cpu",
                      cache_root=str(tiny / "cache"),
                      log=lambda *a, **k: None)


def test_a_sound_run_is_correct(tiny):
    res = run_tiny(tiny, "chr1-pe100.wgs")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"reads_per_s", "recall", "setup_s"}
    assert res["attempted"] == 480 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_half_of_each_batch_left_out(tiny, monkeypatch):
    from soap3dp_tpu_torch.io import fastq

    whole = fastq.read_pairs

    def half(*a, **k):
        for b1, b2 in whole(*a, **k):
            n = len(b1.names) // 2
            yield b1.take(np.arange(n)), b2.take(np.arange(n))

    monkeypatch.setattr(fastq, "read_pairs", half)
    res = run_tiny(tiny, "chr1-pe100.wgs")
    assert not res["correct"]
    assert res["checks"]["records_missing"]["value"] > 0
    assert res["checks"]["missing"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch):
    from soap3dp_tpu_torch.io import sam

    exact = sam.translate_pos

    def off_by_one(index, tp):
        chrom, off = exact(index, tp)
        return chrom, off + 1

    monkeypatch.setattr(sam, "translate_pos", off_by_one)
    res = run_tiny(tiny, "chr1-pe100.clean")
    assert not res["correct"]
    assert res["checks"]["tags_wrong"]["value"] > 0


def test_the_rescue_windows_shifted(tiny, monkeypatch):
    """Every DP window of the port starts 40 bases late: a rescued end
    that the cut clips is still the best in its own span, and not the
    best in the window its anchor gives."""
    import dataclasses

    from soap3dp_tpu_torch.pipeline import dp_rescue

    whole = dp_rescue.run_banded_dp

    def late(didx, reads, lens, cand, ws, wl, max_win, *a, **k):
        return whole(didx, reads, lens,
                     dataclasses.replace(cand, pos=cand.pos + 40), ws + 40,
                     (wl - 40).astype(wl.dtype), max_win, *a, **k)

    monkeypatch.setattr(dp_rescue, "run_banded_dp", late)
    res = run_tiny(tiny, "chr1-pe100.wgs")
    assert not res["correct"]
    assert res["checks"]["rescue_wrong"]["value"] > 0
    assert res["checks"]["dp_wrong"]["value"] == 0


def test_no_jax_in_harness_readers_or_reference():
    """The harness's own check, in a fresh process: what it loads before
    the port, and what the reference alone loads."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, cell, trace, roofline\n"
        "from portbench.reference import judge, index, dp\n"
        "c = cell.Cell('chr1-pe100.wgs', %r)\n"
        "tops = {m.split('.', 1)[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'soap3dp_tpu',"
        " 'soap3dp_tpu_torch'}))\n" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_loaded_compares_whole_names():
    names = ("jax", "jaxlib", "flax", "soap3dp_tpu")
    assert R.loaded(names, ["soap3dp_tpu_torch.cli.main", "jaxfoo",
                            "numpy"]) == []
    assert R.loaded(names, ["jax.numpy", "soap3dp_tpu.fm"]) == [
        "jax", "soap3dp_tpu"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "chr1-pe100.clean", "--seed", "3735928559", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
