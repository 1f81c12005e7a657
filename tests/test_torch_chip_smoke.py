"""chip_smoke.py on the CPU: its golden and end-to-end phases (default
pair, mate-pair card-vs-CPU, mate-pair full window, single-end, and the
multi-device and multi-host phase) run here
at a small size through the port's plain-torch paths, its DP problem
generators are the recipes they claim to be, and without a card (or
outside a checkout) it exits non-zero and prints no result line.
The kernel phases need a card and run only there."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_and_e2e_phases_on_cpu(tmp_path):
    cpu = torch.device("cpu")
    chip_smoke.phase_golden(cpu)
    res, reads = chip_smoke.phase_e2e(cpu, 300_000, 400, "cpu",
                                      str(tmp_path / "w"), str(tmp_path),
                                      profile=False)
    assert res["reads"] == 800 and res["recall"] >= 0.95
    s = res["summary"]
    assert s["num_records"] == 800
    assert s["paired_bwt"] and s["paired_dp"] and s["single_rescued"]
    assert (tmp_path / "e2e_stderr.log").exists()
    se = chip_smoke.phase_single_e2e(cpu, reads, "cpu", str(tmp_path / "w"),
                                     str(tmp_path))
    assert se["reads"] == 400 and se["recall"] >= 0.95
    assert se["summary"]["aligned_dp"] > 0     # the salvage phase ran
    assert (tmp_path / "se_e2e_stderr.log").exists()


def test_multi_device_phases_on_cpu(tmp_path):
    """Phase 7 at a small size: a default pair run (phase 4), then the
    same inputs on a two-replica mesh (and dp_align(mesh=)), through two
    --hosts 2 processes, and the all-card phase, not run on the CPU."""
    cpu = torch.device("cpu")
    w = str(tmp_path / "w")
    _, reads = chip_smoke.phase_e2e(cpu, 200_000, 200, "cpu", w,
                                    str(tmp_path), profile=False)
    mesh = chip_smoke.phase_mesh(cpu, reads, w, str(tmp_path),
                                 dp_case=(9, 40, 200, 30))
    assert mesh["records_equal"] and mesh["summary_equal"]
    assert mesh["devices"] == ["cpu", "cpu"] and mesh["dp_align"]["equal"]
    hosts = chip_smoke.phase_hosts(cpu, reads, w, str(tmp_path), timeout=300)
    assert hosts["records_equal"] and hosts["summary_equal"]
    assert sum(hosts["per_process_pairs"]) == 200
    assert hosts["launches"] == [{"K1": 0, "K2": 0, "TB": 0}] * 2  # no card
    assert len(hosts["index_upload_s"]) == 2
    assert chip_smoke.phase_all_cards(cpu, reads, w) == {"not_run": "1 card"}


def test_mate_pair_phases_on_cpu(tmp_path):
    """The full-window mate rescue (-v 2000 -u 6000, -/+ library,
    SOAP3DP_HALF_NARROW_PAD=0) at a small size: the card-vs-CPU phase
    and the end-to-end phase, on the index the default phase caches."""
    cpu = torch.device("cpu")
    info = chip_smoke.phase_mate_pair_devices(cpu, str(tmp_path / "s"), 40)
    assert set(info) == {"cpu"}
    res, _ = chip_smoke.phase_e2e(cpu, 300_000, 120, "cpu",
                                  str(tmp_path / "w"), str(tmp_path),
                                  profile=False, mate_pair=True)
    assert res["reads"] == 240 and res["recall"] >= 0.95
    assert res["summary"]["paired_dp"] > 0
    assert (tmp_path / "mp_e2e_stderr.log").exists()
    assert "SOAP3DP_HALF_NARROW_PAD" not in os.environ


def test_dp_problem_generators():
    from tests.test_dp import make_problems

    a = chip_smoke.make_problems(np.random.default_rng(1), 16, 30, 60, True)
    b = make_problems(np.random.default_rng(1), 16, 30, 60, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    prob = chip_smoke.main_path_problems(np.random.default_rng(2), 64, 100,
                                         256)
    assert prob[0].shape == (64, 100) and prob[2].shape == (64, 256)
    mate = chip_smoke.main_path_problems(np.random.default_rng(2), 8, 120,
                                         4224, read_len=100)
    assert mate[0].shape == (8, 120) and (mate[1] == 100).all()
    assert not mate[0][:, 100:].any()
    from soap3dp_tpu_torch.kernels import banded_dp as bd
    relaunch = chip_smoke.relaunch_problems(np.random.default_rng(3), 2, 127,
                                            300)
    out = bd.dp_align(*[torch.from_numpy(x) for x in relaunch],
                      sc=bd.DPScores(1, -2, -1, -1))
    # past the traceback kernel's first run budget
    assert (out[6] > max(bd.MAX_RUNS, bd._max_runs_bound(127))).all()
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in prob]
    out = bd.dp_align(*args)
    npass = int((out[6] > 0).sum())
    assert 40 <= npass < 64     # most place; the random reads do not
    ok, err = chip_smoke._dp_equal(out, out)
    assert ok and err == 0


def _run(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def test_refuses_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(ROOT)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path))
    assert res.returncode != 0 and '"ok"' not in res.stdout
