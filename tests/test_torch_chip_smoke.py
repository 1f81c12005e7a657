"""chip_smoke.py on the CPU: its golden and end-to-end phases run here
at a small size through the port's plain-torch paths, its DP problem
generators are the recipes they claim to be, and without a card (or
outside a checkout) it exits non-zero and prints no result line.
The kernel phase needs a card and runs only there."""

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
    res = chip_smoke.phase_e2e(cpu, 300_000, 400, "cpu", str(tmp_path / "w"),
                               str(tmp_path), profile=False)
    assert res["reads"] == 800 and res["recall"] >= 0.95
    s = res["summary"]
    assert s["num_records"] == 800
    assert s["paired_bwt"] and s["paired_dp"] and s["single_rescued"]
    assert (tmp_path / "e2e_stderr.log").exists()


def test_dp_problem_generators():
    from tests.test_dp import make_problems

    a = chip_smoke.make_problems(np.random.default_rng(1), 16, 30, 60, True)
    b = make_problems(np.random.default_rng(1), 16, 30, 60, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    prob = chip_smoke.main_path_problems(np.random.default_rng(2), 64, 100,
                                         256)
    assert prob[0].shape == (64, 100) and prob[2].shape == (64, 256)
    from soap3dp_tpu_torch.kernels import banded_dp as bd
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
