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


def test_bounds_edge_cases_and_launch_shapes(monkeypatch):
    """Phase 2's bounds are the larger of operations over the operations
    peak (twice the int32 peak where the 16-bit forward runs) and bytes
    over the memory rate; its edge and range cases are the shapes and
    forward forms they name; each kernel counts its launches by shape,
    which phases 4-6 print as a histogram."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    peak = 132 * 64 * 1980e6
    assert chip_smoke.OPS_PER_CELL == 4 + 6 + 7
    assert chip_smoke.forward_peak(120, bd.DPScores(), peak) == (
        2 * peak, "int16x2")
    assert chip_smoke.forward_peak(255, bd.DPScores(15, -15, -15, -15),
                                   peak)[1] == "int16x2"
    for Lr, sc in ((256, bd.DPScores()), (100, bd.DPScores(16, -2, -3, -1)),
                   (100, bd.DPScores(1, -2, -3, -16)),
                   # gap init = open - extend = -16
                   (100, bd.DPScores(1, -2, -15, 1))):
        assert chip_smoke.forward_peak(Lr, sc, peak) == (peak, "int32")
    main = chip_smoke.main_path_problems(np.random.default_rng(4), 64, 100,
                                         768)
    cells = int((main[1].astype(np.int64) * 768).sum())
    ms, by = chip_smoke.k1_bound(main, 128, 2 * peak)
    assert by == "operations"
    assert ms == pytest.approx(cells * 17 / (2 * peak) * 1e3)

    cases = chip_smoke.range_cases(np.random.default_rng(7))
    for name, prob, scores in cases:
        assert len(prob) == 9
        form = chip_smoke.forward_peak(prob[0].shape[1],
                                       bd.DPScores(*scores), peak)[1]
        assert form == ("int16x2" if name.startswith("r16") else "int32")
    ext = dict((n, p) for n, p, _ in cases)["r16_Lr255_ext15"]
    reads, wins = ext[0], ext[2]
    assert reads.shape[1] == 255 and (ext[1] == 255).all()
    # a quarter all mismatched against an all-A window, a quarter planted
    assert (wins[0::4] == 0).all() and (reads[0::4] != 0).all()
    assert all(any((wins[p, o:o + 255] == reads[p]).all()
                   for o in range(wins.shape[1] - 254))
               for p in range(1, len(reads), 4))
    # K2 writes (Lr+Lw) x P x (Lr+1) bytes: bytes bound a short-read case
    prob = chip_smoke.make_problems(np.random.default_rng(5), 8, 4, 4096)
    prob[1][:] = 1
    ms2, by2 = chip_smoke.k2_bound(prob, peak)
    assert by2 == "bytes" and ms2 == pytest.approx(
        (8 * (4 + 4096 + 48) + 4100 * 8 * 5) / chip_smoke.HBM_BYTES_PER_S
        * 1e3)
    assert chip_smoke.tb_bound(1000, 10, 128, peak)[1] == "bytes"

    cases = dict(chip_smoke.edge_cases(np.random.default_rng(6)))
    assert list(cases) == ["Lr31", "Lr32", "Lr33", "Lr127", "Lr128",
                           "Lr2047", "ties", "anchors_Lr33",
                           "overflow_Lr260"]
    for name, prob in cases.items():
        assert len(prob) == 9
        if name.startswith("Lr"):
            assert prob[0].shape[1] == int(name[2:])
    assert (cases["anchors_Lr33"][6] <= 200).all()

    k = bd.CudaKernel(bd.BANDED_DP_LIB, "soap3dp_dp_align", [])
    monkeypatch.setattr(chip_smoke, "_kernels", lambda: {"K1": k})
    for shape in ((4096, 100, 768), (12, 100, 256), (4096, 100, 768)):
        k.count(torch.device("cuda", 0), shape)
    assert k.launches == 3 and k.per_device == {0: 3}
    assert chip_smoke._launch_shapes() == {
        "K1": {"12x100x256": 1, "4096x100x768": 2}}
    k.reset()
    assert chip_smoke._launch_shapes() == {}
