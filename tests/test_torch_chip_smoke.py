"""chip_smoke.py on the CPU: its golden and end-to-end phases (default
pair, mate-pair card-vs-CPU, mate-pair full window, single-end, and the
multi-device and multi-host phase) run here
at a small size through the port's plain-torch paths, its DP problem
generators and the seed-search kernels' cases (edges, the main path's
calls, the synthetic index, the repeat genome's search) are what they
claim to be, and without a card (or outside a checkout) it exits
non-zero and prints no result line. The kernel phases need a card and
run only there."""

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
    """The golden and end-to-end phases; phase 4 keeps the first call of
    each launch shape of FS1 to FS6 (path_cases: each its entry's real
    inputs, equal to its plain version here)."""
    from soap3dp_tpu_torch.fm import fmindex

    cpu = torch.device("cpu")
    chip_smoke.phase_golden(cpu)
    kept = {}
    res, reads = chip_smoke.phase_e2e(cpu, 300_000, 400, "cpu",
                                      str(tmp_path / "w"), str(tmp_path),
                                      profile=False, kept=kept)
    assert res["reads"] == 800 and res["recall"] >= 0.95
    assert fmindex.dedupe.__name__ == "dedupe"      # the wrappers are gone
    cases = chip_smoke.path_cases(kept)
    fns = [fn for _, fn, _ in cases]
    assert set(fns) == set(chip_smoke.FS_KEPT)
    assert fns == sorted(fns, key=chip_smoke.PATH_KEPT.index)
    assert len([k for k in kept if k[0] in chip_smoke.FS_KEPT]) \
        == len(cases) > 3
    # GP's and PK's calls, one a launch shape, each equal to its plain
    # version (rescue_cases)
    rescue = chip_smoke.rescue_cases(kept, "path4")
    assert {kernel for _, kernel, _, _ in rescue} == {"GP", "PK"}
    assert len(rescue) == len([k for k in kept
                               if k[0] in chip_smoke.RESCUE_KEPT])
    seeds = [a for _, fn, a in cases if fn == "seed_expand_decode"]
    assert [a[-1] for a in seeds] == sorted((a[-1] for a in seeds),
                                            reverse=True)
    for name, fn, args in cases:
        assert name.startswith("path4_")
        got = getattr(fmindex, fn)(*args)
        want = getattr(fmindex, chip_smoke.plain_of(fn))(*args)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
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
    assert hosts["launches"] == [dict.fromkeys(
        ("K1", "K2", "TB", "FS1", "FS2", "FS2x", "FS3", "FS4", "FS2s",
         "FS5", "FS6", "GP", "PK"), 0)] * 2  # no card
    assert len(hosts["index_upload_s"]) == 2
    assert chip_smoke.phase_all_cards(cpu, reads, w) == {"not_run": "1 card"}


def test_mate_pair_phases_on_cpu(tmp_path):
    """The full-window mate rescue (-v 2000 -u 6000, -/+ library,
    SOAP3DP_HALF_NARROW_PAD=0) at a small size: the card-vs-CPU phase
    and the end-to-end phase, on the index the default phase caches,
    keeping GP's and PK's calls alone (keep=RESCUE_KEPT)."""
    cpu = torch.device("cpu")
    info = chip_smoke.phase_mate_pair_devices(cpu, str(tmp_path / "s"), 40)
    assert set(info) == {"cpu"}
    kept = {}
    res, _ = chip_smoke.phase_e2e(cpu, 300_000, 120, "cpu",
                                  str(tmp_path / "w"), str(tmp_path),
                                  profile=False, mate_pair=True, kept=kept,
                                  keep=chip_smoke.RESCUE_KEPT)
    assert {k[0] for k in kept} == set(chip_smoke.RESCUE_KEPT)
    assert res["reads"] == 240 and res["recall"] >= 0.95
    assert res["summary"]["paired_dp"] > 0
    assert (tmp_path / "mp_e2e_stderr.log").exists()
    assert "SOAP3DP_HALF_NARROW_PAD" not in os.environ


def test_accuracy_phase_on_cpu(tmp_path, capsys):
    """Phase 8 at a small size on the CPU: the easy gate on a 200 kbp
    uniform genome (cuda's place taken by cpu, so the dicts and the
    records must be equal), then repeat text at the CPU gate's size
    (4 Mbp, lut_k 11, 800 pairs: the repeat gate holds there), keeping
    the first call of each launch shape of every kernel's entry (held
    to the plain versions on a card only), with a 50-pair cross-check;
    a second call loads the cached index, and its 50 pairs fail the
    repeat gate (recall 0.72), which exits non-zero."""
    cpu = torch.device("cpu")
    gates = chip_smoke.phase_accuracy_gates(
        cpu, gates=(("easy", "random", 100, 0.01, 0.001),),
        random_bp=200_000)
    assert set(gates) == {"easy"}
    assert gates["easy"]["result"]["n_ends"] == 200
    assert gates["easy"]["records"]["records"] >= 200
    assert gates["easy"]["launches"] == dict.fromkeys(chip_smoke._kernels(),
                                                      0)  # no card
    w = str(tmp_path / "w")
    rep = chip_smoke.phase_repeat_text(cpu, "cpu", w, str(tmp_path),
                                       genome_bp=4_000_000, n_pairs=800,
                                       cross_pairs=50, lut_k=11)
    assert rep["index"] == "built" and rep["lut_k"] == 11
    res = rep["result"]
    assert res["n_ends"] == 1600 and res["still_flagged"] > 0
    assert not chip_smoke.gate_failures("repeat", res)
    assert set(chip_smoke.REPEAT_TEXT_STAGES) <= set(rep["stage_s"])
    assert rep["cross_check"]["equal"]
    assert rep["cross_check"]["result"]["n_ends"] == 100
    assert rep["cross_check"]["records"]["records"] >= 100
    # every kernel entry of the path kept (GP, PK and K1 once each at the
    # 4 Mbp gate's size), none held here: the card holds them
    kinds = {name.split("_", 1)[1].rsplit("_", 1)[0]
             for name in rep["kept_calls"]}
    assert {"seed_intervals", "expand_decode", "count_mismatches_rows",
            "dedupe", "GP", "PK", "K1"} <= kinds
    assert rep["held"] == []
    assert (tmp_path / "repeat_text_stderr.log").exists()
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase_repeat_text(cpu, "cpu", w, str(tmp_path),
                                     genome_bp=4_000_000, n_pairs=50,
                                     cross_pairs=50, lut_k=11)
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "index cached" in out
    assert "FAIL: repeat text at 4000000 bp fails ['recall >= 0.77']" in out


def test_ab_phases_on_cpu(tmp_path, capsys):
    """Phase 9 at a small size on the CPU (cuda's place taken by cpu, so
    each cross-check's two runs must be equal): the storm A/B on the
    4 Mbp repeat genome (lut_k 11, 300 pairs a pool: its repeat pool's
    default arm skips host re-align), the phased A/B on a 300 kbp genome
    (lut_k 8: the phased search engages) and the seed sensitivity on a
    2 Mbp bench genome at sa_rate 1, lut_k 10, each keeping the first
    call of each launch shape of every kernel's entry (held on a card
    only)."""
    cpu = torch.device("cpu")
    w = str(tmp_path / "w")
    storm = chip_smoke.phase_storm_ab(cpu, "cpu", w, str(tmp_path),
                                      genome_bp=4_000_000, n_per_pool=300,
                                      cross_pairs=30, lut_k=11)
    assert storm["index"] == "built" and storm["lut_k"] == 11
    assert storm["result"]["repeat"]["n_ends"] == 600
    assert set(storm["arms"]) == {"uniform/default", "uniform/full",
                                  "repeat/default", "repeat/full"}
    assert storm["arms"]["repeat/default"]["skips"] > 0
    assert storm["arms"]["repeat/full"]["skips"] == 0
    assert storm["arms"]["repeat/full"]["realigns"] > 0
    assert storm["cross_check"]["equal"]
    assert storm["cross_check"]["result"]["n_per_pool"] == 30
    assert storm["held"] == [] and storm["kept_calls"]
    assert (tmp_path / "storm_ab_stderr.log").exists()
    assert "SOAP3DP_HOST_REALIGN_FULL" not in os.environ

    phased = chip_smoke.phase_phased_ab(cpu, "cpu", w, str(tmp_path),
                                        genome_bp=300_000, n_pairs=300,
                                        cross_pairs=40)
    assert phased["result"]["records"] == 600
    assert phased["result"]["missing_either"] == 0
    assert phased["cross_check"]["result"]["records"] == 80
    assert phased["held"] == [] and phased["kept_calls"]

    seed = chip_smoke.phase_seed_sensitivity(cpu, "cpu", w, str(tmp_path),
                                             genome_bp=2_000_000,
                                             n_reads=600, cross_reads=100,
                                             lut_k=10)
    assert seed["lut_k"] == 10 and seed["sa_rate"] == 1
    ex, hv = seed["result"]["exact"], seed["result"]["halved-1mm"]
    assert 0 < ex["recall"] < hv["recall"] <= 1
    assert seed["candidate_ratio"] == hv["candidates"] / ex["candidates"]
    assert seed["cross_check"]["equal"]
    kinds = {name.split("_", 1)[1].rsplit("_", 1)[0]
             for name in seed["kept_calls"]}
    assert kinds == {"seed_intervals", "lane_counts", "seed_expand_decode"}
    assert seed["launches"] == dict.fromkeys(chip_smoke._kernels(), 0)
    capsys.readouterr()


def test_storm_checks(tmp_path, monkeypatch):
    """storm_failures on a run with no flagged read (a uniform random
    genome): the repeat pool's default arm skipped nothing, so the A/B
    measured nothing and the phase fails; and the storm A/B removes
    SOAP3DP_HOST_REALIGN_FULL after its full arm raises."""
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.tools import measure_storm_divergence as storm

    cpu = torch.device("cpu")
    genome = workloads.random_genome(np.random.default_rng(2), 400_000)
    index = build_index(genome, sa_rate=2, lut_k=8)
    res, _, log, _ = chip_smoke._counted(lambda: storm.run(
        index, genome.codes, None, 40, didx=device_index(index, "cpu")), cpu)
    arms = chip_smoke.storm_arms(log)
    assert set(arms) == {"uniform/default", "uniform/full",
                         "repeat/default", "repeat/full"}
    assert all(a["skips"] == 0 for a in arms.values())
    assert chip_smoke.storm_failures(res, arms) == [
        "the repeat pool's default arm skipped no host re-align: the A/B "
        "measured nothing"]
    skipped = dict(arms, **{"repeat/default": dict(
        arms["repeat/default"], skips=1)})
    assert chip_smoke.storm_failures(res, skipped) == []
    assert chip_smoke.storm_failures({}, {}) == [
        "no uniform", "no repeat", "no uniform/default line",
        "no uniform/full line", "no repeat/default line",
        "no repeat/full line", chip_smoke.storm_failures(res, arms)[0]]

    calls = []

    def align_once(*args):
        calls.append(os.environ.get(storm.FULL_ENV))
        if calls[-1]:
            raise RuntimeError("the full arm fails")
        return real(*args)

    real = storm.align_once
    monkeypatch.setattr(storm, "align_once", align_once)
    with pytest.raises(RuntimeError, match="the full arm fails"):
        chip_smoke.phase_storm_ab(cpu, "cpu", str(tmp_path / "w"),
                                  str(tmp_path), genome_bp=4_000_000,
                                  n_per_pool=20, cross_pairs=10, lut_k=11)
    assert calls == [None, "1"]
    assert storm.FULL_ENV not in os.environ


def _passing(name):
    """A result dict that holds gate ``name``."""
    return {"recall": 1.0, "wrong": 0.0, "unaligned": 0.0,
            "mapq30_wrong_rate": 0.0, "still_flagged": 3 if name == "repeat"
            else 0, "mapq_buckets": {"mapq30-255": {"right": 2000,
                                                    "wrong": 0}}}


# each condition of each gate: the dict's edit that breaks it, and the
# condition gate_failures names (the thresholds of tests/test_accuracy.py)
GATE_BREAKS = {
    "easy": ((dict(recall=0.9989), "recall >= 0.999"),
             (dict(wrong=0.0006), "wrong <= 0.0005")),
    "stressed": ((dict(recall=0.9949), "recall >= 0.995"),
                 (dict(mapq_buckets={"mapq30-255": {"right": 2000,
                                                    "wrong": 2}}),
                  "MAPQ>=30 wrong <= max(1, right // 2000)")),
    "repeat": ((dict(unaligned=0.0101), "unaligned <= 0.01"),
               (dict(recall=0.7699), "recall >= 0.77"),
               (dict(mapq30_wrong_rate=0.0101), "mapq30_wrong_rate <= 0.01"),
               (dict(still_flagged=0), "still_flagged > 0")),
}


@pytest.mark.parametrize("name", sorted(GATE_BREAKS))
def test_accuracy_gate_check(name):
    ok = _passing(name)
    assert chip_smoke.gate_failures(name, ok) == []
    # at the thresholds themselves the gate holds
    edge = dict(ok, recall={"easy": 0.999, "stressed": 0.995,
                            "repeat": 0.77}[name], wrong=0.0005,
                unaligned=0.01, mapq30_wrong_rate=0.01)
    assert chip_smoke.gate_failures(name, edge) == []
    for edit, cond in GATE_BREAKS[name]:
        assert chip_smoke.gate_failures(name, dict(ok, **edit)) == [cond]
    assert len(chip_smoke.gate_failures(
        name, dict(ok, **{k: v for edit, _ in GATE_BREAKS[name]
                          for k, v in edit.items()}))) \
        == len(GATE_BREAKS[name])
    # one MAPQ>=30 error is allowed below 4,000 right (max(1, ...))
    one = dict(ok, mapq_buckets={"mapq30-255": {"right": 10, "wrong": 1}})
    assert chip_smoke.gate_failures("stressed", one) == []


def test_k1_calls_kept_and_unheld_shapes():
    """_Recorder keeps K1's entry as dp_rescue calls it
    (dp_align_shards): the first call of each launch shape, one shard's
    nine inputs copied and the scores, restored on exit; k1_kept_cases
    names each by its shape and its inputs give the call's result;
    unheld_shapes lists the launched shapes no case ran at."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.pipeline import dp_rescue

    rng = np.random.default_rng(5)
    probs = [chip_smoke.main_path_problems(rng, P, 120, Lw, read_len=100)
             for P, Lw in ((24, 256), (24, 256), (16, 640))]
    kept, want = {}, []
    with chip_smoke._Recorder(record=False, kept=kept,
                              keep=chip_smoke.HELD_ENTRIES):
        for prob in probs:
            shard = [torch.from_numpy(np.ascontiguousarray(x))
                     for x in prob]
            want.append(dp_rescue.dp_align_shards([shard], bd.DPScores()))
    assert dp_rescue.dp_align_shards is bd.dp_align_shards
    assert sorted(kept) == [("dp_align_shards", 16, 120, 640),
                            ("dp_align_shards", 24, 120, 256)]
    cases = chip_smoke.k1_kept_cases(kept, "repeat")
    assert [name for name, *_ in cases] == ["repeat_K1_16x120x640",
                                            "repeat_K1_24x120x256"]
    for (name, args, sc), w in zip(cases, (want[2], want[0])):
        assert len(args) == 9 and sc == bd.DPScores()
        ok, err = chip_smoke._dp_equal(bd.dp_align_plain(*args, sc), w)
        assert ok and err == 0, name
    # a held dp_align call holds the shape of each DP kernel it launched
    rows = [{"kernel": "K1", "shape": "24x120x256",
             "held_shapes": {"K1": ["24x120x256"], "DW": ["24x246x16"],
                             "K2": [], "TB": []}},
            {"kernel": "FS1", "shape": "240x100x13"}]
    shapes = {"K1": {"24x120x256": 2, "16x120x640": 1},
              "DW": {"24x246x16": 2, "16x246x16": 1},
              "FS1": {"240x100x13": 4}, "GP": {"4521x640x100": 1}}
    assert chip_smoke.unheld_shapes(shapes, rows) == {
        "K1": ["16x120x640"], "DW": ["16x246x16"], "GP": ["4521x640x100"]}
    assert chip_smoke.unheld_shapes({"FS1": shapes["FS1"]}, rows) == {}


def test_packed_dp_calls_kept_as_nine_inputs():
    """_Recorder keeps dp_align_shards' calls in run_banded_dp's packed
    form (reads, wins, params, host cutoffs) by launch shape, the host
    cutoffs copied; k1_kept_cases gives each as dp_align's nine inputs
    (the columns of params), whose plain result is the call's, and names
    a wide-route shape K2."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd
    from soap3dp_tpu_torch.pipeline import dp_rescue

    rng = np.random.default_rng(15)
    kept, want = {}, []
    with chip_smoke._Recorder(record=False, kept=kept,
                              keep=chip_smoke.HELD_ENTRIES):
        for P, Lw in ((16, 256), (4, 4100)):
            prob = chip_smoke.main_path_problems(rng, P, 120, Lw,
                                                 read_len=100)
            params = bd.pack_params(prob[1], *prob[3:9])
            shard = (torch.from_numpy(prob[0]), torch.from_numpy(prob[2]),
                     torch.from_numpy(params), params[:, 6])
            want.append(dp_rescue.dp_align_shards([shard], bd.DPScores()))
    assert sorted(kept) == [("dp_align_shards", 4, 120, 4100),
                            ("dp_align_shards", 16, 120, 256)]
    cases = chip_smoke.k1_kept_cases(kept, "path5")
    assert [c[0] for c in cases] == ["path5_K2_4x120x4100",
                                     "path5_K1_16x120x256"]
    for (name, args, sc), w in zip(cases, (want[1], want[0])):
        assert len(args) == 9 and sc == bd.DPScores()
        ok, err = chip_smoke._dp_equal(bd.dp_align_plain(*args, sc), w)
        assert ok and err == 0, name


def test_plain_align_from_a_given_forward():
    """plain_align_from, which phase 2's wide and range cases hold the
    kernels' dp_align to (its forward the one K2 was held to), equals
    dp_align_plain on the same inputs, on small copies of the wide
    cases."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    for name, prob, sc in chip_smoke.wide_cases(np.random.default_rng(10),
                                                small=True):
        args = [torch.from_numpy(np.ascontiguousarray(x)) for x in prob]
        fwd = bd._dp_forward_scan(*args[:8], sc=sc)
        got = chip_smoke.plain_align_from(fwd, args)
        want = bd.dp_align_plain(*args, sc=sc)
        ok, err = chip_smoke._dp_equal(got, want)
        assert ok and err == 0 and got[4].shape == want[4].shape, name


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
    # past 128 runs, the traceback's first run budget before it became
    # run_budget, and within that
    assert (out[6] > 128).all()
    assert (out[6] <= bd.run_budget(127, 300)).all()
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
    # TB: 40 bytes a problem and 4 a run word beside its path's bytes
    assert chip_smoke.tb_bound(10, 1000, 128, peak) == pytest.approx(
        ((10 + 1000 * 40 + 4 * 128) / chip_smoke.HBM_BYTES_PER_S * 1e3,
         "bytes"))
    assert chip_smoke.dw_bound(100, 7, 16) == pytest.approx(
        ((1600 + 28 + 16) / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes"))

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


@pytest.fixture(scope="module")
def fs_index():
    """(genome codes, the port's CPU device index of a 60 kbp genome at
    sa_rate 4, lut_k 8)."""
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index

    genome = workloads.random_genome(np.random.default_rng(8), 60_000)
    return genome.codes, device_index(build_index(genome, sa_rate=4,
                                                  lut_k=8), "cpu")


def test_fs_cases_are_the_edges_they_name(fs_index):
    """Phase 2's FS1 / FS2 / FS3 cases: each names an entry point with
    its plain version and holds the edges it claims (short segments in
    each mode, reverse-complement rows of variable length, code and
    packed sources, SA rows at the sentinel, word boundaries and the
    last row, placements at word boundaries and the genome's end); on
    the CPU the entry point is its plain version, and the work counts
    of the bounds are what the inputs need."""
    from soap3dp_tpu_torch.fm import fmindex

    codes, didx = fs_index
    rng = np.random.default_rng(3)
    cases = (chip_smoke.fs_search_cases(rng, didx, codes, "cpu", B=32)
             + chip_smoke.fs_verify_cases(rng, didx, codes, "cpu", B=32,
                                          M=512)
             + [chip_smoke.fs_decode_case(rng, "decode", didx, "cpu", 2048)])
    names = [c[0] for c in cases]
    assert names == ["lut_codes", "lut_packed", "packed_codes",
                     "packed_packed", "general_codes", "general_packed",
                     "packed_uniform", "api_backward_search",
                     "api_backward_search_packed", "verify_codes",
                     "verify_packed", "verify_uniform", "verify_L256",
                     "verify_L300", "api_count_mismatches_packed",
                     "decode"]
    k = didx.lut_k
    for name, fn, args in cases:
        label = chip_smoke.FS_FUNCTIONS[fn]
        got = getattr(fmindex, fn)(*args)
        want = getattr(fmindex, fn + "_plain")(*args)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
        w = chip_smoke.fs_work(fn, args, want)  # its replay gives want
        if fn == "seed_intervals":
            ori, length = args[1], args[3].length
            assert (length < k).any() and (length >= k).any()
            assert ori.B * 2 * args[2] == length.shape[0]
            if name != "packed_uniform":
                assert (args[3].start >= ori.L).any()      # starts past L
                assert (ori.rc_len < k).any() and (ori.rc_len == 1).any()
        if label == "FS1":
            assert w["lanes"] == args[{"seed_intervals": 3,
                                       "backward_search": 2}.get(fn, -4)
                                      ].shape[0]
            assert (w["steps"] > 0) == (name[:3] != "lut")
            assert w["sectors"] > w["bytes"] > 0
        if label == "FS3":
            tp, n = args[1], didx.n
            assert ((tp % 16) == 0).any() and (tp == n - 1).any()
            assert (tp >> 4 == n // 16).sum() >= 16    # the last word
            assert w["placements"] == 512 and w["words"] > 0
        if fn == "count_mismatches_rows":
            ori, rows = args[2], args[3]
            rc = ori.rc_lengths()[(rows[rows >= ori.B] - ori.B)]
            if name.startswith("verify_L"):   # the kernel's other widths
                assert ori.L == int(name[len("verify_L"):])
            if name == "verify_uniform":
                assert (ori.rc_lengths() == ori.L - 10).all()
            else:   # each edge length's reverse complement is verified
                for m in chip_smoke.RC_EDGES + (ori.L,):
                    assert (rc == m).any(), (name, m)
    rows = cases[-1][2][1]
    for r in (0, 16, 31, 32, didx.primary, didx.n):
        assert (rows == r).any()
    assert chip_smoke._fs_diff(torch.ones(3), torch.ones(2))[0] > 0


def test_tb_replay_walks_inside_its_windows():
    """TB's window rule on small copies of phase 2's wide cases, through
    the plain forward: every cell a walk visits lies in the bytes its
    warp fetched, and the replay's op stream and exit state are the plain
    sweep's (so are its runs); it counts the windows and the distinct
    32-byte sectors they fetch."""
    from soap3dp_tpu_torch.kernels import banded_dp as bd

    cases = chip_smoke.wide_cases(np.random.default_rng(9), small=True)
    assert [c[0] for c in cases] == ["mate_window", "edge", "tb_long_runs"]
    for name, prob, sc in cases:
        args = [torch.from_numpy(np.ascontiguousarray(x)) for x in prob]
        bS, bI, bJ, _, dirs = bd._dp_forward_scan(*args[:8], sc=sc)
        act = bS >= args[8]
        assert act.any(), name
        want = bd._dp_traceback_plain(dirs, args[1], bI, bJ, args[4],
                                      act.numpy())
        windows, sectors = chip_smoke.tb_replay_matches(
            dirs, args[1], bI, bJ, args[4], act.numpy(), want)
        ops, state, _, _ = chip_smoke.tb_replay(dirs, bI, bJ, act)
        want_ops, want_state = bd._traceback_scan(dirs, bI, bJ, act)
        assert torch.equal(ops, want_ops), name
        assert all(torch.equal(a, b) for a, b in zip(state, want_state))
        moves = int((ops != bd.OP_NONE).sum())
        # a window holds at most TB_WINDOW moves, and a row of it at most
        # TB_WINDOW cells: three sectors
        win = chip_smoke.TB_WINDOW
        assert moves / win <= windows <= moves
        assert windows <= sectors <= 3 * win * windows, name


def test_fs_bounds_count_each_table_element_once(fs_index):
    """The FS bounds count each distinct table element the lanes gather
    once, and each 32-byte sector holding one once: FS1's l and r in one
    BWT word, lanes of one read on the same rows and SA rows of one
    interval read the same occ, BWT and mark elements."""
    from soap3dp_tpu_torch.fm import fmindex

    g = {"a": [torch.tensor([0, 1, 1, 9]), torch.tensor([9, 16])],
         "b": [torch.zeros(0, dtype=torch.int64)]}
    assert chip_smoke._gathered(g) == (4 * 4, 3 * 32)
    codes, didx = fs_index
    cases = chip_smoke.fs_search_cases(np.random.default_rng(5), didx, codes,
                                       "cpu", B=32)
    _, fn, args = next(c for c in cases if c[0] == "general_codes")
    lanes, _ = chip_smoke._fs1_lanes(fn, args)
    l, r, steps, gathers = chip_smoke.fs1_replay(didx, *lanes)
    assert all(torch.equal(a, b) for a, b in
               zip((l, r), fmindex.seed_intervals_plain(*args)))
    assert len(torch.cat(gathers["bwt"])) == 2 * steps > 0
    nbytes, _ = chip_smoke._gathered({"bwt": gathers["bwt"]})
    assert nbytes < 4 * 2 * steps
    rows = torch.arange(didx.n // 2, didx.n // 2 + 64)
    valid = torch.ones(64, dtype=torch.bool)
    out, probes, lf, g2 = chip_smoke.fs2_replay(didx, rows, valid)
    assert torch.equal(out, fmindex.sa_decode_plain(didx, rows, valid))
    assert probes == 64 + lf and lf > 0
    assert chip_smoke._gathered({"m": g2["mark_words"]})[0] < 4 * probes


def test_synthetic_index_and_its_cases():
    """The synthetic index has every table at its true size (about 5.3 GB
    at 3.2 Gbp, sa_rate 8, lut_k 13) with values in range; its cases
    run through the plain versions at a small n."""
    from soap3dp_tpu_torch.fm import fmindex

    sizes = chip_smoke.synthetic_table_sizes(3_200_000_000, 8, 13)
    assert 5.0e9 < 4 * sum(sizes.values()) < 5.6e9
    n = (1 << 20) + 5
    idx = chip_smoke.synthetic_index(torch.device("cpu"), n, lut_k=6)
    sizes = chip_smoke.synthetic_table_sizes(n, 8, 6)
    for name, size in sizes.items():
        assert getattr(idx, name).numel() == size, name
    assert idx.occ_blocks.shape == (sizes["occ_blocks"] // 8, 8)
    u32 = fmindex._u32
    assert int(u32(idx.lut_hi).max()) <= n
    assert int(u32(idx.occ_blocks[:, :4]).max()) < n // 4
    assert (u32(idx.lut_hi) >= u32(idx.lut_lo)).all()
    cases = chip_smoke.synthetic_cases(np.random.default_rng(4), idx, "cpu",
                                       B=64)
    assert [c[0] for c in cases] == [
        "synthetic_lut", "synthetic_packed", "synthetic_general",
        "synthetic_decode", "synthetic_verify", "synthetic_seed_widths",
        "synthetic_counts_search_ragged", "synthetic_counts_seed_ragged",
        "synthetic_wire_K2_65536"]
    for name, fn, args in cases:
        out = getattr(fmindex, fn)(*args)
        for t in out if isinstance(out, tuple) else (out,):
            if t.dtype == torch.int32:     # the u32 words' bit patterns
                t = t.to(torch.int64) & 0xFFFFFFFF
            assert int(t.min()) >= 0 and int(t.max()) <= max(n + 1, 1 << 32)
        if fn == "lane_counts":            # intervals past 2^31
            assert int(args[0].min()) >= 1 << 19 and int(out[1]) > 0
    assert (cases[4][2][1] >= n - 200).any()


def test_repeat_genome_search_runs_rounds_2_and_3():
    """The repeat genome's PendingSearch (SOAP3DP_ESCALATE=1) runs
    rounds 2 and 3, in both round-1 branches; here the card's side is
    the CPU too."""
    cpu = torch.device("cpu")
    didx1, out = chip_smoke.phase_repeat_search(cpu, genome_bp=400_000,
                                                unit=500, copies=400,
                                                n_reads=256)
    assert didx1.sa_rate == 1
    for heavy in ("0", "1"):
        r = out[f"repeat_heavy_{heavy}"]
        assert r["equal"] and len(set(r["caps"])) >= 2 and r["hits"] > 0
    assert "SOAP3DP_ESCALATE" not in os.environ


def test_path_calls_and_kernel_rows(fs_index):
    """The main path's kernel calls (a pair batch's round-1 search and a
    deep-DP seeding) are recorded with their arguments and pass through;
    a plain primitive on a CPU index is not counted as one on a card;
    the JSON rows of FS1, FS2, FS2x, FS3, FS4 and FS2s carry every key
    of the kernels line."""
    codes, didx = fs_index
    calls = chip_smoke.path_calls(didx, codes, B=128, seed_reads=64)
    fns = [fn for fn, _ in calls]
    assert {"seed_intervals", "lane_counts", "expand_decode", "dedupe",
            "count_mismatches_rows", "search_wire",
            "seed_expand_decode"} == set(fns)
    assert fns[0] == "seed_intervals" and calls[0][1][5] == "lut"
    assert calls[0][1][1].L == 120      # phase 4's 120-wide rows
    # the seeding as _deep_dp_round seeds 120-wide rows: 4 seeds a read
    seed = calls[-1][1]
    assert fns[-1] == "seed_expand_decode" and seed[4] == 4
    assert seed[1].shape[0] == 2 * 64 * 4
    with chip_smoke._Recorder(record=False) as rec:
        chip_smoke.path_calls(didx, codes, B=16, seed_reads=8)
    assert rec.plain_on_card == 0
    rows = [{"case": f"path{i}", "kernel": k, "ms": 1.0,
             "timer": "torch.profiler", "plain_ms": 2.0,
             "bound_ms": 0.1, "bound_by": "bytes", "sector_bound_ms": 0.5,
             "max_abs_err": 0, "shape": "8x100x3", "wall_s": 0.5, key: 8}
            for i, (k, key) in enumerate((("FS1", "lanes"), ("FS2", "rows"),
                                          ("FS2x", "slots"),
                                          ("FS3", "placements"),
                                          ("FS4", "slots"),
                                          ("FS2s", "slots"),
                                          ("FS5", "lanes"),
                                          ("FS6", "slots")))]
    out = chip_smoke.fs_kernel_rows(rows)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [r["replaces"] for r in out] == [
        "soap3dp_tpu/fm/fmindex.py:391", "soap3dp_tpu/fm/fmindex.py:509",
        "soap3dp_tpu/fm/search.py:247", "soap3dp_tpu/fm/fmindex.py:653",
        "soap3dp_tpu/fm/search.py:275",
        "soap3dp_tpu/pipeline/dp_rescue.py:176",
        "soap3dp_tpu/fm/search.py:232", "soap3dp_tpu/fm/search.py:322"]
    assert [r["name"] for r in out][-4:] == ["fm_hash_dedupe",
                                             "fm_seed_expand_decode",
                                             "fm_lane_counts",
                                             "fm_search_wire"]
    assert all(keys <= set(r) and r["route"] == "cuda" for r in out)
    # the path's FS kernels: every one but FS2's sa_decode of ready rows
    assert set(chip_smoke.FS_PATH) == set(chip_smoke.FS_ROWS) - {"FS2"}


def test_rescue_calls_kept_and_kernel_rows(fs_index):
    """_Recorder keeps the first call of each launch shape of GP's and
    PK's entries (dp_rescue._prescan_impl, _pack_problems) and lets every
    call through; rescue_cases gives each as a case whose arguments
    reproduce the call; rescue_path_rows adds their measured times and
    bounds to the JSON line's GP and PK rows."""
    from soap3dp_tpu_torch.pipeline import dp_rescue

    codes, didx = fs_index
    rng = np.random.default_rng(16)
    gp = [chip_smoke.prescan_path_case(rng, codes, M, 300)
          for M in (40, 40, 24)]
    pk = [chip_smoke.pack_path_case(rng, len(codes), didx.pac.shape[0], P,
                                    8, 256) for P in (32, 32, 16)]
    kept, want = {}, {}
    with chip_smoke._Recorder(record=False, kept=kept):
        for c in gp:
            want.setdefault(("GP", len(c["rlens"])), dp_rescue._prescan_impl(
                *chip_smoke.prescan_args(c, didx, "cpu")))
        for c in pk:
            want.setdefault(("PK", len(c["cread"])), dp_rescue._pack_problems(
                *chip_smoke.pack_args(c, didx, "cpu")))
    assert dp_rescue._prescan_impl.__name__ == "_prescan_impl"
    assert dp_rescue._pack_problems.__name__ == "_pack_problems"
    assert sorted(kept) == [("_pack_problems", 16, 120, 256),
                            ("_pack_problems", 32, 120, 256),
                            ("_prescan_impl", 24, 384, 120),
                            ("_prescan_impl", 40, 384, 120)]
    cases = chip_smoke.rescue_cases(kept, "path4")
    assert [name for name, *_ in cases] == [
        "path4_GP_40x384x120", "path4_GP_24x384x120",
        "path4_PK_32x120x256", "path4_PK_16x120x256"]
    rows = []
    for name, kernel, c, idx in cases:
        assert idx is didx
        if kernel == "GP":
            got = dp_rescue._prescan_plain(
                *chip_smoke.prescan_args(c, idx, "cpu"))
            assert torch.equal(got, want["GP", len(c["rlens"])])
            w = chip_smoke.prescan_work(c)
        else:
            got = dp_rescue._pack_problems_plain(
                *chip_smoke.pack_args(c, idx, "cpu"))
            for a, b in zip(got, want["PK", len(c["cread"])]):
                assert torch.equal(a, b)
            w = chip_smoke.pack_work(c)
        assert w["bytes"] > 0
        rows.append({"case": name, "kernel": kernel, "ms": 0.01,
                     "timer": "torch.profiler", "bound_ms": 0.001,
                     "max_abs_err": 0, "shape": name.split("_")[-1]})
    kernels = [{"name": "gapless_prescan", "max_abs_err": 0},
               {"name": "problem_pack", "max_abs_err": 0},
               {"name": "fm_hash_dedupe", "max_abs_err": 0}]
    chip_smoke.rescue_path_rows(kernels, rows)
    assert [len(r.get("path_calls", ())) for r in kernels] == [2, 2, 0]
    assert "8532x384x120" in chip_smoke.RESCUE_BEFORE_MS["GP"]
    assert "16384x120x256" in chip_smoke.RESCUE_BEFORE_MS["PK"]
    # the JSON line carries measured numbers only: the spans before the
    # redesign go to the phase line
    assert set(kernels[0]["path_calls"][0]) == {"case", "shape", "ms",
                                                "timer", "bound_ms"}


def test_expansion_and_block_edge_cases(fs_index):
    """Phase 2's cases of FS2's expand_decode (the expansion's edges at a
    K: a total of 0, past K, equal to K, one lane holding every slot)
    and of the occ blocks' edges (small indexes whose last block holds
    4, 2 or 3 BWT words): each is the edge it names, the entry point is
    its plain version on the CPU, and the replay behind the bounds gives
    the plain output, with the occ-block sectors counted beside the
    separate tables' sectors."""
    from soap3dp_tpu_torch.fm import fmindex

    codes, didx = fs_index
    rng = np.random.default_rng(12)
    RS, S, K = 600, 2, 512
    cases = chip_smoke.expansion_cases(rng, didx, "cpu", RS, S, K)
    cases += chip_smoke.block_edge_cases(rng, "cpu", m=20, B=16)
    names = [c[0] for c in cases]
    assert names == [f"expand_{e}" for e in chip_smoke.EXPANSION_EDGES] + [
        f"blocks_nw{r}_{k}" for r in (0, 2, 3)
        for k in ("decode", "expand", "search", "seed_widths")]
    totals = {}
    for name, fn, args in cases:
        got = getattr(fmindex, fn)(*args)
        want = getattr(fmindex, chip_smoke.plain_of(fn))(*args)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
        w = chip_smoke.fs_work(fn, args, want)
        assert w["block_sectors"] > 0 and w["sectors"] > 0
        if fn == "expand_decode":
            totals[name] = int(args[2][-1])
            assert w["slots"] == args[5] and w["walked"] == min(
                args[5], totals[name])
        if name.startswith("blocks"):
            assert (args[0].n // 16 + 1) % 4 == int(name[9])  # BWT words
        if fn == "seed_expand_decode":   # a 64 kbp text: below the start
            assert w["below_start"] > 0 and w["walked"] > 0
    assert totals["expand_total_0"] == 0
    assert totals["expand_total_gt_K"] > K == totals["expand_total_eq_K"]
    assert totals["expand_zeros"] < K
    one = cases[4][2][2]
    assert int((one.diff() > 0).sum()) + int(one[0] > 0) == 1
    assert int(cases[5][2][1].shape[0]) == cases[5][2][0].n + 1


def test_seed_expansion_and_dedupe_cases(fs_index):
    """Phase 2's cases of FS2's seed_expand_decode (interval widths of 0,
    1, 63, 64, 65 and 200, seeds at read offset 0 and at the read's end,
    K past, below and equal to the total, a total of 0) and of FS4 (uniq
    above and equal to K2, no pos_ok, forced collisions at the 1,024-slot
    table, K of 2^22, here 2^14): each is the edge it names, the entry
    point is its plain version on the CPU, the FS2s replay gives the
    plain output, and the forced collisions leave same-key losers."""
    from soap3dp_tpu_torch.fm import fmindex

    codes, didx = fs_index
    rng = np.random.default_rng(13)
    RS, S = 600, 4
    cases = chip_smoke.seed_expand_cases(rng, didx, "cpu", RS, S)
    cases += chip_smoke.dedupe_cases(rng, "cpu", K=4096, big=1 << 14)
    assert [c[0] for c in cases] == [
        f"seed_{e}" for e in chip_smoke.SEED_EDGES] + [
        "dedupe_uniq_gt_K2", "dedupe_uniq_eq_K2", "dedupe_no_pos_ok",
        "dedupe_collide_1024", "dedupe_K_16384"]
    work = {}
    for name, fn, args in cases:
        got = getattr(fmindex, fn)(*args)
        want = getattr(fmindex, chip_smoke.plain_of(fn))(*args)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
        work[name] = w = chip_smoke.fs_work(fn, args, want)
        assert w["bytes"] > 0
        if fn == "seed_expand_decode":
            l, incl, sp, K = args[1], args[2], args[3], args[5]
            total = int(incl[-1])
            assert w["slots"] == K and w["walked"] == min(K, total)
            assert {"widths": K > total, "total_gt_K": total > K,
                    "total_eq_K": total == K, "total_0": total == 0}[
                name[len("seed_"):]]
            if total:
                cnt = incl.diff(prepend=incl.new_zeros(1))
                assert set(cnt.tolist()) == {0, 1, 63, 64}
                assert {0, 74} <= set(sp.start.tolist())
    w = work["dedupe_uniq_gt_K2"]
    assert w["uniq"] > w["K2"] and w["hb"] == 13
    assert work["dedupe_uniq_eq_K2"]["uniq"] == work["dedupe_uniq_eq_K2"]["K2"]
    assert work["dedupe_no_pos_ok"]["uniq"] == 0
    w = work["dedupe_collide_1024"]
    assert w["hb"] == 10 and w["collided"] > 0 and w["surviving_dups"] > 0
    assert work["dedupe_K_16384"]["slots"] == 1 << 14


def test_count_and_wire_cases(fs_index):
    """Phase 2's cases of FS5 (the search's mode with lanes not a
    multiple of the tile, an overflow on one strand only, cap 4,096, one
    read; the seeding's, and a total of 0) and FS6 (reads not a multiple
    of 32, mismatches past k and past 127, slots past uniq, K2 of 0):
    each is the edge it names, the entry point is its plain version on
    the CPU, a case gives each call its own copy of what the entry
    writes in place, and the bounds count 24 bytes a lane, 25 a slot and
    8 more a slot that holds a hit (its urow, read only there);
    FS5's one PyTorch call is the scan of its counts; a search profile's
    library launches are the items of no FS kernel, marker or copy."""
    from soap3dp_tpu_torch.fm import fmindex

    rng = np.random.default_rng(17)
    B, S = 300, 2
    cases = chip_smoke.count_cases(rng, "cpu", B, S, 3000 * 4, 4)
    cases += chip_smoke.wire_cases(rng, "cpu", 100, 700)
    assert [c[0] for c in cases] == [
        f"counts_{e}" for e in chip_smoke.COUNT_EDGES] + [
        "wire_K2_700", "wire_K2_0"]
    for name, fn, args in cases:
        a, b = chip_smoke.fresh_args(fn, args), chip_smoke.fresh_args(fn, args)
        if fn in chip_smoke.FS_WRITES and len(args) > 4:
            i = chip_smoke.FS_WRITES[fn]
            assert a[i] is not b[i] and a[i] is not args[i]
        got = getattr(fmindex, fn)(*a)
        want = getattr(fmindex, chip_smoke.plain_of(fn))(*b)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
        w = chip_smoke.fs_work(fn, args, want)
        lib = chip_smoke.library_call(fn, args, want)
        if fn == "lane_counts":
            RS = args[0].shape[0]
            assert w["lanes"] == RS and w["bytes"] >= 24 * RS
            assert torch.equal(lib(), want[0])      # the scan of the counts
            search = len(args) > 4
            assert w["mode"] == ("search" if search else "seed")
            if name.endswith(("ragged", "cap4096")):
                assert RS % 1024
            if search:
                b_reads = RS // (2 * S)
                assert args[4].shape[0] == -(-b_reads // 32)
                bits = ((want[2].long()[:, None] >> torch.arange(32)) & 1
                        ).reshape(-1)[:b_reads]
                if b_reads >= 2:             # one strand's overflow alone
                    assert bits[0] == 1 and bits[1] == 1
            if name == "counts_seed_total_0":
                assert int(want[1]) == 0
        else:
            assert lib is None and w["slots"] == args[4].shape[0]
            assert w["bytes"] == 25 * w["slots"] + 8 * w["hits"] + 24
            assert w["hits"] < w["slots"] or not w["slots"]
            assert args[1] % 32 and got.dtype == torch.int32
            if w["slots"]:
                meta = got[-w["slots"]:].long() & 0xFFFFFFFF
                nm = (meta >> 24) & 127
                assert (nm == 127).any() and ((meta >> 31) == 0).any()
                assert ((meta & 0xFFFFFF) == 0xFFFFFF).any()
    items = {"expand_decode_kernel<1>": [0.1, 2], "Memcpy DtoH": [0.2, 1],
             "void at::native::vectorized_elementwise_kernel": [0.01, 3],
             "spin_kernel": [1.0, 2], "search_wire_kernel": [0.01, 1]}
    assert chip_smoke.library_items(items) == {
        "void at::native::vectorized_elementwise_kernel": 3}


def test_count_edge_cases(fs_index):
    """Phase 2's FS5 cases at the edges of its tile: one lane; one below,
    at and one above one and two tiles (the seeding's mode), two below,
    at and two above a tile (the search's, S = 1); intervals past 2^31;
    lanes x cap just under 2^31 in both modes. Each is the edge it
    names; on the CPU the entry point is its plain version; the bound
    counts 24 bytes a lane."""
    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.kernels import fm_search as fs

    cases = chip_smoke.count_edge_cases(np.random.default_rng(23), "cpu")
    tile = fs.COUNT_TILE
    lanes = {}
    for name, fn, args in cases:
        got = fmindex.lane_counts(*chip_smoke.fresh_args(fn, args))
        want = fmindex.lane_counts_plain(*chip_smoke.fresh_args(fn, args))
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
        w = chip_smoke.fs_work(fn, args, want)
        lanes[name] = RS = args[0].shape[0]
        assert w["bytes"] >= 24 * RS
        if "past_2^31" in name:
            assert int(args[0].min()) >= 1 << 31
        if "near_2^31" in name:
            assert (1 << 31) - RS <= RS * args[2] < 1 << 31
            assert int(want[1]) > (1 << 31) - 2 * RS
    assert lanes["counts_edge_one_lane"] == 1
    assert {tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile + 1} <= set(
        v for k, v in lanes.items() if "_seed_" in k)
    assert {tile - 2, tile, tile + 2} <= set(
        v for k, v in lanes.items() if "_search_" in k)


def test_scan_share_check_on_cpu():
    """FS5's calls around FS4's on the scan state they share
    (chip_smoke.scan_share_check): on the CPU, the plain versions, every
    output equal, six calls."""
    assert chip_smoke.scan_share_check(np.random.default_rng(31), "cpu") == 6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fs5_edges_and_shared_scan_state_on_the_card():
    """FS5 against lane_counts_plain on the card at its tile's edges, in
    both modes (chip_smoke.count_edge_cases), every element, one launch a
    call; then FS5 and FS4 calls in a row on the scan state they share
    (chip_smoke.scan_share_check), its size, generation and tickets
    after each call."""
    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.kernels import fm_search as fs

    dev = _card()
    rng = np.random.default_rng(37)
    for name, fn, args in chip_smoke.count_edge_cases(rng, dev):
        n0 = fs.LANE_COUNTS_KERNEL.launches
        got = fmindex.lane_counts(*chip_smoke.fresh_args(fn, args))
        assert fs.LANE_COUNTS_KERNEL.launches == n0 + 1
        want = fmindex.lane_counts_plain(*chip_smoke.fresh_args(fn, args))
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
    assert chip_smoke.scan_share_check(rng, dev) == 6


@pytest.mark.cuda
def test_fs1_fs3_new_argument_forms_on_the_card():
    """FS1 with its seeds made from the reads' lengths and FS3 with the
    dedupe's placements as they are (chip_smoke.seed_bound_cases,
    placement_cases), on a 2 Mbp index, against their plain versions,
    every element."""
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm import fmindex
    from soap3dp_tpu_torch.index.builder import build_index

    dev = _card()
    rng = np.random.default_rng(41)
    genome = workloads.random_genome(rng, 2_000_000)
    didx = fmindex.device_index(build_index(genome, sa_rate=2, lut_k=10),
                                dev)
    for name, fn, args in (
            chip_smoke.seed_bound_cases(rng, didx, genome.codes, dev)
            + chip_smoke.placement_cases(rng, didx, genome.codes, dev)):
        got = getattr(fmindex, fn)(*args)
        want = getattr(fmindex, chip_smoke.plain_of(fn))(*args)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name


def test_seed_bound_and_placement_cases(fs_index):
    """Phase 2's FS1 cases with seeds made from the reads' lengths (the
    pigeonhole edges: reads of length 0 and shorter than S, seed_q, a
    seed range, uneven lengths, a mesh-padded and a uniform batch; the
    staged seeds' edges) and FS3's with the dedupe's placements as they
    are (sentinel rows, invalid slots of any position): each is the edge
    it names, the entry point is its plain version on the CPU, and the
    replay behind FS1's bound gives the plain output."""
    from soap3dp_tpu_torch.fm import fmindex

    codes, didx = fs_index
    rng = np.random.default_rng(29)
    cases = (chip_smoke.seed_bound_cases(rng, didx, codes, "cpu", B=64)
             + chip_smoke.placement_cases(rng, didx, codes, "cpu", B=64,
                                          M=2000))
    assert [c[0] for c in cases] == [
        "seeds_len0", "seeds_shorter_than_S", "seeds_seed_q",
        "seeds_seed_range", "seeds_uneven", "seeds_mesh_pad",
        "seeds_uniform", "seeds_staged_short_reads",
        "seeds_staged_pos_past_end", "seeds_staged_len0",
        "verify_placements_ragged", "verify_placements_uniform"]
    for name, fn, args in cases:
        got = getattr(fmindex, fn)(*args)
        want = getattr(fmindex, chip_smoke.plain_of(fn))(*args)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
        w = chip_smoke.fs_work(fn, args, want)   # FS1's replay gives want
        assert w["bytes"] > 0
        if fn == "seed_intervals":
            ori, S, seeds = args[1], args[2], args[3]
            start, length = seeds.bounds(S)
            assert start.shape[0] == 2 * ori.B * S and seeds.start is None
            if name in ("seeds_len0", "seeds_shorter_than_S",
                        "seeds_staged_len0"):
                assert (length == 0).any() and (length > 0).any()
            if name == "seeds_seed_range":
                assert seeds.lo == 1 and S == 2
            if name == "seeds_staged_pos_past_end":
                assert (seeds.pos.long().max(dim=1).values
                        > seeds.lens.long()).any()
        else:
            valid = args[5]
            assert (~valid).any() and (args[3][~valid] == 0x7FFFFFFF).all()
            assert w["placements"] == args[1].shape[0]


def test_rank_by_loss_over_a_launch_histogram():
    """Kernels ranked by launches x (time - bound) over a launch-shape
    histogram, the largest loss first; a launched shape with no time is
    left out of the sum and listed; a timed shape never launched adds
    nothing."""
    shapes = {"FS4": {"8x8x10": 1, "16x8x10": 2},
              "PK": {"4x120x256": 3, "9x120x256": 1},
              "GP": {"2x384x120": 1}}
    timed = {"FS4": {"8x8x10": (0.010, 0.002), "16x8x10": (0.020, 0.005)},
             "PK": {"4x120x256": (0.006, 0.001)},
             "GP": {"2x384x120": (0.004, 0.003), "3x384x120": (1.0, 0.0)},
             "FS2s": {"1x1x2": (0.5, 0.1)}}
    out = chip_smoke.rank_by_loss(shapes, timed)
    assert [r["kernel"] for r in out] == ["FS4", "PK", "GP", "FS2s"]
    assert out[0]["loss_ms"] == pytest.approx(0.008 + 2 * 0.015)
    assert out[0]["launches"] == 3 and out[0]["untimed"] == []
    assert out[1]["loss_ms"] == pytest.approx(3 * 0.005)
    assert out[1]["untimed"] == ["9x120x256"] and out[1]["launches"] == 3
    assert out[2]["loss_ms"] == pytest.approx(0.001)
    assert out[3] == {"kernel": "FS2s", "loss_ms": 0.0, "launches": 0,
                      "untimed": []}


def test_more_dedupe_and_seed_cases(fs_index):
    """Phase 2's FS4 cases at its launches' edges (K not a multiple of
    a tile or a block with uniq > K2, every key in one table slot, one
    key everywhere), FS4's repeat
    on one table, FS2s where its warps search for lanes (98% empty
    lanes, one row of fewer lanes than a warp, K odd): each is the edge
    it names and the entry point is its plain version on the CPU."""
    from soap3dp_tpu_torch.fm import fmindex

    _, didx = fs_index
    rng = np.random.default_rng(16)
    cases = chip_smoke.dedupe_more_cases(rng, "cpu", ragged=1299)
    cases += chip_smoke.seed_lane_cases(rng, didx, "cpu", 600, 4)
    names = [c[0] for c in cases]
    assert names == ["dedupe_K_1299", "dedupe_one_slot", "dedupe_one_key",
                     "seed_sparse", "seed_one_row", "seed_K_odd"]
    work = {}
    for name, fn, args in cases:
        got = getattr(fmindex, fn)(*args)
        want = getattr(fmindex, chip_smoke.plain_of(fn))(*args)
        assert chip_smoke._fs_diff(got, want) == (0, 0), name
        work[name] = chip_smoke.fs_work(fn, args, want)
    w = work["dedupe_K_1299"]
    assert w["slots"] % 1024 and w["slots"] % 256 and w["uniq"] > w["K2"]
    w = work["dedupe_one_slot"]
    assert w["collided"] == w["pos_ok"] - 1 == w["uniq"] - 1
    assert work["dedupe_one_key"]["uniq"] == 1
    args = dict((n, a) for n, _, a in cases)
    cnt = args["seed_sparse"][2].diff()
    assert float((cnt == 0).float().mean()) > 0.95
    assert work["seed_sparse"]["walked"] == int(args["seed_sparse"][2][-1])
    one = args["seed_one_row"]
    assert one[1].shape[0] == one[4] == 4 and one[5] % 32
    assert 0 < one[5] < int(one[2][-1])
    odd = args["seed_K_odd"]
    assert odd[5] % 2 == 1 and odd[5] < int(odd[2][-1])
    assert chip_smoke.dedupe_repeat_check(rng, "cpu") == 5


def test_prescan_cases_and_kernel_row(fs_index):
    """Phase 2's GP cases: the path-shaped chunks of phases 4 and 5
    (PRESCAN_PATH's windows, at a small M), the edges on prescan_genome's
    index and the synthetic index's case are what they name, run through
    the plain version on the CPU, with the bound's count of valid offsets
    and words; the grouped conv1d yardstick gives the same output; the
    JSON row of GP carries every key of the kernels line."""
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.pipeline import dp_rescue

    codes, didx = fs_index
    rng = np.random.default_rng(14)
    for name, (_, win) in chip_smoke.PRESCAN_PATH.items():
        c = chip_smoke.prescan_path_case(rng, codes, 300, win)
        O = {300: 384, 4100: 4224}[win]
        assert (c["O"], c["W"], c["reads"].shape) == (O, O + 128, (300, 120))
        assert (c["rlens"] == 100).all() and not c["reads"][:, 100:].any()
        args = chip_smoke.prescan_args(c, didx, "cpu")
        want = dp_rescue._prescan_plain(*args)
        assert torch.equal(dp_rescue._prescan_impl(*args), want)
        found = float((want[:, 0] == 0).double().mean())
        assert 0.5 < found < 0.95, (name, found)  # substitutions, deletions
        conv, out = chip_smoke.prescan_conv1d(args)
        assert torch.equal(out, want)
        w = chip_smoke.prescan_work(c)
        valid = np.clip(np.minimum(O - 1, c["wlens"] - 100) + 1, 0, None)
        assert w["valid_offsets"] == valid.sum() and w["words"] == 7 * (
            valid.sum()) and w["ops"] == 5 * w["words"]
        ms, by = chip_smoke.prescan_bound(w, 16.7e12)
        assert by == "operations" and ms == w["ops"] / 16.7e12 * 1e3
    genome = chip_smoke.prescan_genome()
    s, n = chip_smoke.PRESCAN_POLY_A
    assert not genome.codes[s:s + n].any()
    edx = device_index(build_index(genome, sa_rate=8), "cpu")
    for name in chip_smoke.PRESCAN_EDGES:
        c = chip_smoke.prescan_edge_case(name, genome.codes)
        args = chip_smoke.prescan_args(c, edx, "cpu")
        assert torch.equal(dp_rescue._prescan_impl(*args),
                           dp_rescue._prescan_plain(*args))
    n = (1 << 20) + 5
    syn = chip_smoke.synthetic_index(torch.device("cpu"), n, lut_k=6)
    c = chip_smoke.prescan_synthetic_case(rng, syn, "cpu", M=64)
    assert (c["ws"] + c["wlens"] <= n).all() and (c["ws"] + c["wlens"]
                                                   == n).any()
    out = dp_rescue._prescan_plain(*chip_smoke.prescan_args(c, syn, "cpu"))
    assert (out[:32, 0] == 0).all()   # the planted half, found
    rows = [{"case": case, "kernel": "GP", "ms": 1.0, "timer": "torch.profiler",
             "plain_ms": 2.0, "bound_ms": 0.1, "bound_by": "operations",
             "bound_term": "operations", "library_ms": 3.0,
             "max_abs_err": 0, "shape": "8x384x120", "wall_s": 0.5}
            for case in ("path_phase4", "path_phase5", "edge_one")]
    row = chip_smoke.gp_kernel_row(rows)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert keys <= set(row) and row["route"] == "cuda"
    assert row["replaces"] == "soap3dp_tpu/pipeline/dp_rescue.py:276"
    assert "GP" in chip_smoke._kernels()


def test_pack_cases_and_kernel_row(fs_index):
    """Phase 2's PK cases: the path-shaped calls of phases 4 and 5
    (PACK_PATH's shapes, at a small P), the edges on prescan_genome's
    index and the synthetic index's windows past 2^31 are what they
    name, run through the plain version on the CPU, with the bound's
    count of distinct pac words and rows; the JSON row of PK carries
    every key of the kernels line."""
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.pipeline import dp_rescue

    codes, didx = fs_index
    rng = np.random.default_rng(15)
    n_pac = didx.pac.shape[0]
    for name, (_, _, W) in chip_smoke.PACK_PATH.items():
        c = chip_smoke.pack_path_case(rng, len(codes), n_pac, 64, 40, W)
        assert c["reads"].shape == (40, 120) and c["un"] == 100
        assert set(c["cread"]) == set(range(40))
        assert (c["win_start"] + W <= len(codes)).all()
        args = chip_smoke.pack_args(c, didx, "cpu")
        oriented, wins = dp_rescue._pack_problems(*args)
        assert oriented.shape == (64, 120) and wins.shape == (64, W)
        ws = c["win_start"][0]
        np.testing.assert_array_equal(wins[0].numpy(), codes[ws:ws + W])
        w = chip_smoke.pack_work(c)
        assert w["read_rows"] == 40 and w["problems"] == 64
        assert w["pac_words"] <= 64 * (W // 16 + 1)
        assert w["bytes"] == (64 * (120 + W) + 4 * w["pac_words"]
                              + 40 * 120 + 64 * 16)
        ms, by = chip_smoke.pack_bound(w)
        assert by == "bytes" and ms == w["bytes"] / 3.35e12 * 1e3
    genome = chip_smoke.prescan_genome()
    edx = device_index(build_index(genome, sa_rate=8), "cpu")
    for name in chip_smoke.PACK_EDGES:
        c = chip_smoke.pack_edge_case(name, len(genome.codes),
                                      edx.pac.shape[0])
        args = chip_smoke.pack_args(c, edx, "cpu")
        for a, b in zip(dp_rescue._pack_problems(*args),
                        dp_rescue._pack_problems_plain(*args)):
            assert torch.equal(a, b)
    n = (1 << 20) + 5
    syn = chip_smoke.synthetic_index(torch.device("cpu"), n, lut_k=6)
    c = chip_smoke.pack_synthetic_case(rng, syn, P=64, rows=16, max_win=300)
    ws = c["win_start"]
    assert (ws >= n // 2).all() and (ws + 300 == n).any()
    assert (ws + 300 > n).any()
    rows = [{"case": case, "kernel": "PK", "ms": 1.0, "timer": "torch.profiler",
             "plain_ms": 2.0, "bound_ms": 0.1, "bound_by": "bytes",
             "library_ms": None, "max_abs_err": 0,
             "shape": "16384x120x4224", "wall_s": 0.5}
            for case in ("path_phase4", "path_phase5", "edge_uniform")]
    row = chip_smoke.pk_kernel_row(rows)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert keys <= set(row) and row["route"] == "cuda"
    assert row["replaces"] == "soap3dp_tpu/pipeline/dp_rescue.py:357"
    assert "PK" in chip_smoke._kernels()
