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
    assert hosts["launches"] == [dict.fromkeys(
        ("K1", "K2", "TB", "FS1", "FS2", "FS2x", "FS3", "FS4", "FS2s", "GP",
         "PK"), 0)] * 2  # no card
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
            ori, length = args[1], args[4]
            assert (length < k).any() and (length >= k).any()
            assert ori.B * 2 * args[2] == length.shape[0]
            if name != "packed_uniform":
                assert (args[3] >= ori.L).any()      # starts past L
                assert (ori.rc_len < k).any() and (ori.rc_len == 1).any()
        if label == "FS1":
            assert w["lanes"] == args[-4 if fn != "backward_search" else 2
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
            rc = ori.rc_len[(rows[rows >= ori.B] - ori.B)]
            if name.startswith("verify_L"):   # the kernel's other widths
                assert ori.L == int(name[len("verify_L"):])
            if name == "verify_uniform":
                assert (ori.rc_len == ori.L - 10).all()
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
    assert [c[0] for c in cases] == ["mate_window", "edge", "tb_relaunch"]
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
        "synthetic_decode", "synthetic_verify"]
    for name, fn, args in cases:
        out = getattr(fmindex, fn)(*args)
        for t in out if isinstance(out, tuple) else (out,):
            assert int(t.min()) >= 0 and int(t.max()) <= max(n + 1, 1 << 32)
    assert (cases[-1][2][1] >= n - 200).any()


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
    assert {"seed_intervals", "expand_decode", "dedupe",
            "count_mismatches_rows", "seed_expand_decode"} == set(fns)
    assert fns[0] == "seed_intervals" and calls[0][1][6] == "lut"
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
                                          ("FS2s", "slots")))]
    out = chip_smoke.fs_kernel_rows(rows)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [r["replaces"] for r in out] == [
        "soap3dp_tpu/fm/fmindex.py:391", "soap3dp_tpu/fm/fmindex.py:509",
        "soap3dp_tpu/fm/search.py:247", "soap3dp_tpu/fm/fmindex.py:653",
        "soap3dp_tpu/fm/search.py:275",
        "soap3dp_tpu/pipeline/dp_rescue.py:176"]
    assert [r["name"] for r in out][-2:] == ["fm_hash_dedupe",
                                             "fm_seed_expand_decode"]
    assert all(keys <= set(r) and r["route"] == "cuda" for r in out)
    # the path's FS kernels: every one but FS2's sa_decode of ready rows
    assert set(chip_smoke.FS_PATH) == set(chip_smoke.FS_ROWS) - {"FS2"}


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
            assert w["slots"] == args[6] and w["walked"] == min(
                args[6], totals[name])
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
                assert {0, 74} <= set(sp.tolist())
    w = work["dedupe_uniq_gt_K2"]
    assert w["uniq"] > w["K2"] and w["hb"] == 13
    assert work["dedupe_uniq_eq_K2"]["uniq"] == work["dedupe_uniq_eq_K2"]["K2"]
    assert work["dedupe_no_pos_ok"]["uniq"] == 0
    w = work["dedupe_collide_1024"]
    assert w["hb"] == 10 and w["collided"] > 0 and w["surviving_dups"] > 0
    assert work["dedupe_K_16384"]["slots"] == 1 << 14


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
                              + 40 * 128 + 64 * 17)
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
