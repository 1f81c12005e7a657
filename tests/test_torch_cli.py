"""`soap3dp-torch --device cpu` against `soap3dp`, command by command
(pair, single, pair-multi, single-multi) on tiny FASTQ files: the same
SAM records (header @PG aside, sorted because deferred rescue records
interleave on a worker thread). The mate-pair case (a -/+ library of
2.5-5.5 kbp inserts, -v 2000 -u 6000, SOAP3DP_HALF_NARROW_PAD=0) drives
the half rescue over the whole insert window, the path on which the
reference runs dp_forward at windows of 4096 and more."""

import numpy as np
import pytest
import torch

from soap3dp_tpu.utils import dna

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)



@pytest.fixture(scope="module")
def pe_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(404)
    codes = rng.integers(0, 4, 40_000).astype(np.uint8)
    seq = dna.decode(codes).decode()
    fa = d / "g.fa"
    with open(fa, "w") as f:
        f.write(">chrA\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i:i + 60] + "\n")
    from soap3dp_tpu.cli.builder import main as builder_main
    assert builder_main([str(fa)]) == 0
    B, L, INS = 40, 80, 250
    pos = rng.integers(0, len(codes) - INS - 1, B)
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for b in range(B):
            left = codes[pos[b]:pos[b] + L].copy()
            right = dna.revcomp_codes(codes[pos[b] + INS - L:pos[b] + INS])
            if b % 4 == 1:      # indel in one end: DP rescue
                right = np.concatenate([right[:30], right[33:],
                                        rng.integers(0, 4, 3)]).astype(np.uint8)
            if b % 4 == 2:      # mismatches
                left[[5, 40, 70]] = (left[[5, 40, 70]] + 1) % 4
            if b % 8 == 3:      # garbage end
                left = rng.integers(0, 4, L).astype(np.uint8)
            f1.write(f"@p{b}\n{dna.decode(left).decode()}\n+\n{'I' * L}\n")
            f2.write(f"@p{b}\n{dna.decode(right).decode()}\n+\n{'5' * L}\n")
    return d, B


def _records(path):
    with open(path) as fh:
        return sorted(l for l in fh if not l.startswith("@PG"))


def test_port_cli_matches_reference_cli(pe_files):
    from soap3dp_tpu.cli.main import main as ref_main
    from soap3dp_tpu_torch.cli.main import main as port_main

    d, B = pe_files
    common = [str(d / "g.fa.index"), str(d / "r1.fq"), str(d / "r2.fq"),
              "-v", "100", "-u", "400"]
    assert ref_main(["pair"] + common + ["-o", str(d / "ref")]) == 0
    assert port_main(["pair"] + common + ["-o", str(d / "port"),
                                          "--device", "cpu"]) == 0
    want = _records(d / "ref.sam")
    got = _records(d / "port.sam")
    assert len([l for l in got if not l.startswith("@")]) == 2 * B
    assert got == want
    assert (d / "port.done").exists()


def test_default_device_needs_cuda(pe_files):
    """--device defaults to cuda; without a card the CLI raises instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from soap3dp_tpu_torch.cli.main import main as port_main
    from soap3dp_tpu_torch.cli.runner import resolve_device

    d, _ = pe_files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["pair", str(d / "g.fa.index"), str(d / "r1.fq"),
                   str(d / "r2.fq"), "-o", str(d / "never")])
    assert not (d / "never.sam").exists()


@pytest.mark.parametrize("cmd,n", [("pair", 2), ("single", 3)])
def test_devices_match_one_device(pe_files, cmd, n):
    """--devices N on the CPU (N replicas of the index, every batch
    sharded over them) writes the SAM of --devices 1."""
    from soap3dp_tpu_torch.cli.main import main as port_main

    d, _ = pe_files
    inputs = [str(d / "r1.fq")]
    if cmd == "pair":
        inputs += [str(d / "r2.fq"), "-v", "100", "-u", "400"]
    for k in (1, n):
        assert port_main([cmd, str(d / "g.fa.index")] + inputs + [
            "-o", str(d / f"dev_{cmd}_{k}"), "--device", "cpu",
            "--devices", str(k)]) == 0
    got = _records(d / f"dev_{cmd}_{n}.sam")
    assert len(got) > 2
    assert got == _records(d / f"dev_{cmd}_1.sam")


def test_hosts_need_host_id_and_coordinator(pe_files, capsys, monkeypatch):
    """--hosts above 1 without a host id or a coordinator (flags or
    environment) exits 2 and writes nothing: never a one-process run."""
    from soap3dp_tpu_torch.cli.main import main as port_main

    for var in ("SOAP3DP_NUM_HOSTS", "SOAP3DP_HOST_ID", "SOAP3DP_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    d, _ = pe_files
    base = ["pair", str(d / "g.fa.index"), str(d / "r1.fq"), str(d / "r2.fq"),
            "-o", str(d / "never_mh"), "--device", "cpu"]
    assert port_main(base + ["--hosts", "2", "--host-id", "0"]) == 2
    assert "needs --host-id and --coordinator" in capsys.readouterr().err
    assert port_main(base + ["--hosts", "2", "--coordinator",
                             "127.0.0.1:1"]) == 2
    assert port_main(base + ["--hosts", "2", "--host-id", "2",
                             "--coordinator", "127.0.0.1:1"]) == 2
    assert "not in [0, 2)" in capsys.readouterr().err
    monkeypatch.setenv("SOAP3DP_NUM_HOSTS", "2")
    assert port_main(base) == 2
    assert not list(d.glob("never_mh*"))


def test_single_matches_reference_cli(pe_files):
    from soap3dp_tpu.cli.main import main as ref_main
    from soap3dp_tpu_torch.cli.main import main as port_main

    d, B = pe_files
    common = [str(d / "g.fa.index"), str(d / "r1.fq")]
    assert ref_main(["single"] + common + ["-o", str(d / "sref")]) == 0
    assert port_main(["single"] + common + ["-o", str(d / "sport"),
                                            "--device", "cpu"]) == 0
    got = _records(d / "sport.sam")
    assert len([l for l in got if not l.startswith("@")]) == B
    assert got == _records(d / "sref.sam")
    assert (d / "sport.done").exists()


@pytest.mark.parametrize("cmd", ["pair-multi", "single-multi"])
def test_multi_matches_reference_cli(pe_files, cmd):
    """A two-line list file: each line is one run with its own output."""
    from soap3dp_tpu.cli.main import main as ref_main
    from soap3dp_tpu_torch.cli.main import main as port_main

    d, _ = pe_files
    for who, main, extra in (("ref", ref_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        lst = d / f"{cmd}_{who}.lst"
        with open(lst, "w") as fh:
            for k, (lo, hi) in enumerate(((100, 400), (200, 300))):
                out = d / f"{cmd}_{who}_{k}"
                fh.write(f"{d / 'r1.fq'}\t{d / 'r2.fq'}\t{lo}\t{hi}\t{out}\n"
                         if cmd == "pair-multi" else
                         f"{d / ('r1.fq', 'r2.fq')[k]}\t{out}\n")
        assert main([cmd, str(d / "g.fa.index"), str(lst)] + extra) == 0
    for k in range(2):
        want = _records(d / f"{cmd}_ref_{k}.sam")
        assert _records(d / f"{cmd}_port_{k}.sam") == want
        assert len(want) > 2


@pytest.fixture(scope="module")
def mate_pair_files(tmp_path_factory):
    """A 200 kbp genome and 48 read pairs of 100 bp from a -/+ mate-pair
    library (inserts ~N(4000, 500) in [2500, 5500])."""
    from soap3dp_tpu_torch import workloads

    d = tmp_path_factory.mktemp("torch_cli_mp")
    rng = np.random.default_rng(2026)
    codes = rng.integers(0, 4, 200_000).astype(np.uint8)
    with open(d / "g.fa", "w") as f:
        f.write(">chrM\n" + dna.decode(codes).decode() + "\n")
    from soap3dp_tpu.cli.builder import main as builder_main
    assert builder_main([str(d / "g.fa")]) == 0
    workloads.make_pe_fastq(rng, codes, 48, str(d / "r1.fq"),
                            str(d / "r2.fq"), orientation="-/+",
                            insert=4000, insert_sd=500,
                            insert_range=(2500, 5500))
    (d / "mp.ini").write_text("[PairEnd]\nStrandArrangement=-/+\n")
    return d


def test_mate_pair_full_window_matches_reference(mate_pair_files,
                                                 monkeypatch):
    """The full-window half rescue of a mate-pair library: the JAX
    package reaches dp_forward with windows of 4096 and more, and the
    port's SAM is byte-equal to it."""
    from soap3dp_tpu.cli.main import main as ref_main
    from soap3dp_tpu.kernels import banded_dp as jb
    from soap3dp_tpu_torch.cli.main import main as port_main

    d = mate_pair_files
    monkeypatch.setenv("SOAP3DP_HALF_NARROW_PAD", "0")
    widths = []
    real = jb.dp_forward

    def spy(reads, rlens, wins, *a, **k):
        widths.append(int(wins.shape[1]))
        return real(reads, rlens, wins, *a, **k)

    monkeypatch.setattr(jb, "dp_forward", spy)
    common = [str(d / "g.fa.index"), str(d / "r1.fq"), str(d / "r2.fq"),
              "-v", "2000", "-u", "6000", "--ini", str(d / "mp.ini")]
    assert ref_main(["pair"] + common + ["-o", str(d / "ref")]) == 0
    assert max(widths) >= 4096, widths
    assert port_main(["pair"] + common + ["-o", str(d / "port"),
                                          "--device", "cpu"]) == 0
    want = _records(d / "ref.sam")
    got = _records(d / "port.sam")
    assert len([l for l in got if not l.startswith("@")]) == 96
    assert got == want
