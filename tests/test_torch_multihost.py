"""Two-process `soap3dp-torch pair --hosts 2` on the CPU (mirrors
tests/test_multihost.py::test_multihost_cli_matches_single_process).

Two OS processes of the port's CLI, joined by torch.distributed over
gloo, each align their stride of the input batches (DP rescue on) into
their own output shard; the merged records must equal a one-process
port run and the JAX CLI's run on the same files, and the summaries
must be summed across the processes."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sam_records(path):
    with open(path) as fh:
        return sorted(l for l in fh if not l.startswith("@"))


def test_multihost_cli_matches_single_process(tmp_path, capsys):
    from soap3dp_tpu.cli.builder import main as builder_main
    from soap3dp_tpu.cli.main import main as ref_main
    from soap3dp_tpu.utils import dna
    from soap3dp_tpu_torch.cli.main import main as port_main

    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, 30000).astype(np.uint8)
    (tmp_path / "g.fa").write_text(">chrA\n" + dna.decode(codes).decode()
                                   + "\n")
    assert builder_main([str(tmp_path / "g.fa")]) == 0
    B, L, INS = 64, 80, 250
    pos = rng.integers(0, 30000 - INS - 1, B)
    with open(tmp_path / "p1.fq", "w") as f1, \
            open(tmp_path / "p2.fq", "w") as f2:
        for b in range(B):
            left = codes[pos[b]:pos[b] + L].copy()
            left[7] = (left[7] + 1) % 4
            right = dna.revcomp_codes(codes[pos[b] + INS - L:pos[b] + INS])
            if b % 4 == 1:      # an indel in one end: DP rescue
                right = np.concatenate([right[:30], right[33:],
                                        rng.integers(0, 4, 3)]).astype(np.uint8)
            f1.write(f"@p{b}\n{dna.decode(left).decode()}\n+\n{'I' * L}\n")
            f2.write(f"@p{b}\n{dna.decode(right).decode()}\n+\n{'I' * L}\n")

    common = ["pair", str(tmp_path / "g.fa.index"), str(tmp_path / "p1.fq"),
              str(tmp_path / "p2.fq"), "-v", "150", "-u", "600",
              "--batch-size", "16"]
    assert ref_main(common + ["-o", str(tmp_path / "ref")]) == 0
    capsys.readouterr()
    assert port_main(common + ["-o", str(tmp_path / "sp"),
                               "--device", "cpu"]) == 0
    summary = [l.split("done: ", 1)[1] for l in
               capsys.readouterr().err.splitlines() if "] done: " in l][0]

    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "soap3dp_tpu_torch.cli.main"] + common
        + ["-o", str(tmp_path / "mh"), "--device", "cpu", "--hosts", "2",
           "--host-id", str(i), "--coordinator", coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(tmp_path)) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("the two port processes did not finish in 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert (tmp_path / f"mh.{i}.sam").exists()
        assert (tmp_path / f"mh.{i}.done").exists()
        assert f"multi-host: process {i}/2" in out
        assert "global (all 2 hosts)" in out
    # each process aligned its stride of the 4 batches of 16 pairs
    assert all(len(_sam_records(tmp_path / f"mh.{i}.sam")) == B
               for i in range(2))
    merged = sorted(_sam_records(tmp_path / "mh.0.sam")
                    + _sam_records(tmp_path / "mh.1.sam"))
    assert merged == _sam_records(tmp_path / "sp.sam")
    assert merged == _sam_records(tmp_path / "ref.sam")
    # the global summary is the one-process run's
    assert f"num_pairs={B}," in summary
    for out in outs:
        assert f"global (all 2 hosts): {summary}" in out
