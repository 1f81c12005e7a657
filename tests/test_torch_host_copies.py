"""The port's own host modules against the JAX package's, on the CPU.

soap3dp_tpu_torch keeps its own copies of the index builder, the
readers and writers, the options and the ini loader (and builds its own
native helpers from csrc/host/). Each test runs the same seeded inputs
through both packages; tolerance: byte-equal files, equal batches,
equal options, equal SAM records.

``port_index`` is how the port's tests turn an index the JAX package
built into the port's Index: saved by the JAX package, loaded by the
port's loader from the same directory (the on-disk format is shared).
"""

import dataclasses
import io
import os
import tempfile

import numpy as np
import pytest
import torch

from soap3dp_tpu.utils import dna

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)


def port_index(jax_index):
    """The port's Index of a JAX-package Index, through the disk."""
    from soap3dp_tpu.index.builder import save_index
    from soap3dp_tpu_torch.index.builder import load_index

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.t3i")
        save_index(jax_index, path)
        index = load_index(path)
        # materialise the memory-mapped arrays before the files go
        return dataclasses.replace(index, **{
            f.name: np.array(getattr(index, f.name))
            for f in dataclasses.fields(index)
            if isinstance(getattr(index, f.name), np.ndarray)})


def _write_fasta(path, rng, lengths, n_run=None):
    """Seeded chromosomes of ``lengths`` bp; ``n_run`` (start, length)
    puts Ns into the first one."""
    with open(path, "w") as fh:
        for c, n in enumerate(lengths):
            seq = bytearray(dna.decode(rng.integers(0, 4, n).astype(np.uint8)))
            if c == 0 and n_run is not None:
                seq[n_run[0]:n_run[0] + n_run[1]] = b"N" * n_run[1]
            fh.write(f">chr{c + 1} seeded\n")
            for i in range(0, n, 70):
                fh.write(seq[i:i + 70].decode() + "\n")


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _numpy_only(monkeypatch):
    """Take the port's numpy builders: no native SA-IS, no fused pass."""
    from soap3dp_tpu_torch.index import build_native, sais_native

    monkeypatch.setattr(build_native, "_load", lambda: None)
    monkeypatch.setattr(sais_native, "_load", lambda: None)


@pytest.mark.parametrize("route", ["build_index_to", "build_index+save_index"])
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_index_files_byte_equal(tmp_path, monkeypatch, route, path):
    """A 200 kbp seeded genome (two chromosomes, an N-run): the port's
    builder writes the JAX package's index files byte for byte, on the
    native path and on the numpy path."""
    from soap3dp_tpu.index import builder as jb
    from soap3dp_tpu.index.packing import pack_fasta as jpack
    from soap3dp_tpu_torch.index import build_native, sais_native
    from soap3dp_tpu_torch.index import builder as tb
    from soap3dp_tpu_torch.index.packing import pack_fasta as tpack

    fa = tmp_path / "g.fa"
    _write_fasta(fa, np.random.default_rng(200), [150_000, 50_000],
                 n_run=(1000, 300))
    if path == "numpy":
        _numpy_only(monkeypatch)
    else:
        assert build_native.available() and sais_native.available()
    outs = {}
    for who, pack, b in (("jax", jpack, jb), ("port", tpack, tb)):
        out = str(tmp_path / f"{who}.t3i")
        genome = pack(str(fa))
        if route == "build_index_to":
            b.build_index_to(genome, out, sa_rate=4, lut_k=None)
        else:
            b.save_index(b.build_index(genome, sa_rate=4, lut_k=None), out)
        outs[who] = _files(out)
    assert len(outs["port"]) > 5
    assert outs["port"].keys() == outs["jax"].keys()
    for name in outs["jax"]:
        assert outs["port"][name] == outs["jax"][name], name


def test_index_loads_in_both(tmp_path):
    """An index built by the port loads in the JAX package and back,
    every array equal."""
    from soap3dp_tpu.index.builder import load_index as jload
    from soap3dp_tpu_torch.index.builder import build_index, load_index, save_index
    from soap3dp_tpu_torch.index.packing import pack_fasta

    fa = tmp_path / "g.fa"
    _write_fasta(fa, np.random.default_rng(201), [30_000])
    save_index(build_index(pack_fasta(str(fa)), sa_rate=2), tmp_path / "p.t3i")
    a, b = jload(tmp_path / "p.t3i"), load_index(tmp_path / "p.t3i")
    back = port_index(a)
    for f in dataclasses.fields(a):
        x, y, z = (getattr(o, f.name) for o in (a, b, back))
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            np.testing.assert_array_equal(x, z, err_msg=f.name)
        else:
            assert x == y == z, f.name


def _reads(rng, n, with_qual=True):
    """(name, ASCII sequence, quality or None) records: varied lengths,
    Ns, lower case."""
    out = []
    for i in range(n):
        ln = int(rng.integers(20, 140))
        seq = bytearray(dna.decode(rng.integers(0, 4, ln).astype(np.uint8)))
        if i % 7 == 3:
            seq[ln // 2] = ord("N")
        if i % 11 == 5:
            seq = seq.lower()
        qual = bytes(rng.integers(35, 75, ln).astype(np.uint8)) \
            if with_qual else None
        out.append((f"read{i}/{1 + i % 2} x".encode(), bytes(seq), qual))
    return out


def _write_reads(path, recs, kind):
    import gzip

    if kind == "bam":
        from soap3dp_tpu.io.sam import SamRecord
        from soap3dp_tpu.io.succinct import BamWriter

        class _Idx:
            names = ["chr1"]
            offsets = np.asarray([0, 1000], np.uint64)

        with BamWriter(str(path), _Idx()) as w:
            for name, seq, qual in recs:
                w.write(SamRecord(name.split()[0], 4, -1, 0, 0, "",
                                  seq.upper(), qual))
        return
    text = "".join(
        f"@{n.decode()}\n{s.decode()}\n+\n{q.decode()}\n" if q is not None
        else f">{n.decode()}\n{s.decode()}\n" for n, s, q in recs).encode()
    if kind.endswith(".gz"):
        with gzip.open(path, "wb") as fh:
            fh.write(text)
    else:
        path.write_bytes(text)


def _batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(np.asarray(x.names)) == list(np.asarray(y.names))
        np.testing.assert_array_equal(x.codes, y.codes)
        np.testing.assert_array_equal(x.lens, y.lens)
        assert (x.quals is None) == (y.quals is None)
        if x.quals is not None:
            np.testing.assert_array_equal(x.quals, y.quals)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", ["fastq", "fastq.gz", "fasta", "bam"])
def test_read_batches_equal(tmp_path, monkeypatch, kind, native):
    """FASTQ, gzip FASTQ, FASTA and BAM input, single and paired, through
    both packages' readers (native parser and Python parser): the same
    batches."""
    from soap3dp_tpu.io import fastq as jfq
    from soap3dp_tpu_torch.io import fastq as tfq

    if not native:
        monkeypatch.setenv("SOAP3DP_NO_NATIVE", "1")
    rng = np.random.default_rng(300)
    recs1 = _reads(rng, 150, with_qual=kind != "fasta")
    recs2 = _reads(rng, 150, with_qual=kind != "fasta")
    p1, p2 = tmp_path / f"r1.{kind}", tmp_path / f"r2.{kind}"
    _write_reads(p1, recs1, kind)
    _write_reads(p2, recs2, kind)
    for fn, args in (("read_single", (str(p1),)),
                     ("read_pairs", (str(p1), str(p2)))):
        if kind == "bam" and fn == "read_pairs":
            args = (str(p1),)   # interleaved BAM: mates adjacent
        kw = dict(batch_size=64, max_len=120)
        want = list(getattr(jfq, fn)(*args, **kw))
        got = list(getattr(tfq, fn)(*args, **kw))
        assert len(got) > 1
        if fn == "read_pairs":
            want = [b for pair in want for b in pair]
            got = [b for pair in got for b in pair]
        _batches_equal(want, got)


def _records(rng, n, names):
    """Seeded SamRecord fields: mapped, reverse, unmapped, mates on
    other chromosomes, tags, missing qualities."""
    out = []
    for i in range(n):
        ln = int(rng.integers(30, 120))
        seq = dna.decode(rng.integers(0, 4, ln).astype(np.uint8))
        chrom = -1 if i % 9 == 4 else int(rng.integers(0, len(names)))
        flag = 4 if chrom < 0 else int(rng.choice([0, 16, 1 | 2 | 64 | 32,
                                                   1 | 2 | 128 | 16, 256]))
        cigar = "" if chrom < 0 else f"{ln - 5}M2I3M"
        mate = int(rng.integers(-1, len(names)))
        out.append(dict(
            qname=f"q{i}".encode(), flag=flag, chrom=chrom,
            pos=int(rng.integers(0, 5000)), mapq=int(rng.integers(0, 61)),
            cigar=cigar, seq=seq,
            qual=None if i % 5 == 2 else bytes(rng.integers(35, 75, ln)
                                               .astype(np.uint8)),
            mate_chrom=mate, mate_pos=int(rng.integers(0, 5000)),
            tlen=int(rng.integers(-600, 600)),
            tags=[] if i % 3 else [f"NM:i:{i % 4}", "MD:Z:10A5"]))
    return out


class _Index:
    names = ["chr1", "chrUn_2"]
    offsets = np.asarray([0, 6000, 11000], np.uint64)


def _write_with(pkg, fmt, path, recs):
    import importlib

    sam = importlib.import_module(f"{pkg}.io.sam")
    succ = importlib.import_module(f"{pkg}.io.succinct")
    if fmt == "sam":
        w = sam.SamWriter(path, _Index(), read_group="rg", sample="s",
                          rg_option="PL:ILLUMINA")
    elif fmt == "bam":
        w = succ.BamWriter(path, _Index(), read_group="rg", sample="s")
    else:
        w = succ.SuccinctWriter(path, _Index())
    with w:
        for r in recs:
            w.write(sam.SamRecord(**r))


@pytest.mark.parametrize("fmt", ["sam", "bam", "succinct"])
def test_writer_bytes_equal(tmp_path, fmt):
    """The same records through SamWriter, BamWriter and SuccinctWriter
    of both packages: byte-equal files; the succinct file decodes to the
    same records in both packages."""
    from soap3dp_tpu.io.succinct import read_succinct as jread
    from soap3dp_tpu_torch.io.succinct import read_succinct as tread

    recs = _records(np.random.default_rng(400), 300, _Index.names)
    for pkg in ("soap3dp_tpu", "soap3dp_tpu_torch"):
        _write_with(pkg, fmt, str(tmp_path / f"{pkg}.{fmt}"), recs)
    want = (tmp_path / f"soap3dp_tpu.{fmt}").read_bytes()
    got = (tmp_path / f"soap3dp_tpu_torch.{fmt}").read_bytes()
    assert len(got) > 1000
    assert got == want
    if fmt == "succinct":
        path = str(tmp_path / f"soap3dp_tpu_torch.{fmt}")
        assert tread(path) == jread(path)


@pytest.mark.parametrize("fmt", [1, 2, 3], ids=["succinct", "sam", "bam"])
def test_pipeline_output_bytes_equal(tmp_path, fmt):
    """The golden paired-end workload through each package's pipeline
    into each package's writer of format ``fmt`` (the columnar
    write_block path): byte-equal files."""
    from soap3dp_tpu.fm.fmindex import device_index as jdev
    from soap3dp_tpu.io.sam import SamWriter as JSam
    from soap3dp_tpu.io.succinct import BamWriter as JBam
    from soap3dp_tpu.io.succinct import SuccinctWriter as JSucc
    from soap3dp_tpu.pipeline.pair import align_pair_batch as jalign
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm.fmindex import device_index as tdev
    from soap3dp_tpu_torch.io.sam import SamWriter as TSam
    from soap3dp_tpu_torch.io.succinct import BamWriter as TBam
    from soap3dp_tpu_torch.io.succinct import SuccinctWriter as TSucc
    from soap3dp_tpu_torch.pipeline.pair import align_pair_batch as talign
    from tests.test_golden_sam import _workload

    case = dict(output_mode=2, output_md=True)
    runs = (("jax", _workload(), jdev, jalign, (JSucc, JSam, JBam),
             _jax_options(case)),
            ("port", workloads.golden_pair_workload(), lambda i: tdev(i, "cpu"),
             talign, (TSucc, TSam, TBam), workloads.golden_options(case)))
    out = {}
    for who, (index, b1, b2), dev, align, writers, opts in runs:
        path = str(tmp_path / f"{who}.out")
        with writers[fmt - 1](path, index) as w:
            align(index, dev(index), b1, b2, opts, w)
        out[who] = open(path, "rb").read()
    assert len(out["port"]) > 1000
    assert out["port"] == out["jax"]


def _jax_options(case):
    from soap3dp_tpu.pipeline.options import AlignOptions

    return AlignOptions(min_insert=100, max_insert=400,
                        output_mode=case["output_mode"],
                        output_md=case.get("output_md", False),
                        soap3_mismatch_allow=case.get("mismatches", 3),
                        random_seed=7)


_INI = """[Alignment]
MaxOutputPerRead = 50
Soap3MisMatchAllow = 3
[PairEnd]
MaxOutputPerPair = 40
MaxHitsEachEndForPairing = 300 ; comment
StrandArrangement = -/+
[DP]
MatchScore = 2
MismatchScore = -3
GapOpenScore = -5
GapExtendScore = -2
DPScoreThreshold = 45
[Score]
MinMAPQ = 1
MaxMAPQ = 50
BWALikeScore = 1
[Clipping]
MaxFrontLenClipped = 7
MaxEndLenClipped = 9
[OtherSettings]
SkipSOAP3Alignment = 1
ProceedDPForTooManyHits = 1
"""


@pytest.mark.parametrize("argv", [
    ["pair", "idx", "a.fq", "b.fq"],
    ["pair", "idx", "a.fq", "b.fq", "-v", "100", "-u", "400", "-h", "3",
     "-b", "3", "-p", "-I", "-L", "100", "-A", "smp", "-D", "grp", "-R",
     "PL:X", "--batch-size", "1000", "-s"],
    ["single", "idx", "a.fq", "-s", "2", "-h", "4", "-o", "out", "--ini",
     "{ini}"],
    ["pair", "idx", "a.fq", "-L", "40", "-s", "--ini", "{ini}"],
    ["single", "idx", "a.fq", "--ini", "{bad_ini}"],
], ids=["pair_default", "pair_flags", "single_ini", "pair_ini", "bad_ini"])
def test_options_equal(tmp_path, argv):
    """AlignOptions from the same command line and ini file in both
    packages' CLI parsing: equal field by field."""
    import argparse

    from soap3dp_tpu.cli import main as jmain
    from soap3dp_tpu_torch.cli import main as tmain

    (tmp_path / "o.ini").write_text(_INI)
    (tmp_path / "bad.ini").write_text("[DP]\nDPScoreThreshold = x\n")
    argv = [a.format(ini=tmp_path / "o.ini", bad_ini=tmp_path / "bad.ini")
            for a in argv]
    cmd = argv[0]
    sub = argparse.ArgumentParser(add_help=False)
    sub.add_argument("index")
    if cmd == "pair":
        sub.add_argument("reads1")
        sub.add_argument("reads2", nargs="?", default=None)
        sub.add_argument("-u", type=int, default=500, dest="max_insert")
        sub.add_argument("-v", type=int, default=1, dest="min_insert")
    else:
        sub.add_argument("reads")
    jmain._add_common(sub)
    jargs = sub.parse_args(argv[1:])
    _, targs = tmain.parse_args(argv)
    first = argv[2]
    want = dataclasses.asdict(jmain._build_options(jargs, first))
    got = dataclasses.asdict(tmain._build_options(targs, first))
    assert got == want
    assert vars(targs).items() - {("torch_device", "cuda")} == \
        vars(jargs).items()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A FASTA indexed by `soap3dp-torch build` and by the JAX package's
    builder CLI, in two directories, and 40 read pairs."""
    from soap3dp_tpu.cli.builder import main as jbuild
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.cli.main import main as port_main

    d = tmp_path_factory.mktemp("host_copies_cli")
    rng = np.random.default_rng(500)
    codes = rng.integers(0, 4, 60_000).astype(np.uint8)
    for who in ("jax", "port"):
        (d / who).mkdir()
        (d / who / "g.fa").write_text(">chrA\n" + dna.decode(codes).decode()
                                      + "\n")
    assert jbuild([str(d / "jax" / "g.fa")]) == 0
    assert port_main(["build", str(d / "port" / "g.fa")]) == 0
    workloads.make_pe_fastq(rng, codes, 40, str(d / "r1.fq"), str(d / "r2.fq"))
    return d


@pytest.mark.parametrize("fmt", ["1", "2", "3"], ids=["succinct", "sam", "bam"])
def test_build_then_pair_matches_reference_cli(built, fmt):
    """`soap3dp-torch build` then `soap3dp-torch pair --device cpu`
    against `soap3dp-builder` then `soap3dp pair`: the same index files
    and the same records in every output format (SAM sorted, since
    deferred rescue records interleave on a worker thread; the succinct
    file through `soap3dp-torch view` and `soap3dp-view`)."""
    import contextlib

    from soap3dp_tpu.cli.main import main as jmain
    from soap3dp_tpu.cli.view import main as jview
    from soap3dp_tpu_torch.cli.main import main as tmain
    from soap3dp_tpu_torch.io.bamread import iter_bam_reads

    d = built
    assert _files(d / "port" / "g.fa.index.t3i") == \
        _files(d / "jax" / "g.fa.index.t3i")
    reads = [str(d / "r1.fq"), str(d / "r2.fq"), "-v", "100", "-u", "600",
             "-b", fmt]
    assert jmain(["pair", str(d / "jax" / "g.fa.index")] + reads
                 + ["-o", str(d / f"jax_{fmt}")]) == 0
    assert tmain(["pair", str(d / "port" / "g.fa.index")] + reads
                 + ["-o", str(d / f"port_{fmt}"), "--device", "cpu"]) == 0
    ext = {"1": ".gout", "2": ".sam", "3": ".bam"}[fmt]
    got = {}
    for who, view in (("jax", jview), ("port", lambda a: tmain(["view"] + a))):
        path = str(d / f"{who}_{fmt}{ext}")
        if fmt == "1":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert view([path]) == 0
            got[who] = sorted(buf.getvalue().splitlines())
        elif fmt == "2":
            got[who] = sorted(l for l in open(path)
                              if not l.startswith("@PG"))
        else:
            got[who] = sorted((n, c.tobytes(), q)
                              for n, c, q in iter_bam_reads(path))
    assert got["port"] == got["jax"]
    assert len(got["port"]) >= 80
