"""Phase A's tied pairs through the columnar block writer.

Pairs with alternates (``-h 2`` ties, ``-h 1`` valid alternates) go to
``SamWriter.write_block`` as one block, their XA alternates as a column
the formatter writes. On a small genome with planted duplicated
segments, so that both ends tie, the SAM must be byte for byte the SAM
that the JAX package writes from the same genome and reads, and the SAM
that the port's per-record path writes: the alternates past a small
``max_output_per_pair``, a repeated (pos, strand) dropped, both strands,
two chromosomes and ragged read lengths, with the native formatter and
with the numpy fallback. ``-p`` keeps the per-record path, and its SAM
is the JAX package's too.
"""

import functools
import io

import numpy as np
import pytest
import torch

from soap3dp_tpu_torch.io import sam_native
from soap3dp_tpu_torch.io.aio import AsyncWriter
from soap3dp_tpu_torch.io.sam import SamWriter
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.pipeline.pair import align_pair_batch

torch.set_num_threads(1)


class SlowSam(SamWriter):
    write_block = property()  # hide: hasattr() -> AttributeError


class RecordTieSam(SamWriter):
    """A block writer whose block form takes no alternates: the tied
    pairs' records go one at a time, after the plain pairs' block."""

    block_alternates = False


@functools.lru_cache(maxsize=1)
def tie_inputs():
    """(codes, chromosome offsets, mate-1 codes, mate-2 codes, lens1,
    lens2, quals): two chromosomes of 30 kbp; a 600 bp segment S copied
    four times on chrA (once reverse complemented, once with a
    substitution) and twice on chrB (once reverse complemented), and
    once with its last 300 bases repeated from base 300, so that end
    2's window lies twice in one insert. Even pairs lie in S, both ends
    tied; odd pairs in unique sequence. Read lengths 40-64."""
    rng = np.random.default_rng(7)
    C, L, n = 30_000, 64, 40
    chroms = [rng.integers(0, 4, C).astype(np.uint8) for _ in range(2)]
    seg = rng.integers(0, 4, 600).astype(np.uint8)

    def rc(x):
        return (3 - x)[::-1]

    sub = seg.copy()
    sub[40] ^= 1
    for c, at, s in ((0, 1000, seg), (0, 4000, seg), (0, 7000, seg),
                     (0, 10000, rc(seg)), (1, 2000, seg), (1, 6000, rc(seg)),
                     (0, 13000, sub),
                     (0, 16000, np.concatenate([seg[:450], seg[300:]]))):
        chroms[c][at:at + len(s)] = s
    lens1 = rng.integers(40, L + 1, n).astype(np.int32)
    lens2 = rng.integers(40, L + 1, n).astype(np.int32)
    c1 = np.zeros((n, L), np.uint8)
    c2 = np.zeros((n, L), np.uint8)
    for i in range(n):
        if i % 2 == 0:
            a = int(rng.integers(0, 100))
            b = int(rng.integers(330, 600 - lens2[i] + 1))
            r1, r2 = seg[a:a + lens1[i]], rc(seg[b:b + lens2[i]])
        else:
            ch = chroms[(i // 2) % 2]
            p = int(rng.integers(20000, C - 400))
            r1, r2 = ch[p:p + lens1[i]], rc(ch[p + 300 - lens2[i]:p + 300])
        c1[i, :lens1[i]] = r1
        c2[i, :lens2[i]] = r2
    q = rng.integers(33, 73, (n, L)).astype(np.uint8)
    offsets = np.asarray([0, C, 2 * C], np.uint64)
    return np.concatenate(chroms), offsets, c1, c2, lens1, lens2, q


def build_workload(packing, builder, fastq, dna):
    """(index, batch 1, batch 2) of tie_inputs through one package's
    genome packing, index builder and read batch."""
    codes, offsets, c1, c2, lens1, lens2, q = tie_inputs()
    genome = packing.PackedGenome(
        codes=codes, pac=dna.pack_codes(codes), length=len(codes),
        names=["chrA", "chrB"], offsets=offsets,
        amb_starts=np.zeros(0, np.uint64), amb_lengths=np.zeros(0, np.uint64))
    index = builder.build_index(genome, sa_rate=4, lut_k=8)
    names = np.array([b"t%d" % i for i in range(len(c1))])
    return (index, fastq.ReadBatch(names, c1, lens1, q.copy()),
            fastq.ReadBatch(names, c2, lens2, np.ascontiguousarray(q[:, ::-1])))


@functools.lru_cache(maxsize=1)
def tie_workload():
    """(index, device index, batch 1, batch 2) for the port."""
    from soap3dp_tpu_torch.fm.fmindex import device_index
    from soap3dp_tpu_torch.index import builder, packing
    from soap3dp_tpu_torch.io import fastq
    from soap3dp_tpu_torch.utils import dna

    index, b1, b2 = build_workload(packing, builder, fastq, dna)
    return index, device_index(index, "cpu"), b1, b2


def run_sam(writer_cls, opts, wrap=False):
    index, didx, b1, b2 = tie_workload()
    buf = io.BytesIO()
    w = writer_cls(buf, index)
    if wrap:
        w = AsyncWriter(w)
    align_pair_batch(index, didx, b1, b2, opts, w)
    if wrap:
        w.close()
    return buf.getvalue()


def records(text: bytes) -> list[bytes]:
    return [l for l in text.splitlines() if not l.startswith(b"@")]


@functools.lru_cache(maxsize=1)
def jax_workload():
    """(index, device index, batch 1, batch 2) for the JAX package."""
    from soap3dp_tpu.fm.fmindex import device_index
    from soap3dp_tpu.index import builder, packing
    from soap3dp_tpu.io import fastq
    from soap3dp_tpu.utils import dna

    index, b1, b2 = build_workload(packing, builder, fastq, dna)
    return index, device_index(index), b1, b2


def jax_sam(mode, cap, md=False) -> bytes:
    """The JAX package's SAM of the workload, through its own pipeline
    and SamWriter."""
    from soap3dp_tpu.io.sam import SamWriter as JaxSam
    from soap3dp_tpu.pipeline.options import AlignOptions as JaxOptions
    from soap3dp_tpu.pipeline.pair import align_pair_batch as jax_align

    index, didx, b1, b2 = jax_workload()
    buf = io.BytesIO()
    jax_align(index, didx, b1, b2,
              JaxOptions(min_insert=100, max_insert=700, output_mode=mode,
                         max_output_per_pair=cap, output_md=md),
              JaxSam(buf, index))
    return buf.getvalue()


def options(mode, cap, md=False):
    return AlignOptions(min_insert=100, max_insert=700, output_mode=mode,
                        max_output_per_pair=cap, output_md=md)


def use_formatter(native, monkeypatch) -> list[bool]:
    """Pick the native formatter or the numpy fallback; the list that
    is returned gets, for each block with alternates, whether the
    native formatter wrote it."""
    if native and not sam_native.available():
        pytest.skip("no native compiler")
    if not native:
        monkeypatch.setattr(sam_native, "available", lambda: False)
    formatted = []
    fmt = sam_native.format_block

    def spy(*a, **kw):
        text = fmt(*a, **kw)
        if kw.get("xa") is not None:
            formatted.append(text is not None)
        return text

    monkeypatch.setattr(sam_native, "format_block", spy)
    return formatted


CASES = [(2, 1000), (2, 3), (1, 1000), (1, 4)]
CASE_IDS = [f"h{m}-cap{c}" for m, c in CASES]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mode,cap", CASES, ids=CASE_IDS)
def test_tie_block_equals_jax(mode, cap, native, monkeypatch):
    formatted = use_formatter(native, monkeypatch)
    got = run_sam(SamWriter, options(mode, cap))
    assert formatted == ([True] if native else [])
    assert b"XA:Z:" in got
    assert got == jax_sam(mode, cap)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mode,cap", CASES, ids=CASE_IDS)
def test_tie_block_equals_per_record(mode, cap, native, monkeypatch):
    formatted = use_formatter(native, monkeypatch)
    opts = options(mode, cap)
    got = run_sam(SamWriter, opts)
    # the native formatter wrote the tied block itself, no fallback
    assert formatted == ([True] if native else [])
    # the order is today's: the plain pairs' block, then the tied pairs
    assert got == run_sam(RecordTieSam, opts)
    assert sorted(records(got)) == sorted(records(run_sam(SlowSam, opts)))
    xa = [l.split(b"XA:Z:")[1] for l in records(got) if b"XA:Z:" in l]
    assert len(xa) >= 20
    ents = [e for x in xa for e in x.rstrip(b";").split(b";")]
    assert max(len(x.rstrip(b";").split(b";")) for x in xa) <= cap - 1
    if cap == 1000:
        assert {e.split(b",")[0] for e in ents} == {b"chrA", b"chrB"}
        assert {e.split(b",")[1][:1] for e in ents} == {b"+", b"-"}
        # a pair whose end-2 window lies twice in the tandem copy lists
        # end 1's placement there once: fewer entries than end 2
        pairs = {}
        for l in records(got):
            f = l.split(b"\t")
            k = l.count(b";") if b"XA:Z:" in l else 0
            pairs.setdefault(f[0], {})[int(f[1]) & 0xC0] = k
        assert any(p[0x40] < p[0x80] for p in pairs.values())


def test_tie_block_through_async_writer():
    """The writer thread forwards the alternates and their flag."""
    opts = AlignOptions(min_insert=100, max_insert=700)
    assert run_sam(SamWriter, opts, wrap=True) == run_sam(SamWriter, opts)
    w = AsyncWriter(RecordTieSam(io.BytesIO(), tie_workload()[0]))
    w.close()
    assert w.block_alternates is False


@pytest.mark.parametrize("mode", [2, 1])
def test_md_output_stays_per_record(mode):
    opts = options(mode, 5, md=True)
    got = run_sam(SamWriter, opts)
    assert got == run_sam(SlowSam, opts)
    assert b"XA:Z:" in got and b"MD:Z:" in got
    assert got == jax_sam(mode, 5, md=True)
