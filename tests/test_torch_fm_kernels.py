"""The seed search's kernels (FS1 backward search, FS2 SA decode, FS3
packed verify; soap3dp_tpu_torch/kernels/fm_search.py) and the plain
versions they are held to.

On the CPU: the plain versions against the JAX package on the same
numpy-seeded inputs, exactly equal (every output is an integer), at the
edges the kernels must reproduce: segments shorter than lut_k in each
of the three branches of _search_batch, variable read lengths with
their reverse-complement rows (code bytes and packed words, and a
uniform-length batch), SA rows at the sentinel, at 16- and 32-row word
boundaries and at the last row, sa_rate 1, 2, 8 and 16, placements at a
packed-word boundary and at the genome's end, and an SA table split
over a two-replica CPU mesh; and the dispatch: a CPU tensor takes the
plain version and no kernel launches. The kernels against their plain
versions are marked ``cuda`` and skip here; chip_smoke.py runs the same
cases on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap3dp_tpu.fm import fmindex as jf
from soap3dp_tpu_torch.distributed import mesh as tmesh
from soap3dp_tpu_torch.fm import fmindex as tf
from soap3dp_tpu_torch.fm.search import pack_read_matrix
from soap3dp_tpu_torch.kernels import fm_search as fs
from tests.conftest import make_genome
from tests.test_torch_host_copies import port_index

# small CPU cases: more intra-op threads only contend with other workers
torch.set_num_threads(1)

B, L, S = 40, 60, 3


@pytest.fixture(scope="module")
def base():
    """(genome codes, JAX index at sa_rate 1, lut_k 8)."""
    from soap3dp_tpu.index.builder import build_index

    genome = make_genome(np.random.default_rng(91), 30_000)
    return genome.codes, build_index(genome, sa_rate=1, lut_k=8)


@pytest.fixture(scope="module", params=[1, 2, 8, 16])
def rated(request, base):
    """(JAX device index, the port's CPU device index) at sa_rate 1-16."""
    from soap3dp_tpu.index.builder import resample_sa

    idx = resample_sa(base[1], request.param)
    return jf.device_index(idx), tf.device_index(port_index(idx), "cpu")


@pytest.fixture(scope="module")
def pair(base):
    idx = base[1]
    return jf.device_index(idx), tf.device_index(port_index(idx), "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t):
    a = np.asarray(j).astype(np.int64)
    b = t.numpy().astype(np.int64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _reads(codes, seed, uniform=0):
    """(reads (B, L) uint8, lens): genome substrings of variable length
    (one of L, of lut_k and lut_k - 1, of 1 base), half reverse
    complemented, a few random; zero past each length."""
    rng = np.random.default_rng(seed)
    lens = np.full(B, uniform) if uniform else rng.integers(5, L + 1, B)
    if not uniform:
        lens[:4] = [L, 8, 7, 1]
    pos = rng.integers(0, len(codes) - L, B)
    reads = codes[pos[:, None] + np.arange(L)].astype(np.uint8)
    rc = rng.random(B) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    reads[-3:] = rng.integers(0, 4, (3, L))
    reads[np.arange(L)[None, :] >= lens[:, None]] = 0
    return reads, lens.astype(np.int32)


def _jax_oriented(reads, lens, uniform=0):
    r = jnp.asarray(reads)
    rc = (jf.revcomp_reads_uniform(r, min(uniform, L)) if uniform
          else jf.revcomp_reads(r, jnp.asarray(lens)))
    return jnp.concatenate([r, rc], axis=0)


def _ori(reads, lens, source, uniform=0):
    data = _t(pack_read_matrix(reads).view(np.int32)) if source == "packed" \
        else _t(reads)
    return tf.OrientedReads.of(data, _t(lens), L, uniform)


def _segments(seed, mode, k):
    """Per-lane (start, length): starts up to past the read and past L,
    lengths up to the mode's top, every fifth shorter than lut_k."""
    rng = np.random.default_rng(seed)
    N = 2 * B * S
    top = {"lut": k + 16, "packed": k + 18, "general": 40}[mode]
    start = rng.integers(0, L + 2, N)
    length = rng.integers(0, top + 1, N)
    length[::5] = rng.integers(0, k, len(length[::5]))
    return start.astype(np.int32), length.astype(np.int32)


@pytest.mark.parametrize("source", ["codes", "packed"])
@pytest.mark.parametrize("mode", ["lut", "packed", "general"])
@pytest.mark.parametrize("uniform", [0, 52])
def test_seed_intervals_plain_matches_reference(pair, base, mode, source,
                                                uniform):
    """Each branch of the reference's _search_batch (the LUT-only gather
    of rolling k-mer codes, backward_search_packed over the rolling
    16-base codes, backward_search over the gathered rows) on the
    oriented rows, against seed_intervals_plain."""
    jd, td = pair
    k = td.lut_k
    reads, lens = _reads(base[0], 5, uniform)
    start, length = _segments(6, mode, k)
    steps = {"lut": 0, "packed": 16, "general": 40}[mode]
    oriented = _jax_oriented(reads, lens, uniform)
    rows = np.repeat(np.arange(2 * B, dtype=np.int32), S)
    if mode == "lut":
        km = jf.rolling_kmer_codes(oriented, k).reshape(-1)
        m = km[rows * L + np.clip(start, 0, L - 1)].astype(jnp.int32)
        jl, jr = jd.lut_lo[m], jd.lut_hi[m]
    elif mode == "packed":
        jl, jr = jf.backward_search_packed(
            jd, jf.rolling_kmer_codes(oriented, 16), jnp.asarray(rows),
            jnp.asarray(start), jnp.asarray(length), steps)
    else:
        jl, jr = jf.backward_search(jd, oriented[rows], jnp.asarray(start),
                                    jnp.asarray(length), steps)
    ori = _ori(reads, lens, source, uniform)
    np.testing.assert_array_equal(np.asarray(oriented),
                                  ori.matrix.numpy())
    tl, tr = tf.seed_intervals_plain(
        td, ori, S, tf.SeedLanes.given(_t(start), _t(length)), steps, mode)
    _eq(jl, tl)
    _eq(jr, tr)
    assert (tr > tl).any()  # seeds with hits


def _decode_rows(n, primary, seed, N=3000):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 15, 16, 17, 31, 32, 33, primary - 1, primary, primary + 1,
            n - 1, n]
    words = rng.integers(1, n // 32, 40) * 32
    edge += list((words[:, None] + np.array([-1, 0, 1, 16])).ravel())
    rows = np.concatenate([edge, rng.integers(0, n + 1, N - len(edge))])
    valid = rng.random(N) < 0.8
    valid[:len(edge)] = True
    return np.clip(rows, 0, n).astype(np.uint32), valid


def test_sa_decode_plain_matches_reference(rated):
    """sa_rate 1, 2, 8 and 16; rows at the sentinel, at 16- and 32-row
    word boundaries and at the last row."""
    jd, td = rated
    rows, valid = _decode_rows(td.n, td.primary, 7)
    _eq(jf.sa_decode(jd, jnp.asarray(rows), jnp.asarray(valid)),
        tf.sa_decode_plain(td, _t(rows.astype(np.int64)), _t(valid)))


@pytest.mark.parametrize("rate", [1, 8])
def test_sa_decode_split_over_mesh_matches_reference(base, rate):
    """The SA table split over a two-replica CPU mesh: each replica's
    decode (the owner routing of _sa_value) equals the JAX package's
    unsplit decode."""
    from soap3dp_tpu.index.builder import resample_sa

    idx = resample_sa(base[1], rate)
    jd = jf.device_index(idx)
    mesh = tmesh.replicate_index(port_index(idx), tmesh.make_mesh(["cpu"] * 2),
                                 shard_sa=True)
    rows, valid = _decode_rows(idx.n, idx.primary, 8)
    want = jf.sa_decode(jd, jnp.asarray(rows), jnp.asarray(valid))
    for rep in mesh.replicas:
        assert rep.sa_parts
        _eq(want, tf.sa_decode(rep, _t(rows.astype(np.int64)), _t(valid)))


# FS3's cases: variable read lengths (the ids "codes" and "packed"), and
# every reverse complement of n bases at the edges of the kernel's
# two-word window (one base, either side of one and two words, L), a
# uniform-length batch of reads shorter than L, and every placement in
# the genome's last word or the one before it
_VERIFY_CASES = ["variable", 1, 15, 16, 17, 31, 32, L, "uniform",
                 "last_word"]


@pytest.mark.parametrize("source,case", [
    pytest.param(src, case, id=src if case == "variable" else f"{src}-{case}")
    for case in _VERIFY_CASES for src in ("codes", "packed")])
def test_count_mismatches_rows_plain_matches_reference(pair, base, source,
                                                      case):
    """Placements of forward and reverse-complement rows at packed-word
    boundaries, in the genome's last words and past its end, and random,
    against count_mismatches_packed over the packed oriented rows."""
    jd, td = pair
    n = td.n
    uniform = 52 if case == "uniform" else (case if isinstance(case, int)
                                            else 0)
    reads, lens = _reads(base[0], 9, uniform)
    rng = np.random.default_rng(10)
    M = 2000
    rows = rng.integers(0, 2 * B, M)
    olens = np.concatenate([lens, lens])[rows]
    tp = rng.integers(0, n, M)
    tp[:500] = rng.integers(0, n // 16, 500) * 16
    tp[500:540] = n - olens[500:540]
    tp[540:580] = n - rng.integers(1, 30, 40)
    tp[:6] = [0, 16, 15, n - 16, n - 1, (n // 16) * 16]
    if case == "last_word":
        tp = (n // 16) * 16 + rng.integers(-16, 16, M)
    rc_uniform = uniform if case == "uniform" else 0
    words = jf.pack_reads(_jax_oriented(reads, lens, rc_uniform))
    want = jf.count_mismatches_packed(jd, jnp.asarray(tp.astype(np.uint32)),
                                      words[rows], jnp.asarray(olens))
    ori = _ori(reads, lens, source, rc_uniform)
    got = tf.count_mismatches_rows_plain(td, _t(tp), ori, _t(rows),
                                         _t(lens))
    _eq(want, got)
    assert (got.numpy() > (0 if 0 < uniform <= 16 else 2)).any()
    assert (rows >= B).sum() > M // 3     # reverse complements verified
    if uniform:
        assert (ori.rc_lengths() == uniform).all() and uniform <= L
    if case == "last_word":
        assert (tp >> 4 >= n // 16 - 1).all() and (tp >> 4 == n // 16).any()


def test_cpu_tensors_take_the_plain_versions(pair, base):
    """Every entry point on CPU tensors returns its plain version's
    output and launches no kernel; the launch wrappers refuse CPU
    tensors (there is no fallback from a kernel to a plain version)."""
    _, td = pair
    for k in (fs.SEARCH_KERNEL, fs.DECODE_KERNEL, fs.VERIFY_KERNEL):
        k.reset()
    reads, lens = _reads(base[0], 11)
    ori = _ori(reads, lens, "packed")
    start, length = _segments(12, "general", td.lut_k)
    seeds = tf.SeedLanes.given(_t(start), _t(length))
    args = (td, ori, S, seeds, 20, "general")
    for a, b in zip(tf.seed_intervals(*args), tf.seed_intervals_plain(*args)):
        assert torch.equal(a, b)
    oriented = ori.matrix
    rows = torch.arange(2 * B).repeat_interleave(S)
    bs = (td, oriented[rows], _t(start), _t(length), 20)
    assert all(torch.equal(a, b) for a, b in
               zip(tf.backward_search(*bs), tf.backward_search_plain(*bs)))
    roll = tf.rolling_kmer_codes(oriented, 16)
    bp = (td, roll, rows, _t(start), _t(length).clamp(max=20), 12)
    assert all(torch.equal(a, b) for a, b in
               zip(tf.backward_search_packed(*bp),
                   tf.backward_search_packed_plain(*bp)))
    r, v = _decode_rows(td.n, td.primary, 13)
    d = (td, _t(r.astype(np.int64)), _t(v))
    assert torch.equal(tf.sa_decode(*d), tf.sa_decode_plain(*d))
    tp = _t(np.arange(0, 16 * 300, 16))
    prow = torch.arange(300) % (2 * B)
    olens = torch.cat([_t(lens), _t(lens)])[prow]
    c = (td, tp, ori, prow, _t(lens))
    assert torch.equal(tf.count_mismatches_rows(*c),
                       tf.count_mismatches_rows_plain(*c))
    w = tf.pack_reads(oriented)[prow]
    assert torch.equal(tf.count_mismatches_packed(td, tp, w, olens),
                       tf.count_mismatches_packed_plain(td, tp, w, olens))
    assert [k.launches for k in (fs.SEARCH_KERNEL, fs.DECODE_KERNEL,
                                 fs.VERIFY_KERNEL)] == [0, 0, 0]
    with pytest.raises(ValueError, match="CUDA"):
        fs.search(td, ori.source(), S, seeds, 20, "general")
    with pytest.raises(ValueError, match="CUDA"):
        fs.sa_decode(td, d[1], d[2])
    with pytest.raises(ValueError, match="CUDA"):
        fs.verify(td, ori.source(), prow, tp, None, _t(lens),
                  (L + 15) // 16)
    with pytest.raises(ValueError, match="unknown mode"):
        tf.seed_intervals(td, ori, S, seeds, 20, "fast")


def test_oriented_reads_layouts(base):
    """OrientedReads holds packed words or code bytes of the same rows,
    and its uniform form is revcomp_reads_uniform's."""
    reads, lens = _reads(base[0], 14)
    a = _ori(reads, lens, "codes").matrix
    b = _ori(reads, lens, "packed").matrix
    assert a.dtype == torch.uint8 and a.shape == (2 * B, L)
    assert torch.equal(a, b)
    ori = _ori(reads, lens, "packed")
    assert ori.matrix is ori.matrix  # made once for every plain version
    u = tf.OrientedReads.of(_t(reads), _t(lens), uniform_len=L + 5)
    assert u.rc_len is None and (u.rc_lengths() == L).all()
    assert torch.equal(u.matrix[B:],
                       tf.revcomp_reads_uniform(_t(reads), L))
    src = _ori(reads, lens, "packed").source()
    assert (src.kind, src.B, src.L, src.W) == (fs.SRC_PACKED, B, L, 4)


# ------------------------------------------------------------------
# On the card (skip here; chip_smoke.py runs the same cases)
# ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _on(dev, x):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tf.OrientedReads):
        return tf.OrientedReads(x.reads.to(dev), x.L, _on(dev, x.rc_len),
                                x.rc_all)
    if isinstance(x, tf.SeedLanes):
        return tf.SeedLanes(**{k: _on(dev, v) for k, v in vars(x).items()})
    return x


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["codes", "packed"])
@pytest.mark.parametrize("mode", ["lut", "packed", "general"])
def test_fs1_kernel_matches_plain(pair, base, mode, source):
    dev = _card()
    td = tf.device_index(port_index(base[1]), dev)
    reads, lens = _reads(base[0], 15)
    start, length = _segments(16, mode, td.lut_k)
    args = [_on(dev, x) for x in (td, _ori(reads, lens, source), S,
                                   tf.SeedLanes.given(_t(start), _t(length)),
                                   {"lut": 0, "packed": 16,
                                    "general": 40}[mode], mode)]
    n0 = fs.SEARCH_KERNEL.launches
    _same(tf.seed_intervals(*args), tf.seed_intervals_plain(*args))
    assert fs.SEARCH_KERNEL.launches == n0 + 1


@pytest.mark.cuda
def test_fs2_kernel_matches_plain(rated):
    dev = _card()
    _, td = rated
    td = tf.DeviceIndex(**{k: _on(dev, v) for k, v in vars(td).items()})
    r, v = _decode_rows(td.n, td.primary, 17)
    args = (td, _t(r.astype(np.int64)).to(dev), _t(v).to(dev))
    _same(tf.sa_decode(*args), tf.sa_decode_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["codes", "packed"])
def test_fs3_kernel_matches_plain(base, source):
    dev = _card()
    td = tf.device_index(port_index(base[1]), dev)
    reads, lens = _reads(base[0], 18)
    rng = np.random.default_rng(19)
    rows = rng.integers(0, 2 * B, 1000)
    olens = np.concatenate([lens, lens])[rows]
    tp = rng.integers(0, td.n, 1000)
    tp[:4] = [0, 16, td.n - 1, td.n - int(olens[3])]
    args = [_on(dev, x) for x in (td, _t(tp), _ori(reads, lens, source),
                                   _t(rows), _t(lens))]
    _same(tf.count_mismatches_rows(*args),
          tf.count_mismatches_rows_plain(*args))
