"""2BWT/FM-index builder with a TPU-first memory layout.

Replaces the reference's three-artifact pipeline (soap3-dp-builder ->
.bwt/.fmv/.sa/.lkt files, then BGS-Build -> .fmv.gpu GPU occ tables,
2bwt-flex/2BWT-Builder.c:306-460 and BGS-Build.cpp:139-194) with a
single builder that directly emits accelerator-ready flat arrays:

* 16bp-block FM tables: ``bwt`` packs the BWT 16 bases per uint32 word
  and ``occ`` holds the four cumulative base counts at every word
  boundary (flat, ``occ[4*w + c]``). An Occ query is therefore TWO
  single-u32 element gathers (count + word) plus an in-register
  popcount. XLA's TPU gather costs per *element*, not per byte — a
  48-byte interleaved row gather measures ~175ns/row on v5e where a
  u32 element gather is ~10ns — so the narrow-block layout beats the
  reference's wide-row GPU design (GPU_OCC_INTERVAL 128,
  definitions.h:94; BGS-Build.cpp:146-161) by ~7x on the search hot
  path at a 1.25 byte/bp memory cost (human genome: ~3.9 GB of 16 GB
  HBM, docs/SCALING.md).
* value-sampled suffix array: rows whose SA value is a multiple of
  ``sa_rate`` are marked in a bitvector (``mark_words``, 32 rows per
  word) with a per-word exclusive rank directory (``mark_rank``),
  giving the SA-decode walk a hard ``sa_rate``-step bound where each
  step is element gathers only. (The reference samples rows instead —
  BWTGenerateSaValue, 2BWT-Builder.c:455-457 — which leaves the walk
  unbounded; a hard bound is what makes the walk a fixed-shape TPU
  loop.)
* k-mer lookup table with [lo, hi) SA-interval per k-mer, the analog of
  the reference's 13-mer LT (2bwt-flex/LT.h:49-56).

Only the forward BWT is built. The reference also builds a reverse BWT
for bidirectional search in its mismatch-case enumeration
(DV-Kernel.cu cases A-F); the rebuilt aligner uses pigeonhole
seed-and-verify instead, which needs backward search only.

Format history: version 1 interleaved occ4 + eight BWT words in
128bp-block rows (``fmi`` (nb,12), ``mark`` (nb,5)); ``load_index``
transparently upgrades v1 directories (pure numpy passes, no suffix
array rebuild) and persists the v2 arrays next to the v1 ones.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from soap3dp_tpu_torch.index.packing import PackedGenome, pack_fasta
from soap3dp_tpu_torch.index.suffix_array import bwt_from_sa, suffix_array
from soap3dp_tpu_torch.utils import dna

OCC_INTERVAL = dna.BASES_PER_WORD  # bases per occ block = one packed word
MARK_INTERVAL = 32           # SA rows per mark bitvector word
PAC_PAD_WORDS = 64           # guard words so window gathers never go OOB

FORMAT_VERSION = 2


@dataclasses.dataclass
class Index:
    """Host-side (numpy) index. See DeviceIndex for the HBM-resident view."""

    n: int                   # text length (concatenated genome)
    primary: int             # row of the sentinel in the conceptual BWT
    counts: np.ndarray       # (5,) uint32: C array, counts[c] = |{x < c}| incl. sentinel
    occ: np.ndarray          # (4 * nw,) uint32: occ[4w+c] = #c in BWT[:16w]
    bwt: np.ndarray          # (nw,) uint32 packed BWT (16 bases/word)
    mark_rank: np.ndarray    # (nmw,) uint32 exclusive rank of marked rows
    mark_words: np.ndarray   # (nmw,) uint32 SA-sample bitvector (32 rows/word)
    sa_samples: np.ndarray   # (num_samples,) uint32
    sa_rate: int             # sampling rate d (walk bound)
    lut_lo: np.ndarray       # (4^lut_k,) uint32
    lut_hi: np.ndarray       # (4^lut_k,) uint32
    lut_k: int
    pac: np.ndarray          # packed genome words incl. guard padding
    names: list[str]
    offsets: np.ndarray      # (num_chrom+1,) uint64
    amb_starts: np.ndarray   # (num_amb,) uint64 — excluded-region starts
    amb_ends: np.ndarray     # (num_amb,) uint64

    @property
    def num_rows(self) -> int:
        return self.n + 1


def build_index(
    genome: PackedGenome,
    sa_rate: int = 8,
    lut_k: int | None = None,
) -> Index:
    """Build the full index from a packed genome."""
    import sys
    import time

    verbose = bool(os.environ.get("SOAP3DP_BUILD_VERBOSE")) or genome.length > 500_000_000
    t0 = time.time()

    def _log(stage: str) -> None:
        if verbose:
            print(f"[build +{time.time() - t0:6.0f}s] {stage}",
                  file=sys.stderr, flush=True)

    codes = genome.codes
    n = genome.length
    _log(f"suffix array ({n / 1e6:.0f} Mbp)...")
    sa = suffix_array(codes)
    fused = _fused_tables_native(codes, sa, sa_rate)
    if fused is not None:
        _log("fused occ/bwt/sampling tables (native)...")
        (occ, bwt_words, mark_rank, mark_words, sa_samples, primary,
         base_counts) = fused
    else:
        _log("bwt from sa...")
        bwt, primary = bwt_from_sa(codes, sa)
        base_counts = np.bincount(codes, minlength=4).astype(np.uint64)
        _log("occ/bwt word tables...")
        occ, bwt_words = _build_fm_tables(bwt, n)
        del bwt  # multi-GB at genome scale; not needed past the table build
        _log("sa sampling...")
        mark_rank, mark_words, sa_samples = _build_sa_sampling(sa, n, sa_rate)
    # C array over the 4-letter alphabet, with the sentinel counted as
    # the unique smallest character: counts[c] = 1 + #chars < c.
    counts = np.zeros(5, dtype=np.uint32)
    counts[0] = 1
    counts[1:] = (1 + np.cumsum(base_counts)).astype(np.uint32)
    # counts layout: counts[c] = C[c] for backward search; counts[4] = n+1.
    if lut_k is None:
        lut_k = 13 if n >= 1_000_000 else max(2, min(8, int(np.log2(max(n, 16))) // 2))
    _log(f"lut (k={lut_k})...")
    lut_lo, lut_hi = _build_lut(codes, sa, lut_k)
    del sa
    _log("done")

    pac = np.concatenate([genome.pac, np.zeros(PAC_PAD_WORDS, dtype=np.uint32)])

    amb_starts, amb_ends = genome.excluded_region_mask()
    return Index(
        n=n,
        primary=primary,
        counts=counts,
        occ=occ,
        bwt=bwt_words,
        mark_rank=mark_rank,
        mark_words=mark_words,
        sa_samples=sa_samples,
        sa_rate=sa_rate,
        lut_lo=lut_lo,
        lut_hi=lut_hi,
        lut_k=lut_k,
        pac=pac,
        names=genome.names,
        offsets=genome.offsets,
        amb_starts=amb_starts,
        amb_ends=amb_ends,
    )


def _fused_tables_native(codes: np.ndarray, sa: np.ndarray, sa_rate: int):
    """Native one-pass fm+sampling build, or None (numpy fallback).

    The numpy stages each re-scan the 4(n+1)-byte SA plus multi-GB
    temporaries; at 3.1 Gbp that is 950 s (fm) + 672 s (sampling) of
    the 4,226 s build (build_v2.log, 1 core). The fused C++ pass reads
    the SA once sequentially with `codes` as the only random access
    (tests/test_builder_native.py asserts bit-identical artifacts)."""
    from soap3dp_tpu_torch.index import build_native

    if not build_native.available():
        return None
    return build_native.fused_tables(np.asarray(codes), np.asarray(sa),
                                     sa_rate)


def _build_fm_tables(bwt: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Flat per-word cumulative occ counts + packed BWT words.

    occ[4w + c] = #occurrences of base c in BWT[0 : 16w). One u32 element
    gather each for count and word serves a full Occ query on TPU.
    """
    nw = n // OCC_INTERVAL + 1
    padded = np.full(nw * OCC_INTERVAL, 255, dtype=np.uint8)
    padded[:n] = bwt
    lanes = padded.reshape(nw, OCC_INTERVAL)
    occ = np.empty((nw, 4), dtype=np.uint32)
    for c in range(4):
        # one transient bool array at a time; padding (255) never counts
        cnts = (lanes == c).sum(axis=1, dtype=np.uint32)
        occ[0, c] = 0
        np.cumsum(cnts[:-1], out=occ[1:, c])
    padded[padded == 255] = 0  # pack padding as A (masked by occ counts)
    words = dna.pack_codes(padded)[:nw]
    return occ.reshape(-1), words


def _build_sa_sampling(sa: np.ndarray, n: int, rate: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Value-sampled SA: flat bitvector words + exclusive rank + values."""
    assert rate & (rate - 1) == 0, "sa_rate must be a power of two"
    nmw = (n + 1) // MARK_INTERVAL + 1
    marked = (sa % rate) == 0
    rows = np.flatnonzero(marked)
    sa_samples = sa[rows].astype(np.uint32)

    bits = np.zeros(nmw * MARK_INTERVAL, dtype=bool)
    bits[rows] = True
    lanes = bits.reshape(nmw, MARK_INTERVAL).astype(np.uint32)
    words = np.bitwise_or.reduce(
        lanes << np.arange(MARK_INTERVAL, dtype=np.uint32)[None, :], axis=1)

    per_word = lanes.sum(axis=1, dtype=np.uint32)
    rank = np.zeros(nmw, dtype=np.uint32)
    np.cumsum(per_word[:-1], out=rank[1:])
    return rank, words.astype(np.uint32), sa_samples


def _build_lut(codes: np.ndarray, sa: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """[lo, hi) SA-row interval for every k-mer.

    Keys are base-5 with digit 0 reserved for past-the-end (sentinel),
    so suffixes shorter than k sort strictly below any k-mer that they
    prefix — exactly matching backward-search semantics.
    """
    n = codes.shape[0]
    # Row counts, not searches: the SA rows whose suffix starts with
    # pattern m form a contiguous run of length #occurrences(m), and
    # lo[m] = 1 (sentinel row) + #short suffixes sorting below m
    #       + #full k-mers with pattern < m.
    # So the whole table is one k-pass rolling k-mer value over the
    # text + a bincount + cumsum — no suffix-array access at all.
    del sa  # unused: kept for signature stability
    from soap3dp_tpu_torch.index import build_native

    if build_native.available():
        nat = build_native.lut_native(np.asarray(codes), k)
        if nat is not None:
            return nat
    mt = np.zeros(n, dtype=np.int32)
    for j in range(k):
        # one transient int32 temp at a time (peak 2 passes of n*4B, not 3)
        tmp = codes[j:].astype(np.int32)
        np.left_shift(tmp, 2 * (k - 1 - j), out=tmp)
        mt[: n - j] += tmp
        del tmp
    size = 4 ** k
    valid = max(n - k + 1, 0)
    cnts = np.bincount(mt[:valid], minlength=size).astype(np.int64)
    # short suffixes (length 1..k-1): each sorts immediately before the
    # patterns it prefixes (its past-the-end ranks below any base)
    bumps = np.zeros(size, dtype=np.int64)
    for start in range(valid, n):
        m_v = 0
        for j in range(n - start):
            m_v |= int(codes[start + j]) << (2 * (k - 1 - j))
        bumps[m_v] += 1
    lo64 = 1 + np.concatenate(([0], np.cumsum(cnts[:-1]))) + np.cumsum(bumps)
    hi64 = lo64 + cnts
    return lo64.astype(np.uint32), hi64.astype(np.uint32)


# ------------------------------------------------------------------
# Serialization: a directory of .npy files plus meta.json, the analog
# of the reference's .bwt/.fmv/.sa/.lkt/.pac/.ann/.amb/.tra file set
# (IndexHandler.h:61-84).
# ------------------------------------------------------------------

_ARRAYS = ["counts", "occ", "bwt", "mark_rank", "mark_words", "sa_samples",
           "lut_lo", "lut_hi", "pac", "offsets", "amb_starts", "amb_ends"]


def save_index(index: Index, path: str | os.PathLike) -> None:
    os.makedirs(path, exist_ok=True)
    meta = {
        "format_version": FORMAT_VERSION,
        "n": index.n,
        "primary": index.primary,
        "sa_rate": index.sa_rate,
        "lut_k": index.lut_k,
        "names": index.names,
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    for name in _ARRAYS:
        np.save(os.path.join(path, f"{name}.npy"), getattr(index, name))


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    """SWAR popcount of a uint32 array (numpy has no native popcount)."""
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> 24


def _upgrade_v1(path: str | os.PathLike, meta: dict) -> dict:
    """Derive the v2 flat arrays from a v1 directory.

    v1 interleaved 128bp rows: fmi (nb, 12) = [occ4 | 8 BWT words],
    mark (nb, 5) = [rank | 4 bitvector words]. Pure vectorized numpy —
    no suffix-array rebuild — so even a human-scale upgrade is a
    sub-minute one-time job.

    Returns the derived arrays (the current load uses them directly)
    and best-effort persists them ATOMICALLY: each array lands via a
    tmp file + os.replace, meta.json flips format_version LAST, and an
    O_EXCL lock file keeps concurrent loaders (the multi-host CLI, N
    processes sharing one index dir) from interleaving partial writes.
    On a read-only index directory the upgrade simply stays in memory.
    """
    n = meta["n"]
    fmi = np.load(os.path.join(path, "fmi.npy"), mmap_mode="r")
    nw = n // OCC_INTERVAL + 1
    nb = fmi.shape[0]
    words_all = np.ascontiguousarray(fmi[:, 4:12]).reshape(-1)  # (nb*8,)
    # per-word per-base counts, excl-cumsummed within each 128bp block
    occ = np.empty((nb * 8, 4), dtype=np.uint32)
    for c in range(4):
        x = words_all ^ np.uint32(c * 0x55555555)
        pc = _popcount_u32((~(x | (x >> np.uint32(1)))) & np.uint32(0x55555555))
        pcr = pc.reshape(nb, 8)
        excl = np.zeros((nb, 8), dtype=np.uint32)
        np.cumsum(pcr[:, :-1], axis=1, out=excl[:, 1:])
        # pad bases in the final partial word were packed as A ('0') in
        # v1; they sit at positions >= n so no occ entry w <= n//16 is
        # affected (entries past nw are sliced off below)
        occ[:, c] = (np.asarray(fmi[:, c], np.uint32)[:, None] + excl).reshape(-1)
    derived = {"occ": occ[:nw].reshape(-1).copy(), "bwt": words_all[:nw].copy()}
    del occ, words_all

    mark = np.load(os.path.join(path, "mark.npy"), mmap_mode="r")
    nmw = (n + 1) // MARK_INTERVAL + 1
    mwords = np.ascontiguousarray(mark[:, 1:5]).reshape(-1)     # (nb*4,)
    pm = _popcount_u32(mwords).reshape(nb, 4)
    excl = np.zeros((nb, 4), dtype=np.uint32)
    np.cumsum(pm[:, :-1], axis=1, out=excl[:, 1:])
    rank = (np.asarray(mark[:, 0], np.uint32)[:, None] + excl).reshape(-1)
    derived["mark_rank"] = rank[:nmw]
    derived["mark_words"] = mwords[:nmw]
    _persist_upgrade(path, meta, derived)
    return derived


def _persist_upgrade(path, meta: dict, derived: dict) -> None:
    """Best-effort atomic write-back of the upgraded arrays."""
    import sys

    lock = os.path.join(path, "upgrade.lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        try:  # self-heal a lock orphaned by a crashed upgrader
            import time
            if time.time() - os.path.getmtime(lock) > 600:
                os.unlink(lock)
                print(f"[soap3dp] removed stale {lock}; the v1->v2 "
                      "upgrade will persist on the next load",
                      file=sys.stderr)
        except OSError:
            pass
        return  # another process is persisting; our in-memory copy is fine
    except OSError as e:
        print(f"[soap3dp] index v1->v2 upgrade kept in memory "
              f"({e.__class__.__name__}: read-only index dir?)",
              file=sys.stderr)
        return
    try:
        os.close(fd)
        for name, arr in derived.items():
            # np.save appends .npy to suffix-less names; keep the tmp
            # name explicit so os.replace targets the file np.save made
            tmp = os.path.join(path, f"{name}.tmp{os.getpid()}.npy")
            np.save(tmp, arr)
            os.replace(tmp, os.path.join(path, f"{name}.npy"))
        meta2 = dict(meta)
        meta2["format_version"] = FORMAT_VERSION
        tmp = os.path.join(path, f"meta.json.tmp{os.getpid()}")
        with open(tmp, "w") as fh:
            json.dump(meta2, fh)
        os.replace(tmp, os.path.join(path, "meta.json"))  # commit point
    except OSError as e:
        print(f"[soap3dp] index v1->v2 upgrade kept in memory ({e})",
              file=sys.stderr)
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def load_index(path: str | os.PathLike) -> Index:
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    derived = {}
    if meta["format_version"] == 1:
        derived = _upgrade_v1(path, meta)
        meta["format_version"] = FORMAT_VERSION
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported index format {meta['format_version']}")
    arrays = {name: derived.get(name) if name in derived
              else np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")
              for name in _ARRAYS}
    # mmap keeps load cheap; materialize small arrays.
    return Index(
        n=meta["n"],
        primary=meta["primary"],
        sa_rate=meta["sa_rate"],
        lut_k=meta["lut_k"],
        names=meta["names"],
        **arrays,
    )


def build_index_from_fasta(fasta_path: str | os.PathLike, **kwargs) -> Index:
    return build_index(pack_fasta(fasta_path), **kwargs)


def resample_sa(index: Index, new_rate: int) -> Index:
    """Re-sample the value-sampled SA to a coarser rate, host-side.

    Keeps only samples whose SA value is a multiple of ``new_rate`` and
    rebuilds the mark bitvector + rank directory. The decode walk bound
    grows to ``new_rate`` but memory halves per doubling — this is the
    degradation ladder the OOM fallback climbs (the analog of the
    reference's SaValueFreq 1/2/4 memory plan, README.md section 2.1,
    and its tryAlloc block-count ladder, DV-DPfunctions.cu:554-612).
    """
    if new_rate == index.sa_rate:
        return index
    if new_rate % index.sa_rate or new_rate & (new_rate - 1):
        raise ValueError(
            f"new_rate {new_rate} must be a power-of-two multiple of the "
            f"current rate {index.sa_rate}")
    samples = np.asarray(index.sa_samples)
    keep = (samples % np.uint32(new_rate)) == 0
    new_samples = samples[keep]

    # marked rows ascend with sample order, so the kept-row set is the
    # current marked-row set filtered by `keep`
    words = np.asarray(index.mark_words)
    nmw = len(words)
    bits = ((words[:, None] >> np.arange(MARK_INTERVAL, dtype=np.uint32)[None, :])
            & 1).astype(bool).reshape(-1)
    rows = np.flatnonzero(bits)
    kept_rows = rows[keep]
    bits[:] = False
    bits[kept_rows] = True
    lanes = bits.reshape(nmw, MARK_INTERVAL).astype(np.uint32)
    new_words = np.bitwise_or.reduce(
        lanes << np.arange(MARK_INTERVAL, dtype=np.uint32)[None, :], axis=1)
    per_word = lanes.sum(axis=1, dtype=np.uint32)
    new_rank = np.zeros(nmw, dtype=np.uint32)
    np.cumsum(per_word[:-1], out=new_rank[1:])
    return dataclasses.replace(
        index, sa_rate=new_rate, sa_samples=new_samples,
        mark_words=new_words.astype(np.uint32), mark_rank=new_rank)


# ------------------------------------------------------------------
# Resumable per-stage build. A whole-genome build is an hour-class
# job (3.1 Gbp SA-IS ~= 69 min single-core), so each stage persists
# its artifacts into the destination directory as it completes and a
# re-run resumes after the last finished stage. SURVEY.md section 5
# calls for exactly this (the reference has no build resume at all;
# its analog is that the built index is the persistent artifact,
# BGS-Build.cpp:199-211 — we extend persistence to the build itself).
# ------------------------------------------------------------------

_STATE_FILE = "build_state.json"
_SA_TMP = "sa.tmp.npy"


def _genome_fingerprint(genome: PackedGenome, sa_rate: int, lut_k: int) -> dict:
    """Cheap identity check so a resume never mixes two genomes/configs.

    64 evenly spaced 64KB windows (plus head/tail and the length) are
    CRC'd, so an edit anywhere beyond ~48Mbp granularity is caught —
    head/tail alone missed middle-of-chromosome changes."""
    import zlib
    c = genome.codes
    n = len(c)
    crc = zlib.crc32(np.ascontiguousarray(c[:1_000_000]).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(c[-1_000_000:]).tobytes(), crc)
    for i in range(64):
        st = (n * i) // 64
        crc = zlib.crc32(
            np.ascontiguousarray(c[st:st + 65536]).tobytes(), crc)
    return {"n": int(genome.length), "sa_rate": int(sa_rate),
            "lut_k": int(lut_k), "crc": crc}


def build_index_to(
    genome: PackedGenome,
    path: str | os.PathLike,
    sa_rate: int = 8,
    lut_k: int | None = None,
    resume: bool = True,
) -> Index:
    """Build an index directly into ``path`` with per-stage checkpoints.

    Stages (each skipped on resume if its artifacts already exist and
    the recorded genome fingerprint matches):

      sa        suffix array (SA-IS; the dominant cost) -> sa.tmp.npy
      fm        BWT + counts + flat occ/word tables -> counts/occ/bwt.npy
      sampling  value-sampled SA + mark bitvector -> mark_*/sa_samples.npy
      lut       k-mer interval table -> lut_lo/lut_hi.npy
      finish    pac/offsets/ambiguity + meta.json; removes sa.tmp.npy

    Returns the finished index (mmap-loaded). ``resume=False`` discards
    any partial state and starts clean.
    """
    import sys
    import time

    n = genome.length
    if lut_k is None:
        lut_k = 13 if n >= 1_000_000 else max(2, min(8, int(np.log2(max(n, 16))) // 2))
    os.makedirs(path, exist_ok=True)
    state_path = os.path.join(path, _STATE_FILE)
    if os.path.exists(os.path.join(path, "meta.json")) and not os.path.exists(state_path):
        # already complete — but only hand it back if it IS the index
        # being requested (same n/sa_rate/lut_k, and same genome when
        # the build recorded a fingerprint)
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        fp = _genome_fingerprint(genome, sa_rate, lut_k)
        same = (meta.get("n") == fp["n"]
                and meta.get("sa_rate") == fp["sa_rate"]
                and meta.get("lut_k") == fp["lut_k"]
                and meta.get("fingerprint", fp["crc"]) == fp["crc"])
        if not same:
            raise ValueError(
                f"{path} already holds a different index "
                f"(n={meta.get('n')}, sa_rate={meta.get('sa_rate')}, "
                f"lut_k={meta.get('lut_k')}); remove it or pick "
                "another path")
        leftover = os.path.join(path, _SA_TMP)
        if os.path.exists(leftover):  # crash between the final removes
            os.remove(leftover)
        return load_index(path)

    fp = _genome_fingerprint(genome, sa_rate, lut_k)
    state: dict = {"fingerprint": fp, "done": []}
    if resume and os.path.exists(state_path):
        try:
            with open(state_path) as fh:
                prev = json.load(fh)
            if prev.get("fingerprint") == fp:
                state = prev
        except (json.JSONDecodeError, OSError):
            pass  # unreadable state: start clean

    verbose = bool(os.environ.get("SOAP3DP_BUILD_VERBOSE")) or n > 500_000_000
    t0 = time.time()

    def _log(msg: str) -> None:
        if verbose:
            print(f"[build +{time.time() - t0:6.0f}s] {msg}",
                  file=sys.stderr, flush=True)

    def _mark(stage: str) -> None:
        state["done"].append(stage)
        tmp = state_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, state_path)

    def _save(name: str, arr: np.ndarray) -> None:
        np.save(os.path.join(path, f"{name}.npy"), arr)

    codes = genome.codes
    sa_path = os.path.join(path, _SA_TMP)

    if "sa" not in state["done"]:
        _log(f"stage sa: suffix array ({n / 1e6:.0f} Mbp)...")
        sa = suffix_array(codes)
        np.save(sa_path, sa)
        del sa
        _mark("sa")
    sa = np.load(sa_path, mmap_mode="r")

    fused = None
    if "fm" not in state["done"] and "sampling" not in state["done"]:
        fused = _fused_tables_native(codes, np.asarray(sa), sa_rate)

    if "fm" not in state["done"]:
        if fused is not None:
            _log("stage fm+sampling: fused native pass...")
            (occ, bwt_words, mark_rank, mark_words, sa_samples, primary,
             base_counts) = fused
            fused = True  # drop the tuple's refs; arrays free as saved
        else:
            _log("stage fm: bwt + occ/word tables...")
            bwt, primary = bwt_from_sa(codes, np.asarray(sa))
            base_counts = np.bincount(codes, minlength=4).astype(np.uint64)
            occ, bwt_words = _build_fm_tables(bwt, n)
            del bwt
        counts = np.zeros(5, dtype=np.uint32)
        counts[0] = 1
        counts[1:] = (1 + np.cumsum(base_counts)).astype(np.uint32)
        _save("counts", counts)
        _save("occ", occ)
        _save("bwt", bwt_words)
        del occ, bwt_words
        state["primary"] = primary
        _mark("fm")
        if fused is not None:
            _save("mark_rank", mark_rank)
            _save("mark_words", mark_words)
            _save("sa_samples", sa_samples)
            del mark_rank, mark_words, sa_samples
            _mark("sampling")

    if "sampling" not in state["done"]:
        _log("stage sampling: value-sampled SA...")
        mark_rank, mark_words, sa_samples = _build_sa_sampling(
            np.asarray(sa), n, sa_rate)
        _save("mark_rank", mark_rank)
        _save("mark_words", mark_words)
        _save("sa_samples", sa_samples)
        del mark_rank, mark_words, sa_samples
        _mark("sampling")

    if "lut" not in state["done"]:
        _log(f"stage lut (k={lut_k})...")
        lut_lo, lut_hi = _build_lut(codes, sa, lut_k)
        _save("lut_lo", lut_lo)
        _save("lut_hi", lut_hi)
        del lut_lo, lut_hi
        _mark("lut")
    del sa

    _log("stage finish: genome tables + meta...")
    _save("pac", np.concatenate(
        [genome.pac, np.zeros(PAC_PAD_WORDS, dtype=np.uint32)]))
    _save("offsets", genome.offsets)
    amb_starts, amb_ends = genome.excluded_region_mask()
    _save("amb_starts", amb_starts)
    _save("amb_ends", amb_ends)
    meta = {
        "format_version": FORMAT_VERSION,
        "n": n,
        "primary": int(state["primary"]),
        "sa_rate": sa_rate,
        "lut_k": lut_k,
        "names": genome.names,
        "fingerprint": fp["crc"],
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    # state first: a crash between the removes must leave the dir in
    # the "complete" shape (meta, no state), not a broken resume where
    # the sa stage is marked done but sa.tmp.npy is gone
    os.remove(state_path)
    os.remove(sa_path)
    _log("done")
    return load_index(path)
