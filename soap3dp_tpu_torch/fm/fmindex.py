"""Batched FM-index primitives on torch tensors.

Port of soap3dp_tpu/fm/fmindex.py (same function names and results).

Dtype policy: torch has no usable uint32 (no shifts, adds, compares or
popcount on it), so the index tables live on the device as int32 BIT
PATTERNS of the host uint32 arrays (the reference's element type) and
every gathered value is widened to
int64 with ``& 0xFFFFFFFF`` (``_u32``). All arithmetic then runs in
int64 on values in [0, 2^32); where the reference relies on uint32
wrap-around the port masks explicitly (``mul32``). Positions and SA
intervals are int64 tensors.

``n`` and ``primary`` are host ints on the DeviceIndex, so no search
step ever reads a device scalar back.

The seed search's device stages (``seed_intervals``, ``lane_counts``,
``sa_decode``, ``expand_decode``, ``count_mismatches_rows``,
``dedupe``, ``search_wire``) and the DP seeding's ``lane_counts`` and
``seed_expand_decode`` take a CUDA tensor to the
hand-written kernels of kernels/fm_search.py (or raise) and a CPU
tensor to their plain-torch versions, the ``*_plain`` functions here,
which the CPU tests hold to the JAX package. The FM steps and LF steps
of both read the occ blocks (``occ_block_table``): the host index's
occ counts and BWT words live on the device only as one 32-byte block
per 64 BWT positions.
The reference's names for the same stages (``backward_search``,
``backward_search_packed``, ``count_mismatches_packed``) take a CUDA
tensor to the same kernels by holding their rows as OrientedReads.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import warnings

import numpy as np
import torch

from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.kernels import fm_search

MASK32 = 0xFFFFFFFF
_LANES = 0x5555_5555  # one bit per 2-bit base slot


@dataclasses.dataclass
class DeviceIndex:
    """Device-resident index tables (int32 bit patterns of the uint32
    host arrays). Host metadata stays on the Index."""

    occ_blocks: torch.Tensor  # (ceil(nw / 4), 8): occ_block_table
    mark_rank: torch.Tensor   # (nmw,) exclusive rank per mark word
    mark_words: torch.Tensor  # (nmw,) SA-sample bitvector
    sa_samples: torch.Tensor  # (num_samples,)
    counts: torch.Tensor      # (5,) int64 C array
    pac: torch.Tensor         # (n_words + pad,) packed genome
    lut_lo: torch.Tensor      # (4^lut_k,)
    lut_hi: torch.Tensor      # (4^lut_k,)
    primary: int
    n: int
    sa_rate: int
    lut_k: int
    repeat_heavy: bool = False
    # the SA-sample table split into equal slices, slice j on mesh device
    # j (distributed.mesh.replicate_index(shard_sa=True)); sa_samples is
    # then this replica's slice and sa_decode reads each row's owner
    sa_parts: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.occ_blocks.device


# ------------------------------------------------------------------
# uint32 emulation helpers
# ------------------------------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any int tensor) -> int64 value in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant c.

    The plain int64 product can pass 2^63; splitting c into 16-bit
    halves keeps every partial product below 2^49, so the low 32 bits
    are exact without relying on signed overflow."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32) (torch has none)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


# ------------------------------------------------------------------
# Upload
# ------------------------------------------------------------------

def _upload(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    with warnings.catch_warnings():
        # mmap'd index arrays are read-only; the copy below never writes
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without stalling the host: a
    CUDA upload goes through pinned memory as a non-blocking copy
    (a pageable copy would wait for the stream's queued kernels)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage_to_device(arrays, device) -> list[torch.Tensor]:
    """Host arrays -> tensors on ``device`` in one upload: packed into one
    buffer, each from a 16-byte boundary (on the way to a card the buffer
    is pinned, so one pinned allocation and one non-blocking copy a call
    where to_device makes one of each an array); each returned as a view
    of the device buffer with its own dtype and shape."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    cuda = torch.device(device).type == "cuda"
    host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
    flat = host.numpy()
    for a, o in zip(arrays, offs):
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True) if cuda else host
    return [buf[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def occ_block_table(occ: np.ndarray, bwt: np.ndarray) -> np.ndarray:
    """The occ blocks of the FM steps, from the host index's occ counts
    (4 per BWT word) and BWT words: block j (uint32, (ceil(nw / 4), 8))
    holds occ[16j + c] for c = 0..3, the counts before BWT word 4j, then
    the BWT words 4j..4j+3 (zero past the last), so one 32-byte block
    answers every Occ query in its 64 BWT positions."""
    nw = len(bwt)
    nb = -(-nw // 4)
    words = np.zeros(4 * nb, np.uint32)
    words[:nw] = bwt
    blocks = np.empty((nb, 8), np.uint32)
    blocks[:, :4] = np.asarray(occ).reshape(nw, 4)[::4]
    blocks[:, 4:] = words.reshape(nb, 4)
    return blocks


def device_index(index: Index, device) -> DeviceIndex:
    """Upload a host Index to ``device`` (the analog of GPUINDEXUpload,
    alignment.cu:27-116). The reference's device_index's host arrays,
    stored as int32 bit patterns, with the occ counts and BWT words
    uploaded as their occ blocks."""
    device = torch.device(device)
    return DeviceIndex(
        occ_blocks=_upload(occ_block_table(index.occ, index.bwt), device),
        mark_rank=_upload(index.mark_rank, device),
        mark_words=_upload(index.mark_words, device),
        sa_samples=_upload(index.sa_samples, device),
        counts=torch.as_tensor(np.asarray(index.counts, np.int64),
                               device=device),
        pac=_upload(index.pac, device),
        lut_lo=_upload(index.lut_lo, device),
        lut_hi=_upload(index.lut_hi, device),
        primary=int(index.primary),
        n=int(index.n),
        sa_rate=int(index.sa_rate),
        lut_k=int(index.lut_k),
        repeat_heavy=_repeat_heavy(index),
    )


def _repeat_heavy(index: Index, thresh: float = 0.05,
                  heavy_x: float = 50.0) -> bool:
    """Is a material fraction of the TEXT inside high-copy repeats?
    (Same measurement as the reference: k-mer interval widths from the
    LUT, strided sample.) SOAP3DP_REPEAT_HEAVY=0/1 overrides."""
    env = os.environ.get("SOAP3DP_REPEAT_HEAVY")
    if env is not None:
        return env not in ("", "0")
    lo = np.asarray(index.lut_lo)
    hi = np.asarray(index.lut_hi)
    size = len(lo)
    if size < 2 or index.n < (1 << 20):
        return False
    step = max(size // (1 << 20), 1)
    w = (hi[::step] - lo[::step]).astype(np.float64)
    total = w.sum()
    if total <= 0:
        return False
    expect = max(float(index.n) / size, 1.0)
    heavy = w[w > heavy_x * expect].sum() / total
    return bool(heavy > thresh)


def is_oom_error(exc: BaseException) -> bool:
    """True for a device (or host) memory exhaustion error."""
    if isinstance(exc, (torch.OutOfMemoryError, MemoryError)):
        return True
    msg = str(exc).upper()
    return "OUT OF MEMORY" in msg or "RESOURCE_EXHAUSTED" in msg


def index_hbm_bytes(index: Index) -> int:
    """Estimated device footprint of device_index(index): the occ blocks
    (32 bytes per 64 BWT positions) and the other host arrays."""
    total = 32 * -(-len(index.bwt) // 4)
    for name in ("mark_rank", "mark_words", "sa_samples", "counts", "pac",
                 "lut_lo", "lut_hi"):
        total += int(np.asarray(getattr(index, name)).nbytes)
    return total


def device_index_ladder(index: Index, device, hbm_budget: int | None = None,
                        max_rate: int = 256, upload=None
                        ) -> tuple[DeviceIndex, Index]:
    """Upload with a degradation ladder: on device OOM (or a predicted
    over-budget upload), re-sample the SA to double the rate and retry,
    up to ``max_rate`` (the reference's tryAlloc ladder analog,
    DV-DPfunctions.cu:554-612). ``upload(index)`` makes the device index
    (default: device_index on ``device``; a mesh passes its replication,
    and ``hbm_budget`` is then the budget of each of its devices).
    Returns (device index, host index)."""
    from soap3dp_tpu_torch.index.builder import resample_sa

    upload = upload or (lambda ix: device_index(ix, device))
    while True:
        try:
            need = index_hbm_bytes(index)
            if hbm_budget is not None and need > hbm_budget:
                raise MemoryError(
                    f"predicted out of memory: index needs {need / 1e9:.2f} "
                    f"GB of {hbm_budget / 1e9:.2f} GB device memory")
            return upload(index), index
        except (torch.OutOfMemoryError, MemoryError):
            if index.sa_rate >= max_rate:
                raise
            new_rate = index.sa_rate * 2
            print(f"[soap3dp] device OOM uploading index "
                  f"(sa_rate={index.sa_rate}); degrading to "
                  f"sa_rate={new_rate}", file=sys.stderr)
            if torch.device(device).type == "cuda":
                with torch.cuda.device(device):
                    torch.cuda.empty_cache()
            index = resample_sa(index, new_rate)


# ------------------------------------------------------------------
# Occ queries
# ------------------------------------------------------------------

def _match_bits(word: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One bit per 2-bit base slot of `word` that equals base c."""
    x = word ^ (c * _LANES)
    return (~(x | (x >> 1))) & _LANES


def _block_of(idx: DeviceIndex, k: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(BWT position kp of row k, the sentinel skipped; kp's occ block
    as (N, 8) values in [0, 2^32))."""
    kp = k - (k > idx.primary).to(torch.int64)
    return kp, _u32(idx.occ_blocks[kp >> 6])


def _block_count(blk: torch.Tensor, c: torch.Tensor,
                 kp: torch.Tensor) -> torch.Tensor:
    """Occ(c, kp) from kp's block: the block's count of c plus c's
    matches in its words below kp (the full words before kp's word, the
    first kp & 15 bases of it; kp & 15 == 0 shifts the lane mask out
    entirely)."""
    i = torch.arange(4, device=kp.device)[None, :]
    fw = ((kp & 63) >> 4)[:, None]
    part = _LANES >> (2 * (16 - (kp & 15)))[:, None]
    mask = torch.where(i < fw, _LANES, torch.where(i == fw, part, 0))
    hits = popcount32(_match_bits(blk[:, 4:], c[:, None]) & mask)
    return blk.gather(1, c[:, None])[:, 0] + hits.sum(dim=1)


def occ(idx: DeviceIndex, c: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Occ(c, k): occurrences of base c in the conceptual BWT[0:k]; the
    sentinel row (primary) is skipped (2bwt-lib/BWT.c BWTOccValue). One
    occ block per query."""
    kp, blk = _block_of(idx, k)
    return _block_count(blk, c, kp)


def backward_extend(idx: DeviceIndex, l: torch.Tensor, r: torch.Tensor,
                    c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One backward-search step: prepend base c to the current pattern
    (the FS1 kernel's step)."""
    cc = idx.counts[c]
    return cc + occ(idx, c, l), cc + occ(idx, c, r)


def lf_step(idx: DeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    """One LF step of each SA row (the FS2 kernel's step): C[c] +
    Occ(c, kp) of the base c at the row's BWT position, from one occ
    block."""
    kp, blk = _block_of(idx, rows)
    word = blk[:, 4:].gather(1, ((kp >> 4) & 3)[:, None])[:, 0]
    c = (word >> (2 * (kp & 15))) & 3
    return idx.counts[c] + _block_count(blk, c, kp)


# ------------------------------------------------------------------
# Backward search over read segments
# ------------------------------------------------------------------

def _require_cpu(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no implementation for {t.device}")


def _i64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64).contiguous()


def _i32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(torch.int32).contiguous()


def backward_search(idx: DeviceIndex, seqs: torch.Tensor, start: torch.Tensor,
                    length: torch.Tensor, max_steps: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """SA interval [l, r) of each read segment (one (N, L) row of
    ``seqs`` a lane), searched right-to-left: one LUT lookup for the last
    lut_k characters of a segment at least that long, then up to
    ``max_steps`` steps. FS1 on CUDA tensors: lane i reads row i, the
    rows held as forward reads."""
    if seqs.is_cuda:
        ori = OrientedReads.forward(seqs.to(torch.uint8))
        return seed_intervals(idx, ori, 1, SeedLanes.given(start, length),
                              max_steps, "general")
    _require_cpu("backward_search", seqs)
    return backward_search_plain(idx, seqs, start, length, max_steps)


def backward_search_plain(idx: DeviceIndex, seqs: torch.Tensor,
                          start: torch.Tensor, length: torch.Tensor,
                          max_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of backward_search: ``max_steps`` masked steps
    for every lane."""
    B, L = seqs.shape
    n1 = idx.n + 1
    k = idx.lut_k
    start = start.to(torch.int64)
    length = length.to(torch.int64)
    tail = start + length - k
    j = torch.arange(k, device=seqs.device)
    pos = (tail[:, None] + j[None, :]).clamp(0, L - 1)
    ch = torch.gather(seqs, 1, pos).to(torch.int64)
    m = (ch << (2 * (k - 1 - j))[None, :]).sum(dim=1) & MASK32
    can_lut = length >= k
    zero = torch.zeros_like(m)
    l = torch.where(can_lut, _u32(idx.lut_lo[m]), zero)
    r = torch.where(can_lut, _u32(idx.lut_hi[m]), zero + n1)
    rem = torch.where(can_lut, length - k, length)
    for s in range(max_steps):
        p = (start + rem - 1 - s).clamp(0, L - 1)
        c = torch.gather(seqs, 1, p[:, None])[:, 0].to(torch.int64)
        l2, r2 = backward_extend(idx, l, r, c)
        active = (s < rem) & (l < r)
        l = torch.where(active, l2, l)
        r = torch.where(active, r2, r)
    return l, r


def rolling_kmer_codes(seqs: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L) codes -> (B, L) int64 MSB-first k-mer code starting at each
    position (positions past L-k are zero-filled = 'A' padded)."""
    B, L = seqs.shape
    s = seqs.to(torch.int64)
    km = torch.zeros((B, L), dtype=torch.int64, device=seqs.device)
    for j in range(k):
        if j >= L:
            break
        km[:, :L - j] |= s[:, j:] << (2 * (k - 1 - j))
    return km


def backward_search_packed(idx: DeviceIndex, roll16: torch.Tensor,
                           seq_rows: torch.Tensor, start: torch.Tensor,
                           length: torch.Tensor, max_steps: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seed search whose per-lane characters come from two gathers of a
    rolling 16-char code array (length <= lut_k + 16). FS1 on CUDA
    tensors, over each lane's row of codes (the top base of each rolling
    code)."""
    if roll16.is_cuda:
        codes = ((roll16[_i64(seq_rows)] >> 30) & 3).to(torch.uint8)
        return seed_intervals(idx, OrientedReads.forward(codes), 1,
                              SeedLanes.given(start, length), max_steps,
                              "packed")
    _require_cpu("backward_search_packed", roll16)
    return backward_search_packed_plain(idx, roll16, seq_rows, start, length,
                                        max_steps)


def backward_search_packed_plain(idx: DeviceIndex, roll16: torch.Tensor,
                                 seq_rows: torch.Tensor, start: torch.Tensor,
                                 length: torch.Tensor, max_steps: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of backward_search_packed."""
    k = idx.lut_k
    n1 = idx.n + 1
    R, L = roll16.shape
    r16 = roll16.reshape(-1)
    flat = seq_rows.to(torch.int64) * L
    start = start.to(torch.int64)
    length = length.to(torch.int64)
    tail = (start + length - k).clamp(0, L - 1)
    wtail = r16[flat + tail]
    m = wtail >> (2 * (16 - k))
    can_lut = length >= k
    zero = torch.zeros_like(m)
    l = torch.where(can_lut, _u32(idx.lut_lo[m]), zero)
    r = torch.where(can_lut, _u32(idx.lut_hi[m]), zero + n1)
    wext = r16[flat + start.clamp(0, L - 1)]
    ext = torch.where(can_lut, length - k, length)
    for s in range(max_steps):
        d = (ext - 1 - s).clamp(0, 15)
        c = (wext >> (2 * (15 - d))) & 3
        l2, r2 = backward_extend(idx, l, r, c)
        active = (s < ext) & (l < r)
        l = torch.where(active, l2, l)
        r = torch.where(active, r2, r)
    return l, r


# ------------------------------------------------------------------
# SA decode: row -> text position
# ------------------------------------------------------------------

def sa_decode(idx: DeviceIndex, rows: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Text position of each SA row via the bounded LF walk (BWTSaValue,
    2bwt-lib/BWT.c:1694); one gather per row when sa_rate == 1. FS2 on
    CUDA tensors; with the SA table split over a mesh (``sa_parts``) FS2
    gives each row's sample rank and step count and _sa_value's owner
    routing gathers the samples."""
    if rows.is_cuda:
        rows, valid = _i64(rows), valid.to(torch.bool).contiguous()
        if not idx.sa_parts:
            return fm_search.sa_decode(idx, rows, valid)
        rank, step = fm_search.sa_ranks(idx, rows, valid)
        return torch.where(valid, (_sa_value(idx, rank) + step) & MASK32,
                           torch.zeros_like(rank))
    _require_cpu("sa_decode", rows)
    return sa_decode_plain(idx, rows, valid)


def sa_decode_plain(idx: DeviceIndex, rows: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """The plain version of sa_decode."""
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    zero = torch.zeros_like(rows)
    if idx.sa_rate == 1:
        return torch.where(valid, _sa_value(idx, rows), zero)
    done = ~valid
    mw_hit = zero
    below_hit = zero
    t_hit = zero

    def mark_probe(rows):
        mw = rows >> 5
        word = _u32(idx.mark_words[mw])
        bsel = rows & 31
        is_marked = ((word >> bsel) & 1) == 1
        partial = torch.where(bsel == 0, zero, MASK32 >> (32 - bsel))
        return mw, is_marked, popcount32(word & partial)

    for t in range(idx.sa_rate - 1):
        mw, is_marked, below = mark_probe(rows)
        newly = is_marked & ~done
        mw_hit = torch.where(newly, mw, mw_hit)
        below_hit = torch.where(newly, below, below_hit)
        t_hit = torch.where(newly, zero + t, t_hit)
        done = done | is_marked
        rows = torch.where(done, rows, lf_step(idx, rows))
    # final probe: a value-sampled SA guarantees a mark within sa_rate
    mw, is_marked, below = mark_probe(rows)
    newly = is_marked & ~done
    mw_hit = torch.where(newly, mw, mw_hit)
    below_hit = torch.where(newly, below, below_hit)
    t_hit = torch.where(newly, zero + (idx.sa_rate - 1), t_hit)
    rank = _u32(idx.mark_rank[mw_hit]) + below_hit
    value = _sa_value(idx, rank)
    return torch.where(valid, (value + t_hit) & MASK32, zero)


def _sa_value(idx: DeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    """sa_samples[rows] (rows clamped to the table) as values in
    [0, 2^32). With the table split over devices (``sa_parts``), every
    row goes to each slice's device, which answers the rows it owns;
    no host sync, like the reference's collective over a sharded SA."""
    if not idx.sa_parts:
        return _u32(idx.sa_samples[rows.clamp(max=idx.sa_samples.shape[0] - 1)])
    per = idx.sa_parts[0].shape[0]
    rows = rows.clamp(max=per * len(idx.sa_parts) - 1)
    out = torch.zeros_like(rows)
    for j, part in enumerate(idx.sa_parts):
        local = (rows - j * per).clamp(0, per - 1).to(part.device)
        out = torch.where(rows // per == j, _u32(part[local]).to(rows.device),
                          out)
    return out


SENTINEL = 0xFFFFFFFF  # the dedupe key of a slot that holds no placement


def expand_decode(idx: DeviceIndex, l: torch.Tensor, incl: torch.Tensor,
                  seeds: SeedLanes, S: int, K: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lane expansion and SA decode of _search_batch: lane j (row
    j // S, its segment start and its row's read length from ``seeds``)
    owns the slots incl[j - 1]..incl[j] - 1 of the inclusive count
    cumsum ``incl``, slot k of them SA row l[j] + k - incl[j - 1]; each
    of the K slots gets the hash dedupe's keys (krow, ktp, pos_ok): the
    oriented row and the read's text position where its decoded position
    starts a placement inside the text, else SENTINEL and False. FS2 on
    CUDA tensors (with the SA table split over a mesh, FS2 gives each
    slot's lane, rank and step count and the owner routing gathers the
    samples)."""
    if l.is_cuda:
        args = (idx, _i64(l), _i64(incl), seeds, S, K)
        if not idx.sa_parts:
            return fm_search.expand_decode(*args)
        lane, rank, step = fm_search.expand_ranks(*args)
        valid = torch.arange(K, device=l.device) < incl[-1]
        sa_pos = torch.where(valid, (_sa_value(idx, rank) + step) & MASK32,
                             torch.zeros_like(rank))
        return _placements(idx, valid, sa_pos, lane, seeds, S)
    _require_cpu("expand_decode", l)
    return expand_decode_plain(idx, l, incl, seeds, S, K)


def _placements(idx: DeviceIndex, valid: torch.Tensor, sa_pos: torch.Tensor,
                lane: torch.Tensor, seeds: SeedLanes, S: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(krow, ktp, pos_ok) of slots whose lane's segment decoded to
    sa_pos: the read starts sa_pos less the lane's segment start into
    the text."""
    sstart = seeds.bounds(S)[0]
    st = sstart[lane]
    tp = sa_pos - st
    orow = lane // S
    olens = seeds.row_lens(sstart.shape[0] // S)
    pos_ok = valid & (sa_pos >= st) & (tp + olens[orow] <= idx.n)
    krow = torch.where(pos_ok, orow, torch.full_like(orow, SENTINEL))
    ktp = torch.where(pos_ok, tp & MASK32, torch.full_like(tp, SENTINEL))
    return krow, ktp, pos_ok


def expand_decode_plain(idx: DeviceIndex, l: torch.Tensor, incl: torch.Tensor,
                        seeds: SeedLanes, S: int, K: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of expand_decode: the reference's compaction
    (exclusive offsets, a scatter-max of lane ids at each lane's offset,
    a cummax fill), then sa_decode_plain."""
    dev = l.device
    RS = l.shape[0]
    incl = incl.to(torch.int64)
    off = torch.cat([incl.new_zeros(1), incl[:-1]])
    cnt = incl - off
    total = incl[-1]
    scat = torch.where(cnt > 0, off, torch.full_like(off, K)).clamp(max=K)
    tbl = torch.zeros(K + 1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, scat, torch.arange(1, RS + 1, device=dev), "amax")
    lane_p1 = torch.cummax(tbl[:K], 0).values
    idxK = torch.arange(K, device=dev)
    cvalid = (idxK < total) & (lane_p1 > 0)
    lane = (lane_p1 - 1).clamp(min=0)
    cslot = torch.where(cvalid, idxK - off[lane], torch.zeros_like(idxK))
    sa_pos = sa_decode_plain(idx, l.to(torch.int64)[lane] + cslot, cvalid)
    return _placements(idx, cvalid, sa_pos, lane, seeds, S)


def seed_expand_decode(idx: DeviceIndex, l: torch.Tensor, incl: torch.Tensor,
                       seeds: SeedLanes, S: int, K: int) -> torch.Tensor:
    """The DP seeding's lane expansion and SA decode: lane j (row j // S,
    its seed start from ``seeds``) owns the slots incl[j - 1]..incl[j] - 1
    of the inclusive count cumsum ``incl``, slot k of them SA row
    l[j] + k - incl[j - 1]; each of the K slots gets its candidate (row,
    pos, valid): the oriented row (0 past the total count) and the read's
    text position where the decoded position is not below the seed
    start, else 0 and 0. Returns them as the reference's one packed
    transfer, the (3K,) int32 bit patterns of the u32 words [row (K) |
    pos (K) | valid (K)] (seed_words). FS2s on CUDA tensors (with the SA
    table split over a mesh, its ranks form and the owner routing)."""
    if l.is_cuda:
        args = (idx, _i64(l), _i64(incl), seeds, S, K)
        if not idx.sa_parts:
            return fm_search.seed_expand_decode(*args)
        lane, rank, step = fm_search.seed_expand_ranks(*args)
        return _seed_from_ranks(idx, lane, rank, step, args[2],
                                seeds.bounds(S)[0], S)
    _require_cpu("seed_expand_decode", l)
    return seed_expand_plain(idx, l, incl, seeds, S, K)


def _seed_from_ranks(idx: DeviceIndex, lane: torch.Tensor,
                     rank: torch.Tensor, step: torch.Tensor,
                     incl: torch.Tensor, sp: torch.Tensor, S: int
                     ) -> torch.Tensor:
    """seed_expand_decode's candidates from each slot's (lane, sample
    rank, LF steps), the samples gathered by the owner routing of a
    split SA table (_sa_value)."""
    live = torch.arange(lane.shape[0], device=lane.device) < incl[-1]
    zero = torch.zeros_like(rank)
    sa_pos = torch.where(live, (_sa_value(idx, rank) + step) & MASK32, zero)
    st = sp[lane]
    valid = live & (sa_pos >= st)
    return seed_words(lane // S, torch.where(valid, sa_pos - st, zero), valid)


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of the bit patterns of ``x``'s values mod 2^32 (the
    reference's u32 words)."""
    return (((x.to(torch.int64) & MASK32) ^ 0x80000000)
            - 0x80000000).to(torch.int32)


def seed_words(row: torch.Tensor, pos: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """The DP seeding's candidates as its packed transfer: the (3K,)
    int32 bit patterns of [row | pos | valid]."""
    return i32_bits(torch.cat([row.to(torch.int64), pos.to(torch.int64),
                               valid.to(torch.int64)]))


def seed_expand_plain(idx: DeviceIndex, l: torch.Tensor, incl: torch.Tensor,
                      seeds: SeedLanes, S: int, K: int) -> torch.Tensor:
    """The plain version of seed_expand_decode: the reference's slot mask
    of (lanes, the widest count) and its nonzero, then sa_decode_plain
    (the mask's row-major order is the expansion's slot order)."""
    dev = l.device
    incl = incl.to(torch.int64)
    cnt = incl - torch.cat([incl.new_zeros(1), incl[:-1]])
    occ_cap = max(int(cnt.max()), 1)
    rows = torch.arange(l.shape[0] // S, device=dev).repeat_interleave(S)
    slot = torch.arange(occ_cap, device=dev)[None, :]
    ok = slot < cnt[:, None]
    flat = _nonzero_prefix(ok.reshape(-1), K)
    cvalid = flat >= 0
    safe = torch.where(cvalid, flat, torch.zeros_like(flat))
    lane = safe // occ_cap
    cslot = safe % occ_cap
    sa_pos = sa_decode_plain(idx, l.to(torch.int64)[lane] + cslot, cvalid)
    st = seeds.bounds(S)[0][lane]
    cvalid = cvalid & (sa_pos >= st)
    pos = torch.where(cvalid, sa_pos - st, torch.zeros_like(sa_pos))
    return seed_words(rows[lane], pos, cvalid)


def lane_counts(l: torch.Tensor, r: torch.Tensor, cap: int, S: int,
                flags: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, ...]:
    """Each seed lane's candidate count from its SA interval [l, r),
    their inclusive cumsum ``incl`` and the total (0-dim). The search's
    (``flags`` given, int32 (ceil(B / 32),) for B = RS / 2S reads of S
    lanes a strand): 0 where the width passes cap, else the width; the
    flagged words of the result wire, read b at bit b % 32 of word
    b // 32 where a lane of its row b or B + b passed cap, written into
    ``flags``; returns (incl, total, flags). The DP seeding's (S lanes a
    row): the width clamped to [0, cap]; returns (incl, total). FS5 on
    CUDA tensors."""
    if l.is_cuda:
        return fm_search.lane_counts(_i64(l), _i64(r), cap, S, flags)
    _require_cpu("lane_counts", l)
    return lane_counts_plain(l, r, cap, S, flags)


def lane_counts_plain(l: torch.Tensor, r: torch.Tensor, cap: int, S: int,
                      flags: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, ...]:
    """The plain version of lane_counts: the reference's overflow mask,
    its any over each read's lanes, the where / minimum and the cumsum
    (search); the widths' clamp and the cumsum (seeding)."""
    width = r.to(torch.int64) - l.to(torch.int64)
    if flags is None:
        incl = torch.cumsum(width.clamp(0, cap), 0)
        return incl, incl[-1]
    overflow = width > cap
    read = overflow.reshape(-1, S).any(dim=1)
    B = read.shape[0] // 2
    read = read[:B] | read[B:]
    bits = torch.zeros(flags.shape[0] * 32, dtype=torch.int64,
                       device=l.device)
    bits[:B] = read.to(torch.int64)
    shift = torch.arange(32, device=l.device)
    flags.copy_(i32_bits((bits.reshape(-1, 32) << shift).sum(dim=1)))
    cnt = torch.where(overflow, torch.zeros_like(width), width.clamp(max=cap))
    incl = torch.cumsum(cnt, 0)
    return incl, incl[-1], flags


def _nonzero_prefix(mask: torch.Tensor, size: int) -> torch.Tensor:
    """First ``size`` indices where mask is True, ascending; -1 padded
    (nonzero without the host sync of torch.nonzero)."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (rank < size), rank, torch.full_like(rank, size))
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, device=mask.device))
    return out[:size]


# ------------------------------------------------------------------
# The hash dedupe of the search's placements
# ------------------------------------------------------------------

ROW_SENTINEL = 0x7FFFFFFF  # the row of an output slot that holds no hit


def dedupe(krow: torch.Tensor, ktp: torch.Tensor, pos_ok: torch.Tensor,
           K2: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The scatter-min hash dedupe of the K placement keys (krow, ktp;
    SENTINEL where not pos_ok) before verification: each pos_ok slot
    hashes its key to a table of 2^hb slots, whose least pos_ok slot
    wins; a slot is a first unless its winner is another slot with the
    same key (a same-key loser of a slot another key won survives, as
    in the reference; the host's hits_to_table removes it). Returns
    (urow, utp, uvalid): the first K2 firsts in ascending slot order
    (ROW_SENTINEL, ktp[0] and False past them), and uniq, the count of
    all firsts. FS4 on CUDA tensors."""
    if krow.is_cuda:
        return fm_search.dedupe(_i64(krow), _i64(ktp),
                                pos_ok.to(torch.bool).contiguous(), K2)
    _require_cpu("dedupe", krow)
    return dedupe_plain(krow, ktp, pos_ok, K2)


def dedupe_plain(krow: torch.Tensor, ktp: torch.Tensor, pos_ok: torch.Tensor,
                 K2: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """The plain version of dedupe: a scatter-min into the table, two
    gathers, the duplicate test and _nonzero_prefix of the firsts."""
    dev = krow.device
    K = krow.shape[0]
    idxs = torch.arange(K, device=dev)
    hb = max((K - 1).bit_length() + 1, 10)
    h = mul32(krow, 0x9E3779B1) ^ mul32(ktp, 0x85EBCA77)
    hslot = mul32(h, 0xC2B2AE3D) >> (32 - hb)
    table = torch.full((1 << hb,), K, dtype=torch.int64, device=dev)
    table.scatter_reduce_(0, hslot, torch.where(pos_ok, idxs,
                                                torch.full_like(idxs, K)),
                          "amin")
    widx = table[hslot].clamp(max=K - 1)
    dup = pos_ok & (widx != idxs) & (krow[widx] == krow) & (ktp[widx] == ktp)
    first = pos_ok & ~dup
    uniq = first.sum()
    idx2 = _nonzero_prefix(first, K2)
    uvalid = idx2 >= 0
    idx2s = torch.where(uvalid, idx2, torch.zeros_like(idx2))
    urow = torch.where(uvalid, krow[idx2s], torch.full_like(idx2s, ROW_SENTINEL))
    utp = ktp[idx2s]
    return urow, utp, uvalid, uniq


def search_wire(wire: torch.Tensor, B: int, total: torch.Tensor,
                uniq: torch.Tensor, urow: torch.Tensor, utp: torch.Tensor,
                uvalid: torch.Tensor, nmis: torch.Tensor, k: int
                ) -> torch.Tensor:
    """The search's result wire of B reads, the reference's
    _search_batch_wire: ``wire`` (int32 bit patterns of its u32 words,
    [total, uniq | ceil(B / 32) flagged words | tp (K2) | meta (K2)],
    the flagged words already written by lane_counts) filled in place
    and returned: the totals, each slot's text position and its meta
    word, row (24 bits, ROW_SENTINEL where it holds no hit: a unique
    placement verified within k mismatches) | nmis (7 bits) | the hit
    (bit 31), each clipped. FS6 on CUDA tensors."""
    if urow.is_cuda:
        return fm_search.search_wire(wire, B, _i64(total), _i64(uniq),
                                     _i64(urow), _i64(utp),
                                     uvalid.to(torch.bool).contiguous(),
                                     _i64(nmis), k)
    _require_cpu("search_wire", urow)
    return search_wire_plain(wire, B, total, uniq, urow, utp, uvalid, nmis,
                             k)


def search_wire_plain(wire: torch.Tensor, B: int, total: torch.Tensor,
                      uniq: torch.Tensor, urow: torch.Tensor,
                      utp: torch.Tensor, uvalid: torch.Tensor,
                      nmis: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version of search_wire: the reference's hit test, its
    where and its meta word's clips, shifts and ors."""
    K2 = urow.shape[0]
    o = 2 + fm_search.flag_words(B)
    nmis = nmis.to(torch.int64)
    hit = uvalid & (nmis <= k)
    row = torch.where(hit, urow.to(torch.int64),
                      torch.full_like(nmis, ROW_SENTINEL))
    meta = (row.clamp(0, (1 << 24) - 1) | (nmis.clamp(0, 127) << 24)
            | (hit.to(torch.int64) << 31))
    wire[:2] = i32_bits(torch.stack([total.to(torch.int64),
                                     uniq.to(torch.int64)]))
    wire[o:o + K2] = i32_bits(utp)
    wire[o + K2:o + 2 * K2] = i32_bits(meta)
    return wire


# ------------------------------------------------------------------
# Genome windows and packed verification
# ------------------------------------------------------------------

def aligned_genome_words(idx: DeviceIndex, tp: torch.Tensor,
                         W: int) -> torch.Tensor:
    """Packed genome words for [tp, tp+16*W), funnel-shifted to the
    2-bit grid: (M, W) int64 values in [0, 2^32)."""
    tp = tp.to(torch.int64)
    w0 = tp >> 4
    j = torch.arange(W + 1, device=tp.device)[None, :]
    words = _u32(idx.pac[(w0[:, None] + j).clamp(0, idx.pac.shape[0] - 1)])
    sh = (2 * (tp & 15))[:, None]
    lo = words[:, :-1] >> sh
    hi = torch.where(sh == 0, torch.zeros_like(lo),
                     (words[:, 1:] << ((32 - sh) & 31)) & MASK32)
    return lo | hi


def extract_genome(idx: DeviceIndex, tp: torch.Tensor, L: int) -> torch.Tensor:
    """Genome codes at [tp, tp+L) as an (M, L) uint8 tensor."""
    W = (L + 15) // 16
    aligned = aligned_genome_words(idx, tp, W)              # (M, W)
    shifts = 2 * torch.arange(16, device=aligned.device)
    codes = (aligned[:, :, None] >> shifts[None, None, :]) & 3
    return codes.reshape(codes.shape[0], -1)[:, :L].to(torch.uint8)


def pack_reads(codes: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """Pack (B, L) codes into (B, ceil(L/16)) int64 words (LSB-first 2-bit
    layout, as the genome)."""
    B, L = codes.shape
    W = ((max_len or L) + 15) // 16
    padded = torch.zeros((B, W * 16), dtype=torch.int64, device=codes.device)
    padded[:, :L] = codes.to(torch.int64)
    shifts = 2 * torch.arange(16, device=codes.device)
    return (padded.reshape(B, W, 16) << shifts[None, None, :]).sum(dim=-1)


def count_mismatches_packed(idx: DeviceIndex, tp: torch.Tensor,
                            read_words: torch.Tensor,
                            read_len: torch.Tensor) -> torch.Tensor:
    """Hamming distance in the packed 2-bit domain: XOR + popcount. FS3
    on CUDA tensors: placement i verifies row i, the words held as
    forward reads of 16 W bases."""
    if tp.is_cuda:
        M, W = read_words.shape
        words = ((_i64(read_words) + (1 << 31)) & MASK32) - (1 << 31)
        ori = OrientedReads.forward(words.to(torch.int32), 16 * W)
        return count_mismatches_rows(
            idx, tp, ori, torch.arange(M, device=tp.device), read_len)
    _require_cpu("count_mismatches_packed", tp)
    return count_mismatches_packed_plain(idx, tp, read_words, read_len)


def count_mismatches_packed_plain(idx: DeviceIndex, tp: torch.Tensor,
                                  read_words: torch.Tensor,
                                  read_len: torch.Tensor) -> torch.Tensor:
    """The plain version of count_mismatches_packed."""
    M, W = read_words.shape
    g = aligned_genome_words(idx, tp, W)
    x = g ^ read_words
    bits = (x | (x >> 1)) & _LANES
    j16 = torch.arange(W, device=tp.device)[None, :] * 16
    m = (read_len.to(torch.int64)[:, None] - j16).clamp(0, 16)
    lane_mask = _LANES >> (2 * (16 - m))
    return popcount32(bits & lane_mask).sum(dim=1)


# ------------------------------------------------------------------
# Oriented read rows: the search over a batch and its reverse complements
# ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OrientedReads:
    """The 2B oriented rows of a read batch, held as the forward reads:
    row b < B is read b, row B + b its reverse complement of rc_len[b]
    bases, or of rc_all where rc_len is None (3 - read[n-1-i] for i < n,
    zero past n). ``reads`` is (B, L) uint8 codes or (B, W) int32 packed
    words of L bases (the layout of search.pack_read_matrix). The
    kernels read the rows where they lie; the plain versions read
    ``matrix``, the (2B, L) code matrix, made once."""

    reads: torch.Tensor
    L: int
    rc_len: torch.Tensor | None  # (B,) int32
    rc_all: int = 0

    @classmethod
    def of(cls, reads: torch.Tensor, lens: torch.Tensor, L: int = 0,
           uniform_len: int = 0) -> "OrientedReads":
        """The batch's oriented rows (L is given for packed words); with
        ``uniform_len`` (every read that long) each reverse complement
        has min(uniform_len, L) bases, as revcomp_reads_uniform makes
        it, else lens[b]. The batch's int32 lengths are held as they
        are."""
        if reads.dtype != torch.int32:
            L = reads.shape[1]
        if uniform_len:
            return cls(reads.contiguous(), L, None, min(uniform_len, L))
        return cls(reads.contiguous(), L, _i32(lens))

    @classmethod
    def forward(cls, reads: torch.Tensor, L: int = 0) -> "OrientedReads":
        """Rows whose lanes read the forward rows only (reverse
        complements of no base)."""
        if reads.dtype != torch.int32:
            L = reads.shape[1]
        return cls(reads.contiguous(), L, None, 0)

    @property
    def B(self) -> int:
        return self.reads.shape[0]

    def rc_lengths(self) -> torch.Tensor:
        """(B,) int64: each reverse-complement row's bases."""
        if self.rc_len is None:
            return torch.full((self.B,), self.rc_all, dtype=torch.int64,
                              device=self.reads.device)
        return self.rc_len.to(torch.int64)

    def source(self) -> fm_search.ReadRows:
        return fm_search.oriented_rows(self.reads, self.L, self.rc_len,
                                       self.rc_all)

    @functools.cached_property
    def matrix(self) -> torch.Tensor:
        """The (2B, L) uint8 code matrix of the rows."""
        reads = self.reads
        if reads.dtype == torch.int32:
            reads = _unpack_read_matrix(reads, self.L)
        return torch.cat([reads, revcomp_reads(reads, self.rc_lengths())],
                         dim=0)


def _unpack_read_matrix(words: torch.Tensor, L: int) -> torch.Tensor:
    """Device-side inverse of search.pack_read_matrix ((B, W) int32
    words)."""
    B, W = words.shape
    shifts = 2 * torch.arange(16, device=words.device)
    codes = (_u32(words)[:, :, None] >> shifts[None, None, :]) & 3
    return codes.reshape(B, W * 16)[:, :L].to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class SeedLanes:
    """Where seed lane i's segment lies in its row i // S (S lanes a
    row). Given: ``start`` (and ``length``) a lane. Made from the read
    length of the row (row r's read is r mod the n reads of ``lens``),
    as the reference makes it: the search's pigeonhole segments lo,
    lo + 1, .. of ``segments`` a read, truncated to ``seed_q`` bases
    where it is above 0 (soap3dp_tpu/fm/search.py ``_seed_bounds`` and
    its seed range), or the DP seeding's staged seeds, ``pos`` (n, S) of
    ``slen`` (n,) bases each, clamped into the read
    (soap3dp_tpu/pipeline/dp_rescue.py ``_seed_cand_batch``). The
    kernels make a lane's segment from its row's read as they load it;
    the plain versions take ``bounds``. The made forms hold the reads'
    int32 tensors as they are, so nothing is launched for them. ``lens``
    also gives the search's expansion each row's read length
    (``row_lens``)."""

    start: torch.Tensor | None = None
    length: torch.Tensor | None = None
    lens: torch.Tensor | None = None
    pos: torch.Tensor | None = None
    slen: torch.Tensor | None = None
    segments: int = 0
    lo: int = 0
    seed_q: int = 0

    @classmethod
    def given(cls, start: torch.Tensor, length: torch.Tensor | None = None,
              lens: torch.Tensor | None = None) -> "SeedLanes":
        """Each lane's start (and length); ``lens``, where given, each
        row's read length, row r's lens[r mod n]."""
        return cls(start=_i64(start),
                   length=None if length is None else _i64(length),
                   lens=_i32(lens))

    @classmethod
    def pigeonhole(cls, lens: torch.Tensor, segments: int, lo: int = 0,
                   seed_q: int = 0) -> "SeedLanes":
        """The search's: a row's lanes are segments lo, lo + 1, .. of its
        read (n reads: rows 0..2n-1)."""
        return cls(lens=_i32(lens), segments=segments, lo=lo, seed_q=seed_q)

    @classmethod
    def staged(cls, pos: torch.Tensor, slen: torch.Tensor,
               lens: torch.Tensor) -> "SeedLanes":
        """The DP seeding's: read b's seeds at pos[b] of slen[b] bases,
        on both strands (rows b and n + b)."""
        return cls(lens=_i32(lens), pos=_i32(pos), slen=_i32(slen))

    @property
    def shape(self) -> tuple:
        """The lanes given, or the reads (a recorder's key)."""
        return tuple((self.start if self.start is not None
                      else self.lens).shape)

    def clone(self) -> "SeedLanes":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone()
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def row_lens(self, rows: int) -> torch.Tensor:
        """(rows,) int64: each row's read length."""
        r = torch.arange(rows, device=self.lens.device)
        return self.lens.to(torch.int64)[r % self.lens.shape[0]]

    def bounds(self, S: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(start, length) int64 of every lane, S lanes a row, in plain
        torch: the reference's formulas."""
        if self.start is not None:
            length = self.length if self.length is not None \
                else torch.zeros_like(self.start)
            return self.start, length
        olens = self.lens.to(torch.int64).repeat(2)[:, None]
        if self.pos is not None:
            sp = self.pos.to(torch.int64).repeat(2, 1)
            sl2 = self.slen.to(torch.int64).repeat(2)[:, None]
            sp = torch.minimum(sp, (olens - sl2).clamp(min=0))
            slen = torch.minimum(sl2, olens).expand(sp.shape)
            return sp.reshape(-1), slen.reshape(-1)
        j = torch.arange(self.lo, self.lo + S, device=olens.device)[None, :]
        start = j * olens // self.segments
        length = (j + 1) * olens // self.segments - start
        if self.seed_q > 0:
            length = length.clamp(max=self.seed_q)
        return start.reshape(-1), length.reshape(-1)


def seed_intervals(idx: DeviceIndex, ori: OrientedReads, S: int,
                   seeds: SeedLanes, max_steps: int, mode: str
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """SA interval [l, r) of each seed lane: lane i searches its segment
    (``seeds``) of oriented row i // S, as one of the three branches of
    the reference's _search_batch (``mode``): "lut", one LUT lookup of
    the k-mer at the segment start; "packed", backward_search_packed
    over the rows' rolling 16-base codes; "general", backward_search
    over the rows. FS1 on CUDA tensors."""
    if mode not in fm_search.MODES:
        raise ValueError(f"seed_intervals: unknown mode {mode!r}")
    if ori.reads.is_cuda:
        return fm_search.search(idx, ori.source(), S, seeds, max_steps, mode)
    _require_cpu("seed_intervals", ori.reads)
    return seed_intervals_plain(idx, ori, S, seeds, max_steps, mode)


def seed_intervals_plain(idx: DeviceIndex, ori: OrientedReads, S: int,
                         seeds: SeedLanes, max_steps: int, mode: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of seed_intervals, over the materialized rows:
    the segments' bounds first (SeedLanes.bounds)."""
    oriented = ori.matrix
    R, L = oriented.shape
    start, length = seeds.bounds(S)
    rows = torch.arange(start.shape[0], device=oriented.device) // S
    if mode == "lut":
        km = rolling_kmer_codes(oriented, idx.lut_k)
        m = km[rows, start.clamp(0, L - 1)]
        return _u32(idx.lut_lo[m]), _u32(idx.lut_hi[m])
    if mode == "packed":
        return backward_search_packed_plain(
            idx, rolling_kmer_codes(oriented, 16), rows, start, length,
            max_steps)
    return backward_search_plain(idx, oriented[rows], start, length,
                                 max_steps)


def count_mismatches_rows(idx: DeviceIndex, tp: torch.Tensor,
                          ori: OrientedReads, rows: torch.Tensor,
                          lens: torch.Tensor,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """count_mismatches_packed of oriented row rows[i] (its packed words,
    pack_reads of the (2B, L) matrix) at tp[i] over its read's length,
    the placements as the search hands them over (the reference's
    soap3dp_tpu/fm/search.py:305-310): each row clamped to [0, 2B), tp
    taken as 0 where ``valid`` is False, row r's read length lens[r mod
    n] of the (n,) ``lens``. FS3 on CUDA tensors, which does that as it
    loads them."""
    if tp.is_cuda:
        return fm_search.verify(
            idx, ori.source(), _i64(rows), _i64(tp),
            None if valid is None else valid.to(torch.bool).contiguous(),
            _i32(lens), (ori.L + 15) // 16)
    _require_cpu("count_mismatches_rows", tp)
    return count_mismatches_rows_plain(idx, tp, ori, rows, lens, valid)


def count_mismatches_rows_plain(idx: DeviceIndex, tp: torch.Tensor,
                                ori: OrientedReads, rows: torch.Tensor,
                                lens: torch.Tensor,
                                valid: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """The plain version of count_mismatches_rows: the reference's clamp,
    where and length gather, then count_mismatches_packed_plain."""
    rows = rows.to(torch.int64).clamp(0, 2 * ori.B - 1)
    if valid is not None:
        tp = torch.where(valid, tp, torch.zeros_like(tp))
    read_len = lens.to(torch.int64)[rows % lens.shape[0]]
    read_words = pack_reads(ori.matrix)
    return count_mismatches_packed_plain(idx, tp, read_words[rows], read_len)


def revcomp_reads(reads: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Length-aware reverse complement: rc[i] = 3 - read[len-1-i], zero-padded."""
    B, L = reads.shape
    i = torch.arange(L, device=reads.device)[None, :]
    lens = lens.to(torch.int64)
    src = (lens[:, None] - 1 - i).clamp(0, L - 1)
    vals = (3 - torch.gather(reads, 1, src).to(torch.int16)) & 0xFF
    out = torch.where(i < lens[:, None], vals, torch.zeros_like(vals))
    return out.to(reads.dtype)


def revcomp_reads_uniform(reads: torch.Tensor, n: int) -> torch.Tensor:
    """revcomp_reads for a batch whose reads ALL have length ``n``."""
    B, L = reads.shape
    rc = ((3 - torch.flip(reads[:, :n], dims=(1,)).to(torch.int16))
          & 0xFF).to(reads.dtype)
    if n == L:
        return rc
    return torch.cat([rc, torch.zeros((B, L - n), dtype=reads.dtype,
                                      device=reads.device)], dim=1)
