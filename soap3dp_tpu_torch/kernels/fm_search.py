"""The seed search's device stages as hand-written Hopper kernels.

The kernels of ``csrc/fm_search.cu`` (see its source note), built with
nvcc at first use into ``_build/`` and loaded with ctypes:

* FS1 ``search``: LUT jumpstart and FM backward search per seed lane, in
  one of the three modes of the reference's ``_search_batch`` ("lut",
  "packed", "general"); replaces ``backward_search`` and
  ``backward_search_packed`` (soap3dp_tpu/fm/fmindex.py:391, :456) and
  the LUT-only branch (soap3dp_tpu/fm/search.py:207-214); a lane's
  segment given or made from its row's read length (``_seed_args``: the
  search's ``_seed_bounds``, soap3dp_tpu/fm/search.py:120, and the DP
  seeding's clamps, soap3dp_tpu/pipeline/dp_rescue.py:155-164), as FS2x
  and FS2s make their lanes' seed starts;
* FS2 ``sa_decode`` / ``sa_ranks``: the bounded LF walk, then the rank
  and sample gathers (fmindex.py:509), of ready rows; and
  ``expand_decode`` / ``expand_ranks``: the same walk with the lane
  expansion of the reference's ``_search_batch``
  (soap3dp_tpu/fm/search.py:247-273) before it and the dedupe keys
  after it (FS2x); and ``seed_expand_decode`` / ``seed_expand_ranks``:
  the same expansion for the DP seeding, which replaces the reference's
  slot mask and nonzero (soap3dp_tpu/pipeline/dp_rescue.py:176-188) and
  writes its candidates as the words of its packed transfer (FS2s);
* FS3 ``verify``: packed XOR/popcount against the genome
  (``count_mismatches_packed``, fmindex.py:653), its placements as the
  search's dedupe hands them over (soap3dp_tpu/fm/search.py:305-310:
  the rows' clamp, the positions' where and the lengths' gather in its
  loads);
* FS4 ``dedupe``: the search's scatter-min hash dedupe and the
  compaction of its first occurrences (soap3dp_tpu/fm/search.py:275-301);
* FS5 ``lane_counts``: the lanes' counts and their scan, and the result
  wire's flagged words, of the search (soap3dp_tpu/fm/search.py:232-252)
  and the DP seeding (soap3dp_tpu/pipeline/dp_rescue.py:176-179), each
  lane's l and r read once (tiles of ``COUNT_TILE`` lanes);
* FS6 ``search_wire``: the search's hit test and its result wire
  (soap3dp_tpu/fm/search.py:312, :322-346);
* GP ``prescan``: the DP rescue's gapless prescan, each candidate's
  mismatches at every window offset reduced to (min, leftmost argmin,
  zero count) in the kernel (soap3dp_tpu/pipeline/dp_rescue.py:276),
  its candidates given as the host's words (the row index, the 64-bit
  start and the lengths made in the kernel) and its result int32;
* PK ``pack_problems``: the DP rescue's problem pack, each problem's
  read oriented by its strand and its genome window's codes
  (soap3dp_tpu/pipeline/dp_rescue.py:357), its problems given as the
  host's words.

These are the launch wrappers: every tensor must lie on one CUDA device
(anything else raises; there is no fallback). ``fm/fmindex.py`` (GP, PK:
``pipeline/dp_rescue.py``) routes a CUDA tensor here and a CPU tensor to
the plain-torch version. A wrapper
launches on the device's current stream, allocates its outputs with
``torch.empty``, reads nothing back to the host and counts its launch
on its ``CudaKernel`` (by card and by launch shape).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from soap3dp_tpu_torch.kernels.cudalib import CudaKernel, CudaLibrary

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_uint
FM_SEARCH_LIB = CudaLibrary("fm_search.cu")
# a kernel's rows (ReadRows): reads, kind, B, L, W, rc_len, rc_all
_ROWS = [_P, _I, _LL, _I, _I, _P, _LL]
# the seed arguments (seed_args): start, lens, pos, slen, nl, segments,
# lo, q (FS1 also takes length, after start)
_SEEDS = [_P] * 4 + [_LL, _I, _I, _I]
# soap3dp_fm_search(rows..., S, start, length, lens, pos, slen, nl,
#   segments, lo, q, N, mode, max_steps, k, blocks, counts, lut_lo,
#   lut_hi, primary, n1, l_out, r_out, stream)
SEARCH_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_fm_search",
    _ROWS + [_I, _P] + _SEEDS + [_LL, _I, _I, _I]
    + [_P] * 4 + [_LL, _LL, _P, _P, _P])
# soap3dp_sa_decode(rows, valid, N, sa_rate, mark_words, mark_rank,
#   blocks, counts, primary, sa, n_sa, out, rank_out, step_out, stream)
DECODE_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_sa_decode",
    [_P, _P, _LL, _I] + [_P] * 4 + [_LL, _P, _LL] + [_P] * 4)
# soap3dp_expand_decode(l, incl, RS, seeds..., S, n, K, sa_rate,
#   mark_words, mark_rank, blocks, counts, primary, sa, n_sa, krow, ktp,
#   pos_ok, lane_out, rank_out, step_out, stream)
EXPAND_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_expand_decode",
    [_P, _P, _LL] + _SEEDS + [_I, _LL, _LL, _I] + [_P] * 4 + [_LL, _P, _LL]
    + [_P] * 7)
# soap3dp_seed_expand_decode(l, incl, RS, seeds..., S, K, sa_rate,
#   mark_words, mark_rank, blocks, counts, primary, sa, n_sa, words,
#   lane_out, rank_out, step_out, stream)
SEED_EXPAND_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_seed_expand_decode",
    [_P, _P, _LL] + _SEEDS + [_I, _LL, _I] + [_P] * 4 + [_LL, _P, _LL]
    + [_P] * 5)
# soap3dp_dedupe(krow, ktp, pos_ok, K, K2, hb, gen, table, scan, base,
#   tag, urow, utp, uvalid, uniq, stream)
DEDUPE_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_dedupe",
    [_P, _P, _P, _LL, _LL, _I, _U, _P, _P, _U, _U] + [_P] * 5)
# soap3dp_lane_counts(l, r, RS, cap, S, scan, base, tag, incl, total,
#   flags, nf, stream)
LANE_COUNTS_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_lane_counts",
    [_P, _P, _LL, _LL, _I, _P, _U, _U, _P, _P, _P, _LL, _P])
# FS4's look-back scan: tiles of 1,024 slots (csrc/fm_search.cu TILE)
DEDUPE_TILE = 1024
# FS5's: tiles of 2,048 lanes, 4 pairs of lanes a thread of 256
# (csrc/fm_search.cu COUNT_TILE)
COUNT_TILE = 2048
# scratch kept across calls (gen_state): (kind, card, stream) -> [int64
# scratch, the last call's generation, the tickets taken]. Kinds: FS4's
# table ("dedupe"); the scan state FS4 and FS5 share ("scan": the ticket
# counter, then the tile statuses)
_STATES: dict[tuple, list] = {}
_STATE_LOCK = threading.Lock()
_GEN_MAX = (1 << 30) - 1  # a generation << 2 (a status's tag) fits 32 bits
# soap3dp_search_wire(urow, utp, uvalid, nmis, K2, k, total, uniq, wire,
#   nf, stream)
SEARCH_WIRE_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_search_wire",
    [_P] * 4 + [_LL, _I, _P, _P, _P, _LL, _P])
# soap3dp_copy_prefix(src, pitch, n, rows, dst, stream): a copy, no kernel
COPY_PREFIX = CudaKernel(FM_SEARCH_LIB, "soap3dp_copy_prefix",
                         [_P, _LL, _LL, _I, _P, _P])
# soap3dp_verify(rows..., rows, tp, valid, lens, nl, M, W, pac, n_pac,
#   out, stream)
VERIFY_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_verify",
    _ROWS + [_P] * 4 + [_LL, _LL, _I, _P, _LL, _P, _P])

# soap3dp_prescan(rows..., words, M, O, pac, n_pac, out, stream)
PRESCAN_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_prescan", _ROWS + [_P, _LL, _I, _P, _LL, _P, _P])
# soap3dp_pack_problems(rows..., words, P, max_win, pac, n_pac, oriented,
#   wins, stream)
PACK_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_pack_problems",
    _ROWS + [_P, _LL, _I, _P, _LL, _P, _P, _P])
# the words of a PK problem and a GP candidate (csrc/fm_search.cu PK_WORDS,
# GP_WORDS; pipeline/dp_rescue.py rescue_words packs them)
PK_WORDS, GP_WORDS = 4, 6
# the count of an offset past a window's valid ones (and the minimum of a
# candidate with none): above any read's mismatches
PRESCAN_NO_VALID = 1 << 20

# where a kernel reads the bases of its rows (csrc/fm_search.cu SRC_*)
SRC_CODES, SRC_PACKED = range(2)
MODES = {"lut": 0, "packed": 1, "general": 2}


class ReadRows(NamedTuple):
    """The rows a kernel reads bases from: ``data`` on the card, of
    ``kind``; rows 0..B-1 as stored, rows B..2B-1 their reverse
    complements of ``rc_len`` bases (int32), or of ``rc_all`` each where
    ``rc_len`` is None; L bases a row, W words a stored row of packed
    words."""

    data: torch.Tensor
    kind: int
    B: int
    L: int
    W: int
    rc_len: torch.Tensor | None
    rc_all: int = 0

    def args(self) -> tuple:
        """The kernels' row arguments: reads, kind, B, L, W, rc_len,
        rc_all."""
        return (self.data.data_ptr(), self.kind, self.B, self.L, self.W,
                None if self.rc_len is None else self.rc_len.data_ptr(),
                self.rc_all)

    def tensors(self) -> dict:
        return {"reads": self.data} if self.rc_len is None else {
            "reads": self.data, "rc_len": self.rc_len}


def oriented_rows(reads: torch.Tensor, L: int, rc_len: torch.Tensor | None,
                  rc_all: int = 0) -> ReadRows:
    """Forward reads ((B, L) uint8 codes or (B, W) int32 packed words of
    L bases) and their reverse complements, of ``rc_len`` bases each
    (int32, or int64 narrowed) or, where it is None, of ``rc_all``
    (fmindex.OrientedReads)."""
    kind = SRC_PACKED if reads.dtype == torch.int32 else SRC_CODES
    B = reads.shape[0]
    W = reads.shape[1] if kind == SRC_PACKED else 0
    if kind == SRC_CODES and (reads.dtype != torch.uint8
                              or reads.shape[1] != L):
        raise ValueError(f"reads must be (B, {L}) uint8 codes or int32 words, "
                         f"got {reads.dtype} {tuple(reads.shape)}")
    if kind == SRC_PACKED and W < (L + 15) // 16:
        raise ValueError(f"{W} packed words cannot hold {L} bases")
    if rc_len is not None:
        if rc_len.dtype not in (torch.int32, torch.int64) \
                or rc_len.shape != (B,):
            raise ValueError(f"rc_len must be int32 or int64 ({B},)")
        rc_len = rc_len.to(torch.int32).contiguous()
    elif not 0 <= rc_all < 1 << 31:
        raise ValueError(f"rc_all {rc_all} out of range")
    return ReadRows(reads, kind, B, L, W, rc_len, rc_all)


def _code_rows(name: str, src: ReadRows) -> None:
    """GP and PK read (B, L) uint8 code rows only (no caller passes
    packed words), their reverse complements' lengths in their problem
    words (none in ``src``)."""
    if src.kind != SRC_CODES:
        raise ValueError(f"{name} reads code rows, not packed words")
    if src.rc_len is not None:
        raise ValueError(f"{name} takes the reverse complements' lengths "
                         "from its words, not from the rows")


def _check(name: str, dev: torch.device, **tensors) -> None:
    """Every tensor on ``dev`` (a CUDA device) and contiguous."""
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _vector(name: str, key: str, t: torch.Tensor, n: int, dtype) -> None:
    if t.dtype != dtype or t.shape != (n,):
        raise ValueError(f"{name}: {key} must be {dtype} ({n},), got "
                         f"{t.dtype} {tuple(t.shape)}")


def _tables(name: str, idx, dev: torch.device) -> None:
    _check(name, dev, occ_blocks=idx.occ_blocks, counts=idx.counts,
           lut_lo=idx.lut_lo, lut_hi=idx.lut_hi, mark_words=idx.mark_words,
           mark_rank=idx.mark_rank, sa_samples=idx.sa_samples, pac=idx.pac)
    for key in ("occ_blocks", "lut_lo", "lut_hi", "mark_words", "mark_rank",
                "sa_samples", "pac"):
        if getattr(idx, key).dtype != torch.int32:
            raise ValueError(f"{name}: the index's {key} must be int32")
    if idx.occ_blocks.dim() != 2 or idx.occ_blocks.shape[1] != 8 \
            or idx.occ_blocks.data_ptr() % 32:
        raise ValueError(f"{name}: the index's occ_blocks must be (nb, 8) "
                         "on a 32-byte boundary")
    if idx.counts.dtype != torch.int64 or idx.counts.shape != (5,):
        raise ValueError(f"{name}: the index's counts must be int64 (5,)")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _seed_args(name: str, seeds, S: int, rows: int, dev: torch.device,
               length: bool = False) -> tuple[int, tuple]:
    """(the lanes, the kernels' seed arguments: start, [length,] lens,
    pos, slen, nl, segments, lo, q) of ``seeds`` (an fmindex.SeedLanes)
    for S lanes a row of ``rows`` rows: given, (N,) int64 starts (and
    lengths, with ``length``: FS1's); or made from (nl,) int32 read
    lengths (nl = rows / 2: row r's read r mod nl), the pigeonhole
    segments or the staged seeds' (nl, S) int32 positions and (nl,)
    int32 lengths."""
    if seeds.start is not None:
        N = seeds.start.shape[0]
        given = {"start": seeds.start}
        if length:
            if seeds.length is None:
                raise ValueError(f"{name}: given starts need lengths")
            given["length"] = seeds.length
        _check(name, dev, **given)
        for key, t in given.items():
            _vector(name, key, t, N, torch.int64)
    else:
        N = rows * S
    nl = 0
    if seeds.lens is not None:
        nl = seeds.lens.shape[0]
        made = {"lens": seeds.lens}
        if seeds.pos is not None:
            made.update(pos=seeds.pos, slen=seeds.slen)
        _check(name, dev, **made)
        _vector(name, "lens", seeds.lens, nl, torch.int32)
        if seeds.pos is not None:
            _vector(name, "slen", seeds.slen, nl, torch.int32)
            if seeds.pos.dtype != torch.int32 or seeds.pos.shape != (nl, S):
                raise ValueError(f"{name}: pos must be int32 ({nl}, {S})")
        if seeds.start is None and (2 * nl != rows or (
                seeds.pos is None
                and not 0 <= seeds.lo < seeds.lo + S <= seeds.segments)):
            raise ValueError(f"{name}: {nl} read lengths for {rows} rows, "
                             f"segments {seeds.lo}..{seeds.lo + S} of "
                             f"{seeds.segments}")
    elif seeds.start is None:
        raise ValueError(f"{name}: seeds need starts or read lengths")

    def ptr(t):
        return None if t is None else t.data_ptr()

    head = (ptr(seeds.start),) + ((ptr(seeds.length),) if length else ())
    return N, head + (ptr(seeds.lens), ptr(seeds.pos), ptr(seeds.slen), nl,
                      seeds.segments, seeds.lo, seeds.seed_q)


def search(idx, src: ReadRows, S: int, seeds, max_steps: int,
           mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """FS1: the SA interval [l, r) (int64) of each lane's segment
    [start, start + length) of row i // S (``seeds``, an
    fmindex.SeedLanes: given a lane, or made from the row's read
    length), searched right to left from a LUT jumpstart in ``mode``."""
    dev = src.data.device
    _check("fm search", dev, **src.tensors())
    N, seed_args = _seed_args("fm search", seeds, S, 2 * src.B, dev,
                              length=True)
    _tables("fm search", idx, dev)
    if mode not in MODES:
        raise ValueError(f"fm search: unknown mode {mode!r}")
    if not 1 <= idx.lut_k <= 16 or S < 1 or src.L < 1 or max_steps < 0:
        raise ValueError(f"fm search: lut_k {idx.lut_k}, S {S}, L {src.L}, "
                         f"max_steps {max_steps} out of range")
    l_out = torch.empty(N, dtype=torch.int64, device=dev)
    r_out = torch.empty(N, dtype=torch.int64, device=dev)
    if N == 0:
        return l_out, r_out
    _, fn = SEARCH_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(*src.args(), S, *seed_args, N, MODES[mode], max_steps,
                 idx.lut_k,
                 idx.occ_blocks.data_ptr(), idx.counts.data_ptr(),
                 idx.lut_lo.data_ptr(), idx.lut_hi.data_ptr(), idx.primary,
                 idx.n + 1,
                 l_out.data_ptr(), r_out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fm search kernel launch failed: CUDA error {err}")
    SEARCH_KERNEL.count(dev, (N, src.L, max_steps))
    return l_out, r_out


def _decode(idx, rows: torch.Tensor, valid: torch.Tensor, ranks: bool):
    N = rows.shape[0]
    dev = rows.device
    _check("sa decode", dev, rows=rows, valid=valid)
    _tables("sa decode", idx, dev)
    _vector("sa decode", "rows", rows, N, torch.int64)
    _vector("sa decode", "valid", valid, N, torch.bool)
    if idx.sa_rate < 1:
        raise ValueError(f"sa decode: sa_rate {idx.sa_rate}")
    outs = [torch.empty(N, dtype=torch.int64, device=dev)
            for _ in range(2 if ranks else 1)]
    if N == 0:
        return outs
    _, fn = DECODE_KERNEL.function()
    out, rank, step = (None, *outs) if ranks else (outs[0], None, None)
    with torch.cuda.device(dev):
        err = fn(rows.data_ptr(), valid.data_ptr(), N, idx.sa_rate,
                 idx.mark_words.data_ptr(), idx.mark_rank.data_ptr(),
                 idx.occ_blocks.data_ptr(), idx.counts.data_ptr(),
                 idx.primary, idx.sa_samples.data_ptr(),
                 idx.sa_samples.shape[0],
                 None if out is None else out.data_ptr(),
                 None if rank is None else rank.data_ptr(),
                 None if step is None else step.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"SA decode kernel launch failed: CUDA error {err}")
    DECODE_KERNEL.count(dev, (N, idx.sa_rate))
    return outs


def sa_decode(idx, rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """FS2: the text position (int64, in [0, 2^32)) of each valid SA row
    (0 elsewhere), the samples gathered from the index's own table."""
    return _decode(idx, rows, valid, ranks=False)[0]


def sa_ranks(idx, rows: torch.Tensor, valid: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """FS2 without the sample gather: (the sample rank, the LF steps to
    it) of each row, for an SA table split over a mesh, whose owner
    routing gathers the samples (fmindex.sa_decode)."""
    return tuple(_decode(idx, rows, valid, ranks=True))


def _expand(kernel: CudaKernel, idx, l: torch.Tensor, incl: torch.Tensor,
            seeds, S: int, K: int, ranks: bool):
    """A lane expansion of FS2: the search's (EXPAND_KERNEL, the dedupe
    keys; ``seeds`` carry the read lengths) or the DP seeding's (the
    candidates' packed words), or either's ranks form. ``seeds`` (an
    fmindex.SeedLanes) give each lane's segment start."""
    RS = l.shape[0]
    dev = l.device
    name = kernel.symbol[len("soap3dp_"):].replace("_", " ")
    search = kernel is EXPAND_KERNEL
    _check(name, dev, l=l, incl=incl)
    _tables(name, idx, dev)
    _vector(name, "l", l, RS, torch.int64)
    _vector(name, "incl", incl, RS, torch.int64)
    if RS < 1 or S < 1 or RS % S or K < 0 or idx.sa_rate < 1:
        raise ValueError(f"{name}: {RS} lanes, S {S}, K {K}, "
                         f"sa_rate {idx.sa_rate} out of range")
    if search and seeds.lens is None:
        raise ValueError(f"{name}: the seeds must carry the read lengths")
    N, seed_args = _seed_args(name, seeds, S, RS // S, dev)
    if N != RS:
        raise ValueError(f"{name}: {N} seeds for {RS} lanes")
    seed = not search and not ranks
    if seed:
        outs = [torch.empty(3 * K, dtype=torch.int32, device=dev)]
    else:
        outs = [torch.empty(K, dtype=torch.int64, device=dev)
                for _ in range(3)]
    if not ranks and not seed:
        outs[2] = torch.empty(K, dtype=torch.bool, device=dev)
    if K == 0:
        return outs
    _, fn = kernel.function()
    ptrs = [o.data_ptr() for o in outs]
    blank = [None] * (3 if search else 1)
    keys = blank + ptrs if ranks else ptrs + [None] * 3
    lead = (S, idx.n, K, idx.sa_rate) if search else (S, K, idx.sa_rate)
    with torch.cuda.device(dev):
        err = fn(l.data_ptr(), incl.data_ptr(), RS, *seed_args, *lead,
                 idx.mark_words.data_ptr(), idx.mark_rank.data_ptr(),
                 idx.occ_blocks.data_ptr(), idx.counts.data_ptr(),
                 idx.primary, idx.sa_samples.data_ptr(),
                 idx.sa_samples.shape[0], *keys, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    kernel.count(dev, (K, RS, idx.sa_rate))
    return outs


def expand_decode(idx, l: torch.Tensor, incl: torch.Tensor, seeds, S: int,
                  K: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FS2 with the lane expansion: output slot k (< K) of lane j (the
    first lane whose inclusive count ``incl`` exceeds k) decodes SA row
    l[j] + k - incl[j - 1]; returns the dedupe's keys (krow, ktp int64,
    pos_ok bool): the slot's oriented row j // S and text position
    minus the segment start of lane j where that placement of the row's
    read (its length from ``seeds``) lies in the text, else the
    0xFFFFFFFF sentinel and False (fmindex.expand_decode)."""
    return tuple(_expand(EXPAND_KERNEL, idx, l, incl, seeds, S, K,
                         ranks=False))


def expand_ranks(idx, l: torch.Tensor, incl: torch.Tensor, seeds, S: int,
                 K: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expand_decode without the sample gather, for an SA table split
    over a mesh: each slot's (lane, sample rank, LF steps), 0 lane and
    the walk of row 0 past the total count; the owner routing gathers
    the samples and checks the placements (fmindex.expand_decode)."""
    return tuple(_expand(EXPAND_KERNEL, idx, l, incl, seeds, S, K,
                         ranks=True))


def seed_expand_decode(idx, l: torch.Tensor, incl: torch.Tensor, seeds,
                       S: int, K: int) -> torch.Tensor:
    """FS2s, the DP seeding's lane expansion: slot k (< K) of lane j
    decodes SA row l[j] + k - incl[j - 1] as expand_decode does; returns
    the candidates as one (3K,) int32 tensor of u32 bit patterns, [row |
    pos | valid]: the oriented row j // S (0 past the total count), and
    the text position minus lane j's seed start (``seeds``) and 1 where
    it is not below it, else 0 and 0 (fmindex.seed_expand_decode)."""
    return _expand(SEED_EXPAND_KERNEL, idx, l, incl, seeds, S, K,
                   ranks=False)[0]


def seed_expand_ranks(idx, l: torch.Tensor, incl: torch.Tensor, seeds,
                      S: int, K: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """seed_expand_decode without the sample gather, for an SA table
    split over a mesh: each slot's (lane, sample rank, LF steps), as
    expand_ranks (fmindex.seed_expand_decode)."""
    return tuple(_expand(SEED_EXPAND_KERNEL, idx, l, incl, seeds, S, K,
                         ranks=True))


def dedupe_tiles(K: int, K2: int) -> int:
    """The tiles of FS4's second launch, ceil(K / 1,024), each the first
    test, scan and write of 1,024 slots. Raises unless 1 <= K < 2^31 and
    0 <= K2 < 2^31: the kernel keeps K - k and the counts of firsts in
    32 bits."""
    if not 1 <= K < 1 << 31 or not 0 <= K2 < 1 << 31:
        raise ValueError(f"dedupe: K {K}, K2 {K2} out of range")
    return -(-K // DEDUPE_TILE)


def gen_state(kind: str, dev: torch.device, stream: int, slots: int,
              tickets: int = 0) -> tuple[torch.Tensor, int, int]:
    """Scratch ``kind`` on card ``dev`` for ``stream``: at least
    ``slots`` int64 words, zeroed when made; this call's generation,
    above every earlier call's there; and the tickets earlier calls took
    there (this call takes ``tickets``). A new scratch (the larger size
    kept) when it is too small or the generations or the 32-bit tickets
    are spent. The caller holds _STATE_LOCK until its launches are
    queued, so two threads that share a stream queue their calls one
    after the other, never interleaved."""
    key = (kind, dev.index, stream)
    ent = _STATES.get(key)
    if (ent is None or ent[0].shape[0] < slots or ent[1] >= _GEN_MAX
            or ent[2] + tickets >= 1 << 32):
        size = max(slots, ent[0].shape[0] if ent is not None else 0)
        ent = _STATES[key] = [
            torch.zeros(size, dtype=torch.int64, device=dev), 0, 0]
    ent[1] += 1
    base = ent[2]
    ent[2] += tickets
    return ent[0], ent[1], base


def _launched(name: str, err: int, dev: torch.device, stream: int) -> None:
    """Raises after a failed launch, first dropping the states of ``dev``
    and ``stream`` (the kernels did not take the tickets counted)."""
    if err != 0:
        for key in [k for k in _STATES if k[1:] == (dev.index, stream)]:
            del _STATES[key]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def dedupe(krow: torch.Tensor, ktp: torch.Tensor, pos_ok: torch.Tensor,
           K2: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """FS4, the hash dedupe of the K search keys (krow, ktp int64 values
    in [0, 2^32), pos_ok bool): slot k with pos_ok is a first unless the
    least pos_ok slot of its hash-table slot is another slot with the
    same key. Returns (urow, utp int64, uvalid bool) of the first K2
    firsts in ascending k (ROW_SENTINEL, ktp[0] and False past them) and
    uniq, the count of all firsts (int64, 0-dim) (fmindex.dedupe). Two
    launches on the card's table and scan state for the current stream
    (gen_state)."""
    K = krow.shape[0]
    dev = krow.device
    _check("dedupe", dev, krow=krow, ktp=ktp, pos_ok=pos_ok)
    _vector("dedupe", "krow", krow, K, torch.int64)
    _vector("dedupe", "ktp", ktp, K, torch.int64)
    _vector("dedupe", "pos_ok", pos_ok, K, torch.bool)
    tiles = dedupe_tiles(K, K2)
    hb = max((K - 1).bit_length() + 1, 10)  # as fmindex.dedupe_plain
    urow = torch.empty(K2, dtype=torch.int64, device=dev)
    utp = torch.empty(K2, dtype=torch.int64, device=dev)
    uvalid = torch.empty(K2, dtype=torch.bool, device=dev)
    uniq = torch.empty((), dtype=torch.int64, device=dev)
    _, fn = DEDUPE_KERNEL.function()
    with torch.cuda.device(dev), _STATE_LOCK:
        stream = _stream(dev)
        table, gen, _ = gen_state("dedupe", dev, stream, 1 << hb)
        scan, sgen, base = gen_state("scan", dev, stream, tiles + 1, tiles)
        _launched("dedupe", fn(
            krow.data_ptr(), ktp.data_ptr(), pos_ok.data_ptr(), K, K2, hb,
            gen, table.data_ptr(), scan.data_ptr(), base & 0xFFFFFFFF,
            sgen << 2, urow.data_ptr(), utp.data_ptr(), uvalid.data_ptr(),
            uniq.data_ptr(), stream), dev, stream)
    DEDUPE_KERNEL.count(dev, (K, K2, hb))
    return urow, utp, uvalid, uniq


def flag_words(B: int) -> int:
    """The result wire's flagged words of B reads: ceil(B / 32)."""
    return -(-B // 32)


def lane_counts(l: torch.Tensor, r: torch.Tensor, cap: int, S: int,
                flags: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, ...]:
    """FS5: each of the RS lanes' count from its SA interval [l, r)
    (int64), their inclusive scan ``incl`` (int64 (RS,)) and the total
    (int64, 0-dim). The search's mode (``flags`` given): a count is 0
    where the width passes cap, else the width, and ``flags`` (int32
    (ceil(B / 32),), B = RS / 2S reads of S lanes a strand) gets the
    result wire's flagged words, read b at bit b % 32 of word b // 32
    where a lane of row b or B + b passed cap; returns (incl, total,
    flags). The seeding's (S lanes a row): the width clamped to
    [0, cap]; returns (incl, total) (fmindex.lane_counts). One launch,
    on the card's scan state for the current stream (gen_state, shared
    with dedupe), its tiles of COUNT_TILE lanes.
    Raises unless RS >= 1 and RS x cap < 2^31 (32-bit counts), or
    where l or r does not lie on a 16-byte boundary."""
    RS = l.shape[0]
    dev = l.device
    name = "lane counts"
    _check(name, dev, l=l, r=r,
           **({} if flags is None else {"flags": flags}))
    _vector(name, "l", l, RS, torch.int64)
    _vector(name, "r", r, RS, torch.int64)
    search = flags is not None
    if RS < 1 or S < 1 or RS % (2 * S if search else S) or cap < 0 \
            or RS * max(cap, 1) >= 1 << 31:
        raise ValueError(f"{name}: {RS} lanes, S {S}, cap {cap} out of "
                         "range")
    if l.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError(f"{name}: l and r must lie on 16-byte boundaries")
    nf = flag_words(RS // (2 * S)) if search else 0
    if search:
        _vector(name, "flags", flags, nf, torch.int32)
    incl = torch.empty(RS, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    tiles = -(-RS // COUNT_TILE)
    _, fn = LANE_COUNTS_KERNEL.function()
    with torch.cuda.device(dev), _STATE_LOCK:
        stream = _stream(dev)
        scan, gen, base = gen_state("scan", dev, stream, tiles + 1, tiles)
        _launched(name, fn(
            l.data_ptr(), r.data_ptr(), RS, cap, S, scan.data_ptr(),
            base & 0xFFFFFFFF, gen << 2, incl.data_ptr(), total.data_ptr(),
            flags.data_ptr() if search else None, nf, stream), dev,
            stream)
    LANE_COUNTS_KERNEL.count(dev, (RS, S, int(search)))
    return (incl, total, flags) if search else (incl, total)


def search_wire(wire: torch.Tensor, B: int, total: torch.Tensor,
                uniq: torch.Tensor, urow: torch.Tensor, utp: torch.Tensor,
                uvalid: torch.Tensor, nmis: torch.Tensor, k: int
                ) -> torch.Tensor:
    """FS6: the search's result wire, ``wire`` (int32 (2 + ceil(B / 32)
    + 2 K2,), the u32 words of the reference's _search_batch_wire), its
    words 2 .. 1 + ceil(B / 32) the flagged words FS5 wrote there, filled
    in place: words 0 and 1 the totals ``total`` and ``uniq`` (int64
    0-dim), then each of the K2 slots' text position ``utp`` and meta
    word, row (24 bits: urow where uvalid and nmis <= k, else
    ROW_SENTINEL, clipped) | nmis (7 bits, clipped) | that hit test (bit
    31); returns ``wire`` (fmindex.search_wire)."""
    K2 = urow.shape[0]
    dev = urow.device
    name = "search wire"
    _check(name, dev, wire=wire, total=total, uniq=uniq, urow=urow, utp=utp,
           uvalid=uvalid, nmis=nmis)
    nf = flag_words(B)
    _vector(name, "wire", wire, 2 + nf + 2 * K2, torch.int32)
    _vector(name, "utp", utp, K2, torch.int64)
    _vector(name, "uvalid", uvalid, K2, torch.bool)
    _vector(name, "nmis", nmis, K2, torch.int64)
    _vector(name, "urow", urow, K2, torch.int64)
    for key, t in (("total", total), ("uniq", uniq)):
        if t.dtype != torch.int64 or t.dim() != 0:
            raise ValueError(f"{name}: {key} must be int64, 0-dim")
    _, fn = SEARCH_WIRE_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(urow.data_ptr(), utp.data_ptr(), uvalid.data_ptr(),
                 nmis.data_ptr(), K2, k, total.data_ptr(), uniq.data_ptr(),
                 wire.data_ptr(), nf, _stream(dev))
    if err != 0:
        raise RuntimeError(f"search wire kernel launch failed: CUDA error "
                           f"{err}")
    SEARCH_WIRE_KERNEL.count(dev, (K2, B))
    return wire


def copy_prefix(src: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """The first n words of each of the ``rows`` equal parts of ``src``
    (int32 (rows x K,) on the card) as one pinned host (rows, n) int32
    tensor: one 2-D copy on the card's current stream, no kernel (the
    DP seeding's prefix of its packed words). Returns before the copy
    ends: the caller waits for the stream."""
    dev = src.device
    _check("copy prefix", dev, src=src)
    K = src.shape[0] // max(rows, 1)
    if src.dtype != torch.int32 or src.dim() != 1 or rows < 1 \
            or src.shape[0] != rows * K or not 0 <= n <= K:
        raise ValueError(f"copy prefix: {n} of {rows} parts of "
                         f"{src.dtype} {tuple(src.shape)}")
    out = torch.empty((rows, n), dtype=torch.int32, pin_memory=True)
    _, fn = COPY_PREFIX.function()
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), K, n, rows, out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"copy prefix failed: CUDA error {err}")
    return out


def verify(idx, src: ReadRows, rows: torch.Tensor, tp: torch.Tensor,
           valid: torch.Tensor | None, lens: torch.Tensor,
           W: int) -> torch.Tensor:
    """FS3: the mismatches (int64) between the first bases of row
    ``rows[i]`` (clamped to the 2B oriented rows), as many as its read's
    length (row r's read is r mod n of the (n,) int32 ``lens``), and the
    genome at tp[i] (0 where ``valid``, bool, is False; None: every
    placement), over W packed words."""
    M = tp.shape[0]
    dev = tp.device
    _check("verify", dev, rows=rows, tp=tp, lens=lens, **src.tensors(),
           **({} if valid is None else {"valid": valid}))
    _tables("verify", idx, dev)
    _vector("verify", "tp", tp, M, torch.int64)
    _vector("verify", "rows", rows, M, torch.int64)
    if valid is not None:
        _vector("verify", "valid", valid, M, torch.bool)
    if lens.dtype != torch.int32 or lens.dim() != 1 or lens.shape[0] < 1:
        raise ValueError("verify: lens must be int32 (n,), n >= 1")
    if src.B < 1:
        raise ValueError("verify: no rows")
    out = torch.empty(M, dtype=torch.int64, device=dev)
    if M == 0:
        return out
    _, fn = VERIFY_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(*src.args(), rows.data_ptr(), tp.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 lens.data_ptr(), lens.shape[0], M, W, idx.pac.data_ptr(),
                 idx.pac.shape[0], out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"verify kernel launch failed: CUDA error {err}")
    VERIFY_KERNEL.count(dev, (M, W))
    return out


def _words(name: str, words: torch.Tensor, k: int) -> int:
    """The rows of an (n, k) int32 block of problem words."""
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != k:
        raise ValueError(f"{name}: words must be int32 (n, {k}), got "
                         f"{words.dtype} {tuple(words.shape)}")
    return words.shape[0]


def prescan(idx, src: ReadRows, words: torch.Tensor, O: int) -> torch.Tensor:
    """GP: candidate m's oriented row placed gapless at each offset o < O
    of its genome window; its mismatches over the first min(L, rlen)
    bases, at the valid offsets o <= wlen - rlen (PRESCAN_NO_VALID
    elsewhere), reduced to (least count, its leftmost offset, the count
    of zero-mismatch offsets): (M, 3) int32 (dp_rescue._prescan_impl).
    Row m of ``words`` ((M, GP_WORDS) int32, dp_rescue.rescue_words):
    read | strand << 31, the window start's low and high words, the
    reverse complement's length, rlen, wlen; ``src`` carries no lengths
    (the candidates' words do)."""
    dev = words.device
    _code_rows("prescan", src)
    _check("prescan", dev, words=words, **src.tensors())
    M = _words("prescan", words, GP_WORDS)
    _tables("prescan", idx, dev)
    if not 1 <= O < (1 << 30) or not 1 <= src.L < PRESCAN_NO_VALID:
        raise ValueError(f"prescan: O {O}, L {src.L} out of range")
    out = torch.empty((M, 3), dtype=torch.int32, device=dev)
    if M == 0:
        return out
    _, fn = PRESCAN_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(*src.args(), words.data_ptr(), M, O, idx.pac.data_ptr(),
                 idx.pac.shape[0], out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"prescan kernel launch failed: CUDA error {err}")
    PRESCAN_KERNEL.count(dev, (M, O, src.L))
    return out


def pack_units(P: int, L: int, max_win: int) -> int:
    """PK's 16-byte units a problem, ceil(max_win / 16) + ceil(L / 16).
    Raises unless 0 <= max_win < 2^30 and P times the units is below
    2^31: the kernel's unit index is 32-bit."""
    if not 0 <= max_win < (1 << 30):
        raise ValueError(f"pack problems: max_win {max_win} out of range")
    units = (max_win + 15) // 16 + (L + 15) // 16
    if P * units >= 1 << 31:
        raise ValueError(f"pack problems: {P} problems of {units} 16-byte "
                         "units pass 2^31")
    return units


def pack_problems(idx, src: ReadRows, words: torch.Tensor,
                  max_win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """PK: problem p's oriented row (its row, or that row's reverse
    complement of its rc_len bases where its strand bit is set), (P, L)
    uint8, and the 2-bit genome codes at [ws, ws + max_win) of its window
    start ws, (P, max_win) uint8 (dp_rescue._pack_problems). Row p of
    ``words`` ((P, PK_WORDS) int32, dp_rescue.rescue_words): row | strand
    << 31, the window start's low and high words, rc_len; ``src``
    carries no lengths. pack_units checks the range."""
    dev = words.device
    _code_rows("pack problems", src)
    _check("pack problems", dev, words=words, pac=idx.pac, **src.tensors())
    P = _words("pack problems", words, PK_WORDS)
    if idx.pac.dtype != torch.int32 or idx.pac.dim() != 1 \
            or idx.pac.shape[0] < 1:
        raise ValueError("pack problems: the index's pac must be int32 "
                         "(n,), n >= 1")
    pack_units(P, src.L, max_win)
    oriented = torch.empty((P, src.L), dtype=torch.uint8, device=dev)
    wins = torch.empty((P, max_win), dtype=torch.uint8, device=dev)
    if P == 0 or src.L + max_win == 0:
        return oriented, wins
    _, fn = PACK_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(*src.args(), words.data_ptr(), P, max_win,
                 idx.pac.data_ptr(), idx.pac.shape[0], oriented.data_ptr(),
                 wins.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"pack problems kernel launch failed: CUDA error "
                           f"{err}")
    PACK_KERNEL.count(dev, (P, src.L, max_win))
    return oriented, wins
