"""The seed search's device stages as hand-written Hopper kernels.

The kernels of ``csrc/fm_search.cu`` (see its source note), built with
nvcc at first use into ``_build/`` and loaded with ctypes:

* FS1 ``search``: LUT jumpstart and FM backward search per seed lane, in
  one of the three modes of the reference's ``_search_batch`` ("lut",
  "packed", "general"); replaces ``backward_search`` and
  ``backward_search_packed`` (soap3dp_tpu/fm/fmindex.py:391, :456) and
  the LUT-only branch (soap3dp_tpu/fm/search.py:207-214);
* FS2 ``sa_decode`` / ``sa_ranks``: the bounded LF walk, then the rank
  and sample gathers (fmindex.py:509), of ready rows; and
  ``expand_decode`` / ``expand_ranks``: the same walk with the lane
  expansion of the reference's ``_search_batch``
  (soap3dp_tpu/fm/search.py:247-273) before it and the dedupe keys
  after it (FS2x); and ``seed_expand_decode`` / ``seed_expand_ranks``:
  the same expansion for the DP seeding, which replaces the reference's
  slot mask and nonzero (soap3dp_tpu/pipeline/dp_rescue.py:176-188) and
  writes its candidates (FS2s);
* FS3 ``verify``: packed XOR/popcount against the genome
  (``count_mismatches_packed``, fmindex.py:653);
* FS4 ``dedupe``: the search's scatter-min hash dedupe and the
  compaction of its first occurrences (soap3dp_tpu/fm/search.py:275-301);
* GP ``prescan``: the DP rescue's gapless prescan, each candidate's
  mismatches at every window offset reduced to (min, leftmost argmin,
  zero count) in the kernel (soap3dp_tpu/pipeline/dp_rescue.py:276);
* PK ``pack_problems``: the DP rescue's problem pack, each problem's
  read oriented by its strand and its genome window's codes
  (soap3dp_tpu/pipeline/dp_rescue.py:357).

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
from typing import NamedTuple

import torch

from soap3dp_tpu_torch.kernels.cudalib import CudaKernel, CudaLibrary

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FM_SEARCH_LIB = CudaLibrary("fm_search.cu")
# soap3dp_fm_search(reads, kind, B, L, W, rc_len, S, start, length, N,
#   mode, max_steps, k, blocks, counts, lut_lo, lut_hi, primary, n1,
#   l_out, r_out, stream)
SEARCH_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_fm_search",
    [_P, _I, _LL, _I, _I, _P, _I, _P, _P, _LL, _I, _I, _I]
    + [_P] * 4 + [_LL, _LL, _P, _P, _P])
# soap3dp_sa_decode(rows, valid, N, sa_rate, mark_words, mark_rank,
#   blocks, counts, primary, sa, n_sa, out, rank_out, step_out, stream)
DECODE_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_sa_decode",
    [_P, _P, _LL, _I] + [_P] * 4 + [_LL, _P, _LL] + [_P] * 4)
# soap3dp_expand_decode(l, incl, RS, sstart, olens, S, n, K, sa_rate,
#   mark_words, mark_rank, blocks, counts, primary, sa, n_sa, krow, ktp,
#   pos_ok, lane_out, rank_out, step_out, stream)
EXPAND_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_expand_decode",
    [_P, _P, _LL, _P, _P, _I, _LL, _LL, _I] + [_P] * 4 + [_LL, _P, _LL]
    + [_P] * 7)
# soap3dp_seed_expand_decode(l, incl, RS, sp, S, K, sa_rate, mark_words,
#   mark_rank, blocks, counts, primary, sa, n_sa, row, pos, valid,
#   lane_out, rank_out, step_out, stream)
SEED_EXPAND_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_seed_expand_decode",
    [_P, _P, _LL, _P, _I, _LL, _I] + [_P] * 4 + [_LL, _P, _LL] + [_P] * 7)
# soap3dp_dedupe(krow, ktp, pos_ok, K, K2, hb, scratch, urow, utp, uvalid,
#   uniq, stream)
DEDUPE_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_dedupe",
    [_P, _P, _P, _LL, _LL, _I] + [_P] * 6)
# soap3dp_verify(reads, kind, B, L, Ws, rc_len, rows, tp, read_len, M, W,
#   pac, n_pac, out, stream)
VERIFY_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_verify",
    [_P, _I, _LL, _I, _I, _P, _P, _P, _P, _LL, _I, _P, _LL, _P, _P])

# soap3dp_prescan(reads, kind, B, L, Ws, rc_len, rows, ws, rlens, wlens, M,
#   O, pac, n_pac, out, stream)
PRESCAN_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_prescan",
    [_P, _I, _LL, _I, _I] + [_P] * 5 + [_LL, _I, _P, _LL, _P, _P])
# soap3dp_pack_problems(reads, kind, B, L, Ws, rc_len, cread, strand,
#   win_start, P, max_win, pac, n_pac, oriented, wins, stream)
PACK_KERNEL = CudaKernel(
    FM_SEARCH_LIB, "soap3dp_pack_problems",
    [_P, _I, _LL, _I, _I] + [_P] * 4 + [_LL, _I, _P, _LL, _P, _P, _P])
# the count of an offset past a window's valid ones (and the minimum of a
# candidate with none): above any read's mismatches
PRESCAN_NO_VALID = 1 << 20

# where a kernel reads the bases of its rows (csrc/fm_search.cu SRC_*)
SRC_CODES, SRC_PACKED = range(2)
MODES = {"lut": 0, "packed": 1, "general": 2}


class ReadRows(NamedTuple):
    """The rows a kernel reads bases from: ``data`` on the card, of
    ``kind``; rows 0..B-1 as stored, rows B..2B-1 their reverse
    complements of ``rc_len`` bases; L bases a row, W words a stored
    row of packed words."""

    data: torch.Tensor
    kind: int
    B: int
    L: int
    W: int
    rc_len: torch.Tensor


def oriented_rows(reads: torch.Tensor, L: int,
                  rc_len: torch.Tensor) -> ReadRows:
    """Forward reads ((B, L) uint8 codes or (B, W) int32 packed words of
    L bases) and their reverse complements (fmindex.OrientedReads)."""
    kind = SRC_PACKED if reads.dtype == torch.int32 else SRC_CODES
    B = reads.shape[0]
    W = reads.shape[1] if kind == SRC_PACKED else 0
    if kind == SRC_CODES and (reads.dtype != torch.uint8
                              or reads.shape[1] != L):
        raise ValueError(f"reads must be (B, {L}) uint8 codes or int32 words, "
                         f"got {reads.dtype} {tuple(reads.shape)}")
    if kind == SRC_PACKED and W < (L + 15) // 16:
        raise ValueError(f"{W} packed words cannot hold {L} bases")
    if rc_len.dtype != torch.int64 or rc_len.shape != (B,):
        raise ValueError(f"rc_len must be int64 ({B},)")
    return ReadRows(reads, kind, B, L, W, rc_len)


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


def search(idx, src: ReadRows, S: int, start: torch.Tensor,
           length: torch.Tensor, max_steps: int,
           mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """FS1: the SA interval [l, r) (int64) of each lane's segment
    [start, start + length) of row i // S, searched right to left from a
    LUT jumpstart in ``mode``."""
    N = start.shape[0]
    dev = start.device
    _check("fm search", dev, reads=src.data, rc_len=src.rc_len, start=start,
           length=length)
    _tables("fm search", idx, dev)
    _vector("fm search", "start", start, N, torch.int64)
    _vector("fm search", "length", length, N, torch.int64)
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
        err = fn(src.data.data_ptr(), src.kind, src.B, src.L, src.W,
                 src.rc_len.data_ptr(), S, start.data_ptr(),
                 length.data_ptr(), N, MODES[mode], max_steps, idx.lut_k,
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
            start: torch.Tensor, olens, S: int, K: int, ranks: bool):
    """A lane expansion of FS2: the search's (``olens`` given, the
    dedupe keys) or the DP seeding's (``olens`` None, the candidates),
    or either's ranks form."""
    RS = l.shape[0]
    dev = l.device
    name = kernel.symbol[len("soap3dp_"):].replace("_", " ")
    _check(name, dev, l=l, incl=incl, start=start,
           **({} if olens is None else {"olens": olens}))
    _tables(name, idx, dev)
    _vector(name, "l", l, RS, torch.int64)
    _vector(name, "incl", incl, RS, torch.int64)
    _vector(name, "start", start, RS, torch.int64)
    rows = RS // S if olens is None else olens.shape[0]
    if olens is not None and (olens.dtype != torch.int64 or olens.dim() != 1):
        raise ValueError(f"{name}: olens must be int64 (R,)")
    if RS < 1 or S < 1 or RS != rows * S or K < 0 or idx.sa_rate < 1:
        raise ValueError(f"{name}: {RS} lanes, S {S}, {rows} rows, K {K}, "
                         f"sa_rate {idx.sa_rate} out of range")
    outs = [torch.empty(K, dtype=torch.int64, device=dev) for _ in range(3)]
    if not ranks:
        outs[2] = torch.empty(K, dtype=torch.bool, device=dev)
    if K == 0:
        return outs
    _, fn = kernel.function()
    ptrs = [o.data_ptr() for o in outs]
    keys = [None] * 3 + ptrs if ranks else ptrs + [None] * 3
    lead = (S, K, idx.sa_rate) if olens is None \
        else (olens.data_ptr(), S, idx.n, K, idx.sa_rate)
    with torch.cuda.device(dev):
        err = fn(l.data_ptr(), incl.data_ptr(), RS, start.data_ptr(), *lead,
                 idx.mark_words.data_ptr(), idx.mark_rank.data_ptr(),
                 idx.occ_blocks.data_ptr(), idx.counts.data_ptr(),
                 idx.primary, idx.sa_samples.data_ptr(),
                 idx.sa_samples.shape[0], *keys, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    kernel.count(dev, (K, RS, idx.sa_rate))
    return outs


def expand_decode(idx, l: torch.Tensor, incl: torch.Tensor,
                  sstart: torch.Tensor, olens: torch.Tensor, S: int, K: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FS2 with the lane expansion: output slot k (< K) of lane j (the
    first lane whose inclusive count ``incl`` exceeds k) decodes SA row
    l[j] + k - incl[j - 1]; returns the dedupe's keys (krow, ktp int64,
    pos_ok bool): the slot's oriented row j // S and text position
    minus the segment start ``sstart[j]`` where that placement of a read
    of ``olens[j // S]`` bases lies in the text, else the 0xFFFFFFFF
    sentinel and False (fmindex.expand_decode)."""
    return tuple(_expand(EXPAND_KERNEL, idx, l, incl, sstart, olens, S, K,
                         ranks=False))


def expand_ranks(idx, l: torch.Tensor, incl: torch.Tensor,
                 sstart: torch.Tensor, olens: torch.Tensor, S: int, K: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expand_decode without the sample gather, for an SA table split
    over a mesh: each slot's (lane, sample rank, LF steps), 0 lane and
    the walk of row 0 past the total count; the owner routing gathers
    the samples and checks the placements (fmindex.expand_decode)."""
    return tuple(_expand(EXPAND_KERNEL, idx, l, incl, sstart, olens, S, K,
                         ranks=True))


def seed_expand_decode(idx, l: torch.Tensor, incl: torch.Tensor,
                       sp: torch.Tensor, S: int, K: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FS2s, the DP seeding's lane expansion: slot k (< K) of lane j
    decodes SA row l[j] + k - incl[j - 1] as expand_decode does; returns
    the candidates (row, pos int64, valid bool): the oriented row j // S
    (0 past the total count), and the text position minus the seed
    start ``sp[j]`` where it is not below it, else 0 and False
    (fmindex.seed_expand_decode)."""
    return tuple(_expand(SEED_EXPAND_KERNEL, idx, l, incl, sp, None, S, K,
                         ranks=False))


def seed_expand_ranks(idx, l: torch.Tensor, incl: torch.Tensor,
                      sp: torch.Tensor, S: int, K: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """seed_expand_decode without the sample gather, for an SA table
    split over a mesh: each slot's (lane, sample rank, LF steps), as
    expand_ranks (fmindex.seed_expand_decode)."""
    return tuple(_expand(SEED_EXPAND_KERNEL, idx, l, incl, sp, None, S, K,
                         ranks=True))


def dedupe(krow: torch.Tensor, ktp: torch.Tensor, pos_ok: torch.Tensor,
           K2: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """FS4, the hash dedupe of the K search keys (krow, ktp int64 values
    in [0, 2^32), pos_ok bool): slot k with pos_ok is a first unless the
    least pos_ok slot of its hash-table slot is another slot with the
    same key. Returns (urow, utp int64, uvalid bool) of the first K2
    firsts in ascending k (ROW_SENTINEL, ktp[0] and False past them) and
    uniq, the count of all firsts (int64, 0-dim) (fmindex.dedupe)."""
    K = krow.shape[0]
    dev = krow.device
    _check("dedupe", dev, krow=krow, ktp=ktp, pos_ok=pos_ok)
    _vector("dedupe", "krow", krow, K, torch.int64)
    _vector("dedupe", "ktp", ktp, K, torch.int64)
    _vector("dedupe", "pos_ok", pos_ok, K, torch.bool)
    if not 1 <= K < (1 << 31) - 1 or K2 < 0:
        raise ValueError(f"dedupe: K {K}, K2 {K2} out of range")
    hb = max((K - 1).bit_length() + 1, 10)  # as fmindex.dedupe_plain
    nb = -(-K // 256)  # csrc/fm_search.cu THREADS
    scratch = torch.empty((1 << hb) + -(-K // 32) + 2 * nb,
                          dtype=torch.int32, device=dev)
    urow = torch.empty(K2, dtype=torch.int64, device=dev)
    utp = torch.empty(K2, dtype=torch.int64, device=dev)
    uvalid = torch.empty(K2, dtype=torch.bool, device=dev)
    uniq = torch.empty((), dtype=torch.int64, device=dev)
    _, fn = DEDUPE_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(krow.data_ptr(), ktp.data_ptr(), pos_ok.data_ptr(), K, K2,
                 hb, scratch.data_ptr(), urow.data_ptr(), utp.data_ptr(),
                 uvalid.data_ptr(), uniq.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"dedupe kernel launch failed: CUDA error {err}")
    DEDUPE_KERNEL.count(dev, (K, K2, hb))
    return urow, utp, uvalid, uniq


def verify(idx, src: ReadRows, rows: torch.Tensor, tp: torch.Tensor,
           read_len: torch.Tensor, W: int) -> torch.Tensor:
    """FS3: the mismatches (int64) between the first read_len bases of
    row ``rows[i]`` and the genome at tp[i], over W packed words."""
    M = tp.shape[0]
    dev = tp.device
    _check("verify", dev, reads=src.data, rc_len=src.rc_len, rows=rows, tp=tp,
           read_len=read_len)
    _tables("verify", idx, dev)
    _vector("verify", "tp", tp, M, torch.int64)
    _vector("verify", "read_len", read_len, M, torch.int64)
    _vector("verify", "rows", rows, M, torch.int64)
    out = torch.empty(M, dtype=torch.int64, device=dev)
    if M == 0:
        return out
    _, fn = VERIFY_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(src.data.data_ptr(), src.kind, src.B, src.L, src.W,
                 src.rc_len.data_ptr(), rows.data_ptr(), tp.data_ptr(),
                 read_len.data_ptr(), M, W, idx.pac.data_ptr(),
                 idx.pac.shape[0], out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"verify kernel launch failed: CUDA error {err}")
    VERIFY_KERNEL.count(dev, (M, W))
    return out


def prescan(idx, src: ReadRows, rows: torch.Tensor, ws: torch.Tensor,
            rlens: torch.Tensor, wlens: torch.Tensor, O: int) -> torch.Tensor:
    """GP: candidate m's oriented row ``rows[m]`` placed gapless at each
    offset o < O of the genome window at ``ws[m]``; its mismatches over
    the first min(L, rlens[m]) bases, at the valid offsets o <=
    wlens[m] - rlens[m] (PRESCAN_NO_VALID elsewhere), reduced to (least
    count, its leftmost offset, the count of zero-mismatch offsets):
    (M, 3) int64 (dp_rescue._prescan_impl)."""
    M = rows.shape[0]
    dev = rows.device
    _check("prescan", dev, reads=src.data, rc_len=src.rc_len, rows=rows,
           ws=ws, rlens=rlens, wlens=wlens)
    _tables("prescan", idx, dev)
    for key, t in (("rows", rows), ("ws", ws), ("rlens", rlens),
                   ("wlens", wlens)):
        _vector("prescan", key, t, M, torch.int64)
    if not 1 <= O < (1 << 30) or not 1 <= src.L < PRESCAN_NO_VALID:
        raise ValueError(f"prescan: O {O}, L {src.L} out of range")
    out = torch.empty((M, 3), dtype=torch.int64, device=dev)
    if M == 0:
        return out
    _, fn = PRESCAN_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(src.data.data_ptr(), src.kind, src.B, src.L, src.W,
                 src.rc_len.data_ptr(), rows.data_ptr(), ws.data_ptr(),
                 rlens.data_ptr(), wlens.data_ptr(), M, O,
                 idx.pac.data_ptr(), idx.pac.shape[0], out.data_ptr(),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"prescan kernel launch failed: CUDA error {err}")
    PRESCAN_KERNEL.count(dev, (M, O, src.L))
    return out


def pack_problems(idx, src: ReadRows, cread: torch.Tensor,
                  strand_rev: torch.Tensor, win_start: torch.Tensor,
                  max_win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """PK: problem p's oriented row (row ``cread[p]``, or its reverse
    complement where ``strand_rev[p]``), (P, L) uint8, and the 2-bit
    genome codes at [win_start[p], win_start[p] + max_win), (P, max_win)
    uint8 (dp_rescue._pack_problems)."""
    P = cread.shape[0]
    dev = cread.device
    _check("pack problems", dev, reads=src.data, rc_len=src.rc_len,
           cread=cread, strand_rev=strand_rev, win_start=win_start,
           pac=idx.pac)
    _vector("pack problems", "cread", cread, P, torch.int64)
    _vector("pack problems", "strand_rev", strand_rev, P, torch.bool)
    _vector("pack problems", "win_start", win_start, P, torch.int64)
    if idx.pac.dtype != torch.int32 or idx.pac.dim() != 1 \
            or idx.pac.shape[0] < 1:
        raise ValueError("pack problems: the index's pac must be int32 "
                         "(n,), n >= 1")
    if not 0 <= max_win < (1 << 30):
        raise ValueError(f"pack problems: max_win {max_win} out of range")
    oriented = torch.empty((P, src.L), dtype=torch.uint8, device=dev)
    wins = torch.empty((P, max_win), dtype=torch.uint8, device=dev)
    if P == 0 or src.L + max_win == 0:
        return oriented, wins
    _, fn = PACK_KERNEL.function()
    with torch.cuda.device(dev):
        err = fn(src.data.data_ptr(), src.kind, src.B, src.L, src.W,
                 src.rc_len.data_ptr(), cread.data_ptr(),
                 strand_rev.data_ptr(), win_start.data_ptr(), P, max_win,
                 idx.pac.data_ptr(), idx.pac.shape[0], oriented.data_ptr(),
                 wins.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"pack problems kernel launch failed: CUDA error "
                           f"{err}")
    PACK_KERNEL.count(dev, (P, src.L, max_win))
    return oriented, wins
